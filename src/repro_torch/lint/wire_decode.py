"""wire-decode pass: decode calls in hot paths must catch `WireError`.

`federated/wire.py` promises that ANY malformed payload — truncation,
bit-flips, duplication, version skew, codebook-lineage mismatch — raises
from the typed `WireError` hierarchy and nothing else (the decode fuzzer
in tests/test_torch_wire.py pins it, subclass for subclass with the
reference). That promise is only worth something if the call sites
honor it: an unguarded ``decode_*`` in the federated
runtime turns a corrupt payload into a crashed server instead of a
quarantined contribution (``runtime._screen_cohort``).

This pass flags every call to ``decode_bytes`` / ``decode_payload`` /
``decode_pq_delta`` inside ``repro_torch/federated/`` (tests excluded) that is
not lexically inside a ``try`` whose handlers catch the hierarchy —
``WireError``, one of its subclasses, ``ValueError`` (the hierarchy
root's base), or a broader catch. ``wire.py`` itself is exempt: the
codec module *produces* the hierarchy, and its internal decode calls
(e.g. `DeltaCodebookLink.decode` surfacing `WireResyncError` to drive a
resync handshake) are the contract, not a violation of it. Trusted
loopback decodes of bytes the same function just encoded carry inline
``# fedlint: disable=unchecked-wire-decode`` suppressions.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                             dotted_name, is_test_path)

_DECODE_NAMES = {"decode_bytes", "decode_payload", "decode_pq_delta"}
_HOT_PATH_RE = re.compile(r"(^|[/\\])repro_torch[/\\]federated[/\\]")
# anything that catches WireError: itself, a subclass, or a superclass
_CATCHERS = {"WireError", "WireTruncationError", "WireCorruptionError",
             "WireVersionError", "WireResyncError", "ValueError",
             "Exception", "BaseException"}


def _handler_catches(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:            # bare except
        return True
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for t in types:
        name = dotted_name(t)
        if name is not None and name.split(".")[-1] in _CATCHERS:
            return True
    return False


class WireDecodePass(LintPass):
    name = "wire-decode"
    rules = {
        "unchecked-wire-decode":
            "wire decode call in a federated hot path outside a try that "
            "catches the WireError hierarchy; a malformed payload crashes "
            "the server instead of being quarantined",
    }

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if not _HOT_PATH_RE.search(module.path) or is_test_path(module.path):
            return
        if Path(module.path).name == "wire.py":
            return   # the codec module produces the hierarchy
        yield from self._visit(module.tree, False, module)

    def _visit(self, node: ast.AST, guarded: bool,
               module: Module) -> Iterable[Finding]:
        if isinstance(node, ast.Try):
            caught = any(_handler_catches(h) for h in node.handlers)
            for child in node.body:
                yield from self._visit(child, guarded or caught, module)
            # handler/else/finally bodies are OUTSIDE the try's protection
            for h in node.handlers:
                for child in h.body:
                    yield from self._visit(child, guarded, module)
            for child in node.orelse + node.finalbody:
                yield from self._visit(child, guarded, module)
            return
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            short = name.split(".")[-1] if name else ""
            if short in _DECODE_NAMES and not guarded:
                yield self.finding(
                    module, node, "unchecked-wire-decode",
                    f"{short}() outside a try/except catching WireError: "
                    "corrupt or truncated payloads raise the typed wire "
                    "hierarchy — catch it and quarantine the contribution "
                    "(or suppress for trusted loopback bytes)")
        for child in ast.iter_child_nodes(node):
            yield from self._visit(child, guarded, module)
