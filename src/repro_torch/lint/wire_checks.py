"""wire-format exhaustiveness + version-manifest pass.

Applies to modules declaring wire kind tags (``KIND_* = <int>`` constants,
as ``federated/wire.py`` does). Checks:

  * every kind has an **encoder arm** — the constant appears in a
    ``.pack(...)`` header call;
  * every kind has a **decoder arm** — the constant appears in an explicit
    comparison (``kind == KIND_X`` / ``!=``); an unlabeled fallthrough
    (``# KIND_X`` comment at the end of a dispatch chain) does not count,
    because the next kind added silently decodes as the fallthrough;
  * an **unknown-kind rejection** exists (a ``kind not in ...`` guard that
    raises);
  * **version discipline** — the AST hash of every ``encode_*`` body is
    pinned in the checked-in ``wire_manifest.json`` (the port's own, beside
    this module) next to the version literal it packs; editing an encode
    body without bumping the version *and* refreshing the manifest
    (``python -m repro_torch.lint --update-wire-manifest``) is an error.
    Docstring-only edits do not change the hash, and neither does the
    Python version: the hash is of a dump that names every field each node
    type had in Python 3.10, and leaves out the fields later versions
    added (``FunctionDef.type_params`` in 3.12), where ``ast.dump`` would
    print them (3.12) or drop empty ones (3.13).
"""

from __future__ import annotations

import ast
import copy
import hashlib
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                                   iter_python_files)

MANIFEST_PATH = Path(__file__).with_name("wire_manifest.json")


def _kind_constants(tree: ast.Module) -> Dict[str, Tuple[int, int]]:
    """KIND_* name -> (value, lineno) for top-level int constants."""
    kinds = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.startswith("KIND_") \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            kinds[node.targets[0].id] = (node.value.value, node.lineno)
    return kinds


def _version_constants(tree: ast.Module) -> Dict[str, int]:
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.startswith("_VERSION") \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            out[node.targets[0].id] = node.value.value
    return out


def _strip_docstring(fn: ast.FunctionDef) -> ast.FunctionDef:
    fn = copy.deepcopy(fn)
    if fn.body and isinstance(fn.body[0], ast.Expr) \
            and isinstance(fn.body[0].value, ast.Constant) \
            and isinstance(fn.body[0].value.value, str):
        fn.body = fn.body[1:]
    return fn


# node fields that Pythons after 3.10 added to the nodes an encoder holds
_NEWER_FIELDS = frozenset({"type_params"})


def _canonical(node) -> str:
    """A dump of ``node`` that reads the same under Python 3.10 to 3.13:
    every field in ``_fields`` order, empty and None ones included, those
    of ``_NEWER_FIELDS`` left out."""
    if isinstance(node, ast.AST):
        fields = ",".join(_canonical(getattr(node, f, None))
                          for f in node._fields if f not in _NEWER_FIELDS)
        return f"{type(node).__name__}({fields})"
    if isinstance(node, list):
        return "[" + ",".join(_canonical(n) for n in node) + "]"
    return repr(node)


def _encoder_hash(fn: ast.FunctionDef) -> str:
    dump = _canonical(_strip_docstring(fn))
    return hashlib.sha256(dump.encode()).hexdigest()[:16]


def _packed_version(fn: ast.FunctionDef,
                    versions: Dict[str, int]) -> Optional[int]:
    """The version literal this encoder packs into its header, if visible."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "pack" and len(node.args) >= 2:
            v = node.args[1]
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return v.value
            if isinstance(v, ast.Name) and v.id in versions:
                return versions[v.id]
    return None


def _encoders(tree: ast.Module) -> List[ast.FunctionDef]:
    return [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("encode_")]


def _manifest_key(module: Module, fn_name: str) -> str:
    return f"{Path(module.path).name}:{fn_name}"


def load_manifest() -> dict:
    if MANIFEST_PATH.exists():
        return json.loads(MANIFEST_PATH.read_text())
    return {}


def update_manifest(paths) -> dict:
    """Regenerate manifest entries for every wire module under ``paths``."""
    from repro_torch.lint.core import Module as _M
    manifest = load_manifest()
    for f in iter_python_files(paths):
        if f.suffix != ".py":
            continue
        module = _M(str(f), f.read_text(encoding="utf-8"))
        if not _kind_constants(module.tree):
            continue
        versions = _version_constants(module.tree)
        for fn in _encoders(module.tree):
            manifest[_manifest_key(module, fn.name)] = {
                "hash": _encoder_hash(fn),
                "version": _packed_version(fn, versions),
            }
    MANIFEST_PATH.write_text(json.dumps(manifest, indent=2, sort_keys=True)
                             + "\n")
    return manifest


class WirePass(LintPass):
    name = "wire-format"
    rules = {
        "wire-kind-no-encoder":
            "wire kind tag never packed into a header (no encoder arm)",
        "wire-kind-no-decoder":
            "wire kind tag never compared in a decode path (no explicit "
            "decoder arm; fallthroughs mis-decode the next kind added)",
        "wire-unknown-kind-guard":
            "wire module lacks an explicit unknown-kind rejection "
            "(`kind not in ...` raise)",
        "wire-version-stale":
            "encode body changed without a version bump + manifest refresh "
            "(run `python -m repro_torch.lint --update-wire-manifest` after "
            "bumping)",
    }

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        kinds = _kind_constants(module.tree)
        if not kinds:
            return
        packed: set = set()
        compared: set = set()
        has_guard = False
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "pack":
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id in kinds:
                        packed.add(arg.id)
            if isinstance(node, ast.Compare):
                names = [n.id for n in [node.left] + node.comparators
                         if isinstance(n, ast.Name)]
                for n in names:
                    if n in kinds and any(isinstance(op, (ast.Eq, ast.NotEq))
                                          for op in node.ops):
                        compared.add(n)
                if any(isinstance(op, ast.NotIn) for op in node.ops):
                    has_guard = True

        for kname, (_, line) in kinds.items():
            if kname not in packed:
                yield self.finding(
                    module, line, "wire-kind-no-encoder",
                    f"{kname} is never packed into a wire header — the "
                    "kind is declared but unproducible")
            if kname not in compared:
                yield self.finding(
                    module, line, "wire-kind-no-decoder",
                    f"{kname} is never compared in a decode dispatch — an "
                    "unlabeled fallthrough decodes it today and silently "
                    "mis-decodes the next kind added; give it an explicit "
                    f"`kind == {kname}` arm")
        if not has_guard:
            yield self.finding(
                module, 1, "wire-unknown-kind-guard",
                "no `kind not in ...` rejection found — unknown payload "
                "kinds must fail loudly, not decode as garbage")

        yield from self._check_manifest(module)

    def _check_manifest(self, module: Module) -> Iterable[Finding]:
        manifest = load_manifest()
        versions = _version_constants(module.tree)
        for fn in _encoders(module.tree):
            key = _manifest_key(module, fn.name)
            entry = manifest.get(key)
            cur_hash = _encoder_hash(fn)
            cur_version = _packed_version(fn, versions)
            if entry is None:
                yield self.finding(
                    module, fn, "wire-version-stale",
                    f"encoder {fn.name!r} is not pinned in "
                    f"{MANIFEST_PATH.name} — run `python -m "
                    "repro_torch.lint --update-wire-manifest <paths>`")
                continue
            if entry.get("hash") != cur_hash:
                if entry.get("version") == cur_version:
                    yield self.finding(
                        module, fn, "wire-version-stale",
                        f"encode body of {fn.name!r} changed but it still "
                        f"packs version {cur_version} — old decoders would "
                        "accept payloads they cannot parse; bump the "
                        "version literal and refresh the manifest")
                else:
                    yield self.finding(
                        module, fn, "wire-version-stale",
                        f"encode body of {fn.name!r} changed (version "
                        f"{entry.get('version')} → {cur_version}); refresh "
                        "the manifest to pin the new body")
