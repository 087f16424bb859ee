"""fleet-scale pass: no per-client Python loops in federated hot paths.

The vectorized scheduler core exists because a Python ``for`` over a
fleet- or arrival-sized sequence is O(cohort) interpreter work per round
— the exact wall the heapq backend hit at 10^5 clients. This pass keeps
the hot paths honest: inside ``repro_torch/federated/`` (tests excluded), any
``for`` statement or comprehension whose iterable is (or wraps, via
``enumerate``/``zip``/``sorted``/``reversed``/``list``/``tuple``) a name
like ``fleet`` / ``arrivals`` / ``profiles`` is flagged as
``python-loop-over-fleet`` — those sequences scale with the population,
so the loop should be an array op over `ClientFleet` columns or the
sorted arrival vector instead.

Round-boundary loops over cohort-sized survivors/buffers are fine (they
are bounded by the cohort, not the fleet) and are not matched. The heapq
reference backend's intentional per-arrival code carries inline
``# fedlint: disable=python-loop-over-fleet`` suppressions — the point
is that NEW per-client loops must justify themselves in review the same
way.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Tuple

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                             dotted_name, is_test_path)

# sequences whose length scales with the fleet/arrival population
_FLEET_NAME_RE = re.compile(r"^(fleet|fleets|arrival|arrivals|profiles)$")
# the hot paths the vectorized core owns
_HOT_PATH_RE = re.compile(r"(^|[/\\])repro_torch[/\\]federated[/\\]")
# transparent wrappers: iterating enumerate(fleet) is iterating fleet
_WRAPPERS = ("enumerate", "zip", "sorted", "reversed", "list", "tuple")


def _fleet_operand(node: ast.expr) -> Optional[str]:
    """The fleet-like name this iterable expression walks, if any."""
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        if fn in _WRAPPERS:
            for arg in node.args:
                hit = _fleet_operand(arg)
                if hit:
                    return hit
        return None
    name = dotted_name(node)
    if name is None:
        return None
    last = name.split(".")[-1]
    return name if _FLEET_NAME_RE.match(last) else None


class FleetLoopPass(LintPass):
    name = "fleet-scale"
    rules = {
        "python-loop-over-fleet":
            "per-client Python for/comprehension over a fleet/arrival "
            "sequence in a federated hot path; use the vectorized "
            "ClientFleet / sorted-arrival array core (or suppress where "
            "the heapq reference backend is intentional)",
    }

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if not _HOT_PATH_RE.search(module.path) or is_test_path(module.path):
            return
        for node in ast.walk(module.tree):
            loops: List[Tuple[ast.AST, ast.expr]] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                loops.append((node, node.iter))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                loops.extend((gen.iter, gen.iter) for gen in node.generators)
            for anchor, it in loops:
                name = _fleet_operand(it)
                if name is None:
                    continue
                yield self.finding(
                    module, anchor, "python-loop-over-fleet",
                    f"Python loop over fleet-scaled sequence {name!r}: this "
                    "is O(population) interpreter work per round — use the "
                    "vectorized ClientFleet/array path, or suppress if this "
                    "is the heapq reference backend")
