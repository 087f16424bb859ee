"""obs-events pass: every emitted obs event name must be registered.

The obs event log is a contract between emitters (``repro_torch/federated/``)
and tooling (the inspector's ``--flight``/``--health`` views, the SLO
monitors, the Perfetto export, downstream dashboards). An event name
that exists only at its emission site is invisible to all of them — a
typo'd ``obs.event("fault.round_vioded", ...)`` silently drops data the
chaos tests think they are recording.

This pass walks ``repro_torch/federated/`` (tests excluded) for
``obs.event(...)`` / ``event(...)`` calls and checks the literal event
name against `repro_torch.obs.schema.EVENT_SCHEMAS` (imported at the
first check: it brings in torch):

  * ``orphan-obs-event`` — a literal event name that is not in the
    registry: add it to ``schema.py`` (with its category and args) so
    tooling can see it, or fix the typo.
  * ``dynamic-obs-event`` — a non-literal first argument: the registry
    cannot vouch for a computed name, so hoist the name into a literal
    (or suppress with a reviewed ``# fedlint: disable=``).
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                             dotted_name, is_test_path)
from repro_torch.lint.fleet_loops import _HOT_PATH_RE

# call shapes that append a named event to the obs log
_EVENT_FNS = frozenset({"obs.event", "event", "spans.event", "_obs_event"})


def _event_schemas():
    from repro_torch.obs.schema import EVENT_SCHEMAS
    return EVENT_SCHEMAS


class ObsEventPass(LintPass):
    name = "obs-events"
    rules = {
        "orphan-obs-event":
            "obs.event() emits a name missing from the "
            "repro_torch.obs.schema.EVENT_SCHEMAS registry; the inspector, "
            "SLO monitors and exporters will never see it — register it "
            "or fix the typo",
        "dynamic-obs-event":
            "obs.event() called with a computed (non-literal) event name; "
            "the schema registry cannot check it — use a literal name",
    }

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        if not _HOT_PATH_RE.search(module.path) or is_test_path(module.path):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted_name(node.func)
            if fn not in _EVENT_FNS or not node.args:
                continue
            name_arg = node.args[0]
            if not isinstance(name_arg, ast.Constant) \
                    or not isinstance(name_arg.value, str):
                yield self.finding(
                    module, node, "dynamic-obs-event",
                    f"{fn}() with a computed event name: the "
                    "EVENT_SCHEMAS registry cannot vouch for it; emit a "
                    "literal name (suppress if dynamism is reviewed)")
                continue
            ev_name = name_arg.value
            if ev_name not in _event_schemas():
                yield self.finding(
                    module, node, "orphan-obs-event",
                    f"event {ev_name!r} is not registered in "
                    "repro_torch.obs.schema.EVENT_SCHEMAS — tooling "
                    "(inspector, SLO monitors, Perfetto flows) will never "
                    "surface it; "
                    "add it to the registry or fix the name")
