"""mesh-axis consistency pass for the port's DeviceMesh code (two-phase,
cross-file).

Collect phase — gather every *declared* mesh dimension name across the
whole linted tree:

  * ``mesh_dim_names=`` of any call (``init_device_mesh``,
    ``DeviceMesh``, ...): a tuple of strings, or names resolved below;
  * tuple-of-string assignments to variables named ``axes`` /
    ``axis_names`` / ``mesh_axes`` / ``mesh_dim_names`` (both branches of
    a conditional, and the paired-tuple form ``shape, axes = (...),
    (...)``), as ``launch/mesh.py`` builds its meshes;
  * ALL-CAPS string constants ending in ``_AXIS`` (``CLIENTS_AXIS =
    "clients"`` in ``sharding/ctx.py``), which also resolve ``Name``
    references at use sites.

Check phase — every dimension-name *use* must be a declared one:

  * string entries of ``P(...)`` / ``PartitionSpec(...)`` (the spec
    tables of ``sharding/rules.py`` are such calls);
  * entries of the ``shard(x, *entries)`` constraint helper and string
    entries of ``local(fn, out_specs, in_specs)``;
  * the name given to ``axis_size`` / ``axis_rank``;
  * ``mesh["…"]`` and ``mesh.get_group("…")`` / ``get_local_rank("…")``.

A typo'd ``"client"`` is a lint error here instead of a ``KeyError`` on a
real mesh of 256 ranks. If the linted tree declares no names at all, the
pass stays silent (nothing to cross-check against).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                                   call_name, dotted_name, keyword_arg)

_SPEC_CALLS = {"P", "PartitionSpec"}
_SHARD_CALLS = {"shard", "shard_residual"}
_AXIS_QUERIES = {"axis_size", "axis_rank"}
_GROUP_QUERIES = {"get_group", "get_local_rank"}
_DECL_NAMES = ("axes", "axis_names", "mesh_axes", "mesh_dim_names")


def _str_elems(node: ast.AST) -> List[Tuple[str, int]]:
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append((n.value, n.lineno))
    return out


def _tuples_of_strings(node: ast.expr) -> Optional[List[str]]:
    """The strings of a tuple of strings, or of both branches of a
    conditional between such tuples."""
    if isinstance(node, ast.IfExp):
        a = _tuples_of_strings(node.body)
        b = _tuples_of_strings(node.orelse)
        return (a or []) + (b or []) if a or b else None
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return None


def _is_mesh_expr(node: ast.expr) -> bool:
    name = dotted_name(node)
    return bool(name) and "mesh" in name.split(".")[-1].lower()


class MeshAxesPass(LintPass):
    name = "mesh-axes"
    rules = {
        "mesh-axis-undeclared":
            "mesh dimension name used in P()/shard()/local()/axis_size/"
            "mesh[...]/get_group that no mesh declaration defines",
    }

    def __init__(self):
        self._declared: Set[str] = set()
        self._constants: dict = {}     # NAME -> axis string
        self._pending: Set[str] = set()  # Name refs seen in declarations
        self._finalized = False

    # ---- collect -----------------------------------------------------------

    def collect(self, module: Module, ctx: LintContext) -> None:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign):
                self._collect_assign(node)
            elif isinstance(node, ast.Call):
                kw = keyword_arg(node, "mesh_dim_names")
                if kw is not None:
                    self._collect_names(kw)

    def _collect_assign(self, node: ast.Assign) -> None:
        pairs: List[Tuple[ast.expr, ast.expr]] = []
        for target in node.targets:
            if isinstance(target, ast.Tuple) \
                    and isinstance(node.value, ast.Tuple) \
                    and len(target.elts) == len(node.value.elts):
                pairs.extend(zip(target.elts, node.value.elts))
            else:
                pairs.append((target, node.value))
        for target, value in pairs:
            if not isinstance(target, ast.Name):
                continue
            if target.id.isupper() and target.id.endswith("_AXIS") \
                    and isinstance(value, ast.Constant) \
                    and isinstance(value.value, str):
                self._declared.add(value.value)
                self._constants[target.id] = value.value
            elif target.id.lower() in _DECL_NAMES:
                strs = _tuples_of_strings(value)
                if strs:
                    self._declared.update(strs)

    def _collect_names(self, arg: ast.expr) -> None:
        strs = _tuples_of_strings(arg)
        if strs:
            self._declared.update(strs)
        elif isinstance(arg, (ast.Tuple, ast.List)):
            for e in arg.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    self._declared.add(e.value)
                elif isinstance(e, ast.Name):
                    self._pending.add(e.id)
        elif isinstance(arg, ast.Name):
            self._pending.add(arg.id)

    def _finalize(self) -> None:
        if self._finalized:
            return
        for name in self._pending:
            if name in self._constants:
                self._declared.add(self._constants[name])
        self._finalized = True

    # ---- check -------------------------------------------------------------

    def _resolve(self, node: ast.expr) -> List[Tuple[str, int]]:
        """Dimension-name strings (with lines) an argument refers to."""
        if isinstance(node, ast.Name) and node.id in self._constants:
            return [(self._constants[node.id], node.lineno)]
        return _str_elems(node)

    def _uses(self, node: ast.AST) -> List[Tuple[str, int, str]]:
        if isinstance(node, ast.Subscript) and _is_mesh_expr(node.value):
            return [(s, ln, "mesh[...] entry")
                    for s, ln in self._resolve(node.slice)]
        if not isinstance(node, ast.Call):
            return []
        name = call_name(node)
        last = name.split(".")[-1] if name else ""
        uses: List[Tuple[str, int, str]] = []
        if last in _SPEC_CALLS:
            uses += [(s, ln, "P() entry") for s, ln in _str_elems(node)]
        elif last in _SHARD_CALLS:
            for arg in node.args[1:]:
                uses += [(s, ln, "shard() entry")
                         for s, ln in self._resolve(arg)]
        elif last == "local":
            specs = list(node.args[1:]) + [
                kw.value for kw in node.keywords
                if kw.arg in ("in_specs", "out_specs")]
            for arg in specs:
                uses += [(s, ln, "local() spec entry")
                         for s, ln in self._resolve(arg)]
        elif last in _AXIS_QUERIES and node.args:
            uses += [(s, ln, f"{last}() name")
                     for s, ln in self._resolve(node.args[0])]
        elif last in _GROUP_QUERIES and node.args \
                and isinstance(node.func, ast.Attribute) \
                and _is_mesh_expr(node.func.value):
            uses += [(s, ln, f"{last}() name")
                     for s, ln in self._resolve(node.args[0])]
        return uses

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        self._finalize()
        if not self._declared:
            return
        for node in ast.walk(module.tree):
            for axis, line, where in self._uses(node):
                if axis not in self._declared:
                    yield self.finding(
                        module, line, "mesh-axis-undeclared",
                        f"{where} {axis!r} matches no declared mesh "
                        f"dimension (declared: {sorted(self._declared)}) "
                        "— a typo'd name only fails on a real mesh")
