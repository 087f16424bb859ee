"""host-sync hygiene pass for the port's torch code.

Flags device→host synchronization where it costs a step, and hand-rolled
timing in the hot paths:

  * the syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")``, ``torch.cuda.synchronize()``, and ``float()`` /
    ``int()`` / ``bool()`` of a tensor expression (in a step: one that
    reads a parameter of the step's functions not annotated as a
    non-tensor; a constant, or a shape, dtype, device or ``len``, is not
    a tensor);
  * ``host-sync-in-step`` — a sync reachable from the ``forward`` of an
    ``nn.Module``, from the ``forward`` or ``backward`` of an
    ``autograd.Function``, or anywhere in ``repro_torch/kernels/``: the
    host waits for the card once per call, and a CUDA graph cannot
    capture the step (the counterpart of the reference's
    ``host-sync-in-jit``). Reachable: the method's own body, nested
    functions included, and the same-module functions and same-class
    methods it calls, transitively;
  * ``host-sync-in-loop`` — a sync on a step's output inside a host loop,
    where the step is the result of a ``make_*step`` factory
    (``float(loss)`` per local step);
  * ``host-sync-in-callback`` — syncs inside per-arrival callbacks (the
    scheduler's ``execute=`` path), as in the reference;
  * ``raw-timing-in-hot-path`` — ``time.perf_counter`` & friends and
    ``print`` in the ``repro_torch/federated`` / ``repro_torch/core`` hot
    paths: telemetry there goes through ``repro_torch.obs`` spans and
    events (tests and the obs package itself are exempt).

The reference's ``jit-closure-rebuild`` and ``jit-static-args`` have no
counterpart: the port has no jit cache and no ``torch.compile`` call, so
there is no trace to rebuild and no static argument to name.
``repro_torch.lint.dispatch.host_syncs`` counts the syncs a call really
makes, op by op, where this pass reads the source.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.lint.core import (Finding, LintContext, LintPass, Module,
                                   call_name, dotted_name)

_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_NP_HOST = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SCALARS = ("float", "int", "bool")
_MODULE_BASES = {"Module"}
_FUNCTION_BASES = {"Function"}
_STEP_FACTORY_RE = re.compile(r"^make_\w*step$")

# the hot paths where ad-hoc timing/printing is banned in favor of
# repro_torch.obs spans/events (repro_torch/obs itself is outside)
_HOT_PATH_RE = re.compile(r"(^|[/\\])repro_torch[/\\](federated|core)[/\\]")
_KERNELS_RE = re.compile(r"(^|[/\\])repro_torch[/\\]kernels[/\\]")
_TEST_PATH_RE = re.compile(r"(^|[/\\])(tests?[/\\]|test_)")
_RAW_TIMERS = {"time.perf_counter", "time.monotonic", "time.process_time",
               "time.perf_counter_ns", "time.monotonic_ns",
               "perf_counter", "monotonic", "process_time",
               "perf_counter_ns", "monotonic_ns"}


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk ``fn`` without descending into nested function/class defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _tensor_params(fn) -> List[str]:
    """The parameters of ``fn`` that may hold a tensor: those with no
    annotation, or one that names ``Tensor`` (or ``Any``)."""
    a = fn.args
    out = []
    for p in (a.posonlyargs + a.args + a.kwonlyargs
              + [p for p in (a.vararg, a.kwarg) if p is not None]):
        ann = ast.unparse(p.annotation) if p.annotation is not None else ""
        if not ann or "Tensor" in ann or "Any" in ann:
            out.append(p.arg)
    return out


def _contains_shape_access(node: ast.AST) -> bool:
    """True where ``node`` reads a tensor's metadata (shape, dtype,
    device, ...), which the host holds without a sync."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in (
                "shape", "size", "ndim", "itemsize", "numel", "dim",
                "element_size", "nbytes", "data_ptr", "dtype", "device",
                "is_cuda", "layout", "requires_grad", "stride",
                "is_contiguous"):
            return True
        if isinstance(n, ast.Call) and call_name(n) in ("len", "ord"):
            return True
    return False


def _base_name(node: ast.AST) -> Optional[str]:
    """The name a Name / Attribute / Subscript / method-call chain starts
    from (``m["loss"]``, ``m.get("loss")``: ``m``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _banned(call: ast.Call, *, in_step: bool,
            dynamic_params: Optional[Set[str]] = None) -> Optional[str]:
    """A human description if ``call`` is a host sync in this context.

    In a step, ``float()`` / ``int()`` / ``bool()`` is flagged only when
    its argument reads a parameter of the step's functions that may hold a
    tensor (unannotated, or annotated ``Tensor``): ``float(eps)`` of a
    Python scalar is legitimate and common."""
    name = call_name(call)
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _SYNC_ATTRS and not call.args:
        return f".{call.func.attr}() blocks on a device value"
    if isinstance(call.func, ast.Attribute) and call.func.attr == "to" \
            and any(isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in call.args):
        return '.to("cpu") copies a device value to the host and waits'
    if name in _SYNC_CALLS:
        return "torch.cuda.synchronize() blocks the host on the card"
    if name in _NP_HOST and in_step:
        refs = {n.id for n in ast.walk(call) if isinstance(n, ast.Name)}
        if refs & (dynamic_params or set()):
            return f"{name} copies the tensor to the host"
    if name in _SCALARS and len(call.args) == 1:
        arg = call.args[0]
        if isinstance(arg, ast.Constant) or _contains_shape_access(arg):
            return None
        if in_step:
            refs = {n.id for n in ast.walk(arg) if isinstance(n, ast.Name)}
            if not refs & (dynamic_params or set()):
                return None
        return f"{name}() forces a blocking device→host transfer"
    return None


def _class_kinds(tree: ast.Module) -> Dict[ast.ClassDef, str]:
    """ClassDef -> "module" (an nn.Module) or "function" (an
    autograd.Function), for the classes of this file that are either."""
    kinds: Dict[ast.ClassDef, str] = {}
    by_name: Dict[str, str] = {}
    changed = True
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    while changed:              # a subclass of a local Module is one too
        changed = False
        for cls in classes:
            if cls in kinds:
                continue
            for base in cls.bases:
                bname = dotted_name(base) or ""
                last = bname.split(".")[-1]
                kind = "module" if last in _MODULE_BASES else \
                    "function" if last in _FUNCTION_BASES else \
                    by_name.get(bname)
                if kind:
                    kinds[cls] = kind
                    by_name[cls.name] = kind
                    changed = True
                    break
    return kinds


class HostSyncPass(LintPass):
    name = "host-sync"
    rules = {
        "host-sync-in-step":
            "host sync (.item/.tolist/.cpu/.numpy/float/int/bool of a "
            "tensor/torch.cuda.synchronize) reachable from an nn.Module "
            "forward, an autograd.Function forward/backward or "
            "repro_torch/kernels/",
        "host-sync-in-loop":
            "per-iteration device sync on a make_*step step's output "
            "inside a host loop",
        "host-sync-in-callback":
            "device sync inside a per-arrival callback (scheduler "
            "execute=/sample_cohort= path)",
        "raw-timing-in-hot-path":
            "hand-rolled time.perf_counter()/print() instrumentation in a "
            "repro_torch/federated or repro_torch/core hot path; record "
            "through repro_torch.obs spans/events instead",
    }

    # ---- module facts ------------------------------------------------------

    @staticmethod
    def _roots(module: Module):
        """(root function, description) for every step entry point."""
        tree = module.tree
        if _KERNELS_RE.search(module.path) \
                and not _TEST_PATH_RE.search(module.path):
            return [(fn, f"repro_torch/kernels/ function {fn.name!r}")
                    for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
        roots = []
        for cls, kind in _class_kinds(tree).items():
            wanted = ("forward",) if kind == "module" \
                else ("forward", "backward")
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and fn.name in wanted:
                    what = "nn.Module" if kind == "module" \
                        else "autograd.Function"
                    roots.append((fn, f"{what} {cls.name}.{fn.name}"))
        return roots

    @staticmethod
    def _callees(tree: ast.Module):
        """(module-level functions by name, method -> its class's methods
        by name)."""
        fns = (ast.FunctionDef, ast.AsyncFunctionDef)
        top = {n.name: n for n in tree.body if isinstance(n, fns)}
        owner = {}
        for cls in ast.walk(tree):
            if isinstance(cls, ast.ClassDef):
                methods = {m.name: m for m in cls.body if isinstance(m, fns)}
                for m in methods.values():
                    owner[m] = methods
        return top, owner

    @staticmethod
    def _reach(root, top, owner) -> List[ast.AST]:
        """``root`` and the same-module functions and same-class methods it
        calls, transitively."""
        seen, todo = [], [root]
        while todo:
            fn = todo.pop()
            if fn in seen:
                continue
            seen.append(fn)
            methods = owner.get(fn, {})
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                name = call_name(call) or ""
                if name in top:
                    todo.append(top[name])
                elif name.startswith(("self.", "cls.")) \
                        and name.split(".", 1)[1] in methods:
                    todo.append(methods[name.split(".", 1)[1]])
        return seen

    @staticmethod
    def _step_names(tree: ast.Module) -> Set[str]:
        """Names bound to a ``make_*step`` factory's result (``step``,
        ``self._step``), and same-module functions returning one."""
        def is_factory_call(node) -> bool:
            if not isinstance(node, ast.Call):
                return False
            name = (call_name(node) or "").split(".")[-1]
            return bool(_STEP_FACTORY_RE.match(name)) or name in factories

        returns: Dict[str, List[ast.expr]] = {}
        assigns: List[ast.Assign] = []

        def visit(node, fn):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit(child, child.name)
                    continue
                if isinstance(child, ast.Return) and fn and child.value:
                    returns.setdefault(fn, []).append(child.value)
                elif isinstance(child, ast.Assign):
                    assigns.append(child)
                visit(child, fn)
        visit(tree, None)

        factories: Set[str] = set()
        names: Set[str] = set()
        for _ in range(2):      # factories of factories, one level
            factories.update(fn for fn, values in returns.items()
                             if any(is_factory_call(v) for v in values))
        for node in assigns:
            if is_factory_call(node.value):
                for t in node.targets:
                    name = dotted_name(t)
                    if name:
                        names.add(name)
        return names

    # ---- checks ------------------------------------------------------------

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        tree = module.tree
        findings: List[Finding] = []
        in_step: Set[ast.AST] = set()
        roots = self._roots(module)
        callees = self._callees(tree) if roots else None
        for root, what in roots:
            reached = self._reach(root, *callees)
            dynamic: Set[str] = set()
            for fn in reached:
                for node in ast.walk(fn):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.Lambda)):
                        dynamic.update(p for p in _tensor_params(node)
                                       if p not in ("self", "cls", "ctx"))
            for fn in reached:
                in_step.add(fn)
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call):
                        why = _banned(node, in_step=True,
                                      dynamic_params=dynamic)
                        if why:
                            findings.append(self.finding(
                                module, node, "host-sync-in-step",
                                f"{why} — reachable from {what}: the host "
                                "waits for the card every call, and a CUDA "
                                "graph cannot capture it"))

        steps = self._step_names(tree)
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn in in_step:
                continue
            findings.extend(self._check_loops(module, fn, steps))
            findings.extend(self._check_callbacks(module, fn))
        findings.extend(self._check_raw_timing(module))
        return sorted(set(findings))

    def _check_raw_timing(self, module: Module) -> Iterable[Finding]:
        """Ban ad-hoc wall-clock timing and print() in the hot paths.

        `repro_torch.obs.span` records the same interval into the run's
        event log (host lane, aligned with the scheduler's virtual lane)
        at near-zero cost when telemetry is off — a bare ``perf_counter``
        pair or a ``print`` is measurement that vanishes when the run
        ends. Scoped to ``repro_torch/federated`` and ``repro_torch/core``
        (not tests, or ``repro_torch/obs`` itself, which owns the
        clock)."""
        if not _HOT_PATH_RE.search(module.path) \
                or _TEST_PATH_RE.search(module.path):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in _RAW_TIMERS:
                yield self.finding(
                    module, node, "raw-timing-in-hot-path",
                    f"{name}() hand-rolls wall-clock timing in a hot "
                    "path; wrap the region in repro_torch.obs.span(...) so "
                    "the measurement lands in the run's event log "
                    "alongside the scheduler's virtual clock")
            elif name == "print":
                yield self.finding(
                    module, node, "raw-timing-in-hot-path",
                    "print() in a hot path is unstructured and serializes "
                    "stdout; emit repro_torch.obs.event(...) (or logging) "
                    "so the record survives in the run's event log")

    def _check_loops(self, module: Module, fn,
                     steps: Set[str]) -> Iterable[Finding]:
        if not steps:
            return
        for loop in _own_nodes(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            tainted: Set[str] = set()
            for node in ast.walk(loop):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call) \
                        and call_name(node.value) in steps:
                    for t in node.targets:
                        names = t.elts if isinstance(t, ast.Tuple) else [t]
                        tainted.update(e.id for e in names
                                       if isinstance(e, ast.Name))
            if not tainted:
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name in _SYNC_CALLS:
                    yield self.finding(
                        module, node, "host-sync-in-loop",
                        "torch.cuda.synchronize() inside a step loop waits "
                        "for every step; keep the outputs on the card and "
                        "sync once after the loop")
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _SYNC_ATTRS and not node.args \
                        and _base_name(node.func.value) in tainted:
                    yield self.finding(
                        module, node, "host-sync-in-loop",
                        f"per-iteration .{node.func.attr}() on "
                        f"{_base_name(node.func.value)!r} (output of a "
                        "make_*step step) blocks the launch queue")
                elif name in _SCALARS and len(node.args) == 1 \
                        and _base_name(node.args[0]) in tainted \
                        and not _contains_shape_access(node.args[0]):
                    yield self.finding(
                        module, node, "host-sync-in-loop",
                        f"{name}({_base_name(node.args[0])}) syncs a "
                        "step's output every iteration; accumulate device "
                        "values and copy them to the host once after the "
                        "loop")

    def _check_callbacks(self, module: Module, fn) -> Iterable[Finding]:
        nested = {c.name: c for c in _own_nodes(fn)
                  if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if not nested:
            return
        passed: Set[str] = set()
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in nested:
                    passed.add(arg.id)
        for name in passed:
            for node in ast.walk(nested[name]):
                if isinstance(node, ast.Call):
                    why = _banned(node, in_step=False)
                    if why:
                        yield self.finding(
                            module, node, "host-sync-in-callback",
                            f"{why} — {name!r} is a per-arrival callback; "
                            "syncing here serializes every round "
                            "(keep device values, transfer after the run)",
                            severity="warning")
