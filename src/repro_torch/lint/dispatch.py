"""Dispatch-level checks: what the AST passes cannot decide statically.

These helpers run a function under a ``TorchDispatchMode``, which sees
every aten op the call makes (forward and backward), and report what the
ops did. They are the counterpart of the reference's ``jaxprs.py``, which
traces instead of running:

  * ``host_syncs`` (for ``host_callback_primitives``) — each op that
    makes the host wait for the card, with the Python line that issued
    it: ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, ``if
    t:``), ops whose output shape depends on the data (``nonzero``,
    ``masked_select``, ``unique``, boolean-mask indexing), and copies
    from a CUDA tensor to a CPU one (``.cpu()``, ``.to("cpu")``,
    ``copy_``). A path with none can be captured in a CUDA graph. On the
    CPU no tensor is on the card, so the copies do not show; the other
    two do.
  * ``collective_group_names`` / ``undeclared_collective_groups`` (for
    ``collective_axis_names`` / ``undeclared_collective_axes``) — the mesh
    dimensions whose process groups the collectives of a call ran on.
    Eager ``torch.distributed`` collectives (``dist.all_reduce``, as
    ``core/fedlite.py``'s mesh step calls it) dispatch as ``c10d`` ops with
    the process group as an argument, and functional collectives as
    ``_c10d_functional`` ops with its name: the mode sees both.
  * ``integer_gradient_violations`` (for
    ``integer_cotangent_violations``) — runs the real backward and reports
    each ``autograd.Function`` input that holds an integer or bool tensor
    and got a gradient that is not ``None``. Autograd drops such a
    gradient silently; a ``backward`` with the wrong count of gradients
    raises, and the error comes out of the helper.
"""

from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path
from typing import Callable, Iterable, List, NamedTuple, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_THIS = str(Path(__file__).resolve())
_ROOT = Path(__file__).resolve().parents[3]

_SCALAR_OPS = {"aten._local_scalar_dense", "aten.is_nonzero",
               "aten.equal"}
_SHAPE_OPS = {"aten.nonzero", "aten.masked_select", "aten._unique",
              "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
              "aten.unique_dim_consecutive", "aten.argwhere",
              "aten.nonzero_numpy"}
_MASK_OPS = {"aten.index", "aten.index_put", "aten.index_put_",
             "aten._index_put_impl_"}
_COPY_OPS = {"aten._to_copy", "aten.copy_", "aten.copy"}


class Sync(NamedTuple):
    op: str       # the aten op, with what made it a sync
    where: str    # the innermost Python frame outside torch: "file:line"


def _where() -> str:
    frame = sys._getframe(2)
    while frame is not None:
        path = os.path.realpath(frame.f_code.co_filename)
        if not path.startswith(_TORCH_DIR) and path != _THIS \
                and not frame.f_code.co_filename.startswith("<"):
            try:
                shown = str(Path(path).relative_to(_ROOT))
            except ValueError:
                shown = path
            return f"{shown}:{frame.f_lineno}"
        frame = frame.f_back
    return "<no Python frame>"


def _tensors(values) -> Iterable[torch.Tensor]:
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from _tensors(v)


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


def _sync_kind(func, args, kwargs, out) -> str:
    """Why ``func`` on these arguments makes the host wait ("" if not)."""
    name = func.overloadpacket._qualified_op_name.replace("::", ".")
    if name in _SCALAR_OPS:
        return name
    if name in _SHAPE_OPS:
        return f"{name} (data-dependent shape)"
    if name == "aten.repeat_interleave" and "output_size" not in kwargs \
            and len(args) >= 2 and isinstance(args[1], torch.Tensor):
        return f"{name} (data-dependent shape)"
    if name in _MASK_OPS and len(args) > 1 and any(
            t.dtype in (torch.bool, torch.uint8)
            for t in _tensors(args[1:2])):
        return f"{name} (boolean mask)"
    if name in _COPY_OPS:
        if name == "aten._to_copy":
            src, dst = args[0], out
        else:
            dst, src = args[0], args[1] if len(args) > 1 else None
        if _on_card(src) and isinstance(dst, torch.Tensor) \
                and dst.device.type == "cpu":
            return f"{name} (cuda -> cpu)"
    return ""


class _SyncMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.syncs: List[Sync] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _sync_kind(func, args, kwargs, out)
        if kind:
            self.syncs.append(Sync(kind, _where()))
        return out


@contextlib.contextmanager
def recording_syncs():
    """``with recording_syncs() as syncs: ...`` — the syncs of the block,
    in order, as `Sync`s (filled in as the block runs)."""
    mode = _SyncMode()
    with mode:
        yield mode.syncs


def host_syncs(fn: Callable, *args, **kwargs) -> List[Sync]:
    """The host syncs ``fn(*args, **kwargs)`` makes, in order, each with
    its op and the Python line that issued it."""
    with recording_syncs() as syncs:
        fn(*args, **kwargs)
    return list(syncs)


def copies_to_host(syncs: Iterable[Sync]) -> List[Sync]:
    """The syncs that copy a CUDA tensor to the host."""
    return [s for s in syncs if s.op.endswith("(cuda -> cpu)")]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _group_name(value) -> str:
    if isinstance(value, torch.ScriptObject) \
            and "ProcessGroup" in str(value._type()):
        from torch._C._distributed_c10d import ProcessGroup
        return ProcessGroup.unbox(value).group_name
    return ""


class _CollectiveMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.groups: Set[str] = set()      # the process groups' names

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional", "_c10d_functional_autograd"):
            values = list(args) + list(kwargs.values())
            names = [_group_name(v) for v in values]
            names = [n for n in names if n]
            if not names and ns != "c10d":
                # functional collectives name their group last
                names = [v for v in values if isinstance(v, str)][-1:]
            self.groups.update(names)
        return func(*args, **kwargs)


def collective_group_names(fn: Callable, mesh, *args, **kwargs) -> Set[str]:
    """The names of ``mesh``'s dimensions whose process groups the
    collectives of ``fn(*args)`` ran on; a group of no dimension is given
    as ``"<group NAME>"``."""
    by_group = {}
    for dim in mesh.mesh_dim_names or ():
        by_group.setdefault(mesh.get_group(dim).group_name, dim)
    mode = _CollectiveMode()
    with mode:
        fn(*args, **kwargs)
    return {by_group.get(g, f"<group {g}>") for g in mode.groups}


def undeclared_collective_groups(fn: Callable, mesh, *args,
                                 **kwargs) -> Set[str]:
    """Collective groups of ``fn(*args)`` that are none of ``mesh``'s
    dimensions."""
    return collective_group_names(fn, mesh, *args, **kwargs) \
        - set(mesh.mesh_dim_names or ())


# ---------------------------------------------------------------------------
# autograd.Function gradients of integer inputs
# ---------------------------------------------------------------------------

def _is_integer(t) -> bool:
    return isinstance(t, torch.Tensor) and not t.is_floating_point() \
        and not t.is_complex()


def integer_gradient_violations(fn: Callable, *inputs
                                ) -> List[Tuple[str, int]]:
    """(Function name, input position) for each integer or bool tensor
    input of an ``autograd.Function`` in ``fn(*inputs)`` whose backward
    returned a gradient that is not ``None``.

    The floating inputs of ``fn`` are made leaves that require grad, and
    every floating output gets a gradient of ones. Raises whatever the
    backward raises (a wrong count of gradients fails here)."""
    applied = []
    original = torch.autograd.Function.__dict__["apply"]
    apply = original.__func__

    def recording_apply(cls, *args, **kwargs):
        out = apply(cls, *args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        node = next((o.grad_fn for o in outs if isinstance(o, torch.Tensor)
                     and o.grad_fn is not None), None)
        if node is not None:
            got = []
            node.register_hook(lambda grads, _outs: got.append(grads))
            applied.append((cls.__name__, args, got))
        return out

    leaves = [x.detach().requires_grad_(True)
              if isinstance(x, torch.Tensor) and x.is_floating_point()
              else x for x in inputs]
    torch.autograd.Function.apply = classmethod(recording_apply)
    try:
        out = fn(*leaves)
    finally:
        torch.autograd.Function.apply = original
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(o, torch.Tensor) and o.requires_grad]
    torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
    bad = []
    for name, args, got in applied:
        # the node's gradients follow the Function's tensor inputs
        tensor_at = [i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor)]
        for grads in got:
            for i, g in zip(tensor_at, grads):
                if _is_integer(args[i]) and g is not None:
                    bad.append((name, i))
    return bad
