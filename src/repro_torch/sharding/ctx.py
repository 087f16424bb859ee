"""Sharding context (twin of ``repro/sharding/ctx.py``): a process-wide
``DeviceMesh``, the placement of client-major data over its ``clients``
axis, and the activation constraints of the ``("data", "model")``
meshes.

The reference places arrays with ``NamedSharding``: a client-major array's
leading axis split over ``clients`` (``clients_sharding``), or the whole
array on every device (``replicated_sharding``). The port runs one
process per shard (SPMD), so placement is a question each rank answers
for itself: it holds the contiguous block of client slots that
``local_slots`` names, and everything else (the train state) is
replicated, one full copy per rank, with no call needed.

On the production meshes the reference shards one program from
``PartitionSpec``s and ``with_sharding_constraint``; the port's
counterpart is DTensor. ``P`` is the spec tuple (one entry per tensor dim:
None, an axis name, or a tuple of names, major first), ``to_placements``
maps it onto DTensor placements, and model code calls
``shard(x, ("pod", "data"), None, "model")`` at the reference's sites:
a no-op unless a mesh is installed and ``x`` is a ``DTensor``, else a
``redistribute`` to the spec. ``local`` runs a function written for plain
tensors (a hand-written kernel, an op DTensor has no rule for) on the
local shards of its DTensor arguments. Axis names the installed mesh does
not have are dropped from a spec, so ``("pod", "data")`` serves the
single-pod ``("data", "model")`` mesh and the multi-pod ``("pod", "data",
"model")`` one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.distributed.tensor.placement_types import Placement, _StridedShard

# The cohort-parallel mesh axis: one shard = one slice of a round's client
# cohort. Built by ``launch/mesh.make_clients_mesh`` and used by the
# ``"mesh"`` cohort executor (``federated/executor.py``), whose step sums
# the shards' weighted gradients with one all-reduce over this axis.
CLIENTS_AXIS = "clients"

# the batch axes of the production meshes: clients over pods and data
BATCH = ("pod", "data")

AxisEntry = Union[None, str, Sequence[str]]

_MESH: Optional[DeviceMesh] = None


class P(tuple):
    """A ``PartitionSpec``: one entry per leading tensor dim (missing
    trailing entries are None). Two specs are equal when they agree
    entry for entry once trailing Nones are dropped, as the reference's
    ``P()`` equals its all-None specs."""

    def __new__(cls, *entries: AxisEntry) -> "P":
        return super().__new__(cls, tuple(_norm(e) for e in entries))

    def _key(self) -> tuple:
        k = tuple(self)
        while k and k[-1] is None:
            k = k[:-1]
        return k

    def __eq__(self, other) -> bool:
        if not isinstance(other, tuple):
            return NotImplemented
        return self._key() == P(*other)._key()

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(tuple(self))}"


def _norm(entry: AxisEntry) -> AxisEntry:
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    return entry[0] if len(entry) == 1 else (entry or None)


def _names(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class AbstractMesh(NamedTuple):
    """Axis sizes and names without ranks or devices (the reference's
    ``jax.sharding.AbstractMesh``): all the spec rules read, so a
    (16, 16) layout is computed in any process."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]


def clients_rank(mesh: DeviceMesh) -> int:
    """This process's coordinate on ``mesh``'s ``clients`` axis."""
    return mesh.get_local_rank(CLIENTS_AXIS)


def local_slots(slots: int, mesh: DeviceMesh,
                rank: Optional[int] = None) -> range:
    """The block of ``slots`` client slots (a multiple of the ``clients``
    axis size) that ``rank`` holds (default: this process): the leading
    axis split by rank into equal contiguous blocks."""
    shards = mesh.size(mesh.mesh_dim_names.index(CLIENTS_AXIS))
    if slots % shards:
        raise ValueError(f"{slots} client slots do not split over "
                         f"{shards} shards")
    per = slots // shards
    r = clients_rank(mesh) if rank is None else rank
    return range(r * per, (r + 1) * per)


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Install (or clear, with None) the process-wide mesh."""
    global _MESH
    _MESH = mesh


def current_mesh() -> Optional[DeviceMesh]:
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]):
    """Install ``mesh`` for the duration of the block. With a mesh, a plain
    tensor that meets a DTensor in an op counts as replicated (DTensor's
    ``implicit_replication``): positions, masks and constants made inside
    the model stay plain."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _MESH = prev


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(name: str) -> int:
    """Size of an axis of the installed mesh, or 1 if there is no mesh or
    it has no such axis."""
    if _MESH is None or name not in (_MESH.mesh_dim_names or ()):
        return 1
    return _MESH.size(_MESH.mesh_dim_names.index(name))


def axis_rank(name: str) -> int:
    """This process's coordinate on an axis of the installed mesh (0
    without a mesh or such an axis)."""
    if _MESH is None or name not in (_MESH.mesh_dim_names or ()):
        return 0
    return _MESH.get_local_rank(name)


def flat_rank(entry: AxisEntry) -> int:
    """This process's block index along a dim split over ``entry``'s axes
    (major first, as ``to_placements`` splits it)."""
    idx = 0
    for a in _names(filter_spec([entry])[0]):
        idx = idx * axis_size(a) + axis_rank(a)
    return idx


def _filter_entry(entry: AxisEntry, names) -> AxisEntry:
    """Drop axis names that the mesh does not have."""
    return _norm(tuple(a for a in _names(entry) if a in names))


def filter_spec(spec: Sequence[AxisEntry],
                mesh: Optional[DeviceMesh] = None) -> P:
    """Rewrite a spec so it only references axes of ``mesh`` (default:
    the installed one; without a mesh, the replicated ``P()``)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return P()
    names = set(mesh.mesh_dim_names)
    return P(*[_filter_entry(e, names) for e in spec])


def _axis_prod(entry: AxisEntry, mesh: DeviceMesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in _names(entry):
        n *= shape[a]
    return n


def guard(spec: Sequence[AxisEntry], shape: Sequence[int],
          mesh: Optional[DeviceMesh] = None) -> P:
    """``spec`` filtered to ``mesh``'s axes, each entry whose dim does not
    divide its axis product replaced by None (replicated): the layouts
    stay the reference's even where DTensor would take an uneven shard."""
    mesh = mesh if mesh is not None else _MESH
    spec = filter_spec(spec, mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*[e if d % _axis_prod(e, mesh) == 0 else None
               for d, e in zip(shape, entries)])


def to_placements(spec: Sequence[AxisEntry], mesh: DeviceMesh,
                  ndim: Optional[int] = None) -> Tuple[Placement, ...]:
    """DTensor placements (one per mesh dim) of ``spec``: a dim whose
    entry names a mesh axis is ``Shard(dim)`` on it. An entry naming
    several axes splits its dim major-first in the entry's order, as a
    ``NamedSharding`` does: a ``Shard`` on each of those mesh dims, in
    mesh order, where that order is the entry's, and a ``_StridedShard``
    on a mesh dim that an axis later in mesh order but earlier in the
    entry splits first (``("model", "data")`` on the ``("data",
    "model")`` mesh). Mesh dims no entry names are ``Replicate``."""
    spec = filter_spec(spec, mesh)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    names = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        for i, a in enumerate(axes):
            m = names.index(a)
            if not isinstance(out[m], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"spec {spec}")
            split = 1
            for b in axes[:i]:
                if names.index(b) > m:
                    split *= sizes[b]
            out[m] = Shard(dim) if split == 1 \
                else _StridedShard(dim, split_factor=split)
    return tuple(out)


def shard(x: torch.Tensor, *entries: AxisEntry) -> torch.Tensor:
    """Constrain ``x`` to the spec ``entries`` if a mesh is installed and
    ``x`` is a DTensor (a ``redistribute``); a no-op otherwise.

    Each entry is guarded by divisibility: a dim that does not divide its
    axis product is replicated instead, so the same constraint serves
    train (S = 4096), decode (S = 1) and smoke shapes."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    want = to_placements(guard(entries, x.shape), _MESH, x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(_MESH, want)


def shard_residual(x: torch.Tensor) -> torch.Tensor:
    """Residual-stream layout (B, S, D): batch over ("pod", "data") and
    sequence over "model" (Megatron-style sequence parallelism): between
    blocks only norms and adds happen, so sharding the sequence there
    divides the saved activations by the model-axis size; the all-gather
    into attention and the MLP and the reduce-scatter out of the
    row-parallel projections are DTensor's."""
    return shard(x, BATCH, "model", None)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product takes it under FSDP: all-gathered over the
    batch axes ("pod", "data"), its "model" sharding kept (the gradient
    flows back as a reduce-scatter). Left to itself DTensor may gather
    the activations' rows instead, which costs the batch axis's factor in
    memory. A no-op on a plain tensor or without a mesh."""
    if _MESH is None or not isinstance(w, DTensor):
        return w
    want = tuple(Replicate() if n in BATCH else pl
                 for n, pl in zip(w.device_mesh.mesh_dim_names,
                                  w.placements))
    return w if want == tuple(w.placements) else w.redistribute(
        w.device_mesh, want)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` in ``ref``'s DTensor layout (a ``redistribute``, which reduces
    a partial sum); ``t`` itself when ``ref`` is a plain tensor or the
    layouts agree."""
    if isinstance(ref, DTensor) and tuple(t.placements) != \
            tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def named_sharding(*entries: AxisEntry
                   ) -> Optional[Tuple[DeviceMesh, Tuple[Placement, ...]]]:
    """(mesh, placements) of the spec ``entries`` on the installed mesh
    (the reference's ``NamedSharding``), or None without a mesh."""
    if _MESH is None:
        return None
    return _MESH, to_placements(P(*entries), _MESH)


def batch_entry(n: int) -> AxisEntry:
    """The batch axes that a leading dim of ``n`` rows divides, or None:
    the guard of ``shard``, for the callers of ``local``."""
    if _MESH is None:
        return None
    entry = filter_spec([BATCH])[0]
    return entry if n % _axis_prod(entry, _MESH) == 0 else None


def model_entry(*dims: int) -> AxisEntry:
    """``"model"`` if every one of ``dims`` divides the model axis (heads
    of q and of k/v both), else None."""
    m = axis_size("model")
    if _MESH is None or "model" not in _MESH.mesh_dim_names:
        return None
    return "model" if all(d % m == 0 for d in dims) else None


class Sum(tuple):
    """An output spec of ``local`` whose value is, on top of ``spec``'s
    layout, a partial sum over the mesh axis ``axis`` (None: none): each
    rank holds its share of a contraction split over that axis."""

    def __new__(cls, spec: P, axis: Optional[str]) -> "Sum":
        return super().__new__(cls, (spec, axis))


def _out_placements(spec, mesh: DeviceMesh):
    if isinstance(spec, Sum):
        pl = list(to_placements(spec[0], mesh))
        if spec[1] in mesh.mesh_dim_names:
            pl[mesh.mesh_dim_names.index(spec[1])] = Partial()
        return tuple(pl)
    return to_placements(spec, mesh)


def _axes(spec) -> set:
    if isinstance(spec, Sum):
        return _axes(spec[0]) | ({spec[1]} if spec[1] else set())
    return {a for e in filter_spec(spec) for a in _names(e)}


def local(fn: Callable, out_specs, in_specs,
          inplace: Sequence[int] = ()) -> Callable:
    """``fn``, written for plain tensors, applied to the local shards of
    its DTensor arguments (``local_map``): each argument is first
    redistributed to its spec in ``in_specs`` (None for a non-tensor),
    and each output of the flattened result becomes a DTensor with the
    placements of its spec in ``out_specs`` (None for a non-tensor; a
    ``Sum`` for a partial sum).

    Gradients flow through. The axes the outputs are split (or summed)
    over are the axes the work is split over; an argument replicated over
    such an axis feeds every rank's share, so its gradient there is a
    partial sum (``Partial``) that DTensor reduces where the param's
    layout needs it. ``inplace`` names the arguments ``fn`` writes in
    place (caches): a DTensor among them must already have its spec's
    layout, since a redistributed copy would take the writes. Without a
    mesh, or with no DTensor among the arguments, it is ``fn`` itself, so
    the unsharded path is unchanged."""
    # a single output's placements go in a 1-tuple: local_map reads a
    # bare tuple as one placement per output
    single = out_specs is None or isinstance(out_specs, (P, Sum))
    outs = (out_specs,) if single else tuple(out_specs)
    ins = tuple(in_specs)

    def run(*args):
        if _MESH is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        work = set().union(*(_axes(s) for s in outs if s is not None))
        for i in inplace:
            a = args[i]
            if isinstance(a, DTensor) and tuple(a.placements) != \
                    to_placements(ins[i], _MESH):
                raise ValueError(
                    f"{getattr(fn, '__name__', fn)}: argument {i}, written "
                    f"in place, is laid out as {a.placements}, not as "
                    f"{ins[i]}")

        def grad(spec):
            if spec is None:
                return None
            named = _axes(spec)
            return tuple(Partial() if n in work and n not in named else pl
                         for n, pl in zip(_MESH.mesh_dim_names,
                                          to_placements(spec, _MESH)))

        return local_map(
            fn, device_mesh=_MESH, redistribute_inputs=True,
            out_placements=tuple(None if s is None
                                 else _out_placements(s, _MESH)
                                 for s in outs),
            in_placements=tuple(None if s is None
                                else to_placements(s, _MESH) for s in ins),
            in_grad_placements=tuple(grad(s) for s in ins))(*args)

    return run


def spec_of(x: DTensor) -> P:
    """The spec of a DTensor's placements (the inverse of
    ``to_placements`` for ``Shard``s in mesh order; a ``Partial`` or
    ``Replicate`` mesh dim names no dim)."""
    entries: list = [()] * x.ndim
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim] = entries[pl.dim] + (name,)
    return P(*entries)


def is_sharded(x) -> bool:
    """True for a DTensor (a tensor laid out over a mesh)."""
    return isinstance(x, DTensor)
