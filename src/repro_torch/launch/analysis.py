"""Per-device cost of a traced step -- FLOPs, bytes, memory and collective
traffic -- the inputs to the roofline model (twin of
``repro/launch/analysis.py``).

The reference reads XLA's ``cost_analysis`` and parses the partitioned
HLO. The port traces the step itself on DTensors over ``FakeTensor``
locals (``launch/dryrun.py``) under ``DeviceCost``, a ``CommDebugMode``
that steps aside for every DTensor-level op (as ``CommDebugMode`` does),
so it sees what one rank runs: its local ops and the collectives DTensor
desugars them into. Per local op it adds the FLOPs of
``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s registry),
the bytes the op reads and writes (views, allocations and metadata
excluded; the collectives' bytes are counted on the wire), and the bytes of the
new storages it makes, which it holds until they are freed (the live and
peak memory ``MemTracker`` would report, taken on the local blocks: a
``MemTracker`` on the DTensor level counts every DTensor at its global
size). Every collective contributes wire bytes estimated with the
reference's ring formulas over its group size g:

    all-gather, reduce-scatter, all-to-all : bytes · (g-1)/g
    all-reduce                             : bytes · 2(g-1)/g
    collective-permute (send/recv)         : bytes

where ``bytes`` is the op's result payload per device.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# functional collective -> the reference's HLO collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


# DTensor's global-shape inference (the name differs across versions)
_META_PROPAGATORS = ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta")

# ops that move no bytes through memory: allocations, aliases, metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh", "lift_fresh_copy", "_to_copy_meta"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCost(CommDebugMode):
    """What one rank runs inside the block: ``flops``, ``bytes_accessed``,
    ``collectives`` (one (kind, result payload bytes, group size) per
    collective), and the ``live`` / ``peak`` bytes of the storages the
    local ops made (plus those ``hold`` registers: the step's
    arguments)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0
        self.arguments = 0
        self._seen: Dict[int, weakref.ref] = {}
        self._meta = 0

    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it is freed; its bytes if it
        is new."""
        st = t.untyped_storage()
        key = id(st)
        ref = self._seen.get(key)
        if ref is not None and ref() is st:
            return 0
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self._seen.pop(key, None)
            self.live -= n

        self._seen[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def hold(self, tree) -> None:
        """Register the local blocks of the DTensors (or tensors) in
        ``tree`` as the step's arguments."""
        for leaf in tree_leaves(tree):
            if isinstance(leaf, DTensor):
                leaf = leaf.to_local()
            if torch.is_tensor(leaf):
                self.arguments += self._hold(leaf)

    def __enter__(self):
        # DTensor infers an op's global output shape by running the op on
        # global-size fake tensors: those ops are no rank's work
        self._patched = []
        for name in _META_PROPAGATORS:
            fn = getattr(ShardingPropagator, name, None)
            if fn is not None:
                self._patched.append((name, fn))
                setattr(ShardingPropagator, name, self._outside(fn))
        self._meta = 0
        return super().__enter__()

    def __exit__(self, *exc):
        for name, fn in self._patched:
            setattr(ShardingPropagator, name, fn)
        return super().__exit__(*exc)

    def _outside(self, fn):
        def run(*args, **kwargs):
            self._meta += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._meta -= 1
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # let DTensor desugar to local ops
        if self._meta:
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        kwargs = kwargs or {}
        packet = func._overloadpacket
        name = packet.__name__
        if name in _KINDS and packet.__module__.endswith("functional"):
            self._collective(name, args, kwargs, out)
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
        if not (func.is_view or name in _NO_TRAFFIC
                or packet.__module__.split(".")[-1] in ("prim",
                                                         "_c10d_functional")):
            ins = [t for t in tree_leaves((args, kwargs))
                   if torch.is_tensor(t)]
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out

    def _collective(self, name, args, kwargs, out) -> None:
        group = [a for a in tree_leaves((args, kwargs)) if isinstance(a, str)]
        size = [a for a in args if isinstance(a, int)]
        g = size[0] if name.startswith(("all_gather", "reduce_scatter")) \
            and size else _group_size(group[-1] if group else None)
        payload = sum(_nbytes(t) for t in tree_leaves(out)
                      if torch.is_tensor(t))
        self.collectives.append((_KINDS[name], payload, int(g)))


def _group_size(name) -> int:
    if name is None:
        return dist.get_world_size()
    try:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(name).size()
    except (ImportError, RuntimeError, ValueError):
        return dist.get_world_size()


def wire_bytes(kind: str, payload: float, g: int) -> float:
    """One collective's bytes on the wire per device (the ring formulas)."""
    if kind == "all-reduce":
        return payload * 2 * (g - 1) / max(g, 1)
    if kind == "collective-permute":
        return payload
    return payload * (g - 1) / max(g, 1)


def collective_stats(record: Iterable[Tuple[str, int, int]]
                     ) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind {count, payload_bytes, wire_bytes} (per device)
    of a ``DeviceCost.collectives`` record."""
    stats: Dict[str, Dict[str, float]] = {}
    for kind, payload, g in record:
        rec = stats.setdefault(kind, {"count": 0, "payload_bytes": 0.0,
                                      "wire_bytes": 0.0})
        rec["count"] += 1
        rec["payload_bytes"] += payload
        rec["wire_bytes"] += wire_bytes(kind, payload, g)
    return stats


def total_wire_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(v["wire_bytes"] for v in stats.values())


def cost_summary(cost: DeviceCost) -> Dict[str, float]:
    """The reference's ``cost_analysis`` keys: FLOPs and bytes accessed
    of one rank's local ops."""
    return {"flops": float(cost.flops),
            "bytes_accessed": float(cost.bytes_accessed)}


def memory_summary(cost: DeviceCost) -> Dict[str, int]:
    """One rank's bytes: the step's arguments, the peak of everything
    live, and the peak's share above the arguments."""
    return {"argument_size_in_bytes": int(cost.arguments),
            "peak_size_in_bytes": int(cost.peak),
            "temp_size_in_bytes": int(cost.peak - cost.arguments)}


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float, *,
                   peak_flops: float, hbm_bw: float, ici_bw: float,
                   num_links: int = 18) -> Dict[str, float]:
    """Three per-device roofline times (seconds) + the dominant term.

    ``flops``/``hbm_bytes``/``wire_bytes`` are per-device quantities;
    collective bandwidth = num_links · ici_bw (an H100 SXM5 has 18 NVLink
    4 links, ``launch/mesh.NVLINK_LINKS``)."""
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bw
    t_coll = wire_bytes / (ici_bw * num_links)
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "bound": dom[1],
        "step_time_lower_bound_s": max(t_compute, t_memory, t_coll),
    }
