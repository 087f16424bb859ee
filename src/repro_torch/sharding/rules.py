"""Parameter partitioning rules: param path + shape -> spec (twin of
``repro/sharding/rules.py``).

Scheme (Megatron-style TP over the "model" axis + FSDP over "data"):

  * column-parallel weights (QKV / up / gate projections, LM head, experts'
    up-projections): last (output) dim -> "model", input d_model dim -> "data"
  * row-parallel weights (attention output / down projections): input dim ->
    "model", output d_model dim -> "data"
  * token embedding: vocab replicated, d_model -> "data"
  * MoE expert stacks (E, din, dout): experts -> "model" when E divides the
    model-axis size (expert parallelism), otherwise TP inside each expert
  * norms / small vectors: replicated

Every axis assignment is guarded by divisibility against the mesh: if a
dim does not divide the axis size, that axis is dropped (replicated on
that dim) instead of failing. Stacked per-layer params (leading period
dim) get a leading ``None``.

The reference turns the specs into ``NamedSharding``s for ``jax.jit``;
the port turns them into DTensor placements (``param_shardings``), lays
a full-tensor param tree out over the mesh (``distribute_params``) and
puts a laid-out param back together on one rank's host (``host_full``,
for checkpoints).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.sharding.ctx import (P, current_mesh, filter_spec,
                                      mesh_shape, to_placements)

# (regex on the param path, spec builder keyed by rank)
# Specs below are written for the *unstacked* shape; a leading period dim
# is handled by the caller.
_RULES = [
    # embeddings & heads -------------------------------------------------
    # vocab dim REPLICATED on purpose: a row-gather from a vocab-sharded
    # table replicates the gather's output; d_model-sharded tables gather
    # locally. LM heads stay column-parallel over vocab.
    (r"(^|/)tok_embed$", {2: P(None, "data"), 3: P(None, None, "data")}),
    (r"(^|/)pos_embed$", {2: P(None, "data")}),
    (r"(^|/)head(_\d+)?$", {2: P("data", "model"),
                            3: P(None, "data", "model")}),
    (r"(^|/)vision_proj$", {2: P(None, "data")}),
    # attention ----------------------------------------------------------
    (r"/(wq|wk|wv)$", {2: P("data", "model")}),
    (r"/wo$", {2: P("model", "data")}),
    (r"/(wq_b|wk_b|wv_b)$", {1: P("model")}),
    (r"/wo_b$", {1: P("data")}),
    # dense mlp ----------------------------------------------------------
    (r"/(w_gate|w_up)$", {2: P("data", "model")}),
    (r"/w_down$", {2: P("model", "data")}),
    (r"/(w_gate_b|w_up_b)$", {1: P("model")}),
    (r"/w_down_b$", {1: P("data")}),
    # MoE ----------------------------------------------------------------
    (r"/router$", {2: P("data", None)}),
    # expert-parallel when E divides the model axis; otherwise Megatron
    # column/row parallel INSIDE each expert (+ FSDP over data): a small
    # expert count must still shard its d_ff over "model"
    (r"/(we_gate|we_up)$", {3: ("EXPERT", P("model", "data", None),
                                P(None, "data", "model"))}),
    (r"/we_down$", {3: ("EXPERT", P("model", None, "data"),
                        P(None, "model", "data"))}),
    # SSM (mamba2) -------------------------------------------------------
    (r"/in_proj(_z|_xbc|_dt)?$", {2: P("data", "model")}),
    (r"/out_proj$", {2: P("model", "data")}),
    (r"/conv_w$", {2: P(None, "model")}),
    (r"/conv_b$", {1: P("model")}),
    (r"/(dt_bias|A_log|ssm_D)$", {1: P(None)}),
    # conv frontends (paper CNN example) ---------------------------------
    (r"/conv\d_w$", {4: P(None, None, None, "model")}),
    (r"/conv\d_b$", {1: P("model")}),
    (r"/(dense\d_w|lstm_.*|emb_w)$", {2: P("data", "model")}),
]


def _fits(dim: int, entry, mesh: DeviceMesh) -> bool:
    if entry is None:
        return True
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    shape = mesh_shape(mesh)
    total = 1
    for n in names:
        if n not in shape:
            return False
        total *= shape[n]
    return dim % total == 0


def _guard(spec: P, shape, mesh: DeviceMesh) -> P:
    """Drop spec axes that do not divide the corresponding dim."""
    spec = filter_spec(spec, mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*[e if _fits(d, e, mesh) else None
               for d, e in zip(shape, entries)])


def spec_for_param(path: str, shape, mesh: Optional[DeviceMesh] = None) -> P:
    """The spec of a parameter identified by its tree path."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return P()
    shape = tuple(shape)
    stacked = bool(re.search(r"(^|/)layers/", path)) and len(shape) >= 2
    core_shape = shape[1:] if stacked else shape
    for pattern, by_rank in _RULES:
        if re.search(pattern, path):
            rule = by_rank.get(len(core_shape))
            if rule is None:
                continue
            if isinstance(rule, tuple) and rule[0] == "EXPERT":
                # expert-parallel if E divides the model axis, else
                # TP-in-expert
                _, ep_spec, tp_spec = rule
                model = mesh_shape(mesh).get("model", 1)
                spec = ep_spec if core_shape[0] % model == 0 else tp_spec
            else:
                spec = rule
            spec = _guard(spec, core_shape, mesh)
            return P(None, *spec) if stacked else spec
    # default: replicate small things, FSDP-shard big matrices on dim0
    if len(core_shape) >= 2:
        spec = _guard(P("data"), core_shape, mesh)
        return P(None, *spec) if stacked else spec
    return P()


def _walk(tree: Mapping[str, Any], leaf, prefix: str = ""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out[k] = _walk(v, leaf, p) if isinstance(v, Mapping) else leaf(p, v)
    return out


def param_specs(params, mesh: Optional[DeviceMesh] = None):
    """A tree of specs matching ``params`` (anything with a ``.shape``)."""
    mesh = mesh if mesh is not None else current_mesh()
    return _walk(params, lambda p, v: spec_for_param(p, v.shape, mesh))


def inference_spec(spec: P, shape, mesh: Optional[DeviceMesh] = None) -> P:
    """Re-layout a training spec for decode serving: fold the FSDP ("data")
    dim into the TP dim instead.

    Training shards matrices (FSDP x TP) so optimizer state fits; decode
    has no optimizer state but all-gathers every FSDP-sharded weight for
    each generated token. Merging "data" into the tensor-parallel dim keeps
    params fully sharded with NO per-token weight gathering (the per-layer
    activation all-reduce spans the merged group instead). Falls back to
    the original spec when the TP dim does not divide the merged axis.
    """
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def names(e):
        return () if e is None else ((e,) if isinstance(e, str)
                                     else tuple(e))

    data_dims = [i for i, e in enumerate(entries) if "data" in names(e)]
    model_dims = [i for i, e in enumerate(entries) if "model" in names(e)]
    if not data_dims or not model_dims or data_dims[0] == model_dims[0]:
        return spec
    di, mi = data_dims[0], model_dims[0]
    merged = tuple(n for n in names(entries[mi]) if n != "data") + ("data",)
    new = list(entries)
    new[di] = tuple(n for n in names(entries[di]) if n != "data") or None
    if isinstance(new[di], tuple) and len(new[di]) == 1:
        new[di] = new[di][0]
    new[mi] = merged if len(merged) > 1 else merged[0]
    cand = _guard(P(*new), shape, mesh)
    # only accept if the merged axis actually divides (guard keeps it)
    if "data" in names(list(cand)[mi] if mi < len(list(cand)) else None):
        return cand
    return spec


def inference_param_specs(params, mesh: Optional[DeviceMesh] = None):
    """param_specs re-laid-out for serving (see inference_spec)."""
    mesh = mesh if mesh is not None else current_mesh()
    return _walk(params, lambda p, v: inference_spec(
        spec_for_param(p, v.shape, mesh), v.shape, mesh))


def param_shardings(params, mesh: Optional[DeviceMesh] = None, *,
                    inference: bool = False):
    """Like param_specs but returns each leaf's DTensor placements (or
    None without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return _walk(params, lambda p, v: None)
    specs = inference_param_specs(params, mesh) if inference \
        else param_specs(params, mesh)

    def place(tree):
        return {k: place(v) if isinstance(v, Mapping)
                else to_placements(v, mesh) for k, v in tree.items()}

    return place(specs)


def _block(shape, mesh: DeviceMesh, placements) -> tuple:
    """The slices of the block of a ``shape`` tensor that this rank holds
    under ``placements``."""
    size, off = compute_local_shape_and_global_offset(shape, mesh,
                                                      placements)
    return tuple(slice(o, o + n) for o, n in zip(off, size))


def distribute_params(params, mesh: DeviceMesh, *,
                      inference: bool = False) -> Dict[str, Any]:
    """A full-tensor param tree laid out over ``mesh`` by the rules: each
    leaf a DTensor cut from the full tensor (``distribute_tensor``), so a
    sharded init is bitwise the unsharded one. A leaf on another device
    type than the mesh's (a checkpoint read to the host) moves only this
    rank's block. A leaf's ``requires_grad`` is kept."""
    placements = param_shardings(params, mesh, inference=inference)

    def place(tree, pl):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = place(v, pl[k])
                continue
            with torch.no_grad():
                v = v.detach()
                if v.device.type == mesh.device_type:
                    d = distribute_tensor(v, mesh, pl[k])
                else:
                    d = DTensor.from_local(
                        v[_block(v.shape, mesh, pl[k])].to(
                            mesh.device_type).contiguous(), mesh, pl[k],
                        run_check=False, shape=v.shape,
                        stride=v.contiguous().stride())
            out[k] = d.requires_grad_(tree[k].requires_grad)
        return out

    return place(params, placements)


def host_full(t: torch.Tensor) -> Optional[torch.Tensor]:
    """A param's full value on the host of its mesh's first rank, None on
    its other ranks (a plain tensor: on the host, on every rank). The
    ranks that hold distinct blocks (coordinate 0 on each mesh dim the
    param is replicated over) send the first rank their block's offset
    and size, then the block, in turn: no device ever holds more than its
    own block and one other, so a param that does not fit one card is
    never built whole on one."""
    if not isinstance(t, DTensor):
        return t.detach().cpu()
    grid = t.device_mesh.mesh
    first = int(grid.flatten()[0])
    senders = grid[tuple(slice(None) if pl.is_shard() else 0
                         for pl in t.placements)].flatten().tolist()[1:]
    local = t.to_local().detach().contiguous()
    size, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    if dist.get_rank() != first:
        if dist.get_rank() in senders:
            dist.send(torch.tensor(off + size, device=local.device), first)
            if local.numel():
                dist.send(local, first)
        return None
    out = torch.empty(t.shape, dtype=t.dtype)
    out[_block(t.shape, t.device_mesh, t.placements)] = local.cpu()
    where = torch.empty(2 * t.ndim, dtype=torch.int64, device=local.device)
    for rank in senders:
        dist.recv(where, rank)
        off, size = where.tolist()[:t.ndim], where.tolist()[t.ndim:]
        if math.prod(size):
            buf = torch.empty(size, dtype=t.dtype, device=local.device)
            dist.recv(buf, rank)
            out[tuple(slice(o, o + n) for o, n in zip(off, size))] = \
                buf.cpu()
    return out
