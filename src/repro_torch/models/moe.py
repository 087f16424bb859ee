"""Mixture-of-Experts layer with grouped, capacity-based scatter dispatch
(twin of ``repro/models/moe.py``).

Dispatch is grouped: tokens are split into G groups (the batch shards of a
mesh, one without one) and each group scatters into its own (E, C_g, D)
buffer with per-group capacity C_g = ceil(k·N_g/E · capacity_factor),
rounded up to a multiple of 8 (at least 8). Under a mesh the routing, the
scatter and the gather run on each rank's own groups (``ctx.local``:
DTensor has no rule for them), so they stay local to a shard.

Expert parallelism: expert-stacked weights are sharded over "model"
whenever E divides the model axis (``sharding/rules.py``); the grouped
buffer then carries (batch axes, "model") sharding, so the token->expert
all-to-all is DTensor's redistribute. Otherwise (e.g. 8 experts on a
16-wide axis) the weights are Megatron column/row parallel inside each
expert and the buffers shard over groups only, the hidden's F over
"model" (``_buffer_specs``).

Routing is the reference's, choice for choice:
  * the router runs in f32; top-k takes the lower expert index first on a
    tie, as ``jax.lax.top_k`` does (k rounds of ``argmax``, which returns
    the first maximum);
  * a (token, choice) pair's slot is its rank among the pairs routed to
    the same expert in the row-major order of the flattened (token,
    choice) list; a pair ranked at or past the capacity is dropped (sent
    to a dump row past the buffer, which is cut off);
  * the dispatch puts each kept pair's row at its slot and the combine
    adds each token's kept rows, weighted, in choice order
    (``kernels/ops.moe_dispatch`` / ``moe_combine``): on the card two
    hand-written kernels, each the other's backward, that move only the
    kept pairs' rows; elsewhere the plain version, one indexed assignment
    and one gather a choice through dump rows (``kernels/ref``). Every
    kept destination is unique, so neither sums over atomics;
  * the Switch load-balance loss is taken over all tokens.

Expert parallelism by configuration (``cfg.experts_held``, a
``PortArchConfig`` field): a layer told that it holds the experts
[``first_expert_held``, + ``experts_held``) routes over all
``num_experts`` with the whole layer's capacity and computes only the
pairs routed to its own experts; the others are dropped here, as a pair
past the capacity is. What it returns is its experts' part of the
layer's output: the shares of disjoint held sets that cover the experts
sum to the whole layer's. Most pairs are then dropped (three in four with
a quarter of the experts held); on the plain route they go to
``DUMP_ROWS`` dump rows, spread by the pair's index, and not to one: the
combine's gather then meets no index repeated hundreds of thousands of
times, whose backward (a sorted accumulation, one index segment at a
time) would run them one after another. The kernels read ``keep`` and
move no dropped pair. Such a layer ranks the pairs by a stable sort of
their experts, where the twinned configs take the one-hot running count:
the same ranks, without a scan of Ng·k rows over E columns (126 ms a
layer of 72 experts at 32768 tokens on the H100, one launch).

Spans (``repro_torch.obs``): ``moe.route`` (the router, top-k, the slots
and the balance loss), ``moe.dispatch`` (the scatter), ``moe.experts``
(the expert products), ``moe.combine`` (the gathers), with k, the
capacity and the experts held as their args; ``moe.dispatch`` and
``moe.combine`` also with ``route`` ("kernel" or "plain",
``ops.moe_route``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.sharding import ctx

Params = Dict[str, torch.Tensor]

# dump rows of a layer that holds a share of the experts
DUMP_ROWS = 1024


def moe_init(generator: Optional[torch.Generator], cfg, dtype: torch.dtype,
             *, device="cuda") -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"router": dense_init(generator, D, cfg.num_experts, torch.float32,
                              device=device)}
    E = cfg.experts_held or cfg.num_experts
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["we_gate"] = _expert_init(generator, E, D, Fd, dtype, device)
    p["we_up"] = _expert_init(generator, E, D, Fd, dtype, device)
    p["we_down"] = _expert_init(generator, E, Fd, D, dtype, device)
    return p


def _expert_init(generator, e: int, d_in: int, d_out: int,
                 dtype: torch.dtype, device) -> torch.Tensor:
    std = 1.0 / math.sqrt(d_in)
    return (torch.randn((e, d_in, d_out), generator=generator, device=device,
                        dtype=torch.float32) * std).to(dtype)


def _buffer_specs(num_experts: int):
    """(ebuf/out spec, hidden spec) for the grouped dispatch buffers.

    Expert-parallel: both sharded over experts. TP-in-expert fallback: the
    (G,E,C,D) buffers shard only over groups; the hidden (G,E,C,F) shards
    F over "model" to match the column-parallel expert weights (Megatron
    pattern), so w_down's row-parallel contraction reduce-scatters
    back."""
    if num_experts % max(ctx.axis_size("model"), 1) == 0:
        ep = (ctx.BATCH, "model", None, None)
        return ep, ep
    return ((ctx.BATCH, None, None, None),
            (ctx.BATCH, None, None, "model"))


def _num_groups(batch: int) -> int:
    """Dispatch groups = batch shards (so each group is shard-local)."""
    shards = max(ctx.axis_size("pod"), 1) * max(ctx.axis_size("data"), 1)
    if shards > 1 and batch % shards == 0:
        return shards
    return 1


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none). Gradients reach the picked values."""
    rest = probs.detach()
    vals, idxs = [], []
    for _ in range(k):
        i = rest.argmax(-1, keepdim=True)
        idxs.append(i)
        vals.append(probs.gather(-1, i))
        rest = rest.scatter(-1, i, -math.inf)
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def capacity_of(cfg, tokens_per_group: int) -> int:
    """Slots per expert and group: ceil(k·N_g/E·cf), rounded up to a
    multiple of 8, at least 8."""
    E, k = cfg.num_experts, cfg.experts_per_token
    capacity = int(math.ceil(k * tokens_per_group / E * cfg.capacity_factor))
    return max(8, -(-capacity // 8) * 8)


def _ranks(flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """flat (G, M) expert ids -> each pair's rank among the pairs of its
    group routed to the same expert, in row-major order: its place in a
    stable sort by expert less the place where its expert's run starts."""
    order = torch.argsort(flat, dim=1, stable=True)
    counts = torch.zeros((flat.shape[0], num_experts), dtype=flat.dtype,
                         device=flat.device).scatter_add_(
        1, flat, torch.ones_like(flat))
    starts = counts.cumsum(1) - counts
    ranked = torch.arange(flat.shape[1], device=flat.device) \
        - starts.gather(1, flat.gather(1, order))
    return torch.empty_like(flat).scatter_(1, order, ranked)


def dispatch_slots(gate_idx: torch.Tensor, num_experts: int, capacity: int,
                   held: int = 0, first: int = 0):
    """gate_idx (G, Ng, k) -> (dest (G, Ng, k), keep (G, Ng, k)): each
    pair's row in the buffer of the H = ``held`` experts from ``first``
    (0: all E), H·capacity rows and then the dump rows (one, or
    ``DUMP_ROWS`` where a share is held), a dump row for a dropped pair
    or one routed to an expert not held."""
    G, Ng, k = gate_idx.shape
    flat = gate_idx.reshape(G, Ng * k)
    if not held or held == num_experts:
        onehot = F.one_hot(flat, num_experts)
        pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
        keep = pos < capacity
        dest = torch.where(keep, flat * capacity + pos,
                           num_experts * capacity)
        return dest.reshape(G, Ng, k), keep.reshape(G, Ng, k)
    pos = _ranks(flat, num_experts)
    flat = flat - first
    keep = (pos < capacity) & (flat >= 0) & (flat < held)
    dump = held * capacity + torch.arange(Ng * k, device=flat.device) \
        % DUMP_ROWS
    dest = torch.where(keep, flat * capacity + pos, dump)
    return dest.reshape(G, Ng, k), keep.reshape(G, Ng, k)


def apply_moe(p: Params, x: torch.Tensor, cfg):
    """x: (B, S, D) -> (y, aux_loss). Grouped top-k routing with capacity."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    # the experts computed here: all, or this chip's share
    H = cfg.experts_held or E
    dump = 1 if H == E else DUMP_ROWS
    G = _num_groups(B)
    Ng = B * S // G
    xg = ctx.shard(x, ctx.BATCH, None, None).reshape(G, Ng, D)

    capacity = capacity_of(cfg, Ng)
    groups = ctx.P(ctx.batch_entry(G) if G > 1 else None, None, None)
    buf_spec, hid_spec = _buffer_specs(H)
    args = {"k": k, "capacity": capacity, "experts_held": H}

    def route(xg, router):
        logits = xg.float() @ router                           # (G, Ng, E)
        probs = torch.softmax(logits, dim=-1)
        gate_w, gate_idx = top_k(probs, k)                     # (G, Ng, k)
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
        chosen = F.one_hot(gate_idx, E).float().sum(2)         # (G, Ng, E)
        dest, keep = dispatch_slots(gate_idx, E, capacity, H,
                                    cfg.first_expert_held)
        return probs, gate_w, chosen, dest, keep

    with obs.span("moe.route", cat="moe", **args):
        # the router (its weight gathered) and the routing of each rank's
        # groups on its block
        probs, gate_w, chosen, dest, keep = ctx.local(
            route, (groups,) * 5, (groups, ctx.P()))(xg, p["router"])

        # load-balance auxiliary loss (Switch-style), over ALL tokens
        me = probs.mean((0, 1))                                # (E,)
        ce = chosen.mean((0, 1))
        aux = E * (me * ce).sum() * cfg.router_aux_weight

    def scatter(xg, dest, keep):
        return ops.moe_dispatch(xg, dest, keep, H, capacity, dump)

    with obs.span("moe.dispatch", cat="moe",
                  route=ops.moe_route(xg), **args):
        ebuf = ctx.local(scatter, ctx.P(*groups, None), (groups,) * 3)(
            xg, dest, keep)
        ebuf = ctx.shard(ebuf, *buf_spec)                      # (G,H,C,D)

    def experts(ebuf, we_gate, we_up, we_down):
        if we_gate is not None:
            gate = torch.einsum("gecd,edf->gecf", ebuf, we_gate)
            act = F.silu(gate) if cfg.mlp_type == "swiglu" \
                else F.gelu(gate, approximate="tanh")
            h = act * torch.einsum("gecd,edf->gecf", ebuf, we_up)
        else:
            h = F.gelu(torch.einsum("gecd,edf->gecf", ebuf, we_up),
                       approximate="tanh")
        return torch.einsum("gecf,efd->gecd", h, we_down)

    # the experts' products on each rank's block (DTensor cannot reshape
    # the einsums' sharded operands): expert-parallel, each rank's groups
    # and experts; else TP in each expert, each rank's groups and slice of
    # d_ff, the down projection's output a partial sum over "model"
    # (reduced by the constraint after it)
    if H % max(ctx.axis_size("model"), 1) == 0:
        bspec = ctx.P(groups[0], ctx.model_entry(H), None, None)
        w_up = w_down = ctx.P(ctx.model_entry(H), None, None)
        out = bspec
    else:
        f = ctx.model_entry(cfg.d_ff)
        bspec = ctx.P(groups[0], None, None, None)
        w_up, w_down = ctx.P(None, None, f), ctx.P(None, f, None)
        out = ctx.Sum(bspec, f)
    gated = "we_gate" in p
    with obs.span("moe.experts", cat="moe", **args):
        out_buf = ctx.local(experts, out, (bspec, w_up if gated else None,
                                           w_up, w_down))(
            ebuf, p.get("we_gate"), p["we_up"], p["we_down"])
        out_buf = ctx.shard(out_buf, *buf_spec)

    def combine(out_buf, dest, gate_w, keep):
        return ops.moe_combine(out_buf, dest, gate_w, keep, dump)

    with obs.span("moe.combine", cat="moe",
                  route=ops.moe_route(out_buf), **args):
        y = ctx.local(combine, groups,
                      (ctx.P(*groups, None),) + (groups,) * 3)(
            out_buf, dest, gate_w, keep)
    return ctx.shard_residual(y.reshape(B, S, D)), aux
