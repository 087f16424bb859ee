"""Mixture-of-Experts layer with grouped, capacity-based scatter dispatch
(twin of ``repro/models/moe.py``).

Dispatch is grouped: tokens are split into G groups (the batch shards of a
mesh) and each group scatters into its own (E, C_g, D) buffer with
per-group capacity C_g = ceil(k·N_g/E · capacity_factor), rounded up to a
multiple of 8 (at least 8). The port's LM runs without a ``("data",
"model")`` mesh, so G = 1; the group axis stays in the code for the
production meshes (ROADMAP A13b).

Routing is the reference's, choice for choice:
  * the router runs in f32; top-k takes the lower expert index first on a
    tie, as ``jax.lax.top_k`` does (k rounds of ``argmax``, which returns
    the first maximum);
  * a (token, choice) pair's slot is its rank among the pairs routed to
    the same expert in the row-major order of the flattened (token,
    choice) list; a pair ranked at or past the capacity is dropped (sent
    to a dump row past the buffer, which is cut off);
  * the scatter runs one choice at a time by indexed assignment (every
    kept destination is unique, so no sum over an atomic ``index_add_``
    whose order could vary), the combine one gather per choice;
  * the Switch load-balance loss is taken over all tokens.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def moe_init(generator: Optional[torch.Generator], cfg, dtype: torch.dtype,
             *, device="cuda") -> Params:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": dense_init(generator, D, E, torch.float32,
                              device=device)}
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


def _num_groups(batch: int) -> int:
    """Dispatch groups = batch shards; one without a ``("data",
    "model")`` mesh (ROADMAP A13b)."""
    del batch
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


def dispatch_slots(gate_idx: torch.Tensor, num_experts: int, capacity: int):
    """gate_idx (G, Ng, k) -> (dest (G, Ng, k), keep (G, Ng, k)): each
    pair's row in the (E·capacity + 1)-row buffer, E·capacity (the dump
    row) for a dropped pair."""
    G, Ng, k = gate_idx.shape
    flat = gate_idx.reshape(G, Ng * k)
    onehot = F.one_hot(flat, num_experts)
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    keep = pos < capacity
    dest = torch.where(keep, flat * capacity + pos,
                       num_experts * capacity)
    return dest.reshape(G, Ng, k), keep.reshape(G, Ng, k)


def apply_moe(p: Params, x: torch.Tensor, cfg):
    """x: (B, S, D) -> (y, aux_loss). Grouped top-k routing with capacity."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = _num_groups(B)
    Ng = B * S // G
    xg = x.reshape(G, Ng, D)

    logits = xg.float() @ p["router"]                          # (G, Ng, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = top_k(probs, k)                         # (G, Ng, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance auxiliary loss (Switch-style), over ALL tokens
    me = probs.mean((0, 1))                                    # (E,)
    ce = F.one_hot(gate_idx, E).float().sum(2).mean((0, 1))
    aux = E * (me * ce).sum() * cfg.router_aux_weight

    capacity = capacity_of(cfg, Ng)
    dest, keep = dispatch_slots(gate_idx, E, capacity)
    groups = torch.arange(G, device=x.device)[:, None]
    buf = x.new_zeros((G, E * capacity + 1, D))
    for j in range(k):    # one choice at a time: no (Ng·k, D) buffer
        buf.index_put_((groups, dest[:, :, j]), xg)
    ebuf = buf[:, :-1].reshape(G, E, capacity, D)

    if "we_gate" in p:
        gate = torch.einsum("gecd,edf->gecf", ebuf, p["we_gate"])
        act = F.silu(gate) if cfg.mlp_type == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        h = act * torch.einsum("gecd,edf->gecf", ebuf, p["we_up"])
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", ebuf, p["we_up"]),
                   approximate="tanh")
    out_buf = torch.einsum("gecf,efd->gecd", h, p["we_down"])

    padded = torch.cat([out_buf.reshape(G, E * capacity, D),
                        x.new_zeros((G, 1, D))], dim=1)
    y = x.new_zeros((G, Ng, D))
    for j in range(k):    # one gather per choice
        wj = (gate_w[:, :, j] * keep[:, :, j]).to(x.dtype)
        y = y + padded[groups, dest[:, :, j]] * wj[:, :, None]
    return y.reshape(B, S, D), aux
