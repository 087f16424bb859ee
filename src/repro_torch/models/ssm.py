"""Mamba-2 style state-space block (SSD, state-space duality,
arXiv:2405.21060; twin of ``repro/models/ssm.py``).

Recurrence per head h with state (P = head_dim, N = d_state):

    H_t = exp(dt_t·A_h)·H_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · H_t + D_h · x_t

computed with the chunked SSD algorithm: quadratic attention-like compute
inside chunks of ``ssm_chunk`` tokens plus a recurrence over the chunk
boundary states, O(S·Cs) instead of O(S²). The recurrence's carry is the
decode state, so a prefill hands the cache to decode as it is.

Caches are dicts {h, conv, conv_bc}: the state (B, H, P, N) and the last
``ssm_conv_width − 1`` inputs of each causal convolution. As the port's KV
caches, they are written in place (prefill and decode return the dict
they were given, updated).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_norm, dense_init, norm_init
from repro_torch.sharding import ctx

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


def ssm_init(generator: Optional[torch.Generator], cfg, dtype: torch.dtype,
             *, device="cuda") -> Params:
    D, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv_width

    def conv_w(c):
        return (torch.randn((W, c), generator=generator, device=device,
                            dtype=torch.float32) * 0.1).to(dtype)
    # four separate projections (z | x | BC | dt), the reference's layout
    return {
        "in_proj_z": dense_init(generator, D, din, dtype, device=device),
        "in_proj_x": dense_init(generator, D, din, dtype, device=device),
        "in_proj_bc": dense_init(generator, D, 2 * N, dtype, device=device),
        "in_proj_dt": dense_init(generator, D, H, dtype, device=device),
        "out_proj": dense_init(generator, din, D, dtype, device=device),
        "conv_w": conv_w(din),
        "conv_b": torch.zeros((din,), dtype=dtype, device=device),
        "conv_w_bc": conv_w(2 * N),
        "conv_b_bc": torch.zeros((2 * N,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "ssm_D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "gate_norm": norm_init(din, "rmsnorm", dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted sums. x: (B,S,C), w: (W,C)."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    y = sum(pad[:, i:i + S] * w[i] for i in range(W))
    return y + b


def _segsum_decay(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., Cs, H) -> decay L (..., H, Cs, Cs):
    L[i,j] = exp(Σ_{j<t<=i} dA_t), 0 above the diagonal."""
    cum = dA.cumsum(-2).movedim(-1, -2)                 # (..., H, Cs)
    diff = cum[..., :, None] - cum[..., None, :]        # (..., H, Cs, Cs)
    Cs = dA.shape[-2]
    mask = torch.ones((Cs, Cs), dtype=torch.bool, device=dA.device).tril()
    # mask BEFORE exp: the upper triangle's diffs are large and positive,
    # exp of them is inf, and a mask after it would give the backward pass
    # 0·inf = NaN
    return torch.exp(torch.where(mask, diff, -torch.inf))


def _chunk_stats(x_c, dt_c, B_c, C_c, A):
    """One chunk's intra-chunk output, the state it contributes (decayed to
    the chunk's end), the decay from its start to each position, and its
    total decay."""
    dA_c = dt_c * A                                     # (B,Cs,H), <= 0
    xdt_c = x_c * dt_c[..., None]                       # (B,Cs,H,P)
    L = _segsum_decay(dA_c)                             # (B,H,Cs,Cs)
    CB = torch.einsum("bin,bjn->bij", C_c, B_c)         # (B,Cs,Cs)
    y_intra = torch.einsum("bij,bhij,bjhp->bihp", CB, L, xdt_c)
    cum = dA_c.cumsum(1)                                # (B,Cs,H)
    decay_end = torch.exp(cum[:, -1:, :] - cum)         # (B,Cs,H)
    state = torch.einsum("bjn,bjh,bjhp->bhpn", B_c, decay_end, xdt_c)
    decay_in = torch.exp(cum)                           # (B,Cs,H)
    chunk_decay = torch.exp(cum[:, -1, :])              # (B,H)
    return y_intra, state, decay_in, chunk_decay


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    xh: (B,S,H,P); dt: (B,S,H); A: (H,) negative; Bm/Cm: (B,S,N).
    Returns (y (B,S,H,P), final state (B,H,P,N)). A sequence that the
    chunk does not divide runs as one chunk. Under autograd each chunk's
    statistics are rematerialized in the backward pass, so only the raw
    inputs and the carried states stay alive across the scan.
    """
    B, S, H, P = xh.shape
    Cs = min(chunk, S)
    if S % Cs != 0:
        Cs = S
    h = torch.zeros((B, H, P, Bm.shape[-1]), dtype=xh.dtype,
                    device=xh.device) if h0 is None else h0
    remat = torch.is_grad_enabled()
    ys = []
    for c0 in range(0, S, Cs):
        inp = (xh[:, c0:c0 + Cs], dt[:, c0:c0 + Cs], Bm[:, c0:c0 + Cs],
               Cm[:, c0:c0 + Cs], A)
        y_intra, state, decay_in, chunk_decay = \
            checkpoint(_chunk_stats, *inp, use_reentrant=False) if remat \
            else _chunk_stats(*inp)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", inp[3],
                               h.to(y_intra.dtype), decay_in)
        h = chunk_decay[:, :, None, None] * h + state.to(h.dtype)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def init_ssm_cache(cfg, batch: int, dtype: torch.dtype, *,
                   device="cuda") -> Cache:
    W = cfg.ssm_conv_width - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"h": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state),
            "conv": zeros(batch, W, cfg.d_inner),
            "conv_bc": zeros(batch, W, 2 * cfg.ssm_state)}


def _promoted(*ts: torch.Tensor):
    """The tensors in their common promoted dtype (jnp.einsum promotes
    mixed operands; torch.einsum wants one dtype)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def apply_ssm(p: Params, x: torch.Tensor, cfg, *, mode: str = "train",
              cache: Optional[Cache] = None):
    """Mamba-2 block. x: (B,S,D) (S = 1 for decode). Returns (y, cache):
    prefill and decode write ``cache`` in place; train takes none."""
    B, S, D = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    Wm1 = cfg.ssm_conv_width - 1
    if mode != "train" and cache is None or mode == "decode" and S != 1:
        raise ValueError(f"{mode} needs a cache (and decode one token)")

    x = ctx.shard(x, ctx.BATCH, None, None)   # the sequence gathered
    w = {k: ctx.gathered(v) for k, v in p.items() if "proj" in k}
    z, x_in = x @ w["in_proj_z"], x @ w["in_proj_x"]
    bc_in, dt_raw = x @ w["in_proj_bc"], x @ w["in_proj_dt"]

    def core(x_in, bc_in, dt_raw, conv_w, conv_b, conv_w_bc, conv_b_bc,
             dt_bias, A_log, ssm_D, c_h, c_conv, c_conv_bc):
        """The convolutions and the scan of the (local) rows and heads:
        y (B, S, din) before the gate; writes the cache's (local) block
        in place."""
        Bl, Hl = x_in.shape[0], dt_raw.shape[-1]

        def conv_stream(stream, tail, w, b):
            """Depthwise causal conv on one stream; returns (y, new
            tail)."""
            if mode == "decode":
                window = torch.cat([tail, stream], dim=1)
                y = (torch.einsum("bwc,wc->bc", window, w) + b)[:, None]
                return y, window[:, 1:]
            conv_in = stream
            if tail is not None:  # continue from the conv tail
                conv_in = torch.cat([tail, stream], dim=1)[:, -(S + Wm1):]
            y = _causal_conv(conv_in, w, b)[:, -S:]
            # zeros ahead of an input shorter than the tail (the reference
            # pads by W − 1 − S even after a cache's rows, giving a tail
            # one row per missing token too long when a cached prefill has
            # S < W − 1)
            pad = stream.new_zeros((Bl, max(Wm1 - conv_in.shape[1], 0),
                                    stream.shape[-1]))
            return y, torch.cat([pad, conv_in[:, -Wm1:]], dim=1)

        x_c, conv_tail = conv_stream(x_in, c_conv, conv_w, conv_b)
        bc_c, conv_bc_tail = conv_stream(bc_in, c_conv_bc, conv_w_bc,
                                         conv_b_bc)
        x_c, bc_c = F.silu(x_c), F.silu(bc_c)
        xs = x_c.reshape(Bl, S, Hl, P)
        Bm, Cm = bc_c[..., :N], bc_c[..., N:]
        # softplus in f32, then cast to the stream's dtype for the scan
        dt = F.softplus(dt_raw.float() + dt_bias)                  # (B,S,H)
        A = -torch.exp(A_log)                                      # (H,) f32

        if mode == "decode":
            h_prev = c_h
            dA = torch.exp(dt[:, 0] * A)                           # (B,H) f32
            upd = torch.einsum("bn,bh,bhp->bhpn",
                               *_promoted(Bm[:, 0], dt[:, 0], xs[:, 0]))
            # the recurrent state stays in its cache dtype
            h = (dA[:, :, None, None] * h_prev + upd).to(h_prev.dtype)
            y = torch.einsum("bn,bhpn->bhp",
                             *_promoted(Cm[:, 0], h))[:, None]
            y = y.to(x_in.dtype)
            c_h.copy_(h)
            c_conv.copy_(conv_tail)
            c_conv_bc.copy_(conv_bc_tail)
        else:
            y, h_final = ssd_scan(xs, dt.to(xs.dtype), A.to(xs.dtype), Bm,
                                  Cm, cfg.ssm_chunk, h0=c_h)
            if mode == "prefill":
                c_h.copy_(h_final)
                c_conv.copy_(conv_tail)
                c_conv_bc.copy_(conv_bc_tail)

        y = y + ssm_D.to(y.dtype)[:, None] * xs
        return y.reshape(Bl, S, Hl * P)

    # head-parallel SSD (Mamba TP): every SSD tensor is independent per
    # head, so the heads (and the x stream's channels) go over "model"
    # and the rows over the batch axes; B/C (one group) are shared across
    # heads and stay replicated. A cache keeps its own layout.
    rows, heads = _local_layout(B, H, None if cache is None else cache["h"])
    ch = ctx.P(rows, None, heads)
    rep = ctx.P(rows, None, None)
    vec = ctx.P(heads)
    cspecs = (None,) * 3 if cache is None else \
        (ctx.P(rows, heads, None, None), ch, rep)
    cache_t = (None,) * 3 if cache is None else \
        (cache["h"], cache["conv"], cache["conv_bc"])
    y = ctx.local(core, ch, (ch, rep, ch, ctx.P(None, heads), vec,
                             ctx.P(), ctx.P(), vec, vec, vec) + cspecs,
                  inplace=(10, 11, 12))(
        x_in, bc_in, dt_raw, p["conv_w"], p["conv_b"], p["conv_w_bc"],
        p["conv_b_bc"], p["dt_bias"], p["A_log"], p["ssm_D"], *cache_t)
    y = y * F.silu(z)
    y = ctx.shard(y, ctx.BATCH, None, "model")
    y = _gate_norm(p["gate_norm"], y, cfg.norm_eps)
    return ctx.shard_residual(y @ w["out_proj"]), cache


def _gate_norm(p: Params, y: torch.Tensor, eps: float) -> torch.Tensor:
    """The gate's RMSNorm over d_inner. Under a mesh d_inner stays split
    over "model": each rank sums its block's squares, the sums meet in
    one all-reduce, and each rank scales its block (DTensor's own rule
    would reshard the rows, then flatten them strided in the backward
    pass)."""
    if not ctx.is_sharded(y):
        return apply_norm(p, y, "rmsnorm", eps)
    n = y.shape[-1]
    block = ctx.P(ctx.batch_entry(y.shape[0]), None, ctx.model_entry(n))
    rows = ctx.P(block[0], None, None)
    sq = ctx.local(lambda t: t.float().square().sum(-1, keepdim=True),
                   ctx.Sum(rows, block[2]), (block,))(y)
    var = ctx.shard(sq, *rows) / n

    def scale(t, v, s):
        return (t.float() * torch.rsqrt(v + eps) * s.float()).to(t.dtype)

    return ctx.local(scale, block, (block, rows, ctx.P(block[2])))(
        y, var, p["scale"])


def _local_layout(batch: int, heads: int, cache_h: Optional[torch.Tensor]):
    """The (rows, heads) entries of the SSM's local block under a mesh:
    the batch axes where they divide the batch, "model" where it divides
    the heads; a cache keeps its own layout."""
    if cache_h is None or not ctx.is_sharded(cache_h):
        return ctx.batch_entry(batch), ctx.model_entry(heads)
    spec = ctx.spec_of(cache_h)
    return spec[0], spec[1]
