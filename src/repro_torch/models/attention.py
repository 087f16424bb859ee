"""Grouped-query attention with RoPE/M-RoPE (twin of
``repro/models/attention.py``), four execution paths:

  * ``flash``: the prefill over positions 0..S−1 -- the hand-written CUDA
    flash kernel on a card (``kernels/ops.flash_attention_strided``), its
    plain version on the CPU. It computes what ``row_block_attention`` computes
    there (causal, GQA, optional window); the reference reaches its Pallas
    twin only from tests and benchmarks, the port puts it on the path.
  * ``row_block``: causal (optionally windowed) attention in query
    row-blocks, peak memory O(q_chunk · S_kv); training and batches that
    carry their own positions take it. Under autograd each block is
    rematerialized in the backward pass, as the reference's
    ``jax.checkpoint``-ed block is, so the backward pass holds one block's
    probabilities at a time. Training stays on this plain algorithm: the
    flash kernel is forward-only, as its Pallas twin is.
  * ``local``: exact sliding-window attention for long sequences, blocks
    of the window attending to (previous ‖ own) key blocks.
  * ``decode``: one query token against a (possibly ring-buffered) cache.

Layouts are the reference's: q (B, S, H, hd), k/v (B, S, Kv, hd), weights
(d_in, d_out). KV caches are dicts {k, v, pos}; ``pos`` records the
absolute position held in each slot (-1 = empty), so windowed ring buffers
and full caches share one code path. Unlike the reference's immutable
arrays, a cache is written in place (prefill and decode return the dict
they were given, updated): a decode step then moves one token's K and V,
not the whole cache.

``positions=None`` means every row sits at 0..S−1, the reference's default
positions; only then can the prefill take the flash kernel, which masks by
index.

Under a ``("data", "model")`` mesh (``sharding/ctx.py``) the projections
are DTensor products, and the attention itself -- the four paths and the
cache writes -- runs on each rank's local block (``ctx.local``): its batch
rows over ("pod", "data") and its heads over "model" where both H and Kv
divide the axis (or the layout of the cache it writes), so the flash
kernel takes plain local tensors and the cache writes land in the local
shards.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.models.rope import apply_rope, rope_angles
from repro_torch.sharding import ctx

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_init(generator: Optional[torch.Generator], cfg, dtype: torch.dtype,
              *, device="cuda") -> Dict[str, torch.Tensor]:
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(generator, D, Q, dtype, device=device),
        "wk": dense_init(generator, D, KV, dtype, device=device),
        "wv": dense_init(generator, D, KV, dtype, device=device),
        "wo": dense_init(generator, Q, D, dtype, device=device),
    }
    if cfg.use_bias:
        for name, n in (("wq_b", Q), ("wk_b", KV), ("wv_b", KV),
                        ("wo_b", D)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _project(p, x: torch.Tensor, cfg, angles: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,Kv,hd) with RoPE applied."""
    B, S, _ = x.shape
    q = x @ ctx.gathered(p["wq"])
    k = x @ ctx.gathered(p["wk"])
    v = x @ ctx.gathered(p["wv"])
    if "wq_b" in p:
        q = q + p["wq_b"]
        k = k + p["wk_b"]
        v = v + p["wv_b"]
    # under a mesh the projections' outputs split over "model" only at
    # head boundaries (whole heads of q and of k/v on each rank)
    heads = ctx.model_entry(cfg.num_heads, cfg.num_kv_heads)
    q, k, v = (ctx.shard(t, ctx.BATCH, None, heads) for t in (q, k, v))
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, angles), apply_rope(k, angles), v


# ---------------------------------------------------------------------------
# score computation (shared)
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float):
    """q: (B,Sq,Kv,G,hd), k: (B,Skv,Kv,hd) -> (B,Kv,G,Sq,Skv) f32 (the
    products of the inputs are exact in f32, as the reference's
    ``preferred_element_type``)."""
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale


def _gqa_out(probs: torch.Tensor, v: torch.Tensor):
    """probs: (B,Kv,G,Sq,Skv), v: (B,Skv,Kv,hd) -> (B,Sq,Kv,G,hd); the
    probabilities are cast to v's dtype first, as in the reference."""
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def _blockwise(block, *args):
    """``block(*args)``, rematerialized in the backward pass under
    autograd."""
    if torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: Optional[int]):
    """(Sq,) x (Skv,) -> (Sq, Skv) bool keep-mask: causal + sliding window."""
    m = qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    m &= kpos[None, :] >= 0  # invalid / unwritten slots carry pos = -1
    return m


# ---------------------------------------------------------------------------
# path 1: the flash kernel over positions 0..S-1
# ---------------------------------------------------------------------------

def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: Optional[int],
                            scale: float) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,S,Kv,hd) at positions 0..S−1 -> (B,S,H,hd);
    the kernel reads the projections' views through their strides and
    writes the (B,S,H,hd) output, so no layout is copied."""
    return torch.ops.repro_torch.flash_prefill(q, k, v, scale, window)


@torch.library.custom_op("repro_torch::flash_prefill", mutates_args=())
def _flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, window: Optional[int]) -> torch.Tensor:
    """The flash kernel as one op: on data, the kernel (its plain version
    on the CPU); on FakeTensors (the dry run), only the output's shape,
    as the kernel holds no (S, S) scores, and the FLOPs of
    ``_flash_flops``."""
    return ops.flash_attention_strided(q, k, v, window=window, scale=scale)


@_flash_prefill.register_fake
def _(q, k, v, scale, window):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.flash_prefill)
def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                 **kwargs) -> int:
    """4·hd FLOPs per causal (query, key) pair in the window: q·k and
    p·v, a multiply and an add each."""
    B, S, H, hd = q_shape
    window = args[1] if len(args) > 1 else kwargs.get("window")
    W = S if window is None else min(window, S)
    pairs = W * (W + 1) // 2 + (S - W) * W
    return 4 * hd * pairs * B * H


# ---------------------------------------------------------------------------
# path 2: row-block causal attention
# ---------------------------------------------------------------------------

def row_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        qpos: torch.Tensor, kpos: torch.Tensor, *,
                        window: Optional[int], q_chunk: int,
                        scale: float) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,Kv,hd), qpos: (Sq,), kpos: (Skv,)."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Sq, Kv, H // Kv, hd)
    if Sq % q_chunk != 0:
        q_chunk = Sq  # small sequences: single block

    def block(qb, qpb):
        s = _gqa_scores(qb, k, scale)
        keep = _mask(qpb, kpos, window)
        s = torch.where(keep, s, NEG_INF)
        return _gqa_out(torch.softmax(s, dim=-1), v)

    out = torch.cat([_blockwise(block, qg[:, i:i + q_chunk],
                                qpos[i:i + q_chunk])
                     for i in range(0, Sq, q_chunk)], dim=1)
    return out.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# path 3: exact block-local sliding-window attention
# ---------------------------------------------------------------------------

def local_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           qpos: torch.Tensor, kpos: torch.Tensor, *,
                           window: int, scale: float) -> torch.Tensor:
    """Exact SWA when S % window == 0: block b attends to blocks {b-1, b}."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    W = window
    if S % W != 0:
        raise ValueError(f"local attention needs S % window == 0, got S={S}, "
                         f"window={W}")
    nb = S // W
    qg = q.reshape(B, nb, W, Kv, H // Kv, hd)
    kb = k.reshape(B, nb, W, Kv, hd)
    vb = v.reshape(B, nb, W, Kv, hd)

    def prev(x):  # the previous block (zeros for block 0)
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)

    k2 = torch.cat([prev(kb), kb], dim=2)  # (B, nb, 2W, Kv, hd)
    v2 = torch.cat([prev(vb), vb], dim=2)
    qpb = qpos.reshape(nb, W)
    kpb = kpos.reshape(nb, W)
    kprev = torch.cat([torch.full((1, W), -1, dtype=kpos.dtype,
                                  device=kpos.device), kpb[:-1]], dim=0)
    kpb2 = torch.cat([kprev, kpb], dim=1)  # (nb, 2W)

    def block(qb, kb_, vb_, qp, kp):
        s = _gqa_scores(qb, kb_, scale)
        keep = _mask(qp, kp, W)
        s = torch.where(keep, s, NEG_INF)
        return _gqa_out(torch.softmax(s, dim=-1), vb_)

    outs = [_blockwise(block, qg[:, b], k2[:, b], v2[:, b], qpb[b], kpb2[b])
            for b in range(nb)]
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# path 4: single-token decode against a cache
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor,
                     qpos: int, *, window: Optional[int],
                     scale: float) -> torch.Tensor:
    """q: (B,1,H,hd); cache_k/v: (B,Sc,Kv,hd); cache_pos: (Sc,); qpos int."""
    B, _, H, hd = q.shape
    Kv = cache_k.shape[2]
    qg = q.reshape(B, 1, Kv, H // Kv, hd)
    s = _gqa_scores(qg, cache_k, scale)  # (B,Kv,G,1,Sc)
    qp = torch.full((1,), qpos, dtype=cache_pos.dtype, device=cache_pos.device)
    keep = _mask(qp, cache_pos, window)  # (1, Sc)
    s = torch.where(keep, s, NEG_INF)
    out = _gqa_out(torch.softmax(s, dim=-1), cache_v)
    return out.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# full block: projections + attention + output
# ---------------------------------------------------------------------------

def init_attn_cache(cfg, batch: int, max_len: int, dtype: torch.dtype, *,
                    device="cuda") -> Cache:
    """Cache length = window size for SWA models (ring buffer), else max_len."""
    Sc = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, Sc, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((Sc,), -1, dtype=torch.int32, device=device),
    }


def default_positions(batch: int, seq_len: int, device, mrope: bool = False,
                      start: int = 0) -> torch.Tensor:
    """(B, S) positions start..start+S−1, or (3, B, S) for M-RoPE."""
    pos = torch.arange(start, start + seq_len, dtype=torch.int32,
                       device=device)
    pos = pos.expand(batch, seq_len)
    return pos.expand(3, batch, seq_len) if mrope else pos


def apply_attention(p, x: torch.Tensor, cfg,
                    positions: Optional[torch.Tensor] = None, *,
                    mode: str = "train", cache: Optional[Cache] = None,
                    decode_pos: Optional[int] = None):
    """Attention block.

    mode "train"/"prefill": x (B,S,D); positions (B,S), (3,B,S) for M-RoPE,
      or None for 0..S−1. Prefill also fills ``cache`` in place.
    mode "decode": x (B,1,D); ``decode_pos`` the absolute position (an int;
      positions None means (B,1) ids of it); ``cache`` is written in place.
    Returns (y, cache).
    """
    if cache is None and mode != "train" or \
            decode_pos is None and mode == "decode":
        raise ValueError(f"{mode} needs a cache (and decode a decode_pos)")
    scale = 1.0 / math.sqrt(cfg.head_dim)
    B, S = x.shape[:2]
    default = positions is None
    if default:
        positions = default_positions(
            B, S, x.device, cfg.mrope_sections is not None,
            start=decode_pos if mode == "decode" else 0)
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.mrope_sections)
    # the sequence-sharded residual gathered into the projections
    q, k, v = _project(p, ctx.shard(x, ctx.BATCH, None, None), cfg, angles)
    # token positions along the sequence (1D; batch-uniform by construction)
    pos1d = positions[0, 0] if positions.dim() == 3 else positions[0]
    window = cfg.sliding_window

    def attend(q, k, v, pos1d):
        """Train or prefill attention of the (local) rows and heads."""
        if window and S > 2 * window and S % window == 0:
            return local_window_attention(q, k, v, pos1d, pos1d,
                                          window=window, scale=scale)
        if mode == "prefill" and default:
            return flash_prefill_attention(q, k, v, window=window,
                                           scale=scale)
        return row_block_attention(q, k, v, pos1d, pos1d, window=window,
                                   q_chunk=cfg.attn_q_chunk, scale=scale)

    def core(q, k, v, pos1d, ck, cv, cpos):
        """The attention of the (local) rows and heads; writes the
        cache's (local) block in place."""
        if mode == "decode":
            slot = decode_pos % ck.shape[1]
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
            cpos[slot] = decode_pos
            return decode_attention(q, ck, cv, cpos, decode_pos,
                                    window=window, scale=scale)
        out = attend(q, k, v, pos1d)
        if mode == "prefill":
            Sc = ck.shape[1]
            if Sc >= S:
                ck[:, :S] = k
                cv[:, :S] = v
                cpos[:S] = pos1d
            else:  # windowed ring cache: keep the last Sc tokens, ring-aligned
                # slot invariant: position p lives in slot p % Sc, so later
                # decode writes (slot = pos % Sc) evict exactly the oldest token
                shift = S % Sc
                ck.copy_(torch.roll(k[:, S - Sc:], shift, dims=1))
                cv.copy_(torch.roll(v[:, S - Sc:], shift, dims=1))
                cpos.copy_(torch.roll(pos1d[S - Sc:], shift, dims=0))
        return out

    kv = (None,) * 3 if cache is None else \
        (cache["k"], cache["v"], cache["pos"])
    rows, heads, seq = _local_layout(B, cfg, kv[0])
    if seq is not None:
        out = _seq_sharded(q, k, v, pos1d, kv, rows, seq, attend, mode,
                           decode_pos, window, scale)
        y = out @ ctx.gathered(p["wo"])
        if "wo_b" in p:
            y = y + p["wo_b"]
        return ctx.shard_residual(y), cache
    if heads is None and cache is None and ctx.is_sharded(q) and \
            ctx.model_entry(cfg.num_heads) is not None:
        # the q heads divide "model" but the k/v heads do not: each k/v
        # head repeated for its q heads, so every rank holds whole heads
        G = cfg.num_heads // cfg.num_kv_heads
        k, v = (t[:, :, :, None].expand(B, S, cfg.num_kv_heads, G,
                                        cfg.head_dim).reshape(
            B, S, cfg.num_heads, cfg.head_dim) for t in (k, v))
        heads = "model"
    qkv = ctx.P(rows, None, heads, None)
    cspec = None if cache is None else qkv
    # the heads merged inside: a head count the model axis does not divide
    # cannot be unflattened from a sharded q_dim (in the backward pass)
    out = ctx.local(lambda *a: core(*a).flatten(2), ctx.P(rows, None, heads),
                    (qkv, qkv, qkv, ctx.P(), cspec, cspec,
                     None if cache is None else ctx.P()),
                    inplace=(4, 5, 6))(q, k, v, pos1d, *kv)

    y = out @ ctx.gathered(p["wo"])
    if "wo_b" in p:
        y = y + p["wo_b"]
    return ctx.shard_residual(y), cache


def _local_layout(batch: int, cfg, cache_k: Optional[torch.Tensor]):
    """The (rows, heads, cache slots) entries of the attention's local
    block under a mesh: the batch axes where they divide the batch,
    "model" where it divides both head counts, no slots split; a cache
    keeps its own layout (``launch/specs.cache_spec_tree``'s: rows, heads
    or slots split, never head_dim)."""
    if cache_k is None or not ctx.is_sharded(cache_k):
        return ctx.batch_entry(batch), ctx.model_entry(
            cfg.num_heads, cfg.num_kv_heads), None
    spec = ctx.spec_of(cache_k)
    if spec[3] is not None:
        raise ValueError(f"attention: a KV cache laid out as {spec} splits "
                         f"head_dim")
    return spec[0], spec[2], spec[1]


def _seq_sharded(q, k, v, pos1d, kv, rows, seq, attend, mode, decode_pos,
                 window, scale):
    """Attention (B, S, H·hd) against a cache whose slots are split over
    the mesh axes ``seq`` (the layout the cache policy takes for a cache
    too large for batch-only sharding): each rank writes the new tokens'
    K and V that fall in its block of slots. A prefill attends on its
    rows and all heads; a decode step takes each block's softmax
    statistics (max, sum, weighted values, in f32) and combines them
    across the blocks (flash-decoding), exact up to the order of the
    sums."""
    ck, cv, cpos = kv
    spec = ctx.P(rows, None, None, None)
    cspec = ctx.P(rows, seq, None, None)

    def block(ck):
        """(this rank's first slot, slots per rank)."""
        return ctx.flat_rank(seq) * ck.shape[1], ck.shape[1]

    if mode == "prefill":
        def write(q, k, v, pos1d, ck, cv, cpos):
            out = attend(q, k, v, pos1d)
            off, n = block(ck)
            S, Sc = k.shape[1], cpos.shape[0]
            if Sc >= S:
                m = max(0, min(S - off, n))
                ck[:, :m] = k[:, off:off + m]
                cv[:, :m] = v[:, off:off + m]
                cpos[:S] = pos1d
            else:  # the ring cache's slots, ring-aligned as in `core`
                shift = S % Sc
                ck.copy_(torch.roll(k[:, S - Sc:], shift, dims=1)[
                    :, off:off + n])
                cv.copy_(torch.roll(v[:, S - Sc:], shift, dims=1)[
                    :, off:off + n])
                cpos.copy_(torch.roll(pos1d[S - Sc:], shift, dims=0))
            return out.flatten(2)

        return ctx.local(write, ctx.P(rows, None, None),
                         (spec, spec, spec, ctx.P(), cspec, cspec, ctx.P()),
                         inplace=(4, 5, 6))(q, k, v, pos1d, ck, cv, cpos)

    def stats(q, k, v, ck, cv, cpos):
        off, n = block(ck)
        slot = decode_pos % cpos.shape[0]
        if off <= slot < off + n:
            ck[:, slot - off] = k[:, 0]
            cv[:, slot - off] = v[:, 0]
        cpos[slot] = decode_pos
        B, _, H, hd = q.shape
        Kv = ck.shape[2]
        s = _gqa_scores(q.reshape(B, 1, Kv, H // Kv, hd), ck, scale)
        qp = torch.full((1,), decode_pos, dtype=cpos.dtype,
                        device=cpos.device)
        s = torch.where(_mask(qp, cpos[off:off + n], window), s, NEG_INF)
        mx = s.amax(-1, keepdim=True)                      # (B,Kv,G,1,1)
        p = torch.exp(s - mx)
        o = torch.einsum("bkgqs,bskh->bkgqh", p, cv.float())
        return mx[None], p.sum(-1, keepdim=True)[None], o[None]

    part = ctx.P(seq, rows, None, None, None, None)
    mx, den, o = ctx.local(stats, (part, part, part),
                           (spec, spec, spec, cspec, cspec, ctx.P()),
                           inplace=(3, 4, 5))(q, k, v, ck, cv, cpos)
    w = torch.exp(mx - mx.amax(0, keepdim=True))
    out = (o * w).sum(0) / (den * w).sum(0)                # (B,Kv,G,1,hd)
    B, _, H, hd = q.shape
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H * hd).to(v.dtype)
