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
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.models.rope import apply_rope, rope_angles

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
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "wq_b" in p:
        q = q + p["wq_b"]
        k = k + p["wk_b"]
        v = v + p["wv_b"]
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
    return ops.flash_attention_strided(q, k, v, window=window, scale=scale)


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
    q, k, v = _project(p, x, cfg, angles)
    # token positions along the sequence (1D; batch-uniform by construction)
    pos1d = positions[0, 0] if positions.dim() == 3 else positions[0]
    window = cfg.sliding_window

    if mode == "decode":
        slot = decode_pos % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["pos"][slot] = decode_pos
        out = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                               decode_pos, window=window, scale=scale)
    else:
        if window and S > 2 * window and S % window == 0:
            out = local_window_attention(q, k, v, pos1d, pos1d,
                                         window=window, scale=scale)
        elif mode == "prefill" and default:
            out = flash_prefill_attention(q, k, v, window=window,
                                          scale=scale)
        else:
            out = row_block_attention(q, k, v, pos1d, pos1d, window=window,
                                      q_chunk=cfg.attn_q_chunk, scale=scale)
        if mode == "prefill":
            Sc = cache["k"].shape[1]
            if Sc >= S:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
                cache["pos"][:S] = pos1d
            else:  # windowed ring cache: keep the last Sc tokens, ring-aligned
                # slot invariant: position p lives in slot p % Sc, so later
                # decode writes (slot = pos % Sc) evict exactly the oldest token
                shift = S % Sc
                cache["k"].copy_(torch.roll(k[:, S - Sc:], shift, dims=1))
                cache["v"].copy_(torch.roll(v[:, S - Sc:], shift, dims=1))
                cache["pos"].copy_(torch.roll(pos1d[S - Sc:], shift, dims=0))

    y = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    if "wo_b" in p:
        y = y + p["wo_b"]
    return y, cache
