"""Plain PyTorch versions of the kernels (twin of ``repro/kernels/ref.py``).

The CPU tests run these, the ``"torch"`` backends run them on any device,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They carry a leading problem axis: ``x`` is ``(..., N, D)``,
``centroids`` ``(..., L, D)``, ``weights`` ``(..., N)``; ``lmask`` is one
``(L,)`` mask shared by every problem (1.0 = valid centroid; None = every
centroid valid), and ``weights`` may be None (every weight 1). The scalar
quantizer and the packers take ``(P, N)`` values or codes, one range or
one stream of words per problem. Flash attention takes the kernel's
``(B·H, S, hd)`` layout, or the strided entry's ``(B, S, H, hd)`` views
(``flash_attention_bshd_ref``). Adafactor's update takes one leaf's gradient in
the reference's layout and its second moment. The SSD scan
(``ssd_scan_ref``, the chunk loop of ``models/ssm.py``'s scan) takes
x (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S, N) and h0. The
MoE's dispatch and combine (``moe_dispatch_ref``, ``moe_combine_ref``)
take one choice at a time, through the dump rows the caller gives.

Assignment is written in the score form the kernels compute,
``argmax_l (2·x·c_l − ‖c_l‖²)`` -- the argmin of ``‖x − c_l‖²`` without
the constant ``‖x‖²`` -- with masked centroids scored ``NEG`` so that they
never win, and ties going to the first index, as ``jnp.argmax`` and
``torch.argmax`` both do.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.backends import opt_einsum
from torch.overrides import has_torch_function
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.ctx import like

NEG = -1e30


def _gather_rows(c: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """c[..., codes[..., i], :] for a (..., L, D) codebook and (..., N) codes."""
    idx = codes.unsqueeze(-1).expand(*codes.shape, c.shape[-1])
    return torch.gather(c, -2, idx)


def _scores(xf: torch.Tensor, centroids: torch.Tensor,
            lmask: Optional[torch.Tensor]) -> torch.Tensor:
    """2·x·c_l − ‖c_l‖² (..., N, L), masked centroids scored NEG."""
    cf = centroids.float()
    scores = 2.0 * (xf @ cf.transpose(-1, -2)) \
        - (cf * cf).sum(-1).unsqueeze(-2)
    if lmask is None:
        return scores
    return torch.where(lmask.to(scores.device) > 0, scores, NEG)


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor,
                      lmask: Optional[torch.Tensor] = None):
    """codes (..., N) int64 + clamped squared distances (..., N) f32."""
    xf = x.float()
    scores = _scores(xf, centroids, lmask)
    codes = scores.argmax(-1)
    best = scores.amax(-1)
    return codes, ((xf * xf).sum(-1) - best).clamp_min(0.0)


def near_ties(x: torch.Tensor, centroids: torch.Tensor,
              lmask: Optional[torch.Tensor] = None,
              rtol: float = 1e-5) -> torch.Tensor:
    """Rows (..., N) whose best two scores differ by <= rtol·(1 + |best|):
    there a kernel's FMA order may pick either code."""
    scores = _scores(x.float(), centroids, lmask)
    top = scores.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) <= rtol * (1 + top[..., 0].abs())


def pq_quantize_ref(x: torch.Tensor, centroids: torch.Tensor,
                    lmask: Optional[torch.Tensor] = None):
    """(z̃ in x.dtype, residual x − z̃ in f32, codes int32)."""
    codes, _ = kmeans_assign_ref(x, centroids, lmask)
    zt = _gather_rows(centroids.float(), codes)
    resid = x.float() - zt
    return zt.to(x.dtype), resid, codes.to(torch.int32)


def scalar_quantize_ref(x: torch.Tensor, lo: torch.Tensor,
                        scale: torch.Tensor, bits: int):
    """Uniform b-bit quantize + dequantize of P problems, each with its own
    range: x (P, N) f32, lo and scale (P,) f32.

    codes = clip(round((x − lo)/scale), 0, 2^b − 1) with half-to-even
    rounding (int32); recon = lo + codes·scale (f32), a multiply and then an
    add, each rounded on its own, as the reference's jnp formula."""
    levels = float((1 << bits) - 1)
    lo_ = lo.float().unsqueeze(-1)
    scale_ = scale.float().unsqueeze(-1)
    codes = torch.round((x.float() - lo_) / scale_).clamp(0.0, levels)
    return codes.to(torch.int32), lo_ + codes * scale_


def _check_pack_bits(bits: int) -> int:
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"packing needs bits in {{1, 2, 4, 8, 16}}, got "
                         f"{bits}")
    return 32 // bits


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack P streams of codes (P, N) at ``bits`` bits each into
    little-endian 32-bit words, code j of a word at bits [j·b, (j+1)·b);
    each stream is padded with 0 to whole words. Returns (P, ⌈N·b/32⌉)
    int32 holding the words' bit patterns. A code keeps its low ``bits``
    bits, as the wire's LSB-first bit stream does."""
    per_word = _check_pack_bits(bits)
    p, n = codes.shape
    words = -(-n // per_word)
    c = F.pad(codes.long() & ((1 << bits) - 1), (0, words * per_word - n))
    shifts = torch.arange(per_word, device=codes.device) * bits
    w = (c.reshape(p, words, per_word) << shifts).sum(-1)   # disjoint bits
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_codes_ref(words: torch.Tensor, count: int,
                     bits: int) -> torch.Tensor:
    """Inverse of ``pack_codes_ref``: (P, W) words -> (P, count) int32."""
    per_word = _check_pack_bits(bits)
    p = words.shape[0]
    shifts = torch.arange(per_word, device=words.device) * bits
    w = words.long() & 0xFFFFFFFF
    codes = (w.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return codes.reshape(p, -1)[:, :count].to(torch.int32)


def lloyd_update_ref(x: torch.Tensor, weights: Optional[torch.Tensor],
                     centroids: torch.Tensor,
                     lmask: Optional[torch.Tensor] = None):
    """One Lloyd iteration's statistics, deviation-accumulated:
    dsums[l] = Σ_i w_i·1[codes_i = l]·(x_i − c_l), counts[l] = Σ_i w_i·1[..]."""
    codes, _ = kmeans_assign_ref(x, centroids, lmask)
    cf = centroids.float()
    onehot = F.one_hot(codes, cf.shape[-2]).float()
    if weights is not None:
        onehot = onehot * weights.float().unsqueeze(-1)
    delta = x.float() - _gather_rows(cf, codes)   # exact 0 on exact cover
    return onehot.transpose(-1, -2) @ delta, onehot.sum(-2)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        num_q_heads: int, num_kv_heads: int, scale: float,
                        window=None) -> torch.Tensor:
    """Causal GQA attention at positions 0..S−1, optionally windowed.

    q (B·H, S, hd), k and v (B·Kv, S, hd); query row bh reads KV row
    ``(bh // H)·Kv + (bh % H) // G`` with G = H / Kv. Scores, softmax and
    P·V are f32 throughout; a score is kept iff qpos ≥ kpos and (window is
    None or qpos − kpos < window), else it is ``NEG``. Returns
    (B·H, S, hd) in ``q.dtype``. Any S: the mask is by index."""
    bh, s, _ = q.shape
    h, kv = num_q_heads, num_kv_heads
    rows = torch.arange(bh, device=q.device)
    kv_rows = (rows // h) * kv + (rows % h) // (h // kv)
    kf, vf = k.float()[kv_rows], v.float()[kv_rows]
    scores = (q.float() @ kf.transpose(-1, -2)) * scale
    pos = torch.arange(s, device=q.device)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep &= (pos[:, None] - pos[None, :]) < window
    scores = torch.where(keep, scores, NEG)
    return (torch.softmax(scores, -1) @ vf).to(q.dtype)


def flash_attention_bshd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float,
                             window=None) -> torch.Tensor:
    """``flash_attention_ref`` on the strided entry's layout: q (B, S, H,
    hd), k and v (B, S, Kv, hd) -> (B, S, H, hd) contiguous, through
    (B·H, S, hd) copies."""
    b, s, h, hd = q.shape
    out = flash_attention_ref(
        *(t.transpose(1, 2).reshape(b * t.shape[2], s, hd)
          for t in (q, k, v)),
        num_q_heads=h, num_kv_heads=k.shape[2], scale=scale, window=window)
    return out.reshape(b, h, s, hd).transpose(1, 2).contiguous()


def adafactor_update_ref(g: torch.Tensor, v: Dict[str, torch.Tensor], *,
                         beta: float, one_minus: float, lr: float,
                         eps: float, clip: float):
    """One leaf's Adafactor update and its new second moment.

    g in the reference's layout, any float dtype; v ``{"row", "col"}`` (a
    leaf of rank >= 2: f32 means of g² + eps over its last and its second
    last dim) or ``{"full"}`` (rank <= 1). Returns (−lr·u in g's dtype,
    the new v), u = g / sqrt(v̂) with its RMS clipped to ``clip``; every
    operation in f32, each rounded once. Under a mesh g and v may be
    DTensors: a factor's partial means are reduced into its state's layout
    (else DTensor may build the outer product below gathered)."""
    g32 = g.float()
    g2 = g32.square() + eps
    if "full" in v:
        vn = beta * v["full"] + one_minus * g2
        rms = vn.sqrt()
        new = {"full": vn}
    else:
        row = like(beta * v["row"] + one_minus * g2.mean(-1), v["row"])
        col = like(beta * v["col"] + one_minus * g2.mean(-2), v["col"])
        mean = row.mean(-1, keepdim=True)[..., None]
        rms = (row[..., None] * col[..., None, :]
               / mean.clamp_min(eps)).sqrt()
        new = {"row": row, "col": col}
    u = g32 / rms.clamp_min(eps)
    urms = (u.square().mean() + eps).sqrt()
    u = u / (urms / clip).clamp_min(1.0)
    return (u * -lr).to(g.dtype), new


# ---------------------------------------------------------------------------
# the SSD scan


@functools.lru_cache(maxsize=256)
def _path(equation: str, shapes: tuple) -> list:
    """opt_einsum's contraction path of ``equation`` at ``shapes``,
    flattened as ``torch.einsum`` hands it to the contraction."""
    pairs = opt_einsum.get_opt_einsum().contract_path(
        equation, *shapes, optimize=opt_einsum.strategy, shapes=True)[0]
    return [i for pair in pairs for i in pair]


def cached_einsum(equation: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``, with opt_einsum's path for three operands or more
    looked up once a set of shapes and not worked out on every call (some
    200 us of host time a call, three calls a chunk, which left the card
    waiting in the chunk loop): the same contraction, op for op."""
    if len(ops) <= 2 or not opt_einsum.enabled \
            or not opt_einsum.is_available() or has_torch_function(ops):
        return torch.einsum(equation, *ops)
    path = _path(equation, tuple(tuple(t.shape) for t in ops))
    return torch._VF.einsum(equation, ops, path=path)


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
    total decay. The decay is computed in dt's dtype and cast to the
    stream's for the products (no cast where the two are one)."""
    stream = x_c.dtype
    dA_c = dt_c * A                                     # (B,Cs,H), <= 0
    xdt_c = (x_c * dt_c[..., None]).to(stream)          # (B,Cs,H,P)
    L = _segsum_decay(dA_c).to(stream)                  # (B,H,Cs,Cs)
    CB = torch.einsum("bin,bjn->bij", C_c, B_c)         # (B,Cs,Cs)
    y_intra = cached_einsum("bij,bhij,bjhp->bihp", CB, L, xdt_c)
    cum = dA_c.cumsum(1)                                # (B,Cs,H)
    decay_end = torch.exp(cum[:, -1:, :] - cum).to(stream)  # (B,Cs,H)
    state = cached_einsum("bjn,bjh,bjhp->bhpn", B_c, decay_end, xdt_c)
    decay_in = torch.exp(cum).to(stream)                # (B,Cs,H)
    chunk_decay = torch.exp(cum[:, -1, :])              # (B,H)
    return y_intra, state, decay_in, chunk_decay


def ssd_chunk_len(S: int, chunk: int) -> int:
    """The plain version's chunk length: ``chunk``, or S where the chunk
    does not divide the sequence (one chunk)."""
    Cs = min(chunk, S)
    return Cs if S % Cs == 0 else S


def ssd_scan_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD as eager PyTorch (``models/ssm.ssd_scan``'s
    arguments and result), the plain route of ``ops.ssd_scan``. Under
    autograd each chunk's statistics are rematerialized in the backward
    pass, so only the raw inputs and the carried states stay alive across
    the scan."""
    B, S, H, P = xh.shape
    Cs = ssd_chunk_len(S, chunk)
    h = torch.zeros((B, H, P, Bm.shape[-1]), dtype=dt.dtype,
                    device=xh.device) if h0 is None else h0
    remat = torch.is_grad_enabled()
    ys = []
    for c0 in range(0, S, Cs):
        inp = (xh[:, c0:c0 + Cs], dt[:, c0:c0 + Cs], Bm[:, c0:c0 + Cs],
               Cm[:, c0:c0 + Cs], A)
        y_intra, state, decay_in, chunk_decay = \
            checkpoint(_chunk_stats, *inp, use_reentrant=False) \
            if remat else _chunk_stats(*inp)
        y_inter = cached_einsum("bin,bhpn,bih->bihp", inp[3],
                                h.to(y_intra.dtype), decay_in)
        h = chunk_decay[:, :, None, None] * h + state.to(h.dtype)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def moe_dispatch_ref(xg: torch.Tensor, dest: torch.Tensor, held: int,
                     capacity: int, dump: int) -> torch.Tensor:
    """The expert buffer (G, held, capacity, D) of x (G, Ng, D): the plain
    route of ``ops.moe_dispatch``. Each choice is one indexed assignment
    of the whole group into a zero-filled buffer of held·capacity slots
    and ``dump`` dump rows (every kept destination is unique, so no sum
    over an atomic ``index_add_`` whose order could vary); the dump rows,
    where the dropped pairs went, are cut off."""
    G, _, D = xg.shape
    g = torch.arange(G, device=xg.device)[:, None]
    buf = xg.new_zeros((G, held * capacity + dump, D))
    for j in range(dest.shape[-1]):   # one choice at a time: no (Ng·k, D)
        buf.index_put_((g, dest[:, :, j]), xg)
    return buf[:, :-dump].reshape(G, held, capacity, D)


def moe_combine_ref(out_buf: torch.Tensor, dest: torch.Tensor,
                    gate_w: torch.Tensor, keep: torch.Tensor,
                    dump: int) -> torch.Tensor:
    """y (G, Ng, D) from the experts' output (G, H, C, D): the plain route
    of ``ops.moe_combine``, one gather a choice from the output padded
    with ``dump`` zero rows, each weighted by its gate (0 where dropped)
    in the output's dtype and added in choice order."""
    Gl, H, C, D = out_buf.shape
    g = torch.arange(Gl, device=out_buf.device)[:, None]
    padded = torch.cat([out_buf.reshape(Gl, H * C, D),
                        out_buf.new_zeros((Gl, dump, D))], dim=1)
    y = out_buf.new_zeros((Gl, dest.shape[1], D))
    for j in range(dest.shape[-1]):    # one gather per choice
        wj = (gate_w[:, :, j] * keep[:, :, j]).to(out_buf.dtype)
        y = y + padded[g, dest[:, :, j]] * wj[:, :, None]
    return y
