"""FedLite's grouped product quantizer, plainly (paper §4.1).

Each client's (n, d) cut is cut into q subvectors of d/q values; group r
holds the subvector positions [r·q/R, (r+1)·q/R) of all n vectors,
position-major, and each group is clustered into L centroids by Lloyd's
algorithm from farthest-point seeds on a strided subsample of its rows
(min(rows, max(4·L, 256)) rows, every (rows // that)-th), the next seed
the first row farthest from the seeds so far. An iteration assigns every
row to its nearest centroid (the first on a tie) and moves each centroid
by the mean deviation of its rows; a centroid with no rows stays. The
message is the codebooks and one code per subvector.

Distances are taken in the score form ``2·x·c − ‖c‖²`` (the nearest
centroid has the largest score), as the paper's reference implementation
writes them, in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

ROWS = 1 << 16


def nearest(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x (P, N, D), c (P, L, D) -> codes (P, N): the nearest centroid,
    the first on a tie, in blocks of rows."""
    cf = c.float()
    sq = (cf * cf).sum(-1)[:, None, :]
    out = []
    for i in range(0, x.shape[1], ROWS):
        scores = 2.0 * (x[:, i:i + ROWS].float() @ cf.transpose(1, 2)) - sq
        out.append(scores.argmax(-1))
    return torch.cat(out, 1)


def gather(c: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return torch.gather(c, 1, codes[..., None].expand(*codes.shape,
                                                      c.shape[-1]))


def fps_seeds(x: torch.Tensor, num_clusters: int) -> torch.Tensor:
    p, n, d = x.shape
    m = min(n, max(4 * num_clusters, 256))
    xs = x[:, ::max(n // m, 1)][:, :m].float()
    rows = torch.arange(p, device=x.device)
    cents = torch.zeros((p, num_clusters, d), device=x.device)
    cents[:, 0] = xs[:, 0]
    mind = (xs - xs[:, :1]).square().sum(-1)
    for l in range(1, num_clusters):
        c = xs[rows, mind.argmax(-1)]
        cents[:, l] = c
        mind = torch.minimum(mind, (xs - c[:, None]).square().sum(-1))
    return cents


def lloyd(x: torch.Tensor, num_clusters: int, iters: int) -> torch.Tensor:
    """f32 centroids (P, L, D) of the rows x (P, N, D)."""
    c = fps_seeds(x, num_clusters)
    for _ in range(iters):
        codes = nearest(x, c)
        dev = torch.zeros_like(c)
        cnt = torch.zeros(c.shape[:2], device=x.device)
        for i in range(0, x.shape[1], ROWS):
            cb = codes[:, i:i + ROWS]
            onehot = torch.nn.functional.one_hot(cb, num_clusters).float()
            delta = x[:, i:i + ROWS].float() - gather(c, cb)
            dev += onehot.transpose(1, 2) @ delta
            cnt += onehot.sum(1)
        c = c + torch.where(cnt[..., None] > 0,
                            dev / cnt.clamp_min(1.0)[..., None], 0.0)
    return c


def to_groups(z: torch.Tensor, q: int, r: int) -> torch.Tensor:
    """(C, n, d) -> (C·R, (q/R)·n, d/q), position-major."""
    c, n, d = z.shape
    sub = z.reshape(c, n, q, d // q).transpose(1, 2)
    return sub.reshape(c * r, (q // r) * n, d // q)


def from_groups(g: torch.Tensor, c: int, n: int, d: int, q: int):
    return g.reshape(c, q, n, d // q).transpose(1, 2).reshape(c, n, d)


def quantize(z: torch.Tensor, q: int, num_clusters: int, iters: int,
             groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """z (C, n, d), one client a row -> (z̃ in f32, codes (C·R, rows),
    codebooks (C·R, L, d/q))."""
    c, n, d = z.shape
    x = to_groups(z.detach().float(), q, groups)
    cents = lloyd(x, num_clusters, iters)
    codes = nearest(x, cents)
    zt = from_groups(gather(cents, codes), c, n, d, q)
    return zt, codes, cents


class Corrected(torch.autograd.Function):
    """z̃ forward; the backward adds λ·(z − z̃) to the incoming gradient
    (paper eq. 5)."""

    @staticmethod
    def forward(ctx, z, zt, lam):
        ctx.save_for_backward(z - zt)
        ctx.lam = lam
        return zt.clone()

    @staticmethod
    def backward(ctx, g):
        (resid,) = ctx.saved_tensors
        return g + ctx.lam * resid, None, None


def wire_bytes(n: int, d: int, q: int, groups: int, num_clusters: int,
               value_bytes: int = 2) -> int:
    """Bytes of one client's pq frame: a 24-byte header, the codebooks at
    ``value_bytes`` a value, the codes packed at ceil(log2 L) bits (whole
    bytes), a 4-byte CRC."""
    bits = 0 if num_clusters <= 1 else max((num_clusters - 1).bit_length(), 1)
    codes = (n * q * bits + 7) // 8
    return 24 + groups * num_clusters * (d // q) * value_bytes + codes + 4


def codes_off(x: torch.Tensor, cents: torch.Tensor, codes: torch.Tensor,
              rtol: float = 1e-5) -> int:
    """How many rows of x (P, N, D) hold a code whose centroid is not the
    nearest, beyond a tie: its score 2·x·c − ‖c‖² (in f64) under the
    best by more than ``rtol``·(1 + |best|)."""
    c = cents.double()
    sq = (c * c).sum(-1)[:, None, :]
    off = 0
    for i in range(0, x.shape[1], ROWS):
        s = 2.0 * (x[:, i:i + ROWS].double() @ c.transpose(1, 2)) - sq
        best = s.amax(-1)
        got = s.gather(-1, codes[:, i:i + ROWS, None].long())[..., 0]
        off += int((best - got > rtol * (1 + best.abs())).sum())
    return off


def against_own_lloyd(x: torch.Tensor, cents: torch.Tensor,
                      codes: torch.Tensor, num_clusters: int,
                      iters: int) -> dict:
    """A quantizer's centroids (P, L, D) and codes (P, N) of the rows x
    against this module's own seeding and Lloyd run on the same rows.

    A near-tie in an assignment may go either way in f32; one that flips
    moves its centroids a little, and the iterations after carry that on.
    So the rows whose code differs from the nearest of the own centroids
    are counted (``rows_differ`` of ``rows``), and the centroids are held
    to the own ones (``centroid_gap``: the largest difference over the
    rows' RMS) in the problems where no row's code differs
    (``problems_agree`` of ``problems``)."""
    own = lloyd(x, num_clusters, iters)
    own_codes = nearest(x, own)
    differ = (own_codes != codes.long()).sum(-1)
    rms = x.float().square().mean((-2, -1)).sqrt().clamp_min(1e-30)
    gap = (cents.float() - own).abs().amax((-2, -1)) / rms
    agree = differ == 0
    return {"rows_differ": int(differ.sum()), "rows": int(codes.numel()),
            "problems_agree": int(agree.sum()), "problems": int(len(agree)),
            "centroid_gap": float(gap[agree].max()) if bool(agree.any())
            else 0.0}


def cast_off(codebooks: torch.Tensor, cents: torch.Tensor,
             dtype: torch.dtype) -> int:
    """How many codebook values are not the centroids' cast to ``dtype``
    (the cut's): a quantizer ships its Lloyd run's centroids."""
    return int((codebooks.float() != cents.to(dtype).float()).sum())
