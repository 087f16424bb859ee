"""Parity of the PyTorch port's kernel layer with the JAX package.

The port's kernel wrappers compute their plain versions on CPU tensors;
these tests hold them to the JAX reference oracles (``repro.kernels.ref``)
and to the Pallas kernels run in interpret mode (``repro.kernels.ops`` with
``interpret=True``), padding and centroid masking included. Inputs come
from a numpy seed and cross between the packages as numpy arrays. Every
problem of the port's leading problem axis is checked against one JAX call.

The CUDA kernels themselves run only on a card: ``test_torch_gpu.py``.
"""

import ast
import ctypes
import ctypes.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated.wire import _pack_codes as wire_pack_codes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash_kernel
from repro.models.attention import row_block_attention as jrow_block
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scalar_quant as tsq
from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                 flash_attention_kernel,
                                                 flash_route)
from repro_torch.models import attention as tattn
from repro_torch.kernels.kmeans_assign import (assign_route,
                                               kmeans_assign_kernel)
from repro_torch.kernels.lloyd_update import (Layout, d8_blocks,
                                              lloyd_update_in_kernel_order,
                                              lloyd_update_kernel, row_route)
from repro_torch.kernels import lloyd_update as tlu
from repro_torch.kernels.pq_quantize import pq_quantize_kernel, pq_route
from repro_torch.kernels.scalar_quant import (pack_codes_kernel,
                                              scalar_quantize_kernel,
                                              scalar_route,
                                              unpack_codes_kernel)

REPO_ROOT = Path(__file__).resolve().parents[1]


def _inputs(seed, p, n, d, l):
    r = np.random.default_rng(seed)
    x = r.standard_normal((p, n, d)).astype(np.float32)
    c = r.standard_normal((p, l, d)).astype(np.float32)
    return x, c


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# lloyd_update
# ---------------------------------------------------------------------------

# n=513: a ragged tail; l=5: a codebook padded to 8 and masked
@pytest.mark.parametrize("n,d,l", [(64, 8, 4), (513, 8, 5), (128, 16, 16)])
def test_lloyd_update_matches_jax(n, d, l):
    x, c = _inputs(n, 2, n, d, l)
    w = np.ones((2, n), np.float32)
    ds, ct = tops.lloyd_update(_t(x), _t(c), _t(w))
    for p in range(2):
        ds_k, ct_k = jops.lloyd_update(jnp.asarray(x[p]), jnp.asarray(c[p]),
                                       jnp.asarray(w[p]), block_n=64,
                                       interpret=True)
        ds_r, ct_r = jref.lloyd_update_ref(jnp.asarray(x[p]),
                                           jnp.asarray(w[p]),
                                           jnp.asarray(c[p]), jnp.ones(l))
        for ref_ds, ref_ct in ((ds_k, ct_k), (ds_r, ct_r)):
            np.testing.assert_allclose(ds[p].numpy(), np.asarray(ref_ds),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(ct[p].numpy(), np.asarray(ref_ct))


def test_lloyd_update_lmask_matches_jax_ref():
    """Masked centroids never win and report count 0, even when they are
    the nearest ones (here they sit on the data)."""
    x, c = _inputs(7, 1, 96, 8, 8)
    c[0, 3:] = x[0, :5]
    lmask = np.array([1, 1, 1, 0, 0, 0, 0, 0], np.float32)
    w = np.ones((1, 96), np.float32)
    ds, ct = tref.lloyd_update_ref(_t(x), _t(w), _t(c), _t(lmask))
    ds_j, ct_j = jops.lloyd_update(jnp.asarray(x[0]), jnp.asarray(c[0, :3]),
                                   interpret=True)
    ds_r, ct_r = jref.lloyd_update_ref(jnp.asarray(x[0]), jnp.asarray(w[0]),
                                       jnp.asarray(c[0]), jnp.asarray(lmask))
    np.testing.assert_array_equal(ct[0, 3:].numpy(), 0.0)
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(ct_r))
    np.testing.assert_array_equal(ct[0, :3].numpy(), np.asarray(ct_j))
    np.testing.assert_allclose(ds[0].numpy(), np.asarray(ds_r),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ds[0, :3].numpy(), np.asarray(ds_j),
                               rtol=1e-5, atol=1e-5)


def test_lloyd_update_zero_weight_rows_contribute_nothing():
    x, c = _inputs(3, 1, 32, 8, 4)
    w = np.concatenate([np.ones(16), np.zeros(16)]).astype(np.float32)[None]
    ds, ct = tops.lloyd_update(_t(x), _t(c), _t(w))
    ds_r, ct_r = jref.lloyd_update_ref(jnp.asarray(x[0, :16]), jnp.ones(16),
                                       jnp.asarray(c[0]), jnp.ones(4))
    np.testing.assert_allclose(ds[0].numpy(), np.asarray(ds_r),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(ct_r))


@pytest.mark.parametrize("n,route,rows,blocks,threads", [
    (300, "d8", 64, 2, 32),        # three sweeps of the grid, a ragged one
    (64, "generic", 1024, 1, 0),   # one block larger than the problem
    (1037, "d8", 256, 3, 128),     # the kernel's tile, 2 rows a thread
    (300, "generic", 256, 2, 0),
])
def test_lloyd_update_in_kernel_order_matches_jax_ref(n, route, rows,
                                                      blocks, threads):
    """The plain version in a kernel route's summation order: counts
    exact, dsums to f32 reordering of the JAX oracle, padding rows add
    nothing."""
    x, c = _inputs(n + 2, 2, n, 8, 3)
    cp, lmask = tops._pad_centroids(_t(c))
    w = (torch.arange(n) < n - 7).float().expand(2, -1)
    ds, ct = lloyd_update_in_kernel_order(
        _t(x), w, cp, lmask, Layout(route, rows, blocks, threads))
    for p in range(2):
        ds_r, ct_r = jref.lloyd_update_ref(
            jnp.asarray(x[p]), jnp.asarray(w[p].numpy()),
            jnp.asarray(cp[p].numpy()), jnp.asarray(lmask.numpy()))
        np.testing.assert_array_equal(ct[p].numpy(), np.asarray(ct_r))
        np.testing.assert_allclose(ds[p].numpy(), np.asarray(ds_r),
                                   rtol=1e-5, atol=1e-5)


def _d8_order_by_hand(x, c, rows, blocks, threads):
    """The d8 route's sums written out one f32 addition at a time (numpy
    scalars), as csrc/lloyd_update.cu's lloyd_d8 and lloyd_reduce add
    them: block b takes tiles b, b + blocks, ... of ``rows`` rows, thread
    t rows t, t + threads, ... of each tile, in row order; then the lanes
    by an xor tree, the warps in warp order, the blocks in block order."""
    f32 = np.float32
    p, n, d = x.shape
    l = c.shape[1]
    scores = 2 * np.einsum("pnd,pld->pnl", x.astype(np.float64),
                           c.astype(np.float64)) - (c.astype(np.float64)
                                                    ** 2).sum(-1)[:, None]
    codes = scores.argmax(-1)
    out = np.zeros((p, l, d + 1), f32)
    g = rows * blocks
    for q in range(p):
        total = np.zeros((l, d + 1), f32)
        for b in range(blocks):
            lanes = np.zeros((threads, l, d + 1), f32)
            for t in range(threads):
                for tile in range(b * rows, n, g):
                    for i in range(tile + t, min(tile + rows, n), threads):
                        k = codes[q, i]
                        lanes[t, k, :d] = lanes[t, k, :d] \
                            + (x[q, i] - c[q, k])
                        lanes[t, k, d] = lanes[t, k, d] + f32(1)
            warps = lanes.reshape(threads // 32, 32, l, d + 1)
            for off in (16, 8, 4, 2, 1):
                warps = warps + warps[:, np.arange(32) ^ off]
            part = warps[0, 0]
            for wi in range(1, threads // 32):
                part = part + warps[wi, 0]
            total = total + part
        out[q] = total
    return out[..., :d], out[..., d]


def test_lloyd_update_in_kernel_order_is_the_d8_order_by_hand():
    """The vectorised d8 order is bitwise the additions written out one by
    one; unweighted is bitwise all-ones weights."""
    x, c = _inputs(17, 2, 333, 8, 4)
    ds_h, ct_h = _d8_order_by_hand(x, c, 128, 2, 64)
    lay = Layout("d8", 128, 2, 64)
    ds, ct = lloyd_update_in_kernel_order(_t(x), None, _t(c), None, lay)
    ds1, ct1 = lloyd_update_in_kernel_order(_t(x), torch.ones(2, 333),
                                            _t(c), torch.ones(4), lay)
    np.testing.assert_array_equal(ds.numpy(), ds_h)
    np.testing.assert_array_equal(ct.numpy(), ct_h)
    assert torch.equal(ds, ds1) and torch.equal(ct, ct1)


def test_lloyd_update_unweighted_is_all_ones_weights():
    x, c = _inputs(19, 3, 257, 8, 5)
    ds, ct = tops.lloyd_update(_t(x), _t(c))
    ds1, ct1 = tops.lloyd_update(_t(x), _t(c), torch.ones(3, 257))
    assert torch.equal(ds, ds1) and torch.equal(ct, ct1)
    ds_k, ct_k = lloyd_update_kernel(_t(x), None, _t(c))
    assert torch.equal(ds, ds_k) and torch.equal(ct, ct_k)


def _bf16_inputs(seed, p, n, d, l):
    """x rounded to bf16 (torch and jax both round to nearest even) and its
    exact f32 upcast, with f32 centroids."""
    x, c = _inputs(seed, p, n, d, l)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return xb, xb.float().numpy(), c


@pytest.mark.parametrize("n,l", [(200, 2), (513, 16)])
def test_lloyd_update_bf16_matches_jax(n, l):
    """The plain version on a bf16 x against the Pallas kernel (interpret
    mode) on the same bf16 values: counts exact, dsums to f32 rounding;
    and bitwise the plain version on the f32 upcast."""
    xb, xf, c = _bf16_inputs(n + l, 2, n, 8, l)
    ds, ct = tops.lloyd_update(xb, _t(c))
    ds_f, ct_f = tops.lloyd_update(_t(xf), _t(c))
    assert torch.equal(ds, ds_f) and torch.equal(ct, ct_f)
    for p in range(2):
        xj = jnp.asarray(xf[p]).astype(jnp.bfloat16)
        ds_k, ct_k = jops.lloyd_update(xj, jnp.asarray(c[p]), block_n=64,
                                       interpret=True)
        np.testing.assert_array_equal(ct[p].numpy(), np.asarray(ct_k))
        np.testing.assert_allclose(ds[p].numpy(), np.asarray(ds_k),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,l", [(200, 2), (513, 16)])
def test_pq_quantize_bf16_matches_jax(n, l):
    """The plain version on a bf16 x against the Pallas kernel (interpret
    mode): codes equal, z̃ in bf16 equal, the f32 residual equal; z̃ is the
    f32 encode's z̃ rounded to bf16, the residual that encode's residual."""
    xb, xf, c = _bf16_inputs(n + 2 * l, 2, n, 8, l)
    zt, resid, codes = tops.pq_quantize(xb, _t(c))
    zt_f, resid_f, codes_f = tops.pq_quantize(_t(xf), _t(c))
    assert zt.dtype == torch.bfloat16 and resid.dtype == torch.float32
    assert torch.equal(codes, codes_f)
    assert torch.equal(zt, zt_f.to(torch.bfloat16))
    assert torch.equal(resid, resid_f)
    for p in range(2):
        xj = jnp.asarray(xf[p]).astype(jnp.bfloat16)
        zt_k, resid_k, codes_k = jops.pq_quantize(xj, jnp.asarray(c[p]),
                                                  block_n=64, interpret=True)
        assert zt_k.dtype == jnp.bfloat16
        np.testing.assert_array_equal(codes[p].numpy(), np.asarray(codes_k))
        np.testing.assert_array_equal(
            zt[p].float().numpy(), np.asarray(zt_k.astype(jnp.float32)))
        np.testing.assert_allclose(resid[p].numpy(), np.asarray(resid_k),
                                   rtol=1e-6, atol=1e-6)


def test_row_route_and_d8_grid():
    """d8 for rows of 8, L in D8_L and a 16-byte-aligned x; generic for
    another D or L and for a misaligned view."""
    x = torch.zeros(2, 64, 8)
    assert [row_route(x, l) for l in (2, 4, 8, 16)] == ["d8"] * 4
    assert row_route(x, 3) == "generic" and row_route(x, 32) == "generic"
    assert row_route(torch.zeros(2, 64, 16), 4) == "generic"
    view = torch.zeros(2 * 64 * 8 + 1)[1:].view(2, 64, 8)
    assert view.is_contiguous() and row_route(view, 4) == "generic"
    # the card's resident blocks shared among the problems, no fewer than
    # min_tiles tiles a block where the problem has them, at least one
    assert d8_blocks(4, 1 << 20, 132, 2, 512, 2) == 66
    assert d8_blocks(10, 23040, 132, 4, 512, 2) == 23   # 45 tiles, 2 a block
    assert d8_blocks(10, 23040, 132, 7, 256, 8) == 12   # 90 tiles, 8 a block
    assert d8_blocks(10, 300, 132, 4, 256, 2) == 1      # 2 tiles
    assert d8_blocks(200, 5000, 132, 1, 512, 2) == 1
    assert d8_blocks(1, 0, 132, 4, 512, 2) == 1


def test_ops_pass_the_codebook_unpadded_and_no_weights(monkeypatch):
    """The k-means wrappers hand the kernels the codebook as it is, with no
    mask, and lloyd_update no weights unless given; x keeps its dtype."""
    seen = {}

    def record(name, result):
        def fn(*args):
            seen[name] = args
            return result(*args)
        return fn

    monkeypatch.setattr(tops, "lloyd_update_kernel",
                        record("lloyd", lloyd_update_kernel))
    monkeypatch.setattr(tops, "pq_quantize_kernel",
                        record("pq", pq_quantize_kernel))
    monkeypatch.setattr(tops, "kmeans_assign_kernel",
                        record("assign", kmeans_assign_kernel))
    x, c = _inputs(23, 2, 50, 8, 3)
    xb = _t(x).to(torch.bfloat16)
    tops.lloyd_update(xb, _t(c))
    tops.pq_quantize(xb, _t(c))
    tops.kmeans_assign(_t(x), _t(c))
    xa, wa, ca, *rest = seen["lloyd"]
    assert xa.dtype == torch.bfloat16 and wa is None and rest == []
    assert ca.shape == (2, 3, 8)
    xa, ca = seen["pq"]
    assert xa.dtype == torch.bfloat16 and ca.shape == (2, 3, 8)
    assert seen["assign"][1].shape == (2, 3, 8) and len(seen["assign"]) == 2


def test_near_ties_flags_equal_scores_only():
    x = np.zeros((1, 2, 8), np.float32)
    x[0, 1, 0] = 1.0
    c = np.zeros((1, 2, 8), np.float32)
    c[0, 1, 0] = 1e-3
    # row 0: scores 0 and -1e-6 (a near-tie); row 1: 0 and 2e-3 - 1e-6
    ties = tref.near_ties(_t(x), _t(c), torch.ones(2))
    np.testing.assert_array_equal(ties.numpy(), [[True, False]])
    masked = tref.near_ties(_t(x), _t(c), torch.tensor([1.0, 0.0]))
    np.testing.assert_array_equal(masked.numpy(), [[False, False]])


def test_lloyd_update_fixed_points_exact():
    """Exact cover gives dsums of exactly 0; an empty cluster count 0."""
    row = np.random.default_rng(4).standard_normal((1, 8)).astype(np.float32)
    x = np.tile(row, (16, 1))[None]
    c = np.concatenate([row, row + 100.0])[None]
    ds, ct = tops.lloyd_update(_t(x), _t(c))
    assert float(ds.abs().max()) == 0.0
    np.testing.assert_array_equal(ct[0].numpy(), [16.0, 0.0])


# ---------------------------------------------------------------------------
# pq_quantize and kmeans_assign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [65, 96, 128])
def test_clustering_kernels_above_one_chunk_of_dims_match_jax(d,
                                                             monkeypatch):
    """Above ``D_TILE`` dims (the CUDA sources' kDTile, a chunk of dims)
    the routes are chosen as below it, by L alone (generic up to the
    card's threshold, an H100's 89 standing in for it, tiled above;
    pq_quantize and kmeans_assign generic); the wrappers' plain versions
    match the Pallas kernels in interpret mode at that D."""
    src = (Path(tlu.__file__).parents[1] / "csrc" / "assign.cuh").read_text()
    assert re.search(r"constexpr int kDTile = (\d+);", src)[1] \
        == str(tlu.D_TILE)
    monkeypatch.setattr(tlu, "generic_max_l", lambda device: 89)
    x, c = _inputs(d, 2, 150, d, 3)
    assert row_route(_t(x), 3) == row_route(_t(x), 89) == "generic"
    assert row_route(_t(x), 90) == "tiled"
    assert pq_route(_t(x), 3) == assign_route(_t(x), 3, None) == "generic"
    ds, ct = tops.lloyd_update(_t(x), _t(c))
    zt, resid, codes = tops.pq_quantize(_t(x), _t(c))
    ka, sq = tops.kmeans_assign(_t(x), _t(c))
    for p in range(2):
        xj, cj = jnp.asarray(x[p]), jnp.asarray(c[p])
        ds_k, ct_k = jops.lloyd_update(xj, cj, block_n=64, interpret=True)
        np.testing.assert_allclose(ds[p].numpy(), np.asarray(ds_k),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(ct[p].numpy(), np.asarray(ct_k))
        zt_k, resid_k, codes_k = jops.pq_quantize(xj, cj, block_n=64,
                                                  interpret=True)
        np.testing.assert_array_equal(codes[p].numpy(), np.asarray(codes_k))
        np.testing.assert_allclose(zt[p].numpy(), np.asarray(zt_k),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(resid[p].numpy(), np.asarray(resid_k),
                                   rtol=1e-6, atol=1e-5)
        ka_k, sq_k = jops.kmeans_assign(xj, cj, block_n=64, interpret=True)
        np.testing.assert_array_equal(ka[p].numpy(), np.asarray(ka_k))
        tol = 1e-5 * (1 + (x[p] ** 2).sum(-1))
        assert (np.abs(sq[p].numpy() - np.asarray(sq_k)) <= tol).all()


@pytest.mark.parametrize("n,d,l", [(64, 8, 4), (513, 8, 5), (128, 16, 16)])
def test_pq_quantize_matches_jax(n, d, l):
    x, c = _inputs(n + 1, 2, n, d, l)
    zt, resid, codes = tops.pq_quantize(_t(x), _t(c))
    assert codes.dtype == torch.int32 and zt.dtype == torch.float32
    for p in range(2):
        zt_k, resid_k, codes_k = jops.pq_quantize(
            jnp.asarray(x[p]), jnp.asarray(c[p]), block_n=64, interpret=True)
        zt_r, resid_r, codes_r = jref.pq_quantize_ref(
            jnp.asarray(x[p]), jnp.asarray(c[p]), jnp.ones(l))
        for z_j, r_j, k_j in ((zt_k, resid_k, codes_k),
                              (zt_r, resid_r, codes_r)):
            np.testing.assert_array_equal(codes[p].numpy(), np.asarray(k_j))
            np.testing.assert_allclose(zt[p].numpy(), np.asarray(z_j),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(resid[p].numpy(), np.asarray(r_j),
                                       rtol=1e-6, atol=1e-6)


def test_pq_quantize_lmask_matches_jax_ref():
    x, c = _inputs(9, 1, 64, 8, 8)
    c[0, 2:] = x[0, :6]                      # masked, yet nearest to some rows
    lmask = np.array([1, 1, 0, 0, 0, 0, 0, 0], np.float32)
    zt, resid, codes = tref.pq_quantize_ref(_t(x), _t(c), _t(lmask))
    zt_r, resid_r, codes_r = jref.pq_quantize_ref(
        jnp.asarray(x[0]), jnp.asarray(c[0]), jnp.asarray(lmask))
    assert int(codes.max()) <= 1
    np.testing.assert_array_equal(codes[0].numpy(), np.asarray(codes_r))
    np.testing.assert_array_equal(zt[0].numpy(), np.asarray(zt_r))
    np.testing.assert_allclose(resid[0].numpy(), np.asarray(resid_r),
                               rtol=1e-6, atol=1e-6)


def test_kmeans_assign_ref_matches_jax():
    x, c = _inputs(11, 1, 200, 8, 6)
    lmask = np.array([1, 1, 1, 1, 0, 1], np.float32)
    codes, sq = tref.kmeans_assign_ref(_t(x), _t(c), _t(lmask))
    codes_r, sq_r = jref.kmeans_assign_ref(jnp.asarray(x[0]),
                                           jnp.asarray(c[0]),
                                           jnp.asarray(lmask))
    np.testing.assert_array_equal(codes[0].numpy(), np.asarray(codes_r))
    np.testing.assert_allclose(sq[0].numpy(), np.asarray(sq_r),
                               rtol=1e-5, atol=1e-5)


def test_ties_go_to_the_first_index():
    x = np.zeros((1, 4, 8), np.float32)
    c = np.zeros((1, 3, 8), np.float32)          # three identical centroids
    _, _, codes = tops.pq_quantize(_t(x), _t(c))
    np.testing.assert_array_equal(codes.numpy(), 0)


def test_pad_centroids_masks_the_padding():
    c = torch.ones((2, 3, 8))
    cp, lmask = tops._pad_centroids(c)
    assert cp.shape == (2, 8, 8) and cp.is_contiguous()
    np.testing.assert_array_equal(lmask.numpy(), [1, 1, 1, 0, 0, 0, 0, 0])
    assert float(cp[:, 3:].abs().max()) == 0.0


# (n, l): a ragged N against JAX's 64-row blocks; L=3 padded to 8, masked
@pytest.mark.parametrize("n,l", [(200, 2), (301, 3), (64, 16)])
def test_kmeans_assign_matches_jax(n, l):
    """Codes equal but for near-ties (none at these inputs); squared
    distances within 1e-5·(1 + ‖x‖²), the f32 rounding of ‖x‖² − best."""
    x, c = _inputs(n + l, 2, n, 8, l)
    codes, sq = tops.kmeans_assign(_t(x), _t(c))
    assert codes.dtype == torch.int32 and sq.dtype == torch.float32
    cp, lmask = tops._pad_centroids(_t(c))
    assert not bool(tref.near_ties(_t(x), cp, lmask).any())
    for p in range(2):
        codes_k, sq_k = jops.kmeans_assign(jnp.asarray(x[p]),
                                           jnp.asarray(c[p]), block_n=64,
                                           interpret=True)
        np.testing.assert_array_equal(codes[p].numpy(), np.asarray(codes_k))
        tol = 1e-5 * (1 + (x[p] ** 2).sum(-1))
        assert (np.abs(sq[p].numpy() - np.asarray(sq_k)) <= tol).all()


@pytest.mark.parametrize("n,l", [(200, 2), (301, 3), (513, 16)])
def test_kmeans_assign_bf16_matches_jax(n, l):
    """A bf16 x against the Pallas kernel (interpret mode) on the same bf16
    values: codes equal (no near-ties at these inputs), distances within
    1e-5·(1 + ‖x‖²); and bitwise the port on the f32 upcast."""
    xb, xf, c = _bf16_inputs(n + 3 * l, 2, n, 8, l)
    codes, sq = tops.kmeans_assign(xb, _t(c))
    codes_f, sq_f = tops.kmeans_assign(_t(xf), _t(c))
    assert torch.equal(codes, codes_f) and torch.equal(sq, sq_f)
    assert not bool(tref.near_ties(_t(xf), _t(c)).any())
    for p in range(2):
        codes_k, sq_k = jops.kmeans_assign(
            jnp.asarray(xf[p]).astype(jnp.bfloat16), jnp.asarray(c[p]),
            block_n=64, interpret=True)
        np.testing.assert_array_equal(codes[p].numpy(), np.asarray(codes_k))
        tol = 1e-5 * (1 + (xf[p] ** 2).sum(-1))
        assert (np.abs(sq[p].numpy() - np.asarray(sq_k)) <= tol).all()


def test_assign_and_scalar_routes():
    """kmeans_assign: d8 where no mask is given and row_route says d8,
    generic for a mask, another D or L, or a misaligned view.
    scalar_quantize: vec where x's address is a multiple of 4·itemsize and
    N of 4 (4-value loads), scalar otherwise."""
    x = torch.zeros(2, 64, 8)
    assert [assign_route(x, l, None) for l in (2, 4, 8, 16)] == ["d8"] * 4
    assert assign_route(x, 2, torch.ones(2)) == "generic"
    assert assign_route(x, 3, None) == "generic"
    assert assign_route(torch.zeros(2, 64, 16), 4, None) == "generic"
    view = torch.zeros(2 * 64 * 8 + 1)[1:].view(2, 64, 8)
    assert assign_route(view, 4, None) == "generic"
    for dtype, n_vec, n_scalar in ((torch.float32, 4, 6),
                                   (torch.bfloat16, 12, 6)):
        assert scalar_route(torch.zeros(3, n_vec, dtype=dtype)) == "vec"
        assert scalar_route(torch.zeros(3, 18432, dtype=dtype)) == "vec"
        assert scalar_route(torch.zeros(3, n_scalar, dtype=dtype)) == \
            "scalar"
        off = torch.zeros(3 * 16 + 1, dtype=dtype)[1:].view(3, 16)
        assert off.is_contiguous() and scalar_route(off) == "scalar"


def test_scalar_vec_grid_and_forced_route(monkeypatch):
    """The vec grid is d8_blocks's with tiles of 4·256 values and one tile
    a block at least, from the occupancy of x's own dtype's instance; a
    route other than None or "scalar" is refused."""
    asked = []

    def occupancy(lib_name, fn, dev, bf16):
        asked.append((lib_name, fn, dev, bf16))
        return 8

    monkeypatch.setattr(tsq, "occupancy", occupancy)
    monkeypatch.setattr(tsq, "device_sms", lambda x: (0, 132))
    assert tsq.VEC_TILE == 1024
    assert tsq.vec_grid(torch.zeros(10, 18432)) == 18      # 18 tiles
    assert tsq.vec_grid(torch.zeros(10, 184320)) == 105    # 1056 / 10
    assert tsq.vec_grid(torch.zeros(4, 1 << 23, dtype=torch.bfloat16)) \
        == 264
    assert tsq.vec_grid(torch.zeros(1, 4)) == 1
    assert [a[3] for a in asked] == [0, 0, 1, 0]
    assert {a[:3] for a in asked} == {
        ("scalar_quant", "scalar_quantize_vec_occupancy", 0)}
    v = torch.zeros(2, 8)
    lo, scale = torch.zeros(2), torch.ones(2)
    forced = scalar_quantize_kernel(v, lo, scale, 4, "scalar")
    plain = tref.scalar_quantize_ref(v, lo, scale, 4)
    assert all(torch.equal(a, b) for a, b in zip(forced, plain))
    with pytest.raises(ValueError, match="route"):
        scalar_quantize_kernel(v, lo, scale, 4, "vec")


def test_ops_hand_bf16_to_kmeans_assign_and_scalar_quantize(monkeypatch):
    """ops.kmeans_assign and ops.scalar_quantize hand a bf16 x to the
    kernels as it is: the same tensor, no f32 copy."""
    seen = {}

    def record(name, result):
        def fn(*args):
            seen[name] = args
            return result(*args)
        return fn

    monkeypatch.setattr(tops, "kmeans_assign_kernel",
                        record("assign", kmeans_assign_kernel))
    monkeypatch.setattr(tops, "scalar_quantize_kernel",
                        record("scalar", scalar_quantize_kernel))
    x, c = _inputs(37, 2, 50, 8, 3)
    xb = _t(x).to(torch.bfloat16)
    tops.kmeans_assign(xb, _t(c))
    assert seen["assign"][0] is xb and len(seen["assign"]) == 2
    v = xb.reshape(2, -1)
    lo, scale = v.amin(-1).float(), torch.full((2,), 0.1)
    tops.scalar_quantize(v, lo, scale, 8)
    assert seen["scalar"][0] is v and seen["scalar"][3] == 8


# ---------------------------------------------------------------------------
# scalar_quantize, pack_codes and unpack_codes
# ---------------------------------------------------------------------------

def _scalar_range(x, bits):
    """The scalarq compressor's per-row range: lo = min, scale = (max −
    min)/(2^b − 1) (1 where max == min), in f32."""
    lo = x.min(-1)
    scale = (x.max(-1) - lo) / np.float32((1 << bits) - 1)
    return lo, np.where(scale > 0, scale, np.float32(1)).astype(np.float32)


@pytest.mark.parametrize("n,bits", [(999, 8), (64, 1), (257, 4), (40, 16)])
def test_scalar_quantize_matches_jax(n, bits):
    """Codes bitwise equal to the Pallas kernel (interpret mode) and to the
    jnp formula clip(round((x − lo)/scale), 0, 2^b − 1); recon within
    1e-6 of both."""
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    x[2] = 0.5                                   # a constant row: scale 1
    lo, scale = _scalar_range(x, bits)
    codes, recon = tops.scalar_quantize(_t(x), _t(lo), _t(scale), bits)
    assert codes.dtype == torch.int32 and recon.dtype == torch.float32
    levels = (1 << bits) - 1
    for p in range(3):
        codes_k, recon_k = jops.scalar_quantize(
            jnp.asarray(x[p][None]), jnp.asarray(lo[p]),
            jnp.asarray(scale[p]), bits, block_n=64, interpret=True)
        t = (jnp.asarray(x[p]) - lo[p]) / scale[p]
        codes_j = jnp.clip(jnp.round(t), 0, levels).astype(jnp.int32)
        recon_j = lo[p] + codes_j.astype(jnp.float32) * scale[p]
        np.testing.assert_array_equal(codes[p].numpy(),
                                      np.asarray(codes_k)[0])
        np.testing.assert_array_equal(codes[p].numpy(), np.asarray(codes_j))
        for r in (np.asarray(recon_k)[0], np.asarray(recon_j)):
            np.testing.assert_allclose(recon[p].numpy(), r, rtol=0,
                                       atol=1e-6)
    assert int(codes.min()) >= 0 and int(codes.max()) <= levels
    np.testing.assert_array_equal(codes[2].numpy(), 0)


@pytest.mark.parametrize("n,bits", [(999, 8), (64, 1), (512, 4), (40, 16)])
def test_scalar_quantize_bf16_matches_jax(n, bits):
    """A bf16 x against the Pallas kernel (interpret mode) on the same bf16
    values: codes bitwise; recon bitwise the jnp formula's multiply and
    then add, each rounded to f32 (numpy), and within 1e-6 of the Pallas
    kernel's recon (as the f32 test), which XLA's CPU compiler contracts
    into one FMA: one rounding apart, on values below 4 in magnitude.
    Codes and recon bitwise the port on the f32 upcast."""
    x = np.random.default_rng(n + bits).standard_normal((3, n))
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    xb[2] = 0.5                                  # a constant row: scale 1
    xf = xb.float().numpy()
    lo, scale = _scalar_range(xf, bits)
    codes, recon = tops.scalar_quantize(xb, _t(lo), _t(scale), bits)
    codes_f, recon_f = tops.scalar_quantize(_t(xf), _t(lo), _t(scale), bits)
    assert torch.equal(codes, codes_f) and torch.equal(recon, recon_f)
    for p in range(3):
        codes_k, recon_k = jops.scalar_quantize(
            jnp.asarray(xf[p][None]).astype(jnp.bfloat16),
            jnp.asarray(lo[p]), jnp.asarray(scale[p]), bits, block_n=64,
            interpret=True)
        np.testing.assert_array_equal(codes[p].numpy(),
                                      np.asarray(codes_k)[0])
        q = codes[p].numpy().astype(np.float32)
        np.testing.assert_array_equal(recon[p].numpy(),
                                      lo[p] + q * scale[p])
        np.testing.assert_allclose(recon[p].numpy(), np.asarray(recon_k)[0],
                                   rtol=0, atol=1e-6)


def test_scalar_quantize_rounds_half_to_even():
    x = np.array([[0.5, 1.5, 2.5, 3.5, 254.5, 300.0, -2.0]], np.float32)
    codes, recon = tref.scalar_quantize_ref(_t(x), torch.zeros(1),
                                            torch.ones(1), 8)
    np.testing.assert_array_equal(codes.numpy(), [[0, 2, 2, 4, 254, 255, 0]])
    np.testing.assert_array_equal(recon.numpy(),
                                  [[0, 2, 2, 4, 254, 255, 0]])


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_codes_matches_wire_and_jax(bits):
    """Each problem's words are, as little-endian bytes, the wire's
    LSB-first stream, and the words of the Pallas pack kernel (interpret
    mode); the stream of a ragged count (999) is padded to whole words."""
    r = np.random.default_rng(bits)
    codes = r.integers(0, 1 << bits, size=(2, 999)).astype(np.int32)
    words = tops.pack_codes(_t(codes), bits)
    assert words.shape == (2, -(-999 * bits // 32))
    assert words.dtype == torch.int32
    for p in range(2):
        host = wire_pack_codes(codes[p].astype(np.uint32), bits)
        mine = words[p].numpy().view(np.uint32)
        assert mine.astype("<u4").tobytes()[:len(host)] == host
        dev = np.asarray(jops.pack_codes(jnp.asarray(codes[p]), bits,
                                         block_n=64, interpret=True))
        np.testing.assert_array_equal(mine, dev)
    back = tops.unpack_codes(words, 999, bits)
    np.testing.assert_array_equal(back.numpy(), codes)
    for p in range(2):
        np.testing.assert_array_equal(
            back[p].numpy(),
            np.asarray(jops.unpack_codes(jnp.asarray(words[p].numpy()
                                                     .view(np.uint32)),
                                         999, bits, block_n=64,
                                         interpret=True)))


def test_pack_codes_pads_and_rejects_widths():
    codes = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    words = tref.pack_codes_ref(codes, 8)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  [[0x030201]])
    top = tref.pack_codes_ref(torch.full((1, 2), 0xFFFF, dtype=torch.int32),
                              16)
    np.testing.assert_array_equal(top.numpy(), [[-1]])  # 0xFFFFFFFF
    np.testing.assert_array_equal(tref.unpack_codes_ref(top, 2, 16).numpy(),
                                  [[0xFFFF, 0xFFFF]])
    for bad in (3, 32):
        with pytest.raises(ValueError, match="bits"):
            tops.pack_codes(codes, bad)


# ---------------------------------------------------------------------------
# wrappers: the plain version on CPU tensors, the kernel or an error on CUDA
# ---------------------------------------------------------------------------

def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    x, c = _inputs(5, 3, 40, 8, 8)
    lmask = torch.ones(8)
    w = torch.ones((3, 40))
    _build.reset_launch_counts()
    ds, ct = lloyd_update_kernel(_t(x), w, _t(c), lmask)
    ds_r, ct_r = tref.lloyd_update_ref(_t(x), w, _t(c), lmask)
    zt, resid, codes = pq_quantize_kernel(_t(x), _t(c), lmask)
    zt_r, resid_r, codes_r = tref.pq_quantize_ref(_t(x), _t(c), lmask)
    assert torch.equal(ds, ds_r) and torch.equal(ct, ct_r)
    assert torch.equal(zt, zt_r) and torch.equal(resid, resid_r)
    assert torch.equal(codes, codes_r)
    codes_a, sq_a = kmeans_assign_kernel(_t(x), _t(c), lmask)
    codes_ar, sq_ar = tref.kmeans_assign_ref(_t(x), _t(c), lmask)
    assert torch.equal(codes_a, codes_ar.to(torch.int32))
    assert torch.equal(sq_a, sq_ar)
    v = _t(x[:, :, 0])
    lo, scale = v.amin(-1), torch.full((3,), 0.1)
    q, rec = scalar_quantize_kernel(v, lo, scale, 4)
    q_r, rec_r = tref.scalar_quantize_ref(v, lo, scale, 4)
    assert torch.equal(q, q_r) and torch.equal(rec, rec_r)
    words = pack_codes_kernel(q, 4)
    assert torch.equal(words, tref.pack_codes_ref(q, 4))
    assert torch.equal(unpack_codes_kernel(words, 40, 4), q)
    assert _build.launch_counts() == {}


def test_load_types_every_launcher_once(monkeypatch):
    """One library with several launchers: each one asked for gets its
    argtypes and restype the first time, and keeps them."""
    libc = ctypes.util.find_library("c")
    assert libc, "no C library to stand in for a kernel library"
    monkeypatch.setattr(_build, "build", lambda names: {
        n: _build.BuildInfo(Path(libc), 0.0, "") for n in names})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_TYPED", set())
    lib = _build.load("fake", "labs", [ctypes.c_long])
    assert _build.load("fake", "strlen", [ctypes.c_char_p]) is lib
    assert lib.labs.argtypes == [ctypes.c_long]
    assert lib.strlen.argtypes == [ctypes.c_char_p]
    assert lib.labs.restype is ctypes.c_int
    assert lib.strlen.restype is ctypes.c_int
    assert lib.labs(-7) == 7 and lib.strlen(b"kernel") == 6
    # asked for again, a launcher is not typed anew
    _build.load("fake", "labs", [ctypes.c_void_p])
    assert lib.labs.argtypes == [ctypes.c_long]
    assert _build._TYPED == {("fake", "labs"), ("fake", "strlen")}


def test_kernel_libraries_are_named_by_their_sources():
    path = _build.library_path("lloyd_update")
    assert path.parent == REPO_ROOT / "build" / "repro_torch"
    assert path.name.startswith("liblloyd_update-") and path.suffix == ".so"
    assert path != _build.library_path("pq_quantize")
    for name in ("kmeans_assign", "scalar_quant"):
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _attention(seed, b, s, h, kv, hd):
    """q (B, S, H, hd), k and v (B, S, Kv, hd) from a numpy seed."""
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((b, s, n, hd)).astype(np.float32)
                 for n in (h, kv, kv))


def _bh(x):
    """(B, S, n, hd) -> the kernels' (B·n, S, hd)."""
    b, s, n, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * n, s, hd))


# the cases of tests/test_flash.py (block sizes are the Pallas kernel's),
# plus a ragged S that the Pallas kernel cannot take unpadded
FLASH_CASES = [(1, 64, 2, 2, 16, 32, 32), (2, 128, 4, 2, 32, 64, 32),
               (1, 128, 8, 2, 16, 128, 64)]


@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk", FLASH_CASES)
@pytest.mark.parametrize("window", [None, 32])
def test_flash_attention_matches_jax(b, s, h, kv, hd, bq, bk, window):
    """The plain version and the CPU wrapper against the Pallas kernel
    (interpret mode) and against row_block_attention, within the
    reference's own flash tolerance (rtol 2e-4, atol 2e-5)."""
    q, k, v = _attention(s + hd, b, s, h, kv, hd)
    scale = 1.0 / np.sqrt(hd)
    kw = dict(num_q_heads=h, num_kv_heads=kv, scale=scale, window=window)
    got_ref = tref.flash_attention_ref(_t(_bh(q)), _t(_bh(k)), _t(_bh(v)),
                                       **kw)
    got_ops = tops.flash_attention(_t(_bh(q)), _t(_bh(k)), _t(_bh(v)), **kw)
    pallas = jflash_kernel(jnp.asarray(_bh(q)), jnp.asarray(_bh(k)),
                           jnp.asarray(_bh(v)), block_q=bq, block_k=bk,
                           interpret=True, **kw)
    pos = jnp.arange(s)
    rows = jrow_block(*map(jnp.asarray, (q, k, v)), pos, pos, window=window,
                      q_chunk=s, scale=scale)
    for want in (np.asarray(pallas), _bh(np.asarray(rows))):
        for got in (got_ref, got_ops):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                       atol=2e-5)


@pytest.mark.parametrize("s,window", [(100, None), (77, 20)])
def test_flash_attention_ragged_s_matches_jax(s, window):
    """Any S: the port masks by index; the reference's ops wrapper pads
    to its block (interpret mode)."""
    q, k, v = _attention(s, 2, s, 4, 2, 16)
    kw = dict(num_q_heads=4, num_kv_heads=2, scale=0.25, window=window)
    got = tops.flash_attention(_t(_bh(q)), _t(_bh(k)), _t(_bh(v)), **kw)
    want = jops.flash_attention(jnp.asarray(_bh(q)), jnp.asarray(_bh(k)),
                                jnp.asarray(_bh(v)), block_q=32, block_k=32,
                                interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_flash_attention_bf16_matches_jax():
    """bf16 in and out, as tests/test_flash.py's bf16 case (tolerance
    3e-2: the outputs round to bf16 on both sides)."""
    q, k, v = _attention(3, 1, 64, 2, 1, 16)
    q16, k16, v16 = (jnp.asarray(_bh(a), jnp.bfloat16) for a in (q, k, v))
    kw = dict(num_q_heads=2, num_kv_heads=1, scale=0.25)
    want = jflash_kernel(q16, k16, v16, interpret=True, **kw)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    got = tops.flash_attention(bf16(q16), bf16(k16), bf16(v16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_flash_attention_is_causal():
    """Future KV perturbations never change earlier outputs (the twin of
    tests/test_flash.py's causality probe)."""
    q, k, v = _attention(5, 1, 64, 2, 2, 16)
    kw = dict(num_q_heads=2, num_kv_heads=2, scale=0.25)
    o1 = tops.flash_attention(_t(_bh(q)), _t(_bh(k)), _t(_bh(v)), **kw)
    k[:, -1] += 50.0
    v[:, -1] += 50.0
    o2 = tops.flash_attention(_t(_bh(q)), _t(_bh(k)), _t(_bh(v)), **kw)
    np.testing.assert_allclose(o1[:, :-1].numpy(), o2[:, :-1].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_flash_attention_refuses_grad():
    q, k, v = (_t(_bh(a)) for a in _attention(6, 1, 32, 2, 1, 16))
    kw = dict(num_q_heads=2, num_kv_heads=1, scale=0.25)
    with pytest.raises(ValueError, match="forward only"):
        tops.flash_attention(q.requires_grad_(), k, v, **kw)


def test_flash_attention_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the kernel wrapper computes the plain version and
    launches nothing; non-contiguous inputs are made contiguous by ops."""
    q, k, v = (_t(_bh(a)) for a in _attention(7, 2, 40, 4, 2, 8))
    kw = dict(num_q_heads=4, num_kv_heads=2, scale=0.3, window=9)
    _build.reset_launch_counts()
    out = flash_attention_kernel(q, k, v, **kw)
    assert torch.equal(out, tref.flash_attention_ref(q, k, v, **kw))
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous()
    assert torch.equal(tops.flash_attention(qt, k, v, **kw), out)
    assert _build.launch_counts() == {}
    assert (_build.CSRC / "flash_attention.cu").exists()
    assert _build.library_path("flash_attention").name.startswith(
        "libflash_attention-")


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 64, "cuda_core"),
    (torch.bfloat16, 40, "cuda_core")])
def test_flash_route(dtype, hd, route):
    """bf16 at hd a multiple of 16 takes the tensor cores; f32 keeps the
    reference's f32 numerics on the CUDA cores, as bf16 at other hd."""
    assert flash_route(dtype, hd) == route


def _strided_views(q, k, v):
    """(B, S, n, hd) arrays as strided views of one fused (B, S, H + 2·Kv,
    hd) tensor, as a fused qkv projection would give them."""
    h, kv = q.shape[2], k.shape[2]
    fused = _t(np.concatenate([q, k, v], axis=2))
    views = fused[:, :, :h], fused[:, :, h:h + kv], fused[:, :, h + kv:]
    assert not any(t.is_contiguous() for t in views)
    return views


@pytest.mark.parametrize("b,s,h,kv,hd,window", [(2, 64, 4, 2, 16, None),
                                                (1, 77, 8, 2, 32, 20)])
def test_flash_attention_strided_entry_matches_jax(b, s, h, kv, hd, window):
    """The strided entry on (B, S, H, hd) views against the Pallas kernel
    in interpret mode (the reference's ops wrapper, which pads a ragged S),
    within the reference's flash tolerance (rtol 2e-4, atol 2e-5)."""
    q, k, v = _attention(s + 2 * hd, b, s, h, kv, hd)
    kw = dict(scale=1.0 / np.sqrt(hd), window=window)
    got = flash_attention_bshd(*_strided_views(q, k, v), **kw)
    assert got.shape == (b, s, h, hd) and got.is_contiguous()
    want = jops.flash_attention(jnp.asarray(_bh(q)), jnp.asarray(_bh(k)),
                                jnp.asarray(_bh(v)), num_q_heads=h,
                                num_kv_heads=kv, block_q=32, block_k=32,
                                interpret=True, **kw)
    want = np.asarray(want).reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_through_strided_entry_is_the_copy_route(dtype):
    """On the CPU, flash_prefill_attention (the strided entry) is bitwise
    ops.flash_attention on the (B·H, S, hd) copies, the route it replaces,
    and launches nothing."""
    q, k, v = (t.to(dtype) for t in _strided_views(
        *_attention(8, 2, 50, 4, 2, 16)))
    _build.reset_launch_counts()
    got = tattn.flash_prefill_attention(q, k, v, window=12, scale=0.25)
    b, s, h, hd = q.shape
    want = tops.flash_attention(
        *(torch.from_numpy(_bh(t.float().numpy())).to(dtype)
          for t in (q, k, v)),
        num_q_heads=h, num_kv_heads=k.shape[2], scale=0.25, window=12)
    assert got.dtype == dtype
    assert torch.equal(got, want.reshape(b, h, s, hd).transpose(1, 2))
    assert _build.launch_counts() == {}


def test_flash_attention_strided_refuses_grad():
    q, k, v = (_t(a) for a in _attention(9, 1, 32, 2, 1, 16))
    with pytest.raises(ValueError, match="forward only"):
        tops.flash_attention_strided(q.requires_grad_(), k, v, scale=0.25)


# ---------------------------------------------------------------------------
# the port imports neither jax nor the JAX package
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((REPO_ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO_ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = {f"{f.relative_to(REPO_ROOT)}: {root}" for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "repro")}
    assert not bad, sorted(bad)
