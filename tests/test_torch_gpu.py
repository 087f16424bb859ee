"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test skips itself when no CUDA card is present (the decision is made
inside the test, so every pytest worker collects the same tests). This file
imports neither jax nor the JAX package, so that it also runs where jax is
not installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_route
from repro_torch.kernels.kmeans_assign import (assign_route,
                                               kmeans_assign_kernel)
from repro_torch.kernels.lloyd_update import (generic_max_l, lloyd_layout,
                                              lloyd_update_in_kernel_order,
                                              lloyd_update_kernel, row_route)
from repro_torch.kernels.pq_quantize import pq_quantize_kernel, pq_route
from repro_torch.kernels.scalar_quant import (scalar_quantize_kernel,
                                              scalar_route)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, dev, p, n, d, l):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((p, n, d)).astype(np.float32))
    c = torch.from_numpy(r.standard_normal((p, l, d)).astype(np.float32))
    return x.to(dev), c.to(dev)


# (route, D, L, masked): the kernel gets L centroids; masked pads a codebook
# of L to 8 with a mask, as a caller that masks centroids would
LLOYD_CASES = [("d8", 8, 8, True), ("d8", 8, 16, False), ("d8", 8, 2, False),
               ("generic", 8, 3, False), ("generic", 16, 5, True)]


def _codebook(c, masked):
    return ops._pad_centroids(c) if masked else (c, None)


def _misaligned(x):
    """A contiguous copy of x one element off a 16-byte boundary: the same
    values, on the fallback routes."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,d,l,masked", LLOYD_CASES)
def test_lloyd_update_kernel_matches_plain_on_card(route, d, l, masked,
                                                   dtype):
    """Counts exact; deviation sums bitwise those of the plain version in
    the route's order and within f32 reordering of the plain order;
    bitwise run to run; a bf16 x bitwise its f32 upcast; a ragged N.
    Near-tie rows, where either code is right, weigh 0."""
    dev = _cuda_or_skip()
    x, c = _inputs(21, dev, 4, 3000, d, l)
    x = x.to(dtype)
    cp, lmask = _codebook(c, masked)
    lay = lloyd_layout(x, cp.shape[1])
    assert lay.route == route
    w = (torch.arange(3000, device=dev) < 2900).float().expand(4, -1)
    w = torch.where(ref.near_ties(x, cp, lmask), 0.0, w).contiguous()
    ds, cnt = lloyd_update_kernel(x, w, cp, lmask)
    ds2, cnt2 = lloyd_update_kernel(x, w, cp, lmask)
    ds_f, cnt_f = lloyd_update_kernel(x.float(), w, cp, lmask)
    ds_o, cnt_o = lloyd_update_in_kernel_order(x, w, cp, lmask, lay)
    ds_r, cnt_r = ref.lloyd_update_ref(x, w, cp, lmask)
    assert torch.equal(ds, ds2) and torch.equal(cnt, cnt2)
    assert torch.equal(ds, ds_f) and torch.equal(cnt, cnt_f)
    assert torch.equal(cnt, cnt_r) and torch.equal(cnt, cnt_o)
    assert torch.equal(ds, ds_o)
    # against the exact sum: within the f32 rounding bound γ·Σ|terms| of
    # the launch's chains of additions (d8: a thread's rows, the 5-level
    # xor tree, the warps, the blocks; generic: a block's rows, the blocks)
    codes, _ = ref.kmeans_assign_ref(x, cp, lmask)
    delta = (x.double() - ref._gather_rows(cp.double(), codes))
    oh = torch.nn.functional.one_hot(codes, cp.shape[1]).double() \
        * w.double().unsqueeze(-1)
    ds64 = oh.transpose(-1, -2) @ delta
    mag = oh.transpose(-1, -2) @ delta.abs()
    if lay.route == "d8":
        depth = -(-3000 // (lay.rows * lay.blocks)) \
            * (lay.rows // lay.threads) + 5 + lay.threads // 32 + lay.blocks
    else:
        depth = lay.rows + lay.blocks
    gamma = depth * 2.0 ** -24 / (1 - depth * 2.0 ** -24)
    assert bool(((ds.double() - ds64).abs() <= gamma * mag).all())
    # against the plain (matmul) order, for f32 rows: on bf16-valued rows
    # that order strays from the exact sum by more than 2e-5 (its roundings
    # no longer cancel), so a bf16 x is held to the exact sum above and,
    # bitwise, to its f32 upcast
    if dtype == torch.float32:
        assert float(((ds - ds_r).abs() / (1 + ds_r.abs())).max()) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("route,d,l,masked", LLOYD_CASES)
def test_lloyd_update_unweighted_is_all_ones_on_card(route, d, l, masked):
    """No weights (none read) gives bitwise the sums of all-ones weights."""
    dev = _cuda_or_skip()
    x, c = _inputs(25, dev, 3, 2049, d, l)
    cp, lmask = _codebook(c, masked)
    ds, cnt = lloyd_update_kernel(x, None, cp, lmask)
    ds1, cnt1 = lloyd_update_kernel(x, torch.ones(3, 2049, device=dev), cp,
                                    lmask)
    assert torch.equal(ds, ds1) and torch.equal(cnt, cnt1)
    assert float(cnt.sum()) == 3 * 2049


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,d,l,masked", LLOYD_CASES)
def test_pq_quantize_kernel_matches_plain_on_card(route, d, l, masked,
                                                  dtype):
    """Codes equal but for near-ties; z̃ (in x's dtype) and the residual
    bitwise equal wherever the codes agree; a bf16 x gives its f32
    upcast's codes and residual, and z̃ rounded to bf16 (ragged N)."""
    dev = _cuda_or_skip()
    x, c = _inputs(22, dev, 4, 3001, d, l)
    x = x.to(dtype)
    cp, lmask = _codebook(c, masked)
    assert row_route(x, cp.shape[1]) == route
    zt, resid, codes = pq_quantize_kernel(x, cp, lmask)
    zt_r, resid_r, codes_r = ref.pq_quantize_ref(x, cp, lmask)
    assert zt.dtype == dtype and resid.dtype == torch.float32
    same = codes == codes_r
    ties = ref.near_ties(x, cp, lmask)
    assert not bool((~same & ~ties).any())
    assert torch.equal(zt[same], zt_r[same])
    assert torch.equal(resid[same], resid_r[same])
    zt_f, resid_f, codes_f = pq_quantize_kernel(x.float(), cp, lmask)
    assert torch.equal(codes, codes_f) and torch.equal(resid, resid_f)
    assert torch.equal(zt, zt_f.to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [2, 3, 16])
def test_three_kernels_pick_the_same_codes_on_card(l, dtype):
    """kmeans_assign, pq_quantize and lloyd_update give every row the same
    code, near-ties included (rows placed midway between two centroids),
    on d8 (L = 2, 16) and generic (L = 3), in f32 and bf16: lloyd_update's
    code of a row is read from the counts of a problem of that one row."""
    dev = _cuda_or_skip()
    x, c = _inputs(26, dev, 1, 2000, 8, l)
    r = np.random.default_rng(27)
    a, b = r.integers(0, l, 2000), r.integers(0, l, 2000)
    mid = (c[0, a] + c[0, b]) / 2
    x[0, 1000:] = mid[1000:] + 1e-7 * x[0, 1000:]
    x = x.to(dtype)
    codes_a, _ = ops.kmeans_assign(x, c)
    _, _, codes_q = ops.pq_quantize(x, c)
    rows = x[0].reshape(2000, 1, 8).contiguous()
    _, cnt = ops.lloyd_update(rows, c.expand(2000, -1, -1).contiguous())
    assert torch.equal(cnt.sum(-1), torch.ones(2000, device=dev))
    codes_l = cnt.argmax(-1).to(torch.int32)
    assert torch.equal(codes_a[0], codes_q[0])
    assert torch.equal(codes_a[0], codes_l)


@pytest.mark.gpu
def test_misaligned_x_goes_generic_on_card():
    """A contiguous view 4 bytes off a 16-byte boundary takes the generic
    route (a kernel, never the plain version): lloyd_update bitwise its
    generic order, pq_quantize bitwise the aligned copy's d8 result."""
    from repro_torch.kernels import _build

    dev = _cuda_or_skip()
    x, c = _inputs(28, dev, 2, 1500, 8, 4)
    buf = torch.empty(x.numel() + 1, device=dev)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    assert row_route(view, 4) == "generic" and row_route(x, 4) == "d8"
    w = torch.where(ref.near_ties(x, c), 0.0, 1.0).contiguous()
    _build.reset_launch_counts()
    ds, cnt = lloyd_update_kernel(view, w, c)
    out = pq_quantize_kernel(view, c)
    assert _build.launch_counts() == {"lloyd_update": 1, "pq_quantize": 1}
    lay = lloyd_layout(view, 4)
    ds_o, cnt_o = lloyd_update_in_kernel_order(view, w, c, None, lay)
    assert lay.route == "generic"
    assert torch.equal(ds, ds_o) and torch.equal(cnt, cnt_o)
    for a, b in zip(out, pq_quantize_kernel(x, c)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [4, 3])
def test_fixed_points_exact_on_card(l):
    """Exact cover: dsums and the residual exactly 0, z̃ the rows; a far
    centroid is an empty cluster: count 0, dsums 0 (d8 at L = 4, generic
    at L = 3)."""
    dev = _cuda_or_skip()
    _, c = _inputs(29, dev, 4, 1, 8, l)
    c[:, -1] = 1e3
    pick = torch.from_numpy(np.random.default_rng(30).integers(
        0, l - 1, (4, 2000))).to(dev)
    x = torch.gather(c, 1, pick.unsqueeze(-1).expand(-1, -1, 8)).contiguous()
    ds, cnt = ops.lloyd_update(x, c)
    zt, resid, codes = ops.pq_quantize(x, c)
    assert float(ds.abs().max()) == 0.0 and float(resid.abs().max()) == 0.0
    assert torch.equal(zt, x) and torch.equal(codes.long(), pick)
    assert float(cnt[:, -1].abs().max()) == 0.0


# (route, D, L, masked): d8 takes no mask; masked pads a codebook of L to 8
ASSIGN_CASES = [("d8", 8, 2, False), ("d8", 8, 16, False),
                ("generic", 8, 3, True), ("generic", 8, 3, False),
                ("generic", 16, 5, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,d,l,masked", ASSIGN_CASES)
def test_kmeans_assign_kernel_matches_plain_on_card(route, d, l, masked,
                                                    dtype):
    """Codes equal but for near-ties; squared distances within
    1e-5·(1 + ‖x‖²); a bf16 x gives bitwise its f32 upcast's codes and
    distances (ragged N)."""
    dev = _cuda_or_skip()
    x, c = _inputs(23, dev, 4, 3001, d, l)
    x = x.to(dtype)
    cp, lmask = _codebook(c, masked)
    assert assign_route(x, cp.shape[1], lmask) == route
    codes, sq = kmeans_assign_kernel(x, cp, lmask)
    codes_r, sq_r = ref.kmeans_assign_ref(x, cp, lmask)
    ties = ref.near_ties(x, cp, lmask)
    assert codes.dtype == torch.int32 and int(codes.max()) < l
    assert not bool(((codes != codes_r) & ~ties).any())
    tol = 1e-5 * (1 + x.float().square().sum(-1))
    assert bool(((sq - sq_r).abs() <= tol).all())
    codes_f, sq_f = kmeans_assign_kernel(x.float(), cp, lmask)
    assert torch.equal(codes, codes_f) and torch.equal(sq, sq_f)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [2, 16])
def test_kmeans_assign_routes_agree_bitwise_on_card(l, dtype):
    """Where both routes apply, d8 and generic give the same codes and
    distances bit for bit: generic through an all-valid mask, and through a
    misaligned copy of x (ragged N, near-ties included)."""
    dev = _cuda_or_skip()
    x, c = _inputs(33, dev, 3, 2001, 8, l)
    x[:, 1000:] = (c[:, :1] + c[:, 1:2]) / 2 + 1e-7 * x[:, 1000:]
    x = x.to(dtype)
    assert assign_route(x, l, None) == "d8"
    codes, sq = kmeans_assign_kernel(x, c)
    for other in (kmeans_assign_kernel(x, c, torch.ones(l, device=dev)),
                  kmeans_assign_kernel(_misaligned(x), c)):
        assert torch.equal(codes, other[0]) and torch.equal(sq, other[1])


@pytest.mark.gpu
def test_batched_kmeans_bf16_is_its_f32_upcast_on_card():
    """batched_kmeans on a bf16 x ("auto": 4 lloyd_update launches and one
    kmeans_assign, all reading bf16) gives bitwise the centroids (rounded
    to bf16), codes and distortion of the same call on its f32 upcast."""
    from repro_torch.core import kmeans as km
    from repro_torch.kernels import _build

    dev = _cuda_or_skip()
    x, _ = _inputs(34, dev, 4, 20001, 8, 16)
    xb = x.to(torch.bfloat16)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    res = km.batched_kmeans(xb, 16, 4, backend="auto")
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"lloyd_update": 4, "kmeans_assign": 1}
    up = km.batched_kmeans(xb.float(), 16, 4, backend="auto")
    assert res.centroids.dtype == torch.bfloat16
    assert torch.equal(res.centroids, up.centroids.to(torch.bfloat16))
    assert torch.equal(res.codes, up.codes)
    assert torch.equal(res.distortion, up.distortion)


# (route, N): vec needs N a multiple of 4; N = 4097 takes scalar
SCALAR_CASES = [("vec", 4096), ("scalar", 4097)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,n", SCALAR_CASES)
def test_scalar_quantize_kernel_is_the_plain_version_on_card(route, n, dtype,
                                                             bits):
    """Codes and recon bitwise those of the plain version (no FMA
    contraction, half-to-even rounding), per-problem ranges; a bf16 x
    bitwise its f32 upcast."""
    dev = _cuda_or_skip()
    r = np.random.default_rng(24)
    x = torch.from_numpy(r.standard_normal((3, n)).astype(np.float32))
    x = x.to(dev, dtype)
    assert scalar_route(x) == route
    lo = x.amin(-1).float()
    scale = (x.amax(-1).float() - lo) / ((1 << bits) - 1)
    codes, recon = ops.scalar_quantize(x, lo, scale, bits)
    codes_r, recon_r = ref.scalar_quantize_ref(x, lo, scale, bits)
    assert torch.equal(codes, codes_r) and torch.equal(recon, recon_r)
    codes_f, recon_f = ops.scalar_quantize(x.float(), lo, scale, bits)
    assert torch.equal(codes, codes_f) and torch.equal(recon, recon_f)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_quantize_routes_agree_bitwise_on_card(dtype):
    """vec on x, scalar forced on x and scalar on a misaligned copy of it
    give the same codes and recon bit for bit."""
    dev = _cuda_or_skip()
    r = np.random.default_rng(35)
    x = torch.from_numpy(r.standard_normal((5, 8192)).astype(np.float32))
    x = x.to(dev, dtype)
    lo = x.amin(-1).float()
    scale = (x.amax(-1).float() - lo) / 255
    xm = _misaligned(x)
    assert scalar_route(x) == "vec" and scalar_route(xm) == "scalar"
    want = scalar_quantize_kernel(x, lo, scale, 8)
    for got in (scalar_quantize_kernel(x, lo, scale, 8, "scalar"),
                scalar_quantize_kernel(xm, lo, scale, 8)):
        assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,n", SCALAR_CASES)
def test_scalar_quantize_zero_range_and_half_levels_on_card(route, n, dtype):
    """A problem whose range is zero (scale 1: every code 0, recon its
    value), values exactly on half-levels (lo + (k + ½)·scale, rounded
    half to even; below 0, clamped) and values past the top level
    (clamped): bitwise the plain version."""
    dev = _cuda_or_skip()
    half = torch.arange(n, dtype=torch.float32) % 140 - 12.0 + 0.5
    x = torch.stack([torch.full((n,), 0.75), half,
                     torch.arange(n, dtype=torch.float32)]).to(dev, dtype)
    assert torch.equal(x[1].float(), half.to(dev))   # exact in bf16 too
    lo = torch.tensor([0.75, 0.0, 0.0], device=dev)
    scale = torch.tensor([1.0, 1.0, 0.5], device=dev)
    assert scalar_route(x) == route
    codes, recon = scalar_quantize_kernel(x, lo, scale, 8)
    codes_r, recon_r = ref.scalar_quantize_ref(x, lo, scale, 8)
    assert torch.equal(codes, codes_r) and torch.equal(recon, recon_r)
    assert int(codes[0].abs().max()) == 0
    assert torch.equal(recon[0], x[0].float())
    k = half.to(dev)
    assert torch.equal(codes[1].float(),
                       torch.round(k).clamp(0, 255))   # half to even


@pytest.mark.gpu
def test_misaligned_views_take_the_fallback_routes_on_card():
    """Views one element off a 16-byte boundary take kmeans_assign's
    generic route and scalar_quantize's scalar route (kernels, never the
    plain versions), bitwise the aligned calls."""
    from repro_torch.kernels import _build

    dev = _cuda_or_skip()
    x, c = _inputs(36, dev, 2, 1500, 8, 4)
    v = x.reshape(3, -1)
    lo, scale = v.amin(-1), (v.amax(-1) - v.amin(-1)) / 15
    xm, vm = _misaligned(x), _misaligned(v)
    assert assign_route(xm, 4, None) == "generic"
    assert scalar_route(vm) == "scalar"
    _build.reset_launch_counts()
    got = kmeans_assign_kernel(xm, c) + scalar_quantize_kernel(vm, lo, scale,
                                                               4)
    assert _build.launch_counts() == {"kmeans_assign": 1,
                                      "scalar_quantize": 1}
    want = kmeans_assign_kernel(x, c) + scalar_quantize_kernel(v, lo, scale,
                                                               4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _wire_stream(codes: np.ndarray, bits: int) -> bytes:
    """The wire format's LSB-first bit stream of ``codes`` at ``bits``."""
    flat = codes.reshape(-1).astype(np.uint32)
    bitmat = (flat[:, None] >> np.arange(bits, dtype=np.uint32)) & 1
    return np.packbits(bitmat.astype(np.uint8).reshape(-1),
                       bitorder="little").tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_unpack_kernels_match_plain_and_wire_on_card(bits):
    dev = _cuda_or_skip()
    r = np.random.default_rng(bits)
    codes = r.integers(0, 1 << bits, size=(3, 999)).astype(np.int32)
    words = ops.pack_codes(torch.from_numpy(codes).to(dev), bits)
    assert torch.equal(words.cpu(), ref.pack_codes_ref(
        torch.from_numpy(codes), bits))
    host = words.cpu().numpy().view(np.uint32).astype("<u4")
    for p in range(3):
        stream = _wire_stream(codes[p], bits)
        assert host[p].tobytes()[:len(stream)] == stream
    back = ops.unpack_codes(words, 999, bits)
    assert np.array_equal(back.cpu().numpy(), codes)


def _attention_inputs(seed, dev, dtype, b, h, kv, s, hd):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal(shape).astype(np.float32))
                 .to(dev, dtype)
                 for shape in ((b * h, s, hd), (b * kv, s, hd),
                               (b * kv, s, hd)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,hd,window", [
    (1, 2, 2, 64, 16, None),      # MHA, one tile
    (2, 4, 2, 200, 32, None),     # GQA group 2, ragged S
    (1, 8, 2, 333, 128, 100),     # group 4, hd = 128, a window
    (2, 4, 1, 40, 64, None),      # S below one tile
    (1, 4, 2, 100, 40, None),     # hd not a multiple of 16
])
def test_flash_attention_kernel_matches_plain_on_card(dtype, b, h, kv, s, hd,
                                                      window):
    """f32 (the cuda_core route): within rtol 2e-4, atol 2e-5 of the plain
    version (the reference's flash tolerance); bf16: within 1e-2 of the
    plain version cast to bf16 (its output rounds to bf16, and the
    tensor_core route rounds P to bf16 before P·V; max |err| 1.56e-2 on
    an H100, one bf16 ulp in [2, 4), inside 1e-2·(1 + |value|)).
    The strided entry on (B, S, H, hd) views is bitwise the contiguous
    call."""
    dev = _cuda_or_skip()
    q, k, v = _attention_inputs(31, dev, dtype, b, h, kv, s, hd)
    kw = dict(num_q_heads=h, num_kv_heads=kv, scale=hd ** -0.5,
              window=window)
    want_route = "tensor_core" if dtype == torch.bfloat16 and hd % 16 == 0 \
        else "cuda_core"
    assert flash_route(dtype, hd) == want_route
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                               atol=2e-5 if dtype == torch.float32 else tol)
    views = [t.view(b, -1, s, hd).transpose(1, 2).contiguous()
             for t in (q, k, v)]
    strided = ops.flash_attention_strided(*views, scale=kw["scale"],
                                          window=window)
    assert torch.equal(strided.transpose(1, 2).reshape(q.shape), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_causal_on_card(dtype):
    """A perturbed last key changes no earlier output, bitwise (a masked
    score adds an exact 0), on both routes, at a ragged S with a window."""
    dev = _cuda_or_skip()
    q, k, v = _attention_inputs(32, dev, dtype, 1, 4, 2, 300, 64)
    kw = dict(num_q_heads=4, num_kv_heads=2, scale=0.125, window=70)
    o1 = ops.flash_attention(q, k, v, **kw)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 50.0
    v2[:, -1] += 50.0
    o2 = ops.flash_attention(q, k2, v2, **kw)
    assert torch.equal(o1[:, :-1], o2[:, :-1])
    assert not torch.equal(o1[:, -1], o2[:, -1])


@pytest.mark.gpu
def test_smoke_prefill_launch_counts_on_card():
    """One smoke prefill with the PQ uplink launches the flash kernel once
    per layer, lloyd_update once per Lloyd iteration and pq_quantize once;
    a decode step launches none of them."""
    from repro_torch.configs.llama3_8b import SMOKE_CONFIG
    from repro_torch.kernels import _build
    from repro_torch.launch.specs import make_model

    dev = _cuda_or_skip()
    model = make_model(SMOKE_CONFIG)
    with torch.inference_mode():
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        tokens = torch.randint(0, SMOKE_CONFIG.vocab_size, (2, 100),
                               device=dev)
        caches = model.init_caches(2, 101, dev)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        logits, caches = model.prefill(params, {"tokens": tokens}, caches,
                                       quantize=True)
        torch.cuda.synchronize()
        assert _build.launch_counts() == {
            "flash_attention": SMOKE_CONFIG.num_layers,
            "lloyd_update": model.pq.kmeans_iters, "pq_quantize": 1}
        _build.reset_launch_counts()
        logits, _ = model.decode_step(params, caches,
                                      logits[:, -1].argmax(-1, keepdim=True),
                                      100)
        torch.cuda.synchronize()
        assert _build.launch_counts() == {}
        assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the federated layer on the card
# ---------------------------------------------------------------------------

def _card_trainer(dev, **kw):
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.federated import FederatedTrainer
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    data = make_federated_image_data(num_clients=8, seed=0, device=dev)
    model = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=3), lam=1e-4,
                       client_batch=4, device=dev,
                       generator=torch.Generator().manual_seed(0))
    return FederatedTrainer(model, sgd(10 ** -1.5), data, cohort=3,
                            client_batch=4, **kw)


@pytest.mark.gpu
def test_short_trainer_run_on_card():
    """Two FullSync rounds through the trainer on the card (its default
    device): the kernels launch, the losses are finite, and the measured
    uplink is the pq frame of one client's 4 x 9216 cut."""
    from repro_torch.federated import wire
    from repro_torch.kernels import _build

    _cuda_or_skip()
    tr = _card_trainer("cuda")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    state, hist = tr.run(2, 0)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"lloyd_update": 3 * 3,
                                      "pq_quantize": 3}
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert tr.last_trace.meta["uplink_bytes_per_client"] == \
        wire.wire_bits(tr.uplink.cfg, 4, 9216) // 8
    assert all(p.is_cuda for p in state.params.values())


@pytest.mark.gpu
def test_wire_fed_by_codes_on_card():
    """Codes and codebooks that live on the card encode to the bytes of
    their host copies, for a pq batch of several clients and a chain."""
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.quantizer import PQConfig, QuantizedBatch, quantize
    from repro_torch.federated import wire

    dev = _cuda_or_skip()
    z = torch.randn((3, 24, 64), generator=torch.Generator().manual_seed(1))
    qb = quantize(z.to(dev), PQConfig(8, 5, kmeans_iters=3))
    host = QuantizedBatch(*(x.cpu() for x in qb))
    for c in range(3):
        for dtype in ("float16", "float32", "bfloat16"):
            assert wire.encode_bytes(qb, dtype, client=c) == \
                wire.encode_bytes(host, dtype, client=c)
    chain = make_compressor("chain:topk(k=0.1)+scalarq(bits=8)")
    comp = chain.compress(z.to(dev))
    payload = chain.wire_payload(comp, client=2)
    dec = wire.decode_payload(payload)
    assert dec.kind == "sparse" and dec.inner.kind == "scalar"
    np.testing.assert_allclose(wire.reconstruct(dec),
                               comp.recon[2].cpu().numpy(), rtol=0,
                               atol=float(comp.payload[1].scale[2]) * 0.5)


@pytest.mark.gpu
def test_scheduler_backends_agree_on_a_card_run():
    """The weighted path on the card (mobile fleet, AsyncBuffer, chain
    downlink, warm start) gives the same trace under both scheduler
    backends."""
    from repro_torch.federated import AsyncBuffer, mobile_fleet

    _cuda_or_skip()
    traces = []
    for backend in ("heapq", "vector"):
        tr = _card_trainer(
            "cuda", fleet=mobile_fleet(8, flaky_fraction=0.3, seed=0),
            policy=AsyncBuffer(2),
            downlink_compressor="chain:topk(k=0.1)+scalarq(bits=8)",
            warm_start=True, scheduler_backend=backend)
        _, hist = tr.run(3, 0)
        assert all(np.isfinite(h["loss"]) for h in hist)
        traces.append(tr.last_trace)
    a, b = traces
    assert [{**r.__dict__, "metrics": None} for r in a] == \
        [{**r.__dict__, "metrics": None} for r in b]
    assert len(a.flights) == len(b.flights)
    assert all(x == y for x, y in zip(a.flights, b.flights))


def _large_l(l, dev):
    """A large codebook's L: a number, or "threshold" (the card's
    ``generic_max_l``, the largest L of lloyd_update's generic route) or
    "threshold + 1" (the smallest of its tiled route)."""
    if isinstance(l, int):
        return l
    return generic_max_l(dev) + (1 if l.endswith("+ 1") else 0)


# lloyd_update's tiled route: L just above the generic route's threshold,
# the SO Tag grid's 100, the SO NWP grid's 960 and 2048, at D = 2, 16 and
# 32 (pq_quantize and kmeans_assign on their generic route)
TILED_L = ["threshold + 1", 100, 960, 2048]

# lloyd_update's generic route at the SO runs' (D, L) (Tag q = 250, 500,
# 1000; NWP q = 48, 12) and at its largest L at D = 64
GENERIC_LARGE = [(8, 20), (4, 20), (2, 10), (2, 60), (8, 30),
                 (64, "threshold")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,l", GENERIC_LARGE)
def test_generic_route_at_so_shapes_on_card(d, l, dtype):
    """lloyd_update on its generic route: counts exact, dsums bitwise the
    plain version in the route's order and run to run, a bf16 x bitwise
    its f32 upcast; pq_quantize and kmeans_assign on theirs: codes equal
    but for near-ties (and equal to each other), z̃ and the residual
    bitwise where codes agree, distances within 1e-5·(1 + ‖x‖²). Near-tie
    rows weigh 0; a ragged N."""
    dev = _cuda_or_skip()
    l = _large_l(l, dev)
    x, c = _inputs(35, dev, 3, 2501, d, l)
    x = x.to(dtype)
    lay = lloyd_layout(x, l)
    assert lay.route == "generic"
    assert pq_route(x, l) == assign_route(x, l, None) == "generic"
    ties = ref.near_ties(x, c, None)
    w = torch.where(ties, 0.0, torch.ones(3, 2501, device=dev)).contiguous()
    ds, cnt = lloyd_update_kernel(x, w, c)
    ds2, cnt2 = lloyd_update_kernel(x, w, c)
    ds_f, cnt_f = lloyd_update_kernel(x.float(), w, c)
    ds_o, cnt_o = lloyd_update_in_kernel_order(x, w, c, None, lay)
    _, cnt_r = ref.lloyd_update_ref(x, w, c)
    assert torch.equal(ds, ds2) and torch.equal(cnt, cnt2)
    assert torch.equal(ds, ds_f) and torch.equal(cnt, cnt_f)
    assert torch.equal(cnt, cnt_r) and torch.equal(cnt, cnt_o)
    assert torch.equal(ds, ds_o)
    zt, resid, codes = pq_quantize_kernel(x, c)
    zt_r, resid_r, codes_r = ref.pq_quantize_ref(x, c)
    same = codes == codes_r
    assert not bool((~same & ~ties).any())
    assert torch.equal(zt[same], zt_r[same])
    assert torch.equal(resid[same], resid_r[same])
    ka, sq = kmeans_assign_kernel(x, c)
    _, sq_r = ref.kmeans_assign_ref(x, c)
    assert torch.equal(ka, codes)
    tol = 1e-5 * (1 + x.float().square().sum(-1))
    assert bool(((sq - sq_r).abs()[same] <= tol[same]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2, 16, 32])
@pytest.mark.parametrize("l", TILED_L)
def test_tiled_lloyd_update_matches_plain_on_card(l, d, dtype):
    """Counts exact; dsums bitwise the plain version summed in the route's
    (the generic route's) block order; bitwise run to run; a bf16 x
    bitwise its f32 upcast; near-tie rows weigh 0. N = 1500 < L = 2048
    leaves most clusters empty: count 0, sums 0."""
    dev = _cuda_or_skip()
    l = _large_l(l, dev)
    x, c = _inputs(31, dev, 3, 1500, d, l)
    x = x.to(dtype)
    lay = lloyd_layout(x, l)
    assert lay.route == "tiled"
    w = torch.where(ref.near_ties(x, c, None), 0.0,
                    torch.ones(3, 1500, device=dev)).contiguous()
    ds, cnt = lloyd_update_kernel(x, w, c)
    ds2, cnt2 = lloyd_update_kernel(x, w, c)
    ds_f, cnt_f = lloyd_update_kernel(x.float(), w, c)
    ds_o, cnt_o = lloyd_update_in_kernel_order(x, w, c, None, lay)
    _, cnt_r = ref.lloyd_update_ref(x, w, c)
    assert torch.equal(ds, ds2) and torch.equal(cnt, cnt2)
    assert torch.equal(ds, ds_f) and torch.equal(cnt, cnt_f)
    assert torch.equal(cnt, cnt_r) and torch.equal(cnt, cnt_o)
    assert torch.equal(ds, ds_o)
    empty = cnt == 0
    assert bool((ds[empty] == 0).all())
    assert bool(empty.any()) or l < 1500


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2, 16, 32])
@pytest.mark.parametrize("l", TILED_L)
def test_tiled_pq_quantize_and_kmeans_assign_match_plain_on_card(l, d,
                                                                dtype):
    """pq_quantize: codes equal but for near-ties, z̃ and the residual
    bitwise where codes agree. kmeans_assign: the same codes, distances
    within 1e-5·(1 + ‖x‖²), also through a mask (all valid but the last
    centroid). Both bitwise run to run, a bf16 x bitwise its f32 upcast;
    a ragged N."""
    dev = _cuda_or_skip()
    l = _large_l(l, dev)
    x, c = _inputs(32, dev, 3, 1501, d, l)
    x = x.to(dtype)
    assert row_route(x, l) == "tiled"
    assert pq_route(x, l) == assign_route(x, l, None) == "generic"
    zt, resid, codes = pq_quantize_kernel(x, c)
    zt_r, resid_r, codes_r = ref.pq_quantize_ref(x, c)
    same = codes == codes_r
    ties = ref.near_ties(x, c, None)
    assert not bool((~same & ~ties).any())
    assert torch.equal(zt[same], zt_r[same])
    assert torch.equal(resid[same], resid_r[same])
    zt2, resid2, codes2 = pq_quantize_kernel(x, c)
    assert torch.equal(zt, zt2) and torch.equal(resid, resid2) \
        and torch.equal(codes, codes2)
    zt_f, resid_f, codes_f = pq_quantize_kernel(x.float(), c)
    assert torch.equal(codes, codes_f) and torch.equal(resid, resid_f)
    assert torch.equal(zt, zt_f.to(dtype))
    lmask = torch.ones(l, device=dev)
    lmask[-1] = 0.0
    for mask in (None, lmask):
        ka, sq = kmeans_assign_kernel(x, c, mask)
        ka_r, sq_r = ref.kmeans_assign_ref(x, c, mask)
        agree = ka.long() == ka_r
        assert not bool((~agree & ~ref.near_ties(x, c, mask)).any())
        tol = 1e-5 * (1 + x.float().square().sum(-1))
        assert bool(((sq - sq_r).abs()[agree] <= tol[agree]).all())
        ka_f, sq_f = kmeans_assign_kernel(x.float(), c, mask)
        assert torch.equal(ka, ka_f) and torch.equal(sq, sq_f)
        if mask is None:
            assert torch.equal(ka, codes)
        else:
            assert not bool((ka == l - 1).any())


@pytest.mark.gpu
@pytest.mark.parametrize("l", ["threshold + 1", 960])
def test_tiled_three_kernels_pick_the_same_codes_on_card(l):
    """Rows midway between two centroids: kmeans_assign, pq_quantize and
    lloyd_update (one-row problems) give each the same code."""
    dev = _cuda_or_skip()
    l = _large_l(l, dev)
    x, c = _inputs(33, dev, 1, 1000, 16, l)
    r = np.random.default_rng(34)
    a, b = r.integers(0, l, 1000), r.integers(0, l, 1000)
    x[0] = (c[0, a] + c[0, b]) / 2 + 1e-7 * x[0]
    codes_a, _ = ops.kmeans_assign(x, c)
    _, _, codes_q = ops.pq_quantize(x, c)
    rows = x[0].reshape(1000, 1, 16).contiguous()
    _, cnt = ops.lloyd_update(rows, c.expand(1000, -1, -1).contiguous())
    assert torch.equal(cnt.sum(-1), torch.ones(1000, device=dev))
    assert torch.equal(codes_a[0], codes_q[0])
    assert torch.equal(codes_a[0], cnt.argmax(-1).to(torch.int32))


# the three clustering kernels at D above one chunk of dims (D_TILE = 64):
# (D, L, P, N) with lloyd_update on its generic route (L <= 64) or its
# tiled one ("threshold + 1"); D = 9216 is vanilla k-means on the FEMNIST
# cut (20 rows), D = 96 the FEMNIST example at --q 96 and SO NWP at q = 1
ANY_D = [(65, 3, 2, 700), (96, 2, 3, 1920), (128, 20, 2, 600),
         (96, "threshold + 1", 2, 500), (9216, 2, 1, 20),
         (9216, 64, 1, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,l,p,n", ANY_D)
def test_three_kernels_at_any_d_on_card(d, l, p, n, dtype):
    """Above D = 64, where the kernels refused D before: lloyd_update's
    counts exact and dsums bitwise the plain version in its route's order
    (chunks of dims split outputs, never a sum) and run to run, a bf16 x
    bitwise its f32 upcast; pq_quantize's and kmeans_assign's codes equal
    the plain version's but for near-ties and each other's, z̃ and the
    residual bitwise where codes agree, distances within the f32 rounding
    bound of two orders of D-term chains. Near-tie rows weigh 0."""
    dev = _cuda_or_skip()
    l = _large_l(l, dev)
    x, c = _inputs(36, dev, p, n, d, l)
    x = x.to(dtype)
    lay = lloyd_layout(x, l)
    assert lay.route == ("generic" if l <= 64 else "tiled")
    assert pq_route(x, l) == assign_route(x, l, None) == "generic"
    ties = ref.near_ties(x, c, None)
    w = torch.where(ties, 0.0, torch.ones(p, n, device=dev)).contiguous()
    ds, cnt = lloyd_update_kernel(x, w, c)
    ds2, cnt2 = lloyd_update_kernel(x, w, c)
    ds_f, cnt_f = lloyd_update_kernel(x.float(), w, c)
    ds_o, cnt_o = lloyd_update_in_kernel_order(x, w, c, None, lay)
    _, cnt_r = ref.lloyd_update_ref(x, w, c)
    assert torch.equal(ds, ds2) and torch.equal(cnt, cnt2)
    assert torch.equal(ds, ds_f) and torch.equal(cnt, cnt_f)
    assert torch.equal(cnt, cnt_r) and torch.equal(cnt, cnt_o)
    assert torch.equal(ds, ds_o)
    zt, resid, codes = pq_quantize_kernel(x, c)
    zt_r, resid_r, codes_r = ref.pq_quantize_ref(x, c)
    same = codes == codes_r
    assert not bool((~same & ~ties).any())
    assert torch.equal(zt[same], zt_r[same])
    assert torch.equal(resid[same], resid_r[same])
    ka, sq = kmeans_assign_kernel(x, c)
    _, sq_r = ref.kmeans_assign_ref(x, c)
    assert torch.equal(ka, codes)
    # ‖x‖² − best from chains of D terms, summed in another order by the
    # plain version's matmul: each within γ_D·Σ(|x_k| + |c_k|)² of exact
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    mag = (x.float().abs() + ref._gather_rows(c, codes.long()).abs()) \
        .square().sum(-1)
    tol = 2 * gamma * mag
    assert bool(((sq - sq_r).abs()[same] <= tol[same]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("l", [2, 8, 32, 64])
def test_vanilla_kmeans_on_the_femnist_cut_on_card(l):
    """kmeans() as Fig. 3's vanilla k-means runs it: 20 rows of the 9216-wide
    cut, one codebook of L, through the kernels ("auto") and the plain
    versions ("torch") on the card: the same codes but for near-ties, and
    centroids within f32 reordering."""
    from repro_torch.core.kmeans import kmeans
    from repro_torch.kernels import _build

    dev = _cuda_or_skip()
    x = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (20, 9216)).astype(np.float32)).to(dev)
    _build.reset_launch_counts()
    c_k, codes_k, _ = kmeans(x, l, 6, backend="auto")
    torch.cuda.synchronize()
    assert _build.launch_counts().get("lloyd_update") == 6
    c_t, codes_t, _ = kmeans(x, l, 6, backend="torch")
    assert torch.equal(codes_k, codes_t)
    assert torch.allclose(c_k, c_t, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_so_tag_round_at_l100_on_card():
    """One SO Tag round at full width, PQ q = 125 L = 100 (D = 16): the
    kernels refused L > 64 with a ValueError before they took any L; now
    lloyd_update launches on its tiled route, pq_quantize on its generic
    one, and the loss is finite."""
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_tag_data
    from repro_torch.federated import FederatedTrainer, wire
    from repro_torch.kernels import _build
    from repro_torch.models.paper_models import SOTagMLP
    from repro_torch.optim import adagrad

    _cuda_or_skip()
    pq = PQConfig(num_subvectors=125, num_clusters=100, kmeans_iters=5)
    model = SOTagMLP(pq=pq, lam=1e-3, client_batch=100,
                     generator=torch.Generator().manual_seed(0))
    data = make_federated_tag_data(num_clients=32, seed=0)
    tr = FederatedTrainer(model, adagrad(10 ** -0.5), data, cohort=10,
                          client_batch=100)
    x = torch.empty((10, 12500, 16), device="cuda")
    assert row_route(x, 100) == "tiled" and pq_route(x, 100) == "generic"
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    state, hist = tr.run(1, 0)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"lloyd_update": 10, "pq_quantize": 2}
    assert np.isfinite(hist[0]["loss"])
    assert tr.last_trace.meta["uplink_bytes_per_client"] == \
        wire.wire_bits(pq, 100, 2000) // 8
    r5 = model.recall_at_5(data.eval_batch(np.random.default_rng(1), 256))
    assert 0.0 <= float(r5) <= 1.0


def _same_twice(step, state, batch):
    """Params after ``step`` from one state and batch, run three times:
    bitwise each time."""
    first = step(state, batch)[0].params
    for _ in range(2):
        again = step(state, batch)[0].params
        for k in first:
            assert torch.equal(first[k], again[k]), k


@pytest.mark.gpu
def test_femnist_step_is_bitwise_repeatable_on_card():
    """A resumed run recomputes rounds: the FedLite step with its cuDNN
    convolutions must give the same bits every time on the same inputs."""
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(0)
    model = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=5), lam=1e-4,
                       client_batch=8, generator=gen)
    state = TrainState.create(dict(model.named_parameters()), sgd(0.03))
    batch = {"image": torch.rand((32, 28, 28, 1), generator=gen).to(dev),
             "label": torch.randint(0, 62, (32,), generator=gen).to(dev)}
    _same_twice(make_train_step(model, sgd(0.03)), state, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [16, 160])   # 480 and 4800 tokens
def test_nwp_step_is_bitwise_repeatable_on_card(rows):
    """The SO NWP step with Adam at (q, L) = (48, 60), its embedding
    backward over repeated tokens included, gives the same bits every
    time (both of F.embedding's backward kernels: below and above its
    3072-index switch)."""
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.models.paper_models import SONwpLSTM
    from repro_torch.optim import adam

    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(1)
    model = SONwpLSTM(vocab=300, hidden=64, pq=PQConfig(48, 60,
                                                        kmeans_iters=3),
                      lam=1e-3, client_batch=16, generator=gen)
    state = TrainState.create(dict(model.named_parameters()), adam(0.01))
    tokens = torch.randint(0, 40, (rows, 30), generator=gen).to(dev)
    labels = torch.cat([tokens[:, 1:], torch.full((rows, 1), -1,
                                                  device=dev)], 1)
    _same_twice(make_train_step(model, adam(0.01)), state,
                {"tokens": tokens, "labels": labels})


@pytest.mark.gpu
def test_snapshot_round_trip_on_card(tmp_path):
    """A tree of card tensors (f32, bf16, int32) saved and restored onto
    the card bitwise; a TrainState through the snapshot layout too."""
    from repro_torch.checkpointing import restore_checkpoint, save_checkpoint
    from repro_torch.core.fedlite import TrainState
    from repro_torch.federated.recovery import (state_from_leaves,
                                                state_leaves)
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import adam

    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(2)
    tree = {"a": {"f32": torch.randn((64, 33), generator=gen).to(dev),
                  "bf16": torch.randn(129, generator=gen).to(dev)
                  .to(torch.bfloat16)},
            "i": torch.arange(7, dtype=torch.int32, device=dev)}
    save_checkpoint(str(tmp_path / "t"), 3, tree, extra={"v": 1})
    back = restore_checkpoint(str(tmp_path / "t"))
    for got, want in ((back["a"]["f32"], tree["a"]["f32"]),
                      (back["a"]["bf16"], tree["a"]["bf16"]),
                      (back["i"], tree["i"])):
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(got, want)
    model = FemnistCNN(generator=gen)
    state = TrainState.create(dict(model.named_parameters()), adam(0.01))
    save_checkpoint(str(tmp_path / "s"), 0, {"train": {
        f"{i:04d}": x for i, x in enumerate(state_leaves(state))}})
    tree = restore_checkpoint(str(tmp_path / "s"))
    again = state_from_leaves([tree["train"][k]
                               for k in sorted(tree["train"])], state)
    for k, p in state.params.items():
        assert again.params[k].is_cuda and torch.equal(again.params[k], p)
    for part in ("m", "v"):
        for k in state.params:
            assert torch.equal(again.opt_state[part][k],
                               state.opt_state[part][k])
    assert again.step == state.step and again.opt_state["step"] == 0


# ---------------------------------------------------------------------------
# the LM zoo's training on the card (MoE dispatch, the SSM scan, the train
# step of every architecture with the kernels against the plain route)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_moe_dispatch_on_card():
    """A dropping MoE layer (capacity factor 0.5) on the card and on the
    CPU from the same f32 weights and input: the same gate indices and
    kept pairs, the output and aux loss within 1e-5."""
    import dataclasses
    from repro_torch.configs import mixtral_8x22b
    from repro_torch.models import moe

    dev = _cuda_or_skip()
    cfg = dataclasses.replace(mixtral_8x22b.SMOKE_CONFIG, capacity_factor=0.5)
    gen = torch.Generator().manual_seed(4)
    p = moe.moe_init(gen, cfg, torch.float32, device="cpu")
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    out = {}
    for d in ("cpu", dev):
        pd = {k: v.to(d) for k, v in p.items()}
        xg = x.to(d).reshape(1, -1, cfg.d_model)
        _, idx = moe.top_k(torch.softmax(xg @ pd["router"], -1),
                           cfg.experts_per_token)
        dest, keep = moe.dispatch_slots(idx, cfg.num_experts,
                                        moe.capacity_of(cfg, 128))
        y, aux = moe.apply_moe(pd, x.to(d), cfg)
        out[str(d)] = [t.cpu() for t in (idx, dest, keep, y, aux)]
    cpu, card = out["cpu"], out[str(dev)]
    assert not bool(cpu[2].all())
    for a, b in zip(cpu[:3], card[:3]):
        assert torch.equal(a, b)
    for a, b in zip(cpu[3:], card[3:]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_ssm_scan_on_card():
    """ssd_scan on the card in f32 against the CPU (within 1e-4), with a
    chunk that divides S and one that does not, and finite gradients
    through the rematerialized chunks."""
    from repro_torch.models import ssm

    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(5)
    B, S, H, P, N = 2, 96, 4, 16, 8
    xh = torch.randn((B, S, H, P), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
    A = -torch.exp(torch.randn(H, generator=gen))
    Bm = torch.randn((B, S, N), generator=gen)
    Cm = torch.randn((B, S, N), generator=gen)
    for chunk in (32, 40):
        y, h = ssm.ssd_scan(xh, dt, A, Bm, Cm, chunk)
        ins = [t.to(dev).requires_grad_() for t in (xh, dt, A, Bm, Cm)]
        yc, hc = ssm.ssd_scan(*ins, chunk)
        torch.testing.assert_close(yc.detach().cpu(), y, rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(hc.detach().cpu(), h, rtol=1e-4,
                                   atol=1e-4)
        (yc.square().mean() + hc.square().mean()).backward()
        assert all(bool(torch.isfinite(t.grad).all()) for t in ins)


LM_ARCHS = ["starcoder2_3b", "mamba2_1p3b", "mixtral_8x22b",
            "jamba_v0p1_52b", "gemma_7b", "llama4_maverick_400b",
            "qwen2_vl_2b", "musicgen_large", "llama3_8b", "command_r_35b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_kernels_vs_plain_on_card(arch):
    """Two make_train_step steps of the smoke config on the card (f32,
    Adam, PQ at the cut), each from one state through lloyd_update and
    pq_quantize (4 + 1 launches a step) and on the plain versions (PQ
    backend "torch", no launch of them; an MoE arch launches its
    dispatch and combine kernels alike in both steps): the two losses
    within 1e-4 relative (a
    PQ code may flip at a near-tie between the two Lloyd orders; the next
    state is the kernels' step's, since Adam turns such a flip into an
    lr-sized difference of the params)."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.kernels import _build
    from repro_torch.launch.specs import make_model
    from repro_torch.launch.train import make_batch, step_rng
    from repro_torch.optim import adam

    dev = _cuda_or_skip()
    cfg = get_arch(arch, smoke=True)
    params = make_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    kernel_step, plain_step = (
        make_train_step(make_model(dataclasses.replace(cfg, pq_backend=b)),
                        adam(1e-3)) for b in ("auto", "torch"))
    state = TrainState.create(params, adam(1e-3))

    def counts():
        """(the cut kernels' launches, the MoE kernels'): the MoE takes
        its kernels on the card whatever the PQ backend."""
        c = _build.launch_counts()
        moe = {k: v for k, v in c.items() if k.startswith("moe_")}
        return {k: v for k, v in c.items() if k not in moe}, moe
    for s in range(2):
        batch = make_batch(cfg, step_rng(0, s), 2, 64, dev)
        _build.reset_launch_counts()
        _, m_p = plain_step(state, batch)
        torch.cuda.synchronize()
        cut, moe_p = counts()
        assert cut == {}
        _build.reset_launch_counts()
        state, m_k = kernel_step(state, batch)
        torch.cuda.synchronize()
        cut, moe_k = counts()
        assert cut == {"lloyd_update": 4, "pq_quantize": 1}
        assert moe_k == moe_p
        assert np.isfinite(float(m_k["loss"]))
        np.testing.assert_allclose(float(m_k["loss"]), float(m_p["loss"]),
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# the cohort-parallel executor on the card
# ---------------------------------------------------------------------------

MESH_COHORT, MESH_B, MESH_ITERS = 10, 20, 5


def _femnist_trainer(dev, executor, weights=None):
    """The FEMNIST run at full width (q = 1152, L = 2, 5 Lloyd iterations,
    cohort 10 of 20 examples, sgd(10**-1.5)) on ``executor``."""
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.federated import FederatedTrainer
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    model = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=MESH_ITERS),
                       lam=1e-4, client_batch=MESH_B, device=dev,
                       generator=torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict(weights)
    data = make_federated_image_data(num_clients=64, seed=0, device=dev)
    return FederatedTrainer(model, sgd(10 ** -1.5), data,
                            cohort=MESH_COHORT, client_batch=MESH_B,
                            device=dev, executor=executor)


def _hold_to_stacked(mesh_loss, mesh_params, stacked_loss, stacked_params):
    """The reference's stacked-vs-mesh bounds (tests/test_executor.py)."""
    np.testing.assert_allclose(mesh_loss, stacked_loss, rtol=5e-4)
    for k, v in stacked_params.items():
        torch.testing.assert_close(mesh_params[k].detach().cpu(),
                                   v.detach().cpu(), rtol=5e-3, atol=5e-5)


@pytest.mark.gpu
def test_mesh_world_of_one_matches_stacked_on_card():
    """One FEMNIST round on the mesh at a world of one (NCCL) against the
    stacked executor: the loss and params within the reference's bounds,
    the stacked path's launches exactly (the cohort fused into one batch:
    5 lloyd_update and 1 pq_quantize, and the wire measurement's
    compress)."""
    from repro_torch.kernels import _build

    dev = _cuda_or_skip()
    s_st, h_st = _femnist_trainer(dev, "stacked").run(1, 0)
    mesh = _femnist_trainer(dev, "mesh")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    s_me, h_me = mesh.run(1, 0)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"lloyd_update": 2 * MESH_ITERS,
                                      "pq_quantize": 2}
    assert mesh.executor.num_shards == 1
    _hold_to_stacked(h_me[0]["loss"], s_me.params, h_st[0]["loss"],
                     s_st.params)


def _mesh_rank_on_card(rank, world, store, out):
    """A spawned rank: one FEMNIST round on a ``world``-shard gloo mesh on
    cuda:0, its params and loss saved to ``out``."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        state, hist = _femnist_trainer(
            "cuda", f"mesh(shards={world},backend=gloo)").run(1, 0)
        torch.save({"loss": hist[0]["loss"],
                    "params": {k: v.detach().cpu()
                               for k, v in state.params.items()}}, out)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_mesh_two_gloo_ranks_on_card(tmp_path):
    """Two spawned ranks on one card (gloo: NCCL refuses two ranks on one
    device), the kernels built before the spawn: one round, the ranks'
    params bitwise equal and rank 0 within the reference's bounds of the
    stacked round."""
    import torch.multiprocessing as mp

    from repro_torch.kernels import _build

    dev = _cuda_or_skip()
    _build.build(["lloyd_update", "pq_quantize"])
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank_on_card,
                         args=(r, 2, str(tmp_path / "store"),
                               str(tmp_path / f"rank{r}.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(ranks[1]["params"][k], v), k
    s_st, h_st = _femnist_trainer(dev, "stacked").run(1, 0)
    _hold_to_stacked(ranks[0]["loss"], ranks[0]["params"], h_st[0]["loss"],
                     s_st.params)


def _one_rank_mesh_on_card():
    """A (data=1, model=1) mesh over a NCCL world of one (made here unless
    a group is open); returns (mesh, True if the group was made here)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    owns = not dist.is_initialized()
    return make_debug_mesh(1, 1, device="cuda"), owns


@pytest.mark.gpu
def test_cut_under_a_one_rank_mesh_is_the_unsharded_cut_on_card():
    """TransformerLM.cut_activation on a DTensor over a 1 x 1 NCCL mesh:
    the kernels run on the local block (4 lloyd_update and 1 pq_quantize
    launches, as unsharded), z̃, the distortion and the eq.-5 gradient
    bitwise the unsharded cut's."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.specs import make_model
    from repro_torch.sharding.ctx import BATCH, P, to_placements, use_mesh

    dev = _cuda_or_skip()
    cfg = dataclasses.replace(get_arch("llama3_8b", smoke=True),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = make_model(cfg)
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((4, 64, cfg.d_model), generator=gen).to(
        dev, torch.bfloat16)
    w = torch.randn(x0.shape, generator=gen).to(dev, torch.bfloat16)

    def cut(x):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        z, stats = model.cut_activation(x, quantize=True)
        full = z.full_tensor() if hasattr(z, "full_tensor") else z
        (full.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        return z, stats["pq_distortion"], _build.launch_counts()

    x = x0.clone().requires_grad_()
    z, dist_, counts = cut(x)
    mesh, owns = _one_rank_mesh_on_card()
    try:
        with use_mesh(mesh):
            xd = distribute_tensor(x0.clone(), mesh, to_placements(
                P(BATCH, None, None), mesh)).requires_grad_()
            zd, dist_d, counts_d = cut(xd)
            assert torch.equal(zd.full_tensor(), z)
            assert torch.equal(dist_d.full_tensor(), dist_)
            assert torch.equal(xd.grad.full_tensor(), x.grad)
    finally:
        if owns:
            dist.destroy_process_group()
    assert counts == counts_d == {"lloyd_update": 4, "pq_quantize": 1}


@pytest.mark.gpu
def test_kernel_wrappers_refuse_a_dtensor_on_card():
    """A CUDA DTensor handed straight to a kernel wrapper raises: the
    kernels read raw pointers, so under a mesh they take local blocks."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    dev = _cuda_or_skip()
    x, c = _inputs(0, dev, 2, 64, 8, 16)
    mesh, owns = _one_rank_mesh_on_card()
    try:
        xd = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        with pytest.raises(TypeError, match="DTensor"):
            ops.pq_quantize(xd, c)
        with pytest.raises(TypeError, match="DTensor"):
            ops.lloyd_update(xd, c)
    finally:
        if owns:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# host syncs on the card (repro_torch.lint.dispatch)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_femnist_step_host_syncs_include_the_copies_on_card():
    """On CUDA tensors ``host_syncs`` also sees the copies to the host (on
    the CPU there are none to see): a FEMNIST step, then its loss copied
    to the host, each sync with its op and a line of this repo."""
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.lint import dispatch
    from repro_torch.optim import sgd

    dev = _cuda_or_skip()
    trainer = _femnist_trainer(dev, "stacked")
    model = trainer.model
    state = TrainState.create(dict(model.named_parameters()), sgd(0.03))
    rng = np.random.default_rng(0)
    parts = [trainer.data.sample_batch(c, rng, MESH_B) for c in range(3)]
    batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    step = make_train_step(model, sgd(0.03))

    def step_and_read():
        _, met = step(state, batch)
        return met["loss"].cpu()

    syncs = dispatch.host_syncs(step_and_read)
    copies = dispatch.copies_to_host(syncs)
    line = step_and_read.__code__.co_firstlineno + 2
    assert copies[-1] == ("aten._to_copy (cuda -> cpu)",
                          f"tests/test_torch_gpu.py:{line}")
    assert all(":" in s.where and not s.where.startswith("<")
               for s in syncs)


@pytest.mark.gpu
def test_fullsync_copies_to_host_do_not_grow_with_rounds_on_card():
    """The FullSync run's copies to the host are the CPU test's three
    (.cpu() of the wire measurement's codes and codebooks, and the metrics
    of every round in one transfer) for 2 rounds and for 4."""
    from repro_torch.lint import dispatch

    dev = _cuda_or_skip()
    copies = []
    for rounds in (2, 4):
        trainer = _femnist_trainer(dev, "stacked")
        with dispatch.recording_syncs() as syncs:
            trainer.run(rounds, 0)
        copies.append(dispatch.copies_to_host(syncs))
    assert len(copies[0]) == len(copies[1]) == 3, copies
    assert [s.where for s in copies[0]] == [s.where for s in copies[1]]
