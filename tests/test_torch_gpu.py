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
from repro_torch.kernels.lloyd_update import (lloyd_layout,
                                              lloyd_update_in_kernel_order,
                                              lloyd_update_kernel, row_route)
from repro_torch.kernels.pq_quantize import pq_quantize_kernel
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
