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
from repro_torch.kernels.lloyd_update import lloyd_update_in_kernel_order


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, dev, p, n, d, l):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((p, n, d)).astype(np.float32))
    c = torch.from_numpy(r.standard_normal((p, l, d)).astype(np.float32))
    return x.to(dev), c.to(dev)


@pytest.mark.gpu
def test_lloyd_update_kernel_matches_plain_on_card():
    """Counts exact; deviation sums bitwise those of the plain version in
    the kernel's order and within f32 reordering of the plain order;
    bitwise run to run; a ragged N and a masked codebook (L=3 padded to
    8). Near-tie rows, where either code is right, weigh 0."""
    dev = _cuda_or_skip()
    x, c = _inputs(21, dev, 4, 3000, 8, 3)
    cp, lmask = ops._pad_centroids(c)
    w = (torch.arange(3000, device=dev) < 2900).float().expand(4, -1)
    w = torch.where(ref.near_ties(x, cp, lmask), 0.0, w).contiguous()
    ds, cnt = ops.lloyd_update(x, c, w)
    ds2, cnt2 = ops.lloyd_update(x, c, w)
    ds_o, cnt_o = lloyd_update_in_kernel_order(x, w, cp, lmask)
    ds_r, cnt_r = ref.lloyd_update_ref(x, w, cp, lmask)
    assert torch.equal(ds, ds2) and torch.equal(cnt, cnt2)
    assert torch.equal(cnt, cnt_r[:, :3]) and torch.equal(cnt, cnt_o[:, :3])
    assert torch.equal(ds, ds_o[:, :3])
    assert float(((ds - ds_r[:, :3]).abs()
                  / (1 + ds_r[:, :3].abs())).max()) <= 2e-5


@pytest.mark.gpu
def test_pq_quantize_kernel_matches_plain_on_card():
    """Codes equal but for near-ties; z̃ and the residual bitwise equal
    wherever the codes agree (L=16, ragged N)."""
    dev = _cuda_or_skip()
    x, c = _inputs(22, dev, 4, 3001, 8, 16)
    zt, resid, codes = ops.pq_quantize(x, c)
    zt_r, resid_r, codes_r = ref.pq_quantize_ref(x, c,
                                                 torch.ones(16, device=dev))
    same = codes == codes_r
    ties = ref.near_ties(x, c, torch.ones(16, device=dev))
    assert not bool((~same & ~ties).any())
    assert torch.equal(zt[same], zt_r[same])
    assert torch.equal(resid[same], resid_r[same])


@pytest.mark.gpu
def test_kmeans_assign_kernel_matches_plain_on_card():
    """Codes equal but for near-ties; squared distances within
    1e-5·(1 + ‖x‖²) (ragged N, L=3 masked in a codebook padded to 8)."""
    dev = _cuda_or_skip()
    x, c = _inputs(23, dev, 4, 3001, 8, 3)
    codes, sq = ops.kmeans_assign(x, c)
    cp, lmask = ops._pad_centroids(c)
    codes_r, sq_r = ref.kmeans_assign_ref(x, cp, lmask)
    ties = ref.near_ties(x, cp, lmask)
    assert codes.dtype == torch.int32 and int(codes.max()) <= 2
    assert not bool(((codes != codes_r) & ~ties).any())
    tol = 1e-5 * (1 + x.square().sum(-1))
    assert bool(((sq - sq_r).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 4, 8, 16])
def test_scalar_quantize_kernel_is_the_plain_version_on_card(bits):
    """Codes and recon bitwise those of the plain version (no FMA
    contraction, half-to-even rounding), per-problem ranges, ragged N."""
    dev = _cuda_or_skip()
    r = np.random.default_rng(24)
    x = torch.from_numpy(r.standard_normal((3, 4097)).astype(np.float32))
    x = x.to(dev)
    lo = x.amin(-1)
    scale = (x.amax(-1) - lo) / ((1 << bits) - 1)
    codes, recon = ops.scalar_quantize(x, lo, scale, bits)
    codes_r, recon_r = ref.scalar_quantize_ref(x, lo, scale, bits)
    assert torch.equal(codes, codes_r) and torch.equal(recon, recon_r)


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
