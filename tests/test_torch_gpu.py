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
