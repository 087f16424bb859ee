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
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.lloyd_update import (lloyd_update_in_kernel_order,
                                              lloyd_update_kernel)
from repro_torch.kernels.pq_quantize import pq_quantize_kernel

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


@pytest.mark.parametrize("n,rows_per_block", [(300, 64), (64, 1024)])
def test_lloyd_update_in_kernel_order_matches_jax_ref(n, rows_per_block):
    """The plain version in the kernel's summation order: counts exact,
    dsums to f32 reordering of the JAX oracle, padding rows add nothing."""
    x, c = _inputs(n + 2, 2, n, 8, 3)
    cp, lmask = tops._pad_centroids(_t(c))
    w = (torch.arange(n) < n - 7).float().expand(2, -1)
    ds, ct = lloyd_update_in_kernel_order(_t(x), w, cp, lmask,
                                          rows_per_block)
    for p in range(2):
        ds_r, ct_r = jref.lloyd_update_ref(
            jnp.asarray(x[p]), jnp.asarray(w[p].numpy()),
            jnp.asarray(cp[p].numpy()), jnp.asarray(lmask.numpy()))
        np.testing.assert_array_equal(ct[p].numpy(), np.asarray(ct_r))
        np.testing.assert_allclose(ds[p].numpy(), np.asarray(ds_r),
                                   rtol=1e-5, atol=1e-5)


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
    assert _build.launch_counts() == {}


def test_kernel_libraries_are_named_by_their_sources():
    path = _build.library_path("lloyd_update")
    assert path.parent == REPO_ROOT / "build" / "repro_torch"
    assert path.name.startswith("liblloyd_update-") and path.suffix == ".so"
    assert path != _build.library_path("pq_quantize")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


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
