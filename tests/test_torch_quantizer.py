"""Parity of the PyTorch port's quantizer stack with the JAX package.

Covers k-means seeding and Lloyd iterations, the grouped PQ ``quantize``
(against the JAX package's ``"jnp"`` backend, one JAX call per client), the
eq.-5 correction VJP, the accounting helpers, the optimizer and the split
accounting. Inputs come from a numpy seed and cross as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import correction as jcorr
from repro.core import kmeans as jkm
from repro.core import quantizer as jq
from repro.core import split as jsplit
from repro.optim import sgd as jsgd
from repro_torch.core import correction as tcorr
from repro_torch.core import kmeans as tkm
from repro_torch.core import quantizer as tq
from repro_torch.core import split as tsplit
from repro_torch.optim import constant, sgd as tsgd

TOL = dict(rtol=1e-5, atol=1e-5)


def _acts(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,l", [(300, 4), (1000, 8), (50, 2)])
def test_init_centroids_matches_jax(n, l):
    x = _acts(n, 2, n, 8)
    cents = tkm._init_centroids(torch.from_numpy(x), l)
    for p in range(2):
        ref = jkm._init_centroids(jnp.asarray(x[p]), l, None)
        np.testing.assert_array_equal(cents[p].numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,chunk", [(100, 4096), (700, 256)])
def test_batched_lloyd_matches_jax(n, chunk):
    x = _acts(n + 3, 3, n, 8)
    cents = tkm.batched_lloyd(torch.from_numpy(x), 4, 6, chunk=chunk,
                              backend="torch")
    ref = jkm.batched_lloyd(jnp.asarray(x), 4, 6, chunk=chunk,
                            backend="jnp")
    np.testing.assert_allclose(cents.numpy(), np.asarray(ref), **TOL)


def test_lloyd_single_problem_matches_jax():
    x = _acts(5, 200, 8)
    cents = tkm.lloyd(torch.from_numpy(x), 3, 4, backend="torch")
    ref = jkm.lloyd(jnp.asarray(x), 3, 4, backend="jnp")
    np.testing.assert_allclose(cents.numpy(), np.asarray(ref), **TOL)
    seeds = tkm.lloyd(torch.from_numpy(x), 3, 0)
    np.testing.assert_array_equal(
        seeds.numpy(), tkm._init_centroids(torch.from_numpy(x)[None], 3)[0])


def test_lloyd_empty_cluster_keeps_its_centroid():
    """Identical rows seed two identical centroids; ties go to the first,
    so the second stays empty and keeps its centroid exactly."""
    x = np.tile(_acts(8, 1, 1, 4), (1, 64, 1))
    cents = tkm.batched_lloyd(torch.from_numpy(x), 2, 3)
    np.testing.assert_array_equal(cents[0].numpy(), np.tile(x[0, :1], (2, 1)))
    ref = jkm.batched_lloyd(jnp.asarray(x), 2, 3, backend="jnp")
    np.testing.assert_array_equal(cents.numpy(), np.asarray(ref))


def test_backend_registry():
    assert set(tkm.available_backends()) == {"torch", "cuda", "auto"}
    assert tkm.resolve_backend("auto", torch.device("cpu")) == "torch"
    assert tkm.resolve_backend("auto", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError):
        tkm.get_backend("pallas", torch.device("cpu"))
    with pytest.raises(ValueError):
        tq.PQConfig(4, 2, backend="triton")


def test_cuda_backend_raises_on_cpu_tensors():
    """No fallback: the "cuda" backend never computes on the CPU."""
    z = torch.from_numpy(_acts(1, 1, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tq.quantize(z, tq.PQConfig(2, 2, backend="cuda"))


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,r", [(1, 1), (288, 1), (288, 2)])
def test_quantize_matches_jax(q, r):
    d = 576
    cfg_t = tq.PQConfig(q, 4, r, kmeans_iters=5, backend="torch")
    cfg_j = jq.PQConfig(q, 4, r, kmeans_iters=5, backend="jnp")
    z = _acts(q + r, 2, 16, d)            # two clients of 16 vectors
    qb = tq.quantize(torch.from_numpy(z), cfg_t)
    assert qb.codes.shape == (2, r, q // r * 16)
    assert qb.codebooks.shape == (2,) + cfg_t.codebook_shape(d)
    for c in range(2):
        ref = jq.quantize(jnp.asarray(z[c]), cfg_j)
        np.testing.assert_array_equal(qb.codes[c].numpy(),
                                      np.asarray(ref.codes))
        np.testing.assert_allclose(qb.dequantized[c].numpy(),
                                   np.asarray(ref.dequantized), **TOL)
        np.testing.assert_allclose(qb.residual[c].numpy(),
                                   np.asarray(ref.residual), **TOL)
        np.testing.assert_allclose(qb.codebooks[c].numpy(),
                                   np.asarray(ref.codebooks), **TOL)
        np.testing.assert_allclose(float(qb.distortion[c]),
                                   float(ref.distortion), rtol=1e-5)


def test_groups_layout_matches_jax_row_for_row():
    cfg_t, cfg_j = tq.PQConfig(6, 2, 3), jq.PQConfig(6, 2, 3)
    z = _acts(3, 2, 5, 12)
    g = tq._to_groups(torch.from_numpy(z), cfg_t)
    for c in range(2):
        ref = jq._to_groups(jnp.asarray(z[c]), cfg_j)
        np.testing.assert_array_equal(g[3 * c:3 * c + 3].numpy(),
                                      np.asarray(ref))
    back = tq._from_groups(g, 2, 5, 12, cfg_t)
    np.testing.assert_array_equal(back.numpy(), z)


def test_exact_cover_gives_an_exactly_zero_residual():
    row = _acts(4, 1, 1, 64)
    z = np.tile(row, (1, 10, 1))
    qb = tq.quantize(torch.from_numpy(z), tq.PQConfig(1, 2, kmeans_iters=8))
    assert float(qb.residual.abs().max()) == 0.0
    assert torch.equal(qb.dequantized, torch.from_numpy(z))


@pytest.mark.parametrize("q,l,r", [(1152, 2, 1), (288, 16, 4), (1, 64, 1)])
def test_accounting_matches_jax(q, l, r):
    t, j = tq.PQConfig(q, l, r), jq.PQConfig(q, l, r)
    assert tq.bits_per_code(l) == jq.bits_per_code(l)
    assert t.codebook_shape(9216) == j.codebook_shape(9216)
    assert t.message_bits(200, 9216) == j.message_bits(200, 9216)
    assert t.codebook_bits(9216, 32) == j.codebook_bits(9216, 32)
    assert t.compression_ratio(20, 9216) == j.compression_ratio(20, 9216)


# ---------------------------------------------------------------------------
# the eq.-5 correction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.0, 0.5, 1e-4])
def test_correction_vjp_is_eq5_and_matches_jax(lam):
    cfg_t = tq.PQConfig(8, 2, kmeans_iters=4, backend="torch")
    cfg_j = jq.PQConfig(8, 2, kmeans_iters=4, backend="jnp")
    z = _acts(12, 1, 20, 64)
    g = _acts(13, 1, 20, 64)
    zt = torch.from_numpy(z).requires_grad_()
    out = tcorr.quantize_with_correction(zt, lam, cfg_t)
    (grad,) = torch.autograd.grad(out, zt, torch.from_numpy(g))
    resid = tq.quantize(torch.from_numpy(z), cfg_t).residual
    lam32 = torch.tensor(lam, dtype=torch.float32)
    assert torch.equal(grad, torch.from_numpy(g) + lam32 * resid)
    out_j, vjp = jax.vjp(lambda v: jcorr.quantize_with_correction(
        v, lam, cfg_j), jnp.asarray(z[0]))
    np.testing.assert_allclose(out.detach()[0].numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(grad[0].numpy(),
                               np.asarray(vjp(jnp.asarray(g[0]))[0]), **TOL)


def test_correction_stats_distortion_is_a_metric():
    cfg = tq.PQConfig(8, 2, kmeans_iters=2)
    z = torch.from_numpy(_acts(14, 2, 10, 64)).requires_grad_()
    zt, dist = tcorr.quantize_with_correction_stats(z, torch.tensor(0.25),
                                                    cfg)
    assert dist.shape == (2,) and not dist.requires_grad
    qb = tq.quantize(z.detach(), cfg)
    assert torch.equal(dist, qb.distortion)
    (grad,) = torch.autograd.grad(zt.sum(), z)
    assert torch.equal(grad, 1.0 + 0.25 * qb.residual)


# ---------------------------------------------------------------------------
# optimizer and split accounting
# ---------------------------------------------------------------------------

def test_sgd_matches_jax_bitwise():
    g = _acts(15, 7, 3)
    p = _acts(16, 7, 3)
    lr = 10 ** -1.5
    opt_t, opt_j = tsgd(lr), jsgd(lr)
    upd_t, st = opt_t.update({"w": torch.from_numpy(g)},
                             opt_t.init({"w": torch.from_numpy(p)}), None)
    upd_j, _ = opt_j.update({"w": jnp.asarray(g)},
                            opt_j.init({"w": jnp.asarray(p)}), None)
    np.testing.assert_array_equal(upd_t["w"].numpy(),
                                  np.asarray(upd_j["w"]))
    assert st["step"] == 1
    assert constant(0.5)(3) == 0.5


def test_split_accounting_matches_jax():
    shapes = {"a": (3, 4), "b": (5,)}
    t = {"a": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16)}
    j = {"a": jnp.zeros((3, 4)), "b": jnp.zeros((5,), jnp.bfloat16)}
    assert tsplit.tree_size(t) == jsplit.tree_size(j) == 17
    assert tsplit.tree_bits(t) == jsplit.tree_bits(j)
    assert tsplit.tree_bits(t, 64) == jsplit.tree_bits(j, 64)
    assert tsplit.dtype_bits(torch.bfloat16) == \
        jsplit.dtype_bits(jnp.bfloat16) == 16
    assert tsplit.tree_size(t.values()) == sum(
        int(np.prod(s)) for s in shapes.values())
