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


def test_lloyd_warm_start_matches_jax():
    """``init_centroids`` resumes Lloyd from a given codebook (no seeding);
    0 iterations return it unchanged."""
    x = _acts(17, 3, 400, 8)
    init = _acts(18, 3, 4, 8)
    cents = tkm.batched_lloyd(torch.from_numpy(x), 4, 3, backend="torch",
                              init_centroids=torch.from_numpy(init))
    ref = jkm.batched_lloyd(jnp.asarray(x), 4, 3, backend="jnp",
                            init_centroids=jnp.asarray(init))
    np.testing.assert_allclose(cents.numpy(), np.asarray(ref), **TOL)
    same = tkm.lloyd(torch.from_numpy(x[0]), 4, 0,
                     init_centroids=torch.from_numpy(init[0]))
    np.testing.assert_array_equal(same.numpy(), init[0])
    with pytest.raises(ValueError, match="init_centroids"):
        tkm.batched_lloyd(torch.from_numpy(x), 3, 1,
                          init_centroids=torch.from_numpy(init))


@pytest.mark.parametrize("n,l,iters", [(300, 4, 5), (1000, 2, 3)])
def test_batched_kmeans_matches_jax(n, l, iters):
    """Centroids and codes as the "jnp" backend's; the distortion (from
    ``assign_dist``: ‖x‖² − best score here, the direct ‖x − c‖² there)
    within 1e-5 relative."""
    x = _acts(n + l, 3, n, 8)
    res = tkm.batched_kmeans(torch.from_numpy(x), l, iters, backend="torch")
    assert res.codes.dtype == torch.int32 and res.distortion.shape == (3,)
    for p in range(3):
        ref = jkm.kmeans(jnp.asarray(x[p]), l, iters, backend="jnp")
        np.testing.assert_allclose(res.centroids[p].numpy(),
                                   np.asarray(ref.centroids), **TOL)
        np.testing.assert_array_equal(res.codes[p].numpy(),
                                      np.asarray(ref.codes))
        np.testing.assert_allclose(float(res.distortion[p]),
                                   float(ref.distortion), rtol=1e-5)
    one = tkm.kmeans(torch.from_numpy(x[1]), l, iters, backend="torch")
    assert torch.equal(one.centroids, res.centroids[1])
    assert torch.equal(one.codes, res.codes[1])
    np.testing.assert_allclose(float(one.distortion),
                               float(res.distortion[1]), rtol=1e-6)


@pytest.mark.parametrize("n,l,iters", [(300, 4, 5), (1000, 16, 3)])
def test_batched_kmeans_bf16_matches_jax(n, l, iters):
    """A bf16 x against the JAX package's batched_kmeans ("jnp") on the same
    bf16 values: codes equal, centroids (bf16, as both return them) within
    one bf16 rounding of each other (their f32 centroids agree to 1e-5),
    the distortion within 1e-5 relative; and bitwise the port on the f32
    upcast, centroids rounded to bf16."""
    xb = torch.from_numpy(_acts(n + 2 * l, 3, n, 8)).to(torch.bfloat16)
    res = tkm.batched_kmeans(xb, l, iters, backend="torch")
    up = tkm.batched_kmeans(xb.float(), l, iters, backend="torch")
    assert res.centroids.dtype == torch.bfloat16
    assert torch.equal(res.centroids, up.centroids.to(torch.bfloat16))
    assert torch.equal(res.codes, up.codes)
    assert torch.equal(res.distortion, up.distortion)
    ref = jkm.batched_kmeans(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), l, iters, backend="jnp")
    assert ref.centroids.dtype == jnp.bfloat16
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_allclose(
        res.centroids.float().numpy(),
        np.asarray(ref.centroids.astype(jnp.float32)), rtol=2.0 ** -8,
        atol=1e-6)
    np.testing.assert_allclose(res.distortion.numpy(),
                               np.asarray(ref.distortion), rtol=1e-5)


def test_keyed_seeding_is_kmeans_plus_plus():
    """With a generator the seeds are kmeans++ draws: rows of the
    subsample, distinct where the data is, reproducible from the seed,
    different across seeds. (``jax.random`` draws cannot be reproduced, so
    this is a property test.)"""
    x = torch.from_numpy(_acts(19, 4, 600, 8))
    seeds = [tkm._init_centroids(x, 6, torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert torch.equal(seeds[0], seeds[1])
    assert not torch.equal(seeds[0], seeds[2])
    xs = x[:, ::2][:, :256]                      # the strided subsample
    for p in range(4):
        hits = (seeds[0][p][:, None, :] == xs[p][None]).all(-1)
        assert bool(hits.any(-1).all())
        assert len({tuple(r.tolist()) for r in seeds[0][p]}) == 6
    assert torch.equal(seeds[0][:, 0], x[:, 0])  # the first seed: row 0
    res = tkm.batched_kmeans(x, 6, 2, backend="torch",
                             generator=torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(res.distortion).all())


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
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkm.batched_kmeans(z.reshape(1, -1, 8), 2, 1, backend="cuda")


def test_cuda_backend_lloyd_pads_nothing_and_builds_no_weights(monkeypatch):
    """On "cuda" every Lloyd update gets x as it came (its rows and dtype,
    no chunk padding) and no weights; on "torch" the rows are padded to the
    chunk and carry 0/1 weights. The centroids agree to f32 rounding."""
    seen = []
    cuda = tkm._REGISTRY["cuda"]

    def update(x, weights, cents):
        seen.append((tuple(x.shape), x.dtype, weights))
        return tkm._update_torch(x, weights, cents)

    monkeypatch.setitem(tkm._REGISTRY, "cuda", cuda._replace(update=update))
    x = torch.from_numpy(_acts(8, 3, 700, 8)).to(torch.bfloat16)
    cents = tkm.batched_lloyd(x, 4, 3, chunk=256, backend="cuda")
    assert seen == [((3, 700, 8), torch.bfloat16, None)] * 3
    ref = tkm.batched_lloyd(x, 4, 3, chunk=256, backend="torch")
    assert cents.dtype == torch.float32
    np.testing.assert_allclose(cents.numpy(), ref.numpy(), **TOL)


def test_cuda_backend_kmeans_reads_x_as_it_comes(monkeypatch):
    """On "cuda" batched_kmeans hands every Lloyd update and the final
    assignment the caller's x itself (a bf16 x stays bf16: no f32 copy);
    the result is that of the "torch" backend."""
    seen = []
    cuda = tkm._REGISTRY["cuda"]

    def update(x, weights, cents):
        seen.append(("update", x))
        return tkm._update_torch(x, weights, cents)

    def assign_dist(x, cents):
        seen.append(("assign", x))
        return tkm._assign_dist_torch(x, cents)

    monkeypatch.setitem(tkm._REGISTRY, "cuda", cuda._replace(
        update=update, assign_dist=assign_dist))
    x = torch.from_numpy(_acts(38, 2, 500, 8)).to(torch.bfloat16)
    res = tkm.batched_kmeans(x, 4, 3, backend="cuda")
    assert [kind for kind, _ in seen] == ["update"] * 3 + ["assign"]
    assert all(t is x for _, t in seen)
    ref = tkm.batched_kmeans(x, 4, 3, backend="torch")
    assert torch.equal(res.codes, ref.codes)
    np.testing.assert_allclose(res.centroids.float().numpy(),
                               ref.centroids.float().numpy(), rtol=2.0 ** -8)


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


@pytest.mark.parametrize("warm_iters", [None, 0, 3])
def test_quantize_stateful_warm_start_matches_jax(warm_iters):
    """A cold round bootstraps the state (rounds 1); the warm rounds resume
    from it at ``effective_warm_iters`` and count up, client by client, as
    the reference does on each client."""
    kw = dict(kmeans_iters=5, warm_iters=warm_iters)
    cfg_t = tq.PQConfig(72, 4, 2, backend="torch", **kw)
    cfg_j = jq.PQConfig(72, 4, 2, backend="jnp", **kw)
    assert cfg_t.effective_warm_iters == cfg_j.effective_warm_iters
    assert cfg_t.l == cfg_j.l == 4
    state_t, state_j = None, [None, None]
    for rnd in range(3):
        z = _acts(20 + rnd, 2, 12, 288)
        qb, state_t = tq.quantize_stateful(torch.from_numpy(z), cfg_t,
                                           state_t)
        assert state_t.codebooks.shape == (2, 2, 4, 4)
        np.testing.assert_array_equal(state_t.rounds.numpy(), [rnd + 1] * 2)
        for c in range(2):
            ref, state_j[c] = jq.quantize_stateful(jnp.asarray(z[c]), cfg_j,
                                                   state_j[c])
            np.testing.assert_array_equal(qb.codes[c].numpy(),
                                          np.asarray(ref.codes))
            np.testing.assert_allclose(qb.dequantized[c].numpy(),
                                       np.asarray(ref.dequantized), **TOL)
            np.testing.assert_allclose(state_t.codebooks[c].numpy(),
                                       np.asarray(state_j[c].codebooks),
                                       **TOL)
            assert int(state_j[c].rounds) == rnd + 1


def test_init_quantizer_state_and_warm_zero_iters():
    cfg = tq.PQConfig(8, 2, kmeans_iters=4, warm_iters=0)
    z = torch.from_numpy(_acts(23, 3, 10, 64))
    qb = tq.quantize(z, cfg)
    st = tq.init_quantizer_state(qb)
    assert st.codebooks.dtype == torch.float32
    np.testing.assert_array_equal(st.rounds.numpy(), [1, 1, 1])
    # a warm round of 0 iterations encodes with the given codebooks
    warm = tq.quantize(z, cfg, state=st)
    assert torch.equal(warm.codebooks, qb.codebooks)
    assert torch.equal(warm.codes, qb.codes)
    with pytest.raises(ValueError, match="warm_iters"):
        tq.PQConfig(8, 2, warm_iters=-1)


def test_quantization_error_and_vanilla_configs_match_jax():
    z = _acts(24, 2, 16, 64)
    for mk in ("vanilla_kmeans_config", "vanilla_pq_config"):
        args = (4,) if mk == "vanilla_kmeans_config" else (8, 4)
        cfg_t = getattr(tq, mk)(*args, kmeans_iters=3, backend="torch")
        cfg_j = getattr(jq, mk)(*args, kmeans_iters=3, backend="jnp")
        assert (cfg_t.q, cfg_t.r, cfg_t.l) == (cfg_j.q, cfg_j.r, cfg_j.l)
        err = tq.quantization_error(torch.from_numpy(z), cfg_t)
        assert err.shape == (2,)
        for c in range(2):
            np.testing.assert_allclose(
                float(err[c]),
                float(jq.quantization_error(jnp.asarray(z[c]), cfg_j)),
                rtol=1e-5)


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


@pytest.mark.parametrize("warm", [False, True])
def test_quantize_bf16_cut_is_its_f32_upcast(warm):
    """A bf16 cut is grouped in bf16 and upcast where f32 is needed: codes,
    codebooks and distortion equal those of its f32 upcast, z̃ and the
    residual equal after the cast to bf16."""
    zb = torch.from_numpy(_acts(12, 2, 30, 64)).to(torch.bfloat16)
    cfg = tq.PQConfig(8, 4, num_groups=2, kmeans_iters=4)
    state = tq.quantize_stateful(zb.float(), cfg)[1] if warm else None
    qb = tq.quantize(zb, cfg, state=state)
    qf = tq.quantize(zb.float(), cfg, state=state)
    assert qb.dequantized.dtype == torch.bfloat16
    assert torch.equal(qb.codes, qf.codes)
    assert torch.equal(qb.codebooks, qf.codebooks.to(torch.bfloat16))
    assert torch.equal(qb.distortion, qf.distortion)
    assert torch.equal(qb.dequantized, qf.dequantized.to(torch.bfloat16))
    assert torch.equal(qb.residual, qf.residual.to(torch.bfloat16))


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


def test_quantize_downlink_matches_jax():
    """Identity forward; the backward pass quantizes the cotangent, per
    client, as the reference's ``quantize_downlink`` does on each."""
    cfg_t = tq.PQConfig(8, 2, kmeans_iters=3, backend="torch")
    cfg_j = jq.PQConfig(8, 2, kmeans_iters=3, backend="jnp")
    z = _acts(25, 2, 10, 64)
    g = _acts(26, 2, 10, 64)
    zt = torch.from_numpy(z).requires_grad_()
    out = tcorr.quantize_downlink(zt, cfg_t)
    assert torch.equal(out.detach(), zt.detach())
    (grad,) = torch.autograd.grad(out, zt, torch.from_numpy(g))
    assert torch.equal(grad, tq.quantize(torch.from_numpy(g),
                                         cfg_t).dequantized)
    for c in range(2):
        _, vjp = jax.vjp(lambda v: jcorr.quantize_downlink(v, cfg_j),
                         jnp.asarray(z[c]))
        np.testing.assert_allclose(grad[c].numpy(),
                                   np.asarray(vjp(jnp.asarray(g[c]))[0]),
                                   **TOL)


def test_quantize_with_stats_matches_jax():
    cfg_t = tq.PQConfig(8, 4, kmeans_iters=3, backend="torch")
    cfg_j = jq.PQConfig(8, 4, kmeans_iters=3, backend="jnp")
    z = _acts(27, 2, 12, 64)
    zt, stats = tcorr.quantize_with_stats(torch.from_numpy(z), 0.1, cfg_t)
    assert stats["pq_distortion"].shape == (2,)
    for c in range(2):
        zj, sj = jcorr.quantize_with_stats(jnp.asarray(z[c]), 0.1, cfg_j)
        np.testing.assert_allclose(zt[c].detach().numpy(), np.asarray(zj),
                                   **TOL)
        np.testing.assert_allclose(float(stats["pq_distortion"][c]),
                                   float(sj["pq_distortion"]), rtol=1e-5)
        assert stats["pq_message_bits"] == sj["pq_message_bits"]
        assert stats["pq_compression_ratio"] == sj["pq_compression_ratio"]


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
