"""The port's SSM block (``repro_torch/models/ssm.py``) against the JAX
package's and against a per-token recurrence: the chunked SSD scan (with a
chunk that does not divide the sequence), the segment-sum decay and its
gradients, the block in train, prefill and decode mode with the state and
conv tails handed from prefill to decode, and jamba's nested remat, on the
CPU. f32 results agree at f32 noise; each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v0p1_52b as jjamba
from repro.configs import mamba2_1p3b as jmamba
from repro.models import ssm as jssm
from repro_torch.configs import jamba_v0p1_52b as tjamba
from repro_torch.configs import mamba2_1p3b as tmamba
from repro_torch.core import fedlite as tfed
from repro_torch.kernels import ref as tref
from repro_torch.launch.specs import make_model as tmake_model
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import from_jax_params


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _scan_inputs(seed, B=2, S=40, H=3, P=4, N=5):
    r = np.random.default_rng(seed)
    xh = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(r.standard_normal((B, S, H)))) * 0.5
          ).astype(np.float32)
    A = -np.exp(r.standard_normal(H) * 0.5).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    h0 = r.standard_normal((B, H, P, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm, h0


def _recurrence(xh, dt, A, Bm, Cm, h0):
    """The SSM one token at a time, in f64:
    H_t = exp(dt_t·A)·H_{t−1} + dt_t·B_t ⊗ x_t, y_t = C_t·H_t."""
    xh, dt, Bm, Cm, h = (a.astype(np.float64) for a in (xh, dt, Bm, Cm, h0))
    ys = []
    for t in range(xh.shape[1]):
        decay = np.exp(dt[:, t] * A)                         # (B, H)
        h = decay[:, :, None, None] * h + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xh[:, t], Bm[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("S,chunk", [(40, 8), (40, 16), (40, 64), (7, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_reference_and_recurrence(S, chunk, with_h0):
    """y and the final state of ``ssd_scan``: within 1e-5 of the
    reference's ``ssd_scan`` and within 1e-4 of the f64 per-token
    recurrence; a chunk that does not divide S (40 % 16, 7 % 4) runs the
    whole sequence as one chunk, as the reference does."""
    xh, dt, A, Bm, Cm, h0 = _scan_inputs(S + chunk, S=S)
    h0 = h0 if with_h0 else None
    y, h = tssm.ssd_scan(*(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)),
                         chunk,
                         h0=None if h0 is None else torch.from_numpy(h0))
    yj, hj = jssm.ssd_scan(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)),
                           chunk, h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h), np.asarray(hj), rtol=1e-5, atol=1e-5)
    yr, hr = _recurrence(xh, dt, A, Bm, Cm,
                         np.zeros_like(_scan_inputs(0, S=S)[5])
                         if h0 is None else h0)
    np.testing.assert_allclose(_np(y), yr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h), hr, rtol=1e-4, atol=1e-4)


def test_segsum_decay_masks_before_exp():
    """The decay matrix equals the reference's (0 above the diagonal), and
    with steps large enough that exp of an upper-triangle difference is
    inf its gradient stays finite and equals the reference's (a mask after
    exp gives 0·inf = NaN)."""
    r = np.random.default_rng(4)
    dA = (-np.abs(r.standard_normal((2, 16, 3))) * 60).astype(np.float32)
    w = r.standard_normal((2, 3, 16, 16)).astype(np.float32)
    L = tref._segsum_decay(torch.from_numpy(dA))
    Lj = jssm._segsum_decay(jnp.asarray(dA))
    # entries in [0, 1]: exp of sums of ~1e3 whose f32 rounding differs
    np.testing.assert_allclose(_np(L), np.asarray(Lj), rtol=1e-4, atol=1e-6)
    assert bool((L[..., ~torch.ones(16, 16, dtype=torch.bool).tril()] == 0)
                .all())
    dt = torch.from_numpy(dA).requires_grad_()
    (tref._segsum_decay(dt) * torch.from_numpy(w)).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jssm._segsum_decay(a) * w))(
        jnp.asarray(dA))
    assert bool(torch.isfinite(dt.grad).all())
    np.testing.assert_allclose(_np(dt.grad), np.asarray(gj), rtol=1e-4,
                               atol=1e-5)


def _block(seed, chunk=8):
    cfg_j = dataclasses.replace(jmamba.SMOKE_CONFIG, ssm_chunk=chunk)
    cfg_t = dataclasses.replace(tmamba.SMOKE_CONFIG, ssm_chunk=chunk)
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    # nonzero conv biases and dt biases, so every leaf matters
    r = np.random.default_rng(seed)
    jp = dict(jp, conv_b=jnp.asarray(r.standard_normal(
        jp["conv_b"].shape).astype(np.float32) * 0.1),
        dt_bias=jnp.asarray(r.standard_normal(
            jp["dt_bias"].shape).astype(np.float32) * 0.5))
    x = (r.standard_normal((2, 24, cfg_t.d_model)) * 0.5).astype(np.float32)
    return cfg_j, cfg_t, jp, from_jax_params(jax.tree.map(np.asarray, jp)), x


def test_apply_ssm_train_and_grads_match_reference():
    """The block's train-mode output within 1e-5 and its gradients within
    1e-4 relative plus 1e-5 of each leaf's largest |gradient| (the chunk
    statistics rematerialized in the backward pass)."""
    cfg_j, cfg_t, jp, tp, x = _block(1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    yj = jssm.apply_ssm(jp, jnp.asarray(x), cfg_j)[0]
    gj = jax.grad(lambda p: jnp.sum(jssm.apply_ssm(
        p, jnp.asarray(x), cfg_j)[0] * w))(jp)
    flat = tfed.flat_params(tp)
    for v in flat.values():
        v.requires_grad_()
    y, cache = tssm.apply_ssm(tp, torch.from_numpy(x), cfg_t)
    assert cache is None
    np.testing.assert_allclose(_np(y), np.asarray(yj), rtol=1e-5, atol=1e-5)
    (y * torch.from_numpy(w)).sum().backward()
    gjf = tfed.flat_params(jax.tree.map(np.asarray, gj))
    for k, v in flat.items():
        np.testing.assert_allclose(_np(v.grad), gjf[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(gjf[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("prompt", [20, 2])
def test_prefill_then_decode_carries_the_state_and_conv_tails(prompt):
    """Prefill of ``prompt`` tokens, then decode one at a time to 24: each
    step's output equals the train-mode output at its position within
    1e-5; after the prefill the caches (h, the two conv tails) equal the
    reference's, and after each decode step too. A prompt shorter than
    the conv width − 1 (2 < 3) keeps a tail of the cache's zeros and the
    prompt; there the reference's prefill returns a tail one row too long
    (its pad assumes no cache), so only the forward holds the port."""
    cfg_j, cfg_t, jp, tp, x = _block(3)
    y_full = tssm.apply_ssm(tp, torch.from_numpy(x), cfg_t)[0]
    cache = tssm.init_ssm_cache(cfg_t, 2, torch.float32, device="cpu")
    jcache = jssm.init_ssm_cache(cfg_j, 2, jnp.float32)
    y, cache2 = tssm.apply_ssm(tp, torch.from_numpy(x[:, :prompt]), cfg_t,
                               mode="prefill", cache=cache)
    assert cache2 is cache                      # written in place
    _, jcache = jssm.apply_ssm(jp, jnp.asarray(x[:, :prompt]), cfg_j,
                               mode="prefill", cache=jcache)
    np.testing.assert_allclose(_np(y), _np(y_full[:, :prompt]), rtol=1e-5,
                               atol=1e-5)
    assert tuple(cache["conv"].shape) == (2, 3, cfg_t.d_inner)
    for t in range(prompt, 24):
        for key in ("h", "conv", "conv_bc") if prompt >= 3 else ():
            np.testing.assert_allclose(_np(cache[key]),
                                       np.asarray(jcache[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        y, _ = tssm.apply_ssm(tp, torch.from_numpy(x[:, t:t + 1]), cfg_t,
                              mode="decode", cache=cache)
        if prompt >= 3:
            _, jcache = jssm.apply_ssm(jp, jnp.asarray(x[:, t:t + 1]),
                                       cfg_j, mode="decode", cache=jcache)
        np.testing.assert_allclose(_np(y[:, 0]), _np(y_full[:, t]),
                                   rtol=1e-5, atol=1e-5)


def test_decode_keeps_the_state_in_the_cache_dtype():
    """A bf16 cache: the decode step's new state is bf16 (the f32 update
    rounded once), as the reference keeps its scan carry."""
    cfg_j, cfg_t, jp, tp, x = _block(5)
    cache = tssm.init_ssm_cache(cfg_t, 2, torch.bfloat16, device="cpu")
    jcache = jssm.init_ssm_cache(cfg_j, 2, jnp.bfloat16)
    for t in range(3):
        tssm.apply_ssm(tp, torch.from_numpy(x[:, t:t + 1]), cfg_t,
                       mode="decode", cache=cache)
        _, jcache = jssm.apply_ssm(jp, jnp.asarray(x[:, t:t + 1]), cfg_j,
                                   mode="decode", cache=jcache)
    assert cache["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(cache["h"].float()),
                               np.asarray(jcache["h"], np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_jamba_nested_remat_equals_no_remat(policy):
    """Jamba's smoke model (periods of an SSM and an attention block, MoE
    on the second) with ``remat=True`` (a checkpoint per period and per
    block inside it; ``dots`` saving the matmul outputs): loss and every
    gradient bitwise those without remat."""
    base = dataclasses.replace(tjamba.SMOKE_CONFIG, ssm_chunk=8)
    r = np.random.default_rng(6)
    toks = torch.from_numpy(r.integers(0, base.vocab_size, (2, 32)))
    batch = {"tokens": toks, "labels": toks}
    params = tmake_model(base).init(torch.Generator().manual_seed(0), "cpu")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        state = tfed.TrainState.create(params, tfed.Optimizer(
            lambda p: None, None))
        loss, _, grads = tfed._grads(tmake_model(cfg), state.params, batch,
                                     {"quantize": True})
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k
    assert jjamba.SMOKE_CONFIG.period == base.period == 2
