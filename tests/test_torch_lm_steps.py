"""The port's LM train step against the JAX package's, for every
architecture of the zoo at its smoke config: three ``make_train_step``
steps under Adam with the PQ uplink (FedLite), and the chunked
cross-entropy against the full logits' and the reference's, on the CPU.
Models, params and batches as in ``test_torch_lm_train.py``.
"""

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import fedlite as jfed
from repro.optim import adam as jadam
from repro_torch.core import fedlite as tfed
from repro_torch.models.transformer import from_jax_params
from repro_torch.optim import adam as tadam
from test_torch_lm_train import (ARCHS, B, LR, S, _batch, _jb, _jflat,
                                 _models, _np)


def _set_state(state, jstate):
    """The port's state with the reference's params and Adam moments."""
    params = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    flat = tfed.flat_params(params)
    opt = jstate.opt_state
    moments = {m: {k: torch.from_numpy(np.array(v))
                   for k, v in _jflat(opt[m]).items()} for m in ("m", "v")}
    return tfed.TrainState(
        tfed.nest_like(params, {k: v.requires_grad_()
                                for k, v in flat.items()}),
        {"step": int(opt["step"]), **moments}, int(jstate.step))


def _close_params(tstate, jstate, steps):
    """Every parameter within 1e-5, but for entries whose gradient is
    rounding noise on both sides (a key bias, which the softmax cannot
    see): Adam's first steps move those by ~lr·sign(noise), so at most
    1e-4 of all entries may differ, each by at most 2·lr a step."""
    pj = _jflat(jstate.params)
    off, total = 0, 0
    for k, v in tfed.flat_params(tstate.params).items():
        d = np.abs(_np(v) - pj[k])
        assert d.max() <= 2 * LR * steps, (k, d.max())
        off += int((d > 1e-5).sum())
        total += d.size
    assert off <= 1e-4 * total, (off, total)


def three_adam_steps(arch, quantize):
    """Three ``make_train_step`` steps under ``adam(1e-3)`` against the
    reference's: SplitFed from one start; FedLite (PQ, λ = 1e-4) with
    each step started from the reference's state (a PQ code flip at a
    near-tie after a step would otherwise compound). Losses, ce and aux
    within rtol 1e-5 each step, the params as ``_close_params`` says."""
    jm, tm, jp, tp = _models(arch)
    jopt, topt = jadam(LR), tadam(LR)
    jstep = jfed.make_train_step(jm, jopt, quantize=quantize, donate=False)
    tstep = tfed.make_train_step(tm, topt, quantize=quantize)
    jst = jfed.TrainState.create(jp, jopt)
    tst = tfed.TrainState.create(tp, topt)
    for s in range(3):
        if quantize:
            tst = _set_state(tst, jst)
        nb, tb = _batch(tm.cfg, 10 + s)
        jst, mj = jstep(jst, _jb(nb))
        tst, mt = tstep(tst, tb)
        assert tst.step == int(jst.step) == s + 1
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(_np(mt[k]), np.asarray(mj[k]),
                                       rtol=1e-5, atol=1e-7)
        _close_params(tst, jst, 1 if quantize else s + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adam_steps_match_reference(arch):
    """FedLite's three steps (``three_adam_steps``); SplitFed's are in
    ``test_torch_lm_splitfed.py``."""
    three_adam_steps(arch, quantize=True)


# ---------------------------------------------------------------------------
# the chunked CE, the eval step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_8b", "musicgen_large",
                                  "qwen2_vl_2b"])
def test_chunked_ce_matches_token_ce_and_reference(arch):
    """``chunked_ce`` on its chunked path (chunk 16 of S = 64) and on its
    fallbacks (S % chunk != 0; S <= chunk) equals ``token_ce`` of the full
    logits and the reference's ``chunked_ce`` within rtol 1e-5; the
    gradients of the chunked path (each chunk rematerialized) equal the
    full logits' within 1e-5 of the leaf's largest |gradient|."""
    jm, tm, jp, tp = _models(arch)
    nb, tb = _batch(tm.cfg, 6)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, tm.cfg.d_model)).astype(np.float32))
    full = tm.token_ce(tm.logits(tp, x), tb["labels"])
    for chunk in (16, 24, 64):
        got = tm.chunked_ce(tp, x, tb["labels"], chunk=chunk)
        ref = jm.chunked_ce(jp, jnp.asarray(x.numpy()), _jb(nb)["labels"],
                            chunk=chunk)
        np.testing.assert_allclose(_np(got), _np(full), rtol=1e-5)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5)
    head = tm.head_matrix(tp).detach().clone().requires_grad_()
    xg = x.clone().requires_grad_()

    def ce(chunk):
        params = {"client": {"tok_embed": head.transpose(-1, -2)},
                  "server": {"head": head}}
        return tm.chunked_ce(params, xg, tb["labels"], chunk=chunk)
    g16 = torch.autograd.grad(ce(16), [head, xg])
    g64 = torch.autograd.grad(ce(64), [head, xg])
    for a, b in zip(g16, g64):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
