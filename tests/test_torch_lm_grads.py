"""The port's LM gradients, eval step, decode and communication report
against the JAX package's, for every architecture of the zoo at its smoke
config, on the CPU. Models, params and batches as in
``test_torch_lm_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import fedlite as jfed
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import base as tbase
from repro_torch.core import fedlite as tfed
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adam as tadam
from test_torch_lm_train import (ARCHS, B, LR, S, _batch, _jb, _jflat,
                                 _models, _np)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    """d loss / d params with ``quantize=False``, every leaf: within
    1e-4 relative plus 1e-5 of the leaf's largest |gradient| (two
    frameworks' f32 sums; a parameter the loss does not reach, the ln2 of
    an FFN-less SSM block, gets zeros on both)."""
    jm, tm, jp, tp = _models(arch)
    nb, tb = _batch(tm.cfg, 4)
    gj = _jflat(jax.grad(lambda p: jm.loss(p, _jb(nb), quantize=False)[0])(
        jp))
    params = tfed.TrainState.create(tp, tadam(LR)).params
    _, _, gt = tfed._grads(tm, params, tb, {"quantize": False})
    assert gt.keys() == gj.keys()
    for k, g in gt.items():
        ref = gj[k]
        np.testing.assert_allclose(
            _np(g), ref, rtol=1e-4, atol=1e-5 * max(np.abs(ref).max(), 1e-6),
            err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_reference(arch):
    """``make_eval_step``: the uncompressed forward's ce within rtol 1e-5
    and its masked top-1 accuracy equal."""
    jm, tm, jp, tp = _models(arch)
    nb, tb = _batch(tm.cfg, 7)
    mj = jfed.make_eval_step(jm)(jp, _jb(nb))
    mt = tfed.make_eval_step(tm)(tp, tb)
    np.testing.assert_allclose(_np(mt["ce"]), np.asarray(mj["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(mt["accuracy"]),
                               np.asarray(mj["accuracy"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# decode against the forward; the communication report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill(S−1) and one decode step at S−1 give the train-mode
    forward's last logits (no quantizer; MoE at capacity_factor 8, so no
    token drops), within the reference test's 2e-2 (tests/test_archs.py),
    and that forward equals the reference's within 1e-4. Text prompts only
    for the VLM (its default M-RoPE positions)."""
    cfg = tbase.get_arch(arch, smoke=True)
    fields = {"capacity_factor": 8.0} if cfg.num_experts else {}
    jm0, _, jp, tp = _models(arch, **fields)
    tm, jm = TransformerLM(dataclasses.replace(cfg, **fields)), JLM(jm0.cfg)
    _, tb = _batch(cfg, 8, s=16)
    toks = tb["tokens"]
    batch = {"tokens": toks}
    acts, _, _ = tm.client_forward(tp["client"], batch, mode="train")
    x, _, _ = tm.server_forward(tp["server"], acts, batch, mode="train")
    lg_full = tm.logits(tp, x)[:, -1]
    jbatch = {"tokens": jnp.asarray(toks.numpy().astype(np.int32))}
    ja, _, _ = jm.client_forward(jp["client"], jbatch)
    jx, _, _ = jm.server_forward(jp["server"], ja, jbatch)
    np.testing.assert_allclose(_np(lg_full),
                               np.asarray(jm.logits(jp, jx)[:, -1]),
                               rtol=1e-4, atol=1e-4)
    n = toks.shape[-1]
    caches = tm.init_caches(B, n + 4, "cpu")
    _, caches = tm.prefill(tp, {"tokens": toks[..., :n - 1]}, caches)
    lg_dec, _ = tm.decode_step(tp, caches, toks[..., n - 1:], n - 1)
    np.testing.assert_allclose(_np(lg_dec[:, 0]), _np(lg_full), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_comm_report_matches_reference(arch):
    """``comm_report`` on each family's nested params (the vision
    projector, stacked codebook embeddings and heads, MoE and SSM leaves):
    every key and value the reference's, at the params' dtypes and at
    φ = 64."""
    jm, tm, jp, tp = _models(arch)
    for phi in (None, 64):
        rj = jfed.comm_report(jm, jp, tokens_per_client=S, phi_bits=phi)
        rt = tfed.comm_report(tm, tp, tokens_per_client=S, phi_bits=phi)
        assert rt.keys() == rj.keys()
        for k, v in rj.items():
            if k == "pq_backend":
                assert (rt[k], v) == ("torch", "jnp")
            else:
                assert rt[k] == pytest.approx(v, rel=1e-12), k
