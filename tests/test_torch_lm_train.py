"""Parity of the port's LM training with the JAX package, for every
architecture of the zoo at its smoke config: the configs, the loss (with
and without the PQ uplink), the gradients, the train step under Adam,
the chunked CE, the eval step, decode against the train-mode forward and
the communication report, on the CPU.

The reference's params are carried across by ``from_jax_params`` and both
packages get the same numpy-made batches. The JAX side runs its "jnp"
quantizer backend; the port runs plain PyTorch on the CPU. f32 results of
the two frameworks sum in other orders, so they agree at f32 noise; each
test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.quantizer import quantize as jquantize
from repro.launch.specs import make_model as jmake_model
from repro_torch.configs import base as tbase
from repro_torch.core import fedlite as tfed
from repro_torch.core.quantizer import quantize as tquantize
from repro_torch.launch.specs import make_model as tmake_model
from repro_torch.launch.train import make_batch, step_rng
from repro_torch.models.transformer import from_jax_params

ARCHS = jbase.ARCH_IDS
B, S = 2, 64
LR = 1e-3


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _batch(cfg, seed, b=B, s=S):
    """The launcher's batch for ``cfg``, drawn from numpy: as numpy arrays
    (int32 tokens, for the reference) and as the port's tensors."""
    tb = make_batch(cfg, step_rng(seed, 0), b, s, "cpu")
    nb = {k: _np(v).astype(np.int32) if v.dtype != torch.float32
          else _np(v) for k, v in tb.items()}
    return nb, tb


def _jb(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def _jflat(tree):
    """The reference's nested leaves keyed like ``tfed.flat_params``."""
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


_MODELS = {}


def _models(arch, **fields):
    """(reference model, port model, reference params, port params) of the
    smoke config, cached per (arch, overrides)."""
    key = (arch, tuple(sorted(fields.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jbase.get_arch(arch, smoke=True), **fields)
        tcfg = dataclasses.replace(tbase.get_arch(arch, smoke=True), **fields)
        jm, tm = jmake_model(jcfg), tmake_model(tcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[key] = (jm, tm, jp, from_jax_params(jax.tree.map(np.asarray,
                                                                   jp)))
    return _MODELS[key]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    """``get_arch`` resolves every id; CONFIG and SMOKE_CONFIG equal the
    reference's field by field, with the same derived sizes."""
    j, t = jbase.get_arch(arch, smoke=smoke), tbase.get_arch(arch,
                                                             smoke=smoke)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    for f in dataclasses.fields(j):
        assert getattr(j, f.name) == getattr(t, f.name), f.name
    for prop in ("period", "num_periods", "padded_vocab", "q_dim", "kv_dim",
                 "d_inner", "ssm_heads"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert j.param_count() == t.param_count()
    assert t.compute_dtype == getattr(torch, j.dtype)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_reference(arch):
    """The port's own init draws the reference's shapes and dtypes for
    every family (MoE router and experts, SSM leaves, stacked codebook
    embeddings and heads, the vision projector)."""
    jm, tm, jp, _ = _models(arch)
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tfed.flat_params(own).items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in _jflat(jp).items()}


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, quantize):
    """``model.loss`` and its metrics (ce, the MoE aux loss, the PQ
    distortion and bits) within f32 noise: rtol 1e-5."""
    jm, tm, jp, tp = _models(arch)
    nb, tb = _batch(tm.cfg, 3)
    lj, mj = jm.loss(jp, _jb(nb), quantize=quantize)
    lt, mt = tm.loss(tp, tb, quantize=quantize)
    assert lt.dtype == torch.float32 and lt.dim() == 0
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=1e-5)
    assert set(mt) == set(mj)
    for k in ("ce", "aux", "pq_distortion"):
        if k in mj:
            np.testing.assert_allclose(_np(mt[k]), np.asarray(mj[k]),
                                       rtol=1e-5, atol=1e-7)
    for k in ("pq_message_bits", "pq_compression_ratio"):
        if k in mj:
            assert mt[k] == mj[k]


@pytest.mark.parametrize("arch", ARCHS)
def test_pq_codes_match_reference(arch):
    """The cut activation of each client (sequence), its PQ codes and its
    distortion: FPS seeding with no key is deterministic, so the codes are
    equal on all but near-ties (at most 0.1 % of the subvectors, where the
    order of the f32 sums may pick the other code) and the distortion
    agrees within 1e-4 relative."""
    jm, tm, jp, tp = _models(arch)
    nb, tb = _batch(tm.cfg, 5)
    acts_j, _, _ = jm.client_forward(jp["client"], _jb(nb), mode="train")
    acts_t, _, _ = tm.client_forward(tp["client"], tb, mode="train")
    np.testing.assert_allclose(_np(acts_t), np.asarray(acts_j), rtol=1e-4,
                               atol=1e-5)
    qb = tquantize(torch.from_numpy(np.asarray(acts_j)), tm.pq)
    same, total = 0, 0
    for b in range(B):
        jq = jquantize(acts_j[b], jm.pq)
        codes = np.asarray(jq.codes)
        same += int((qb.codes[b].numpy() == codes).sum())
        total += codes.size
        np.testing.assert_allclose(_np(qb.distortion[b]),
                                   np.asarray(jq.distortion), rtol=1e-4)
    assert same >= 0.999 * total, (same, total)
