"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's: routing, top-k ties, the capacity, which (token, choice) pairs
are dropped, the combine, the Switch aux loss and the gradients, on the
CPU. Weights come from the reference's ``moe_init``; inputs from a numpy
seed. f32 results agree at f32 noise; each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x22b as jmix
from repro.models import moe as jmoe
from repro_torch.configs import mixtral_8x22b as tmix
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import from_jax_params


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _case(seed, capacity_factor, *, B=2, S=16, E=4, k=2, mlp="swiglu"):
    """(reference cfg, port cfg, reference params, port params, x)."""
    fields = dict(num_experts=E, experts_per_token=k, mlp_type=mlp,
                  capacity_factor=capacity_factor, d_model=32, d_ff=48)
    jcfg = dataclasses.replace(jmix.SMOKE_CONFIG, **fields)
    tcfg = dataclasses.replace(tmix.SMOKE_CONFIG, **fields)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, 32)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _kept_by_rank(idx, num_experts, capacity):
    """The documented drop rule as a plain loop: walk the (token, choice)
    pairs in row-major order; a pair is kept while its expert has fewer
    than ``capacity`` pairs before it."""
    seen = np.zeros(num_experts, int)
    keep = np.zeros(idx.shape, bool)
    for t in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            e = idx[t, j]
            keep[t, j] = seen[e] < capacity
            seen[e] += 1
    return keep


@pytest.mark.parametrize("cf,mlp", [(0.5, "swiglu"), (0.25, "gelu"),
                                    (1.25, "geglu")])
def test_dispatch_drops_the_reference_pairs(cf, mlp):
    """A capacity small enough to drop (cf 0.5 and 0.25: 8 slots an expert
    for 64 pairs over 4 experts): the same gate indices as
    ``jax.lax.top_k``, the kept pairs those of the row-major rank rule,
    and the layer's output and aux loss equal to the reference's within
    1e-5 (a pair dropped on one side only would move a token's output by
    a whole expert's term)."""
    jcfg, tcfg, jp, tp, x = _case(1, cf, mlp=mlp)
    xg = torch.from_numpy(x).reshape(1, -1, 32)
    probs = torch.softmax(xg @ tp["router"], -1)
    _, idx = tmoe.top_k(probs, tcfg.experts_per_token)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(1, -1, 32)
                            @ jp["router"], -1)
    _, jidx = jax.lax.top_k(jprobs, jcfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    capacity = tmoe.capacity_of(tcfg, 32)
    dest, keep = tmoe.dispatch_slots(idx, tcfg.num_experts, capacity)
    want = _kept_by_rank(idx[0].numpy(), tcfg.num_experts, capacity)
    np.testing.assert_array_equal(keep[0].numpy(), want)
    if cf < 1:
        assert not want.all(), "this case must drop pairs"
    kept = dest[keep]
    assert len(set(kept.tolist())) == kept.numel()      # unique slots
    assert bool((dest[~keep] == tcfg.num_experts * capacity).all())

    yj, aj = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    yt, at = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(at), np.asarray(aj), rtol=1e-5)


def test_top_k_takes_the_lower_index_on_a_tie():
    """Equal probabilities: the lower expert first, as ``jax.lax.top_k``
    orders them; the values gathered with their gradients."""
    p = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                  [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        vals, idx = tmoe.top_k(torch.from_numpy(p), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(p), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    pt = torch.from_numpy(p).requires_grad_()
    tmoe.top_k(pt, 2)[0].sum().backward()
    np.testing.assert_array_equal(
        pt.grad.numpy(), [[0, 1, 1, 0], [1, 1, 0, 0], [1, 0, 1, 0]])


@pytest.mark.parametrize("tokens,cf,want", [(32, 0.5, 8), (32, 1.25, 24),
                                            (32, 8.0, 128), (1, 1.25, 8),
                                            (16384, 1.25, 10240)])
def test_capacity_is_the_reference_formula(tokens, cf, want):
    """ceil(k·N_g/E·cf) rounded up to a multiple of 8, at least 8 (k = 2,
    E = 4): the reference's ``apply_moe`` lines, by value."""
    cfg = dataclasses.replace(tmix.SMOKE_CONFIG, capacity_factor=cf)
    assert tmoe.capacity_of(cfg, tokens) == want
    assert tmoe._num_groups(8) == 1


def test_mixtral_full_config_capacity():
    """Mixtral-8x22B at 8 x 2048 tokens: 5120 slots per expert."""
    assert tmoe.capacity_of(tmix.CONFIG, 8 * 2048) == 5120


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_grads_match_reference(cf):
    """d (Σ y·w + aux) / d (x, router, experts), with drops (cf 0.5) and
    without: within 1e-4 relative plus 1e-5 of each leaf's largest
    |gradient|."""
    jcfg, tcfg, jp, tp, x = _case(2, cf)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(p, xx, jcfg)
        return jnp.sum(y * w) + aux

    gjp, gjx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.apply_moe(tp, xt, tcfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    for got, ref in [(xt.grad, gjx)] + [(tp[k].grad, gjp[k]) for k in tp]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


def test_moe_init_layout_matches_reference():
    """Router f32 (D, E); expert stacks (E, D, F) / (E, F, D) in the param
    dtype, the reference's keys."""
    cfg = dataclasses.replace(tmix.SMOKE_CONFIG, param_dtype="bfloat16")
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      device="cpu")
    jp = jax.eval_shape(lambda: jmoe.moe_init(
        jax.random.PRNGKey(0), jmix.SMOKE_CONFIG, jnp.bfloat16))
    assert sorted(p) == sorted(jp)
    for k, v in p.items():
        assert tuple(v.shape) == jp[k].shape
        assert str(v.dtype).split(".")[-1] == str(jp[k].dtype)
