"""Parity of the port's optimizers and schedules (``repro_torch/optim``)
with the JAX package's, on the CPU.

The same parameters and the same five steps of gradients, made from a
numpy seed, go through both packages' ``update``; each step's updates and
every state tensor must agree to 1e-6 relative (f32 arithmetic; the two
frameworks may round a division or a mean's sum differently in the last
bit). Adam's bias corrections 1 − b^step and Adafactor's β are f32 powers
of the step and are held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.optim.optimizers import _adafactor_beta, _bias_correction

RTOL, ATOL = 1e-6, 1e-9
SHAPES = {"w": (6, 5), "b": (5,), "k": (2, 3, 4)}


def _params(seed):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(r):
    return {k: (r.standard_normal(s) * 10.0 ** r.uniform(-3, 1))
            .astype(np.float32) for k, s in SHAPES.items()}


def _leaves(tree, prefix=""):
    """Flat {path: np.ndarray} of a state tree (ints included)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _lr(kind):
    if kind == "constant":
        return 10 ** -0.5, 10 ** -0.5
    if kind == "cosine":
        return (joptim.cosine_decay(0.01, 4),
                toptim.cosine_decay(0.01, 4))
    return (joptim.warmup_cosine(0.01, 2, 5),
            toptim.warmup_cosine(0.01, 2, 5))


@pytest.mark.parametrize("sched", ["constant", "cosine", "warmup"])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adagrad",
                                  "adafactor"])
def test_optimizer_five_steps_match_jax(name, sched):
    jlr, tlr = _lr(sched)
    jopt = joptim.get_optimizer(name, jlr)
    topt = toptim.get_optimizer(name, tlr)
    assert topt.name == jopt.name == name
    p = _params(1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    r = np.random.default_rng(2)
    for step in range(5):
        g = _grads(r)
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                             js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        for k in SHAPES:
            assert tu[k].dtype == torch.float32
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} {k}")
        jl, tl = _leaves(js), _leaves(ts)
        assert jl.keys() == tl.keys()
        for k in jl:
            np.testing.assert_allclose(tl[k], jl[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} state {k}")
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}


@pytest.mark.parametrize("b", [0.9, 0.999])
def test_adam_bias_correction_is_the_f32_power(b):
    """1 − b^step in f32, bitwise the reference's, over 2000 steps (a
    Python-float power, in f64, differs in the last bits)."""
    steps = np.arange(1, 2001, dtype=np.int32)
    want = np.asarray(1 - b ** jnp.asarray(steps).astype(jnp.float32))
    got = np.array([_bias_correction(b, int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)
    f64 = (1 - b ** steps.astype(np.float64)).astype(np.float32)
    assert (f64 != want).any()


def test_adafactor_beta_is_the_f32_power():
    """β = 1 − step^−0.8 and 1 − β, each in f32, bitwise the
    reference's."""
    for step in range(1, 2001):
        jbeta = 1.0 - jnp.asarray(step).astype(jnp.float32) ** -0.8
        beta, one_minus = _adafactor_beta(step)
        assert np.float32(beta) == np.asarray(jbeta)
        assert np.float32(one_minus) == np.asarray(1 - jbeta)


@pytest.mark.parametrize("sched", ["cosine", "warmup"])
def test_schedules_match_jax(sched):
    jf, tf = _lr(sched)
    for step in range(12):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        assert isinstance(tf(step), float)
        np.testing.assert_allclose(tf(step), want, rtol=RTOL)


def test_get_optimizer_table():
    for name in ("sgd", "momentum", "adam", "adagrad", "adafactor"):
        assert toptim.get_optimizer(name, 0.1).name == name
    assert toptim.get_optimizer("adam", 0.1, b1=0.5).name == "adam"
    with pytest.raises(KeyError):
        toptim.get_optimizer("lamb", 0.1)


# ---------------------------------------------------------------------------
# Adafactor on the paper models' conv weights (OIHW here, HWIO in the
# reference): factored over I and O, as the reference factors them
# ---------------------------------------------------------------------------

def _update_close(got, want, name):
    """Within rtol 1e-5 and 1e-5 of the update's max: factored over the
    port's kH and kW, the update was 2.70x its max off."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_adafactor_conv_gradient_matches_jax():
    """Five steps on a (3, 3, 1, 32) conv weight and its bias: updates and
    factors (kept in the reference's layout: row (kH, kW, I), col (kH, kW,
    O)) as the reference's."""
    from repro_torch.models.paper_models import from_jax_params

    r = np.random.default_rng(4)
    hwio = r.standard_normal((3, 3, 1, 32)).astype(np.float32)
    jp = {"client": {"conv1_w": jnp.asarray(hwio),
                     "conv1_b": jnp.zeros(32)}}
    tp = from_jax_params({"client": {"conv1_w": hwio,
                                     "conv1_b": np.zeros(32, np.float32)}})
    assert tp["client.conv1_w"].shape == (32, 1, 3, 3)
    jopt, topt = joptim.adafactor(0.01), toptim.adafactor(0.01)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = {"conv1_w": (r.standard_normal((3, 3, 1, 32))
                         * 10.0 ** r.uniform(-3, 1)).astype(np.float32),
             "conv1_b": r.standard_normal(32).astype(np.float32)}
        ju, js = jopt.update({"client": {k: jnp.asarray(v)
                                         for k, v in g.items()}}, js, jp)
        tu, ts = topt.update(from_jax_params({"client": g}), ts, tp)
        _update_close(tu["client.conv1_w"].permute(2, 3, 1, 0).numpy(),
                      np.asarray(ju["client"]["conv1_w"]), f"step {step}")
        _update_close(tu["client.conv1_b"].numpy(),
                      np.asarray(ju["client"]["conv1_b"]), f"step {step}")
        for part in ("row", "col"):
            np.testing.assert_allclose(
                ts["v"]["client.conv1_w"][part].numpy(),
                np.asarray(js["v"]["client"]["conv1_w"][part]),
                rtol=RTOL, atol=ATOL, err_msg=part)
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}


def test_adafactor_femnist_step_matches_jax():
    """One FedLite step of FemnistCNN (q = 1152, L = 2) under Adafactor
    from the same params and batch: every parameter's update as the
    reference's, the conv weights' included."""
    from repro.core.fedlite import TrainState as JTrainState
    from repro.core.fedlite import make_train_step as j_make_train_step
    from repro.core.quantizer import PQConfig as JPQConfig
    from repro.data.synthetic import make_federated_image_data as j_data
    from repro.models.paper_models import FemnistCNN as JFemnistCNN
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.models.paper_models import FemnistCNN, from_jax_params

    jm = JFemnistCNN(pq=JPQConfig(1152, 2, kmeans_iters=5, backend="jnp"),
                     lam=1e-4)
    tm = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=5, backend="torch"),
                    lam=1e-4, device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(from_jax_params(params))
    b = j_data(num_clients=4, seed=0).sample_batch(
        0, jax.random.PRNGKey(1), 8)
    js = JTrainState.create(jax.tree.map(jnp.asarray, params),
                            joptim.adafactor(0.01))
    ts = TrainState.create(dict(tm.named_parameters()),
                           toptim.adafactor(0.01))
    js2, _ = j_make_train_step(jm, joptim.adafactor(0.01),
                               donate=False)(js, b)
    ts2, _ = make_train_step(tm, toptim.adafactor(0.01))(ts, {
        "image": torch.from_numpy(np.array(b["image"])),
        "label": torch.from_numpy(np.asarray(b["label"]).astype(np.int64))})
    before = from_jax_params(params)
    want = from_jax_params(jax.tree.map(np.asarray, js2.params))
    for k, p in ts2.params.items():
        _update_close((p.detach() - before[k]).numpy(),
                      (want[k] - before[k]).numpy(), k)
