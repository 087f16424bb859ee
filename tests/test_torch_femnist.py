"""Parity of the port's FEMNIST FedLite slice with the JAX package: the
synthetic data, the ``FemnistCNN`` forward (through ``from_jax_params``)
and the full train step, step for step, from the same weights and batches.
The JAX side runs its ``"jnp"`` quantizer backend; the port runs plain
PyTorch on the CPU. Batches are drawn by the JAX package and injected."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jC
from repro.core.fedlite import make_train_step as j_make_train_step
from repro.core.fedlite import TrainState as JTrainState
from repro.core.quantizer import PQConfig as JPQConfig
from repro.data.synthetic import make_federated_image_data as j_image_data
from repro.models.paper_models import FemnistCNN as JFemnistCNN
from repro.optim import sgd as jsgd
from repro_torch.core.compressors import CutState
from repro_torch.core.fedlite import TrainState, make_train_step
from repro_torch.core.quantizer import PQConfig
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import FederatedTrainer
from repro_torch.models.paper_models import FemnistCNN, from_jax_params
from repro_torch.optim import sgd

LR = 10 ** -1.5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _full_f32():
    """Hold the port to full f32 wherever it is compared with the
    reference (cuDNN would run f32 convolutions in TF32 by default)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _jax_params(seed=0):
    params = JFemnistCNN().init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _models(pq_args=None, lam=1e-4, client_batch=0):
    jpq = None if pq_args is None else JPQConfig(*pq_args, kmeans_iters=5,
                                                 backend="jnp")
    tpq = None if pq_args is None else PQConfig(*pq_args, kmeans_iters=5,
                                                backend="torch")
    jm = JFemnistCNN(pq=jpq, lam=lam, client_batch=client_batch)
    tm = FemnistCNN(pq=tpq, lam=lam, client_batch=client_batch, device=CPU)
    params = _jax_params()
    tm.load_state_dict(from_jax_params(params))
    return jm, tm, params


def _jax_batch(seed, batch, clients=1):
    data = j_image_data(num_clients=8, seed=0)
    keys = jax.random.split(jax.random.PRNGKey(seed), clients)
    parts = [data.sample_batch(c, keys[c], batch // clients)
             for c in range(clients)]
    return {k: np.concatenate([np.asarray(p[k]) for p in parts])
            for k in parts[0]}


def _torch_batch(b):
    return {"image": torch.from_numpy(b["image"]),
            "label": torch.from_numpy(b["label"].astype(np.int64))}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _closure(fn, name):
    return np.asarray(inspect.getclosurevars(fn).nonlocals[name])


def test_image_data_tables_are_bitwise_the_references():
    ref = j_image_data(num_clients=16, seed=3)
    port = make_federated_image_data(num_clients=16, seed=3, device=CPU)
    np.testing.assert_array_equal(port.client_weights, ref.client_weights)
    # the reference keeps its f64 mixtures as an f32 jax array
    np.testing.assert_array_equal(
        _closure(port.sample_batch, "mixtures").astype(np.float32),
        _closure(ref.sample_batch, "mix_j"))
    protos = inspect.getclosurevars(
        inspect.getclosurevars(port.sample_batch).nonlocals["_batch"]
    ).nonlocals["protos"]
    np.testing.assert_array_equal(protos,
                                  _closure(ref.sample_batch, "protos_j"))


def test_image_batches_have_the_references_layout():
    port = make_federated_image_data(num_clients=4, device=CPU)
    b = port.sample_batch(2, np.random.default_rng(0), 6)
    e = port.eval_batch(np.random.default_rng(1), 5)
    assert b["image"].shape == (6, 28, 28, 1) and e["label"].shape == (5,)
    assert b["image"].dtype == torch.float32 and b["label"].dtype == \
        torch.int64
    assert int(e["label"].max()) < 62


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_from_jax_params_layouts():
    params = _jax_params()
    sd = from_jax_params(params)
    assert sd["client.conv1_w"].shape == (32, 1, 3, 3)
    assert sd["client.conv2_w"].shape == (64, 32, 3, 3)
    np.testing.assert_array_equal(sd["client.conv2_w"][5, 7].numpy(),
                                  params["client"]["conv2_w"][:, :, 7, 5])
    np.testing.assert_array_equal(sd["server.dense1_w"].numpy(),
                                  params["server"]["dense1_w"])
    tm = FemnistCNN(device=CPU)
    assert set(sd) == set(dict(tm.named_parameters()))


def test_client_forward_flattens_the_cut_in_nhwc_order():
    jm, tm, params = _models()
    b = _jax_batch(1, 4)
    cut_j = np.asarray(jm.client_forward(params["client"], b))
    cut_t = tm.client_forward(torch.from_numpy(b["image"])).detach()
    assert cut_t.shape == (4, 9216)
    np.testing.assert_allclose(cut_t.numpy(), cut_j, rtol=1e-5, atol=1e-5)
    # the cut's first 64 values are the 64 channels of pixel (0, 0)
    x = torch.from_numpy(b["image"]).permute(0, 3, 1, 2)
    conv = torch.nn.functional
    h = conv.relu(conv.conv2d(x, tm.client["conv1_w"], tm.client["conv1_b"]))
    h = conv.relu(conv.conv2d(h, tm.client["conv2_w"], tm.client["conv2_b"]))
    np.testing.assert_array_equal(
        cut_t[:, :64].numpy(),
        conv.max_pool2d(h, 2)[:, :, 0, 0].detach().numpy())


@pytest.mark.parametrize("quantize", [False, True])
def test_loss_matches_jax(quantize):
    jm, tm, params = _models((1152, 2), client_batch=4)
    b = _jax_batch(2, 8, clients=2)
    loss_j, met_j = jm.loss(params, b, quantize=quantize)
    loss_t, met_t = tm(_torch_batch(b), quantize=quantize)
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-4
    if quantize:
        np.testing.assert_allclose(float(met_t["pq_distortion"]),
                                   float(met_j["pq_distortion"]), rtol=1e-4)
        assert met_t["pq_compression_ratio"] == met_j["pq_compression_ratio"]


def test_accuracy_matches_jax():
    jm, tm, params = _models()
    b = _jax_batch(4, 16, clients=2)
    acc = tm.accuracy(_torch_batch(b))
    assert float(acc) == float(jm.accuracy(params, b))


def test_per_client_split_condition_matches_reference():
    """At batch == client_batch the whole batch is one client, as in the
    reference (paper_models.py:59-60); at 2x it is two."""
    jm, tm, params = _models((1152, 2), client_batch=4)
    for batch, clients in ((4, 1), (8, 2)):
        b = _jax_batch(3, batch, clients=clients)
        _, met_j = jm.loss(params, b)
        _, met_t = tm(_torch_batch(b))
        np.testing.assert_allclose(float(met_t["pq_distortion"]),
                                   float(met_j["pq_distortion"]), rtol=1e-4)


def test_unported_options_raise(caplog):
    """What still raises: a cut state with microbatches, which the
    reference refuses too. The downlink's wire payload is the reference's
    frame, and the downlink, step keys and cut state themselves run. The
    mesh executor runs (a world of one here): it warns, as the reference
    does, that a cohort-global codebook clusters per client on the mesh,
    and with per-client codebooks its round is the stacked one's within
    the reference's stacked-vs-mesh bounds."""
    tm = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=2), lam=1e-4,
                    downlink_compressor="topk(k=0.1)", device=CPU)
    assert tm.downlink_compressor.spec == "topk(k=0.1)"
    z = np.arange(16, dtype=np.float32).reshape(1, 2, 8) % 5
    jdl = JFemnistCNN(downlink_compressor=jC.make_compressor(
        "topk(k=0.1)")).downlink_compressor
    assert tm.downlink_compressor.wire_payload(
        tm.downlink_compressor.compress(torch.from_numpy(z))) == \
        jdl.wire_payload(jdl.compress(jnp.asarray(z[0])))
    data = make_federated_image_data(num_clients=8, seed=0, device=CPU)
    with caplog.at_level("WARNING"):
        FederatedTrainer(tm, sgd(LR), data, cohort=2, client_batch=4,
                         device=CPU, executor="mesh")
    assert "cohort-global PQ codebook" in caplog.text
    runs = {}
    for ex in ("stacked", "mesh"):
        per_client = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=2),
                                lam=1e-4, client_batch=4, device=CPU,
                                generator=torch.Generator().manual_seed(0))
        tr = FederatedTrainer(per_client, sgd(LR), data, cohort=3,
                              client_batch=4, device=CPU, executor=ex)
        runs[ex] = tr.run(1, 0)
    (s_st, h_st), (s_me, h_me) = runs["stacked"], runs["mesh"]
    np.testing.assert_allclose(h_me[0]["loss"], h_st[0]["loss"], rtol=5e-4)
    for k, v in s_st.params.items():
        np.testing.assert_allclose(s_me.params[k].detach().numpy(),
                                   v.detach().numpy(), rtol=5e-3, atol=5e-5)
    b = _torch_batch(_jax_batch(0, 4))
    state = TrainState.create(dict(tm.named_parameters()), sgd(LR))
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, sgd(LR), microbatches=2)(state, b,
                                                     cut_state=CutState())
    state, met = make_train_step(tm, sgd(LR), step_key=0)(
        state, b, cut_state=CutState())
    assert np.isfinite(float(met["loss"]))
    assert met["cut_state"].quantizer.rounds.tolist() == [1]
    assert 0.0 <= float(tm.accuracy(b)) <= 1.0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _run_both(steps, microbatches=1, lam_schedule=None):
    jm, tm, params = _models((1152, 2), lam=1e-4, client_batch=4)
    jstep = j_make_train_step(jm, jsgd(LR), donate=False,
                              microbatches=microbatches,
                              lam_schedule=lam_schedule)
    tstep = make_train_step(tm, sgd(LR), microbatches=microbatches,
                            lam_schedule=lam_schedule)
    js = JTrainState.create(jax.tree.map(jnp.asarray, params), jsgd(LR))
    ts = TrainState.create(dict(tm.named_parameters()), sgd(LR))
    out = []
    for i in range(steps):
        b = _jax_batch(10 + i, 8, clients=2)
        js, met_j = jstep(js, b)
        ts, met_t = tstep(ts, _torch_batch(b))
        out.append((js, met_j, ts, met_t))
    return out


def _assert_params_close(js, ts, atol):
    for part, leaves in js.params.items():
        ref = from_jax_params({part: jax.tree.map(np.asarray, leaves)})
        for k, v in ref.items():
            np.testing.assert_allclose(ts.params[k].detach().numpy(),
                                       v.numpy(), rtol=0, atol=atol,
                                       err_msg=k)


def test_train_step_tracks_jax_step_for_step():
    """3 steps at batch 8 with client_batch=4 (two clients' codebooks)."""
    out = _run_both(3)
    for js, met_j, ts, met_t in out:
        assert abs(float(met_t["loss"]) - float(met_j["loss"])) <= 1e-4
        assert ts.step == int(js.step)
    _assert_params_close(out[0][0], out[0][2], atol=1e-5)


def test_microbatched_step_with_lam_schedule_tracks_jax():
    sched = lambda step: 1e-4 * (step + 1)    # noqa: E731
    js, met_j, ts, met_t = _run_both(1, microbatches=2,
                                     lam_schedule=sched)[0]
    assert abs(float(met_t["loss"]) - float(met_j["loss"])) <= 1e-4
    _assert_params_close(js, ts, atol=1e-5)


def test_exact_cover_fedlite_grads_equal_splitfed_bitwise():
    """Identical images -> identical cut rows -> one centroid reconstructs
    them exactly: the residual is exactly 0 and FedLite's corrected
    gradient is SplitFed's, bit for bit."""
    model = FemnistCNN(pq=PQConfig(1, 2, kmeans_iters=8), lam=0.5,
                       device=CPU)
    batch = {"image": torch.ones((8, 28, 28, 1)),
             "label": torch.zeros(8, dtype=torch.int64)}
    params = list(model.parameters())
    loss_q, _ = model(batch)
    g_q = torch.autograd.grad(loss_q, params)
    loss_s, _ = model(batch, quantize=False)
    g_s = torch.autograd.grad(loss_s, params)
    assert torch.equal(loss_q, loss_s)
    for a, b in zip(g_q, g_s):
        assert torch.equal(a, b)
