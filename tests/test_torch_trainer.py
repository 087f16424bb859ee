"""Parity of the port's ``FederatedTrainer`` (``repro_torch/federated/
runtime.py``, the stacked executor, ``make_weighted_step``) with the JAX
package's, on the CPU at a small size.

Both trainers start from the same weights (``from_jax_params``) and see
the same batches: the reference draws them with ``jax.random``, and the
port's ``client_batch_for`` is overridden to hand it the reference's
batch for the same (client, round). Tolerances:

  * the trace (times, participants, dropped clients, bytes, the ledger,
    flight frames) and the measured wire bytes: bitwise;
  * per-round losses: rtol 1e-4 (f32 PQ, convolutions and sums in another
    order);
  * ``make_weighted_step``'s update: allclose (rtol 1e-4, atol 1e-6) to
    the reference's ``tensordot`` over vmapped per-client gradients, which
    the port accumulates client by client in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as jllama
from repro.core.compressors import CutState as JCutState
from repro.core.fedlite import TrainState as JTrainState
from repro.core.fedlite import comm_report as j_comm_report
from repro.core.fedlite import make_weighted_step as j_make_weighted_step
from repro.core.quantizer import PQConfig as JPQConfig
from repro.core.split import split_summary as j_split_summary
from repro.data.synthetic import make_federated_image_data as j_image_data
from repro.federated import AsyncBuffer as JAsyncBuffer
from repro.federated import FederatedTrainer as JTrainer
from repro.federated import mobile_fleet as j_mobile_fleet
from repro.federated import runtime as jruntime
from repro.launch.specs import make_model as jmake_model
from repro.models.paper_models import FemnistCNN as JFemnistCNN
from repro.optim import sgd as jsgd
from repro_torch import obs as tobs
from repro_torch.configs import llama3_8b as tllama
from repro_torch.core.compressors import CutState
from repro_torch.core.fedlite import TrainState, comm_report
from repro_torch.core.fedlite import make_weighted_step
from repro_torch.core.quantizer import PQConfig, QuantizerState
from repro_torch.core.split import split_summary
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import (AsyncBuffer, FederatedTrainer,
                                   mobile_fleet, runtime)
from repro_torch.launch.specs import make_model as tmake_model
from repro_torch.models import transformer as ttransformer
from repro_torch.models.paper_models import FemnistCNN, from_jax_params
from repro_torch.optim import sgd

LR = 10 ** -1.5
CPU = torch.device("cpu")
CLIENTS, COHORT, B = 8, 3, 4
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _full_f32():
    """Hold the port to full f32 where it is compared with the reference."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _pair(*, downlink=None, policy=None, fleet=None, warm_start=False,
          error_feedback=False, delta_bits=None, kmeans_iters=5):
    """(reference trainer, port trainer) from the same weights, the port
    fed the reference's batches through ``client_batch_for``."""
    jdata = j_image_data(num_clients=CLIENTS, seed=0)
    tdata = make_federated_image_data(num_clients=CLIENTS, seed=0,
                                      device=CPU)
    jm = JFemnistCNN(pq=JPQConfig(1152, 2, kmeans_iters=kmeans_iters,
                                  backend="jnp"),
                     lam=1e-4, client_batch=B)
    tm = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=kmeans_iters,
                                backend="torch"),
                    lam=1e-4, client_batch=B, device=CPU)
    key = jax.random.PRNGKey(0)
    tm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jm.init(key))))
    kw = dict(cohort=COHORT, client_batch=B, downlink_compressor=downlink,
              warm_start=warm_start, error_feedback=error_feedback,
              codebook_delta_bits=delta_bits)
    jt = JTrainer(jm, jsgd(LR), jdata, fleet=fleet and fleet[0],
                  policy=policy and policy[0], **kw)
    tt = FederatedTrainer(tm, sgd(LR), tdata, fleet=fleet and fleet[1],
                          policy=policy and policy[1], device=CPU, **kw)

    def ref_batch(cid, round_id, draw=0):
        if round_id == 0:    # the wire measurement's batches
            k = jax.random.fold_in(key, 0)
            k = jax.random.fold_in(k, 1) if draw else k
        else:
            k = jax.random.fold_in(jax.random.fold_in(key, round_id), cid)
        b = jdata.sample_batch(int(cid), k, B)
        return {"image": torch.from_numpy(np.array(b["image"])),
                "label": torch.from_numpy(
                    np.asarray(b["label"]).astype(np.int64))}

    tt.client_batch_for = ref_batch
    return jt, tt, key


def _run_pair(steps, **kw):
    jt, tt, key = _pair(**kw)
    _, jhist = jt.run(steps, key)
    _, thist = tt.run(steps, 0)
    return jt, tt, jhist, thist


def _assert_trace_parity(jt, tt, jhist, thist):
    jtr, ttr = jt.last_trace, tt.last_trace
    assert len(ttr) == len(jtr) > 0
    for a, b in zip(ttr, jtr):
        fields = dict(a.__dict__)
        ref = dict(b.__dict__)
        ma, mb = fields.pop("metrics"), ref.pop("metrics")
        assert fields == ref        # times, participants, bytes, ledger
        assert ma.keys() == mb.keys()
        for k in ma:   # loss, ce, the PQ metrics: f32 on the reference
            np.testing.assert_allclose(ma[k], mb[k], rtol=LOSS_RTOL)
    for fa, fb in zip(ttr.flights, jtr.flights):
        for col in fa._COLS:
            np.testing.assert_array_equal(getattr(fa, col),
                                          getattr(fb, col))
    assert len(ttr.flights) == len(jtr.flights)
    assert ttr.meta == jtr.meta
    for a, b, rec in zip(thist, jhist, ttr):
        assert a.keys() == b.keys()
        for k in a:
            if k in rec.metrics:
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL)
            else:    # the simulation's fields: exact
                assert a[k] == b[k], k


def test_fullsync_ideal_trainer_matches_reference():
    """The main path: ideal fleet, FullSync, the stacked executor, the pq
    uplink measured by the wire."""
    jt, tt, jhist, thist = _run_pair(3)
    _assert_trace_parity(jt, tt, jhist, thist)
    meta = tt.last_trace.meta
    assert meta["uplink_wire_kind"] == "pq"
    assert meta["uplink_bytes_per_client"] == \
        jt.last_trace.meta["uplink_bytes_per_client"]
    assert all(h["participants"] == COHORT for h in thist)


def test_async_mobile_trainer_matches_reference():
    """The weighted path: a mobile fleet, AsyncBuffer flushes through
    ``make_weighted_step``, the chain downlink and per-client warm start."""
    jt, tt, jhist, thist = _run_pair(
        4, downlink="chain:topk(k=0.1)+scalarq(bits=8)",
        policy=(JAsyncBuffer(2), AsyncBuffer(2)),
        fleet=(j_mobile_fleet(CLIENTS, flaky_fraction=0.3, seed=0),
               mobile_fleet(CLIENTS, flaky_fraction=0.3, seed=0)),
        warm_start=True, kmeans_iters=3)
    _assert_trace_parity(jt, tt, jhist, thist)
    assert tt.last_trace.meta["downlink_wire_kind"] == "sparse"
    assert "mean_staleness_weight" in thist[-1]
    assert len(tt._client_q) > 0   # per-client warm-start lineage


def test_measured_bytes_match_reference_every_direction():
    """Measured uplink / downlink bytes (and the pq-delta codebook meta)
    equal the reference's: pq up, dense / chain down, pq-delta both."""
    for kw in ({}, {"downlink": "chain:topk(k=0.1)+scalarq(bits=8)"},
               {"downlink": "pq", "delta_bits": 8}):
        jt, tt, key = _pair(**kw)
        jstate = jt.init_state(key)
        tstate = tt.init_state()
        assert tt.measure_round_bytes(tstate) == \
            jt.measure_round_bytes(jstate, jax.random.fold_in(key, 0))
        assert tt.last_wire_kinds == jt.last_wire_kinds
        assert tt.last_codebook_meta == jt.last_codebook_meta
        assert tt.measure_dense_bytes(tstate) == \
            jt.measure_dense_bytes(jstate, key)


def test_error_feedback_and_stacked_warm_start_track_reference():
    """FullSync with per-client warm start and error feedback on the
    stacked layout: the same losses, the same per-client lineage."""
    jt, tt, jhist, thist = _run_pair(3, warm_start=True,
                                     error_feedback=True, kmeans_iters=3)
    _assert_trace_parity(jt, tt, jhist, thist)
    assert sorted(tt._client_q) == sorted(jt._client_q)
    assert sorted(tt._ef_memory) == sorted(jt._ef_memory)
    for c in tt._ef_memory:
        np.testing.assert_allclose(tt._ef_memory[c].numpy(),
                                   np.asarray(jt._ef_memory[c]),
                                   rtol=1e-3, atol=1e-3)


_SYNCS = ("cpu", "item", "tolist", "__float__", "__int__", "__bool__")


def _count_syncs(monkeypatch):
    counts = {}
    for name in _SYNCS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return counts


def test_fullsync_run_makes_one_metrics_transfer(monkeypatch):
    """A FullSync run's host syncs do not grow with the rounds: the wire
    measurement copies the pq payload's codes and codebooks to the host
    once, and the metrics of every round come back in ONE transfer."""
    flushes = []
    orig_flush = tobs.MetricsBuffer.flush

    def flush(self):
        flushes.append(len(self))
        return orig_flush(self)
    monkeypatch.setattr(tobs.MetricsBuffer, "flush", flush)
    totals = []
    for steps in (2, 4):
        _, tt, _ = _pair(kmeans_iters=2)
        counts = _count_syncs(monkeypatch)
        tt.run(steps, 0)
        monkeypatch.undo()
        monkeypatch.setattr(tobs.MetricsBuffer, "flush", flush)
        totals.append(dict(counts))
    assert flushes == [2, 4]
    assert totals[0] == totals[1] == {"cpu": 3}   # codes, codebooks, metrics


def test_weighted_step_matches_reference_on_one_flush():
    """``make_weighted_step``: per-client gradients, each discounted by its
    own staleness weight, against the reference's vmap + tensordot, with
    a client-major warm-start state."""
    jm = JFemnistCNN(pq=JPQConfig(1152, 2, kmeans_iters=3, backend="jnp"),
                     lam=1e-4, client_batch=B)
    tm = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=3, backend="torch"),
                    lam=1e-4, client_batch=B, device=CPU)
    jparams = jm.init(jax.random.PRNGKey(1))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    data = j_image_data(num_clients=CLIENTS, seed=0)
    parts = [data.sample_batch(c, jax.random.PRNGKey(10 + c), B)
             for c in range(3)]
    weights = [1.0, 0.5, 0.25]
    rng = np.random.default_rng(0)
    cbs = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    jcut = JCutState(quantizer=jruntime.QuantizerState(
        codebooks=jnp.asarray(cbs), rounds=jnp.ones(3, jnp.int32)))
    tcut = CutState(quantizer=QuantizerState(
        torch.from_numpy(cbs), torch.ones(3, dtype=torch.int32)))
    jstep = j_make_weighted_step(jm, jsgd(LR), donate=False)
    tstep = make_weighted_step(tm, sgd(LR))
    jst, jmet = jstep(JTrainState.create(jparams, jsgd(LR)),
                      jax.tree.map(lambda *x: jnp.stack(x), *parts),
                      jnp.asarray(weights), jcut)
    tparts = [{"image": torch.from_numpy(np.array(p["image"])),
               "label": torch.from_numpy(np.asarray(p["label"])
                                         .astype(np.int64))} for p in parts]
    tst, tmet = tstep(TrainState.create(dict(tm.named_parameters()),
                                        sgd(LR)), tparts, weights, tcut)
    want = from_jax_params(jax.tree.map(np.asarray, jst.params))
    for k, v in tst.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6)
    for k in ("loss", "ce", "pq_distortion", "mean_staleness_weight"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL)
    new = tmet["cut_state"].quantizer
    assert tuple(new.codebooks.shape) == (3, 1, 2, 8)
    np.testing.assert_allclose(
        new.codebooks.numpy(),
        np.asarray(jmet["cut_state"].quantizer.codebooks),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(new.rounds.numpy(), [2, 2, 2])


def test_split_summary_and_comm_report_equal_reference():
    """``split_summary`` on the CNN's flat params and the LM's nested ones,
    and ``comm_report`` on the split Llama-3 8B smoke model, equal the
    reference's (``pq_backend`` names each package's own backend)."""
    jm = JFemnistCNN()
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = FemnistCNN(device=CPU)
    for phi in (None, 64):
        assert split_summary(dict(tm.named_parameters()), phi) == \
            j_split_summary(jparams, phi)
    jcfg, tcfg = jllama.SMOKE_CONFIG, tllama.SMOKE_CONFIG
    jlm, tlm = jmake_model(jcfg), tmake_model(tcfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    tp = ttransformer.from_jax_params(jax.tree.map(np.asarray, jp))
    assert split_summary(tp) == j_split_summary(jp)
    for phi in (None, 64):
        ours = comm_report(tlm, tp, 16, phi_bits=phi)
        ref = j_comm_report(jlm, jp, 16, phi_bits=phi)
        assert ours.pop("pq_backend") == "torch"
        assert ref.pop("pq_backend") == "jnp"
        assert ours == ref


def test_fedavg_baseline_matches_reference():
    """Cohort sampling and weighted averaging are bitwise; one FedAvg round
    from the same weights and batches tracks the reference."""
    for w in (None, np.linspace(1.0, 2.0, CLIENTS)):
        assert np.array_equal(
            runtime.sample_clients(np.random.default_rng(3), CLIENTS, 4, w),
            jruntime.sample_clients(np.random.default_rng(3), CLIENTS, 4, w))
    trees = [{"a": torch.full((2,), float(i))} for i in range(3)]
    avg = runtime.weighted_average(trees, [1.0, 2.0, 1.0])
    ref = jruntime.weighted_average([{"a": jnp.full((2,), float(i))}
                                     for i in range(3)], [1.0, 2.0, 1.0])
    np.testing.assert_allclose(avg["a"].numpy(), np.asarray(ref["a"]),
                               rtol=1e-6)
    jm, tm = JFemnistCNN(), FemnistCNN(device=CPU)
    jparams = jm.init(jax.random.PRNGKey(2))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    jdata = j_image_data(num_clients=CLIENTS, seed=0)
    tdata = make_federated_image_data(num_clients=CLIENTS, seed=0,
                                      device=CPU)
    key = jax.random.PRNGKey(5)
    ids = [1, 4]
    # the reference's batches, in the order the port asks for them
    queue = [jdata.sample_batch(c, jax.random.fold_in(
        jax.random.fold_in(key, c), s), B) for c in ids for s in range(2)]
    tdata.sample_batch = lambda cid, rng, batch: {
        "image": torch.from_numpy(np.array(queue[0]["image"])),
        "label": torch.from_numpy(np.asarray(queue.pop(0)["label"])
                                  .astype(np.int64))}
    new, loss = runtime.fedavg_round(
        tm, {k: v.detach() for k, v in tm.named_parameters()}, tdata, ids,
        0, local_steps=2, batch=B, lr=LR)
    jnew, jloss = jruntime.fedavg_round(jm, jparams, jdata, ids, key,
                                        local_steps=2, batch=B, lr=LR)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jnew))
    for k, v in new.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_trainer_not_asked_for_the_cpu_raises_without_a_card(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    without CUDA, the default trainer raises instead of falling back;
    a model on another device than the trainer's raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_federated_image_data(num_clients=CLIENTS, seed=0,
                                     device=CPU)
    model = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=2), lam=1e-4,
                       client_batch=B, device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedTrainer(model, sgd(LR), data, cohort=COHORT,
                         client_batch=B)
    with pytest.raises(ValueError, match="is on cpu, the trainer on meta"):
        FederatedTrainer(model, sgd(LR), data, cohort=COHORT,
                         client_batch=B, device="meta")
    tt = FederatedTrainer(model, sgd(LR), data, cohort=COHORT,
                          client_batch=B, device=CPU)
    assert tt.model is model        # no codec to install: the same module


def test_installed_codec_leaves_the_callers_module_alone():
    """A downlink spec goes into a shallow copy of the model: the caller's
    module keeps its codec, the parameters are shared, and the trained
    path and the measurement use the one installed codec object."""
    data = make_federated_image_data(num_clients=CLIENTS, seed=0,
                                     device=CPU)
    model = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=2), lam=1e-4,
                       client_batch=B, device=CPU)
    tt = FederatedTrainer(model, sgd(LR), data, cohort=COHORT,
                          client_batch=B, device=CPU,
                          downlink_compressor="topk(k=0.1)")
    assert model.downlink_compressor is None
    assert tt.model is not model
    assert tt.model.downlink_compressor is tt.downlink
    assert all(a is b for a, b in zip(tt.model.parameters(),
                                      model.parameters()))
    # the mesh executor (a world of one here) installs the same codec, and
    # its round() is the stacked one's within the reference's
    # stacked-vs-mesh bounds, leaving the caller's state as it was
    tm = FederatedTrainer(model, sgd(LR), data, cohort=COHORT,
                          client_batch=B, device=CPU, executor="mesh",
                          downlink_compressor="topk(k=0.1)")
    assert model.downlink_compressor is None
    assert tm.model.downlink_compressor is tm.downlink
    assert (tm.executor.name, tm.executor.num_shards) == ("mesh", 1)
    state = tt.init_state()
    before = {k: v.detach().clone() for k, v in state.params.items()}
    s_st, m_st = tt.round(state, 1)
    s_me, m_me = tm.round(state, 1)
    for k, v in state.params.items():
        assert torch.equal(v, before[k]), k
    np.testing.assert_allclose(float(m_me["loss"]), float(m_st["loss"]),
                               rtol=5e-4)
    for k, v in s_st.params.items():
        np.testing.assert_allclose(s_me.params[k].detach().numpy(),
                                   v.detach().numpy(), rtol=5e-3, atol=5e-5)
    assert s_me.step == s_st.step == 1
