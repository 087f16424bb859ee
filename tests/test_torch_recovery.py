"""The port's crash recovery (``repro_torch/federated/recovery.py``)
against the JAX package's, on the CPU at ``tests/test_faults.py``'s size
(8 clients, q = 288, L = 4, 2 Lloyd iterations, cohort 4 x 8).

Twins of the reference's kill-and-resume, cold restart, restart budget and
flight lineage tests: a run killed at round 7 of 9 and resumed from its
round-6 snapshot is bitwise the run never killed (params, optimizer state,
history, trace records, flight frames).

Across the packages, snapshots are one format: the reference's snapshot
after its first segment restores into the port, and the port's into the
reference, with the state (through `state_leaves`), the cursor, the
trainer's RNG, the cut-layer state, the records and the history bitwise.
Both then continue 3 rounds on the reference's batches (injected through
``client_batch_for``, as ``tests/test_torch_trainer.py`` does): the trace
bitwise, the losses within rtol 1e-4 (``test_torch_trainer.py``'s
tolerance: f32 PQ, convolutions and sums in another order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.quantizer import PQConfig as JPQConfig
from repro.data.synthetic import make_federated_image_data as j_image_data
from repro.federated import FaultPlan as JFaultPlan
from repro.federated import FederatedTrainer as JTrainer
from repro.federated import recovery as jrecovery
from repro.models.paper_models import FemnistCNN as JFemnistCNN
from repro.optim import sgd as jsgd
from repro_torch.core.quantizer import PQConfig
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import (FaultPlan, FederatedTrainer, ServerKilled,
                                   restore_runtime, run_with_recovery)
from repro_torch.federated.recovery import state_from_leaves, state_leaves
from repro_torch.models.paper_models import FemnistCNN, from_jax_params
from repro_torch.optim import adafactor, adam, sgd

CPU = torch.device("cpu")
LOSS_RTOL = 1e-4


def _chaos_trainer(plan, seed=0, client_batch=0, optimizer=None, **kw):
    data = make_federated_image_data(num_clients=8, seed=0, device=CPU)
    pq = PQConfig(num_subvectors=288, num_clusters=4, kmeans_iters=2)
    model = FemnistCNN(pq=pq, lam=1e-4, client_batch=client_batch,
                       device=CPU)
    return FederatedTrainer(model, optimizer or sgd(0.03), data, cohort=4,
                            client_batch=8, quantize=True, seed=seed,
                            fault_plan=plan, device=CPU, **kw)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert a.opt_state.keys() == b.opt_state.keys()
    for x, y in zip(state_leaves(a), state_leaves(b)):
        np.testing.assert_array_equal(_np(x), _np(y))


# ---------------------------------------------------------------------------
# twins of tests/test_faults.py
# ---------------------------------------------------------------------------

def test_kill_and_resume_is_bitwise_identical(tmp_path):
    """A server killed at round 7 and restored from the round-6 snapshot
    finishes with bitwise-identical params, opt state, history, trace and
    flights to the run that was never killed."""
    base = FaultPlan(seed=5, crash_rate=0.1)
    kill = dataclasses.replace(base, server_kill_rounds=(7,))
    tr_a = _chaos_trainer(base, warm_start=True, error_feedback=True)
    st_a, hist_a = run_with_recovery(tr_a, 9, 0, str(tmp_path / "a"),
                                     checkpoint_every=3)
    tr_b = _chaos_trainer(kill, warm_start=True, error_feedback=True)
    st_b, hist_b = run_with_recovery(tr_b, 9, 0, str(tmp_path / "b"),
                                     checkpoint_every=3)
    assert hist_a == hist_b
    _assert_states_equal(st_a, st_b)
    assert tr_a.last_trace.records == tr_b.last_trace.records
    assert tr_a.last_trace.flights == tr_b.last_trace.flights
    assert len(tr_b.last_trace.records) == 9
    assert all(p.requires_grad and p.is_leaf for p in st_b.params.values())
    assert tr_b.fault_plan.server_kill_rounds == (7,)   # plan restored


def test_kill_on_first_segment_cold_restarts(tmp_path):
    plan = FaultPlan(seed=0, server_kill_rounds=(1,))
    tr = _chaos_trainer(plan)
    st, hist = run_with_recovery(tr, 4, 0, str(tmp_path / "ck"),
                                 checkpoint_every=3)
    assert len(tr.last_trace.records) == 4
    assert all(np.isfinite(h["loss"]) for h in hist if "loss" in h)
    # the cold restart is the run never killed
    st0, hist0 = run_with_recovery(_chaos_trainer(FaultPlan(seed=0)), 4, 0,
                                   str(tmp_path / "ck0"), checkpoint_every=3)
    assert hist == hist0
    _assert_states_equal(st, st0)


def test_pathological_kill_plan_exhausts_restart_budget(tmp_path):
    plan = FaultPlan(seed=0, server_kill_rounds=tuple(range(20)))
    tr = _chaos_trainer(plan)
    with pytest.raises(ServerKilled):
        run_with_recovery(tr, 6, 0, str(tmp_path / "ck"),
                          checkpoint_every=3, max_restarts=2)


def test_kill_and_resume_preserves_flight_lineage(tmp_path):
    base = FaultPlan(seed=5, crash_rate=0.1)
    kill = dataclasses.replace(base, server_kill_rounds=(7,))
    tr_a = _chaos_trainer(base)
    run_with_recovery(tr_a, 9, 0, str(tmp_path / "a"), checkpoint_every=3)
    tr_b = _chaos_trainer(kill)
    run_with_recovery(tr_b, 9, 0, str(tmp_path / "b"), checkpoint_every=3)
    assert len(tr_b.last_trace.flights) == 9
    assert tr_a.last_trace.flights == tr_b.last_trace.flights


def test_checkpoint_every_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="positive"):
        run_with_recovery(_chaos_trainer(None), 3, 0, str(tmp_path),
                          checkpoint_every=0)


def test_adafactor_kill_and_resume_is_bitwise_identical(tmp_path):
    """An Adafactor run (per-parameter factors, the conv weights' over I and
    O) killed at round 3 and restored from its round-2 snapshot is bitwise
    the run never killed; the snapshot's leaves are the reference's
    ``jax.tree.leaves`` of its Adafactor TrainState, in order and shape."""
    from repro.core.fedlite import TrainState as JTrainState
    from repro.optim import adafactor as jadafactor
    from repro_torch.checkpointing import restore_checkpoint

    base = FaultPlan(seed=5, crash_rate=0.1)
    kill = dataclasses.replace(base, server_kill_rounds=(3,))
    tr_a = _chaos_trainer(base, optimizer=adafactor(0.01))
    st_a, hist_a = run_with_recovery(tr_a, 5, 0, str(tmp_path / "a"),
                                     checkpoint_every=2)
    tr_b = _chaos_trainer(kill, optimizer=adafactor(0.01))
    st_b, hist_b = run_with_recovery(tr_b, 5, 0, str(tmp_path / "b"),
                                     checkpoint_every=2)
    assert hist_a == hist_b
    _assert_states_equal(st_a, st_b)
    assert tr_a.last_trace.records == tr_b.last_trace.records
    tree = restore_checkpoint(str(tmp_path / "b"), 4, device=CPU)["train"]
    ours = [tree[k] for k in sorted(tree)]
    ref = jax.tree.leaves(JTrainState.create(
        JFemnistCNN(pq=None).init(jax.random.PRNGKey(0)),
        jadafactor(0.01)))
    assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in ours] \
        == [(b.shape, str(b.dtype)) for b in ref]


# ---------------------------------------------------------------------------
# the TrainState conversion
# ---------------------------------------------------------------------------

def test_state_leaves_are_the_reference_leaves():
    """`state_leaves` of a port state made from the reference's params is
    the reference's ``jax.tree.leaves(TrainState)``: order, shapes (conv
    HWIO), dtypes and values; `state_from_leaves` inverts it."""
    from repro.core.fedlite import TrainState as JTrainState
    from repro.optim import adam as jadam
    from repro_torch.core.fedlite import TrainState
    jm = JFemnistCNN(pq=None)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    jstate = JTrainState.create(jparams, jadam(0.01))
    tm = FemnistCNN(device=CPU)
    tm.load_state_dict(from_jax_params(jparams))
    tstate = TrainState.create(dict(tm.named_parameters()), adam(0.01))
    ours, ref = state_leaves(tstate), jax.tree.leaves(jstate)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        a = a.detach().numpy() if torch.is_tensor(a) else a
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    back = state_from_leaves([np.asarray(x) for x in ref], tstate)
    _assert_states_equal(back, tstate)
    assert list(back.params) == list(tstate.params)
    assert all(p.requires_grad and p.is_leaf for p in back.params.values())


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _pair(client_batch, plan_kw):
    """(reference trainer, port trainer, key) from the same weights and
    plan, the port fed the reference's batches."""
    jdata = j_image_data(num_clients=8, seed=0)
    tdata = make_federated_image_data(num_clients=8, seed=0, device=CPU)
    jm = JFemnistCNN(pq=JPQConfig(288, 4, kmeans_iters=2, backend="jnp"),
                     lam=1e-4, client_batch=client_batch)
    tm = FemnistCNN(pq=PQConfig(288, 4, kmeans_iters=2, backend="torch"),
                    lam=1e-4, client_batch=client_batch, device=CPU)
    key = jax.random.PRNGKey(0)
    tm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jm.init(key))))
    kw = dict(cohort=4, client_batch=8, warm_start=True, error_feedback=True)
    jt = JTrainer(jm, jsgd(0.03), jdata, fault_plan=JFaultPlan(**plan_kw),
                  **kw)
    tt = FederatedTrainer(tm, sgd(0.03), tdata, fault_plan=FaultPlan(
        **plan_kw), device=CPU, **kw)

    def ref_batch(cid, round_id, draw=0):
        if round_id == 0:
            k = jax.random.fold_in(key, 0)
            k = jax.random.fold_in(k, 1) if draw else k
        else:
            k = jax.random.fold_in(jax.random.fold_in(key, round_id), cid)
        b = jdata.sample_batch(int(cid), k, 8)
        return {"image": torch.from_numpy(np.array(b["image"])),
                "label": torch.from_numpy(
                    np.asarray(b["label"]).astype(np.int64))}

    tt.client_batch_for = ref_batch
    return jt, tt, key


def _frames(trace):
    """The flight frames as json columns (the packages' frame classes
    differ; their columns and json are the same)."""
    return [f.to_json() for f in trace.flights]


def _assert_restored_equal(jt, jstate, jcur, jtrace, jhist,
                           tt, tstate, tcur, ttrace, thist):
    ref = jax.tree.leaves(jstate)
    ours = state_leaves(tstate)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert _np(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert tcur == jcur
    assert tt._rng.bit_generator.state == jt._rng.bit_generator.state
    assert [r.__dict__ for r in ttrace.records] == \
        [r.__dict__ for r in jtrace.records]
    assert _frames(ttrace) == _frames(jtrace)
    assert ttrace.meta == jtrace.meta
    assert thist == jhist
    assert sorted(tt._client_q) == sorted(jt._client_q)
    for c, q in tt._client_q.items():
        for a, b in zip(q, jt._client_q[c]):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert sorted(tt._ef_memory) == sorted(jt._ef_memory)
    for c, m in tt._ef_memory.items():
        np.testing.assert_array_equal(_np(m), np.asarray(jt._ef_memory[c]))
    assert (tt._global_q is None) == (jt._global_q is None)
    if jt._global_q is not None:
        for a, b in zip(tt._global_q, jt._global_q):
            np.testing.assert_array_equal(_np(a).reshape(np.shape(b)),
                                          np.asarray(b))
    assert tt._global_q_nparts == jt._global_q_nparts
    assert (tt._seed_q is None) == (jt._seed_q is None)


def _continue_and_compare(jt, jstate, jcur, tt, tstate, tcur, key):
    """3 more rounds from the restored snapshot in each package."""
    _, jhist = jt.run(6, key, state=jstate, cursor=jcur)
    _, thist = tt.run(6, 0, state=tstate, cursor=tcur)
    jtr, ttr = jt.last_trace, tt.last_trace
    assert len(ttr) == len(jtr) == 3
    for a, b in zip(ttr, jtr):
        fa, fb = dict(a.__dict__), dict(b.__dict__)
        ma, mb = fa.pop("metrics"), fb.pop("metrics")
        assert fa == fb
        assert ma.keys() == mb.keys()
        for k in ma:
            np.testing.assert_allclose(ma[k], mb[k], rtol=LOSS_RTOL)
    assert _frames(ttr) == _frames(jtr)
    assert ttr.cursor == jtr.cursor
    for a, b in zip(thist, jhist):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL)


PLAN = dict(seed=5, crash_rate=0.1, corrupt_rate=0.1)


@pytest.mark.parametrize("client_batch", [0, 8],
                         ids=["global_codebook", "per_client_codebooks"])
def test_reference_snapshot_restores_into_the_port(tmp_path, client_batch):
    jt, tt, key = _pair(client_batch, PLAN)
    jrecovery.run_with_recovery(jt, 3, key, str(tmp_path),
                                checkpoint_every=3)
    jstate, jcur, jtrace, jhist = jrecovery.restore_runtime(
        jt, jt.init_state(key), str(tmp_path))
    tstate, tcur, ttrace, thist = restore_runtime(tt, tt.init_state(),
                                                  str(tmp_path))
    _assert_restored_equal(jt, jstate, jcur, jtrace, jhist,
                           tt, tstate, tcur, ttrace, thist)
    _continue_and_compare(jt, jstate, jcur, tt, tstate, tcur, key)


@pytest.mark.parametrize("client_batch", [0, 8],
                         ids=["global_codebook", "per_client_codebooks"])
def test_port_snapshot_restores_into_the_reference(tmp_path, client_batch):
    jt, tt, key = _pair(client_batch, PLAN)
    run_with_recovery(tt, 3, 0, str(tmp_path), checkpoint_every=3)
    tstate, tcur, ttrace, thist = restore_runtime(tt, tt.init_state(),
                                                  str(tmp_path))
    jstate, jcur, jtrace, jhist = jrecovery.restore_runtime(
        jt, jt.init_state(key), str(tmp_path))
    _assert_restored_equal(jt, jstate, jcur, jtrace, jhist,
                           tt, tstate, tcur, ttrace, thist)
    _continue_and_compare(jt, jstate, jcur, tt, tstate, tcur, key)
