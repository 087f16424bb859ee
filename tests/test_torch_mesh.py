"""The port's cohort-parallel ``"mesh"`` executor and ``make_mesh_step``
against the JAX package's, on the CPU with gloo.

  * spec parsing, the registry and ``place`` against the reference's;
  * ``make_mesh_step`` in process at a world of one against the
    reference's on its one-device ``make_clients_mesh(1)``: both
    correction scopes, a zero-masked slot, a cut state; the port's parity
    policy: loss and metrics rtol 1e-4, the update rtol 1e-4 / atol 1e-6,
    the cut state's round counters equal and its codebooks and EF memory
    within rtol 1e-4 / atol 1e-5;
  * the trainer at 2 and 4 gloo ranks (``torch.multiprocessing`` with
    spawn, a ``FileStore`` under the test's temporary directory, no port)
    on three runs (FullSync at cohort 3, which pads at 4 ranks;
    AsyncBuffer(2); warm start with error feedback), each held to the
    port's stacked run under the reference's stacked-vs-mesh bounds
    (tests/test_executor.py: loss and ce rtol 5e-4, params rtol 5e-3 /
    atol 5e-5, participants and bytes equal) and to the reference's mesh
    run at 4 host devices (a subprocess with XLA_FLAGS, as
    tests/test_executor.py runs it) under the port's parity policy (the
    per-client memories within tests/test_torch_trainer.py's 1e-3); the
    ranks bitwise equal to each other. Init params and batches come from
    the reference, as tests/test_torch_trainer.py injects them;
  * the cut-state gather bitwise on every rank, -0.0 included;
  * kill and resume on the mesh: rank 0 alone writes the snapshots, every
    rank restores from them, bitwise the run never killed.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core.compressors import CutState as JCutState
from repro.core.fedlite import TrainState as JTrainState
from repro.core.fedlite import make_mesh_step as j_make_mesh_step
from repro.core.quantizer import PQConfig as JPQConfig
from repro.core.quantizer import QuantizerState as JQuantizerState
from repro.data.synthetic import make_federated_image_data as j_image_data
from repro.federated import executor as jexecutor
from repro.federated.scheduler import Arrival as JArrival
from repro.launch.mesh import make_clients_mesh as j_make_clients_mesh
from repro.models.paper_models import FemnistCNN as JFemnistCNN
from repro.optim import sgd as jsgd
from repro_torch.core.compressors import CutState
from repro_torch.core.fedlite import (TrainState, _gather_cuts,
                                      make_mesh_step)
from repro_torch.core.quantizer import PQConfig, QuantizerState
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import (AsyncBuffer, FederatedTrainer, FullSync,
                                   executor, lognormal_fleet)
from repro_torch.federated.scheduler import Arrival
from repro_torch.launch.mesh import make_clients_mesh
from repro_torch.models.paper_models import FemnistCNN, from_jax_params
from repro_torch.optim import sgd
from repro_torch.sharding.ctx import CLIENTS_AXIS, local_slots

CPU = torch.device("cpu")
LR = 0.03
CLIENTS, COHORT, B = 8, 3, 8
PQ_ARGS = (288, 4)
ITERS = 2
LOSS_RTOL = 1e-4                       # the port's parity policy
UPD_RTOL, UPD_ATOL = 1e-4, 1e-6
MESH_LOSS_RTOL = 5e-4                  # the reference's stacked vs mesh
MESH_RTOL, MESH_ATOL = 5e-3, 5e-5
CUT_RTOL, CUT_ATOL = 5e-3, 5e-4        # tests/test_executor.py's cut state
# a step's new cut state against the reference's: round counters equal;
# codebooks and EF memory are cut activations (|x| up to ~2, an f32 ulp
# 2.4e-7) that convolutions summed in another order move by a few ulps
STEP_CUT_RTOL, STEP_CUT_ATOL = 1e-4, 1e-5
# a run's per-client memories against the reference's run: the bounds of
# tests/test_torch_trainer.py's EF parity
RUN_CUT_RTOL, RUN_CUT_ATOL = 1e-3, 1e-3
# the three trainer runs: (policy, straggler fleet, warm start + EF, rounds)
RUNS = {"full_sync": ("full_sync", False, False, 2),
        "async": ("async", True, False, 2),
        "warm_ef": ("full_sync", False, True, 3)}
WORLDS = (2, 4)
JOIN_SECONDS = 300


@pytest.fixture(autouse=True)
def _full_f32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# spec parsing, registry, placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "stacked", "mesh", "mesh(shards=2)",
                                  " mesh(shards=4) "])
def test_make_executor_matches_the_reference(spec):
    ours, ref = executor.make_executor(spec), jexecutor.make_executor(spec)
    assert type(ours).__name__ == type(ref).__name__
    assert ours.name == ref.name
    assert getattr(ours, "shards", None) == getattr(ref, "shards", None)
    assert executor.available_executors() == \
        jexecutor.available_executors()


@pytest.mark.parametrize("spec,match", [("hamster_wheel", "unknown executor"),
                                        ("mesh(2)", "key=value")])
def test_bad_specs_raise_as_the_reference(spec, match):
    with pytest.raises(ValueError, match=match):
        jexecutor.make_executor(spec)
    with pytest.raises(ValueError, match=match):
        executor.make_executor(spec)


@pytest.mark.parametrize("clustered", [False, True], ids=["flat", "topo"])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_place_matches_the_reference(n, shards, clustered):
    """Contiguous blocks over the padded slots, cluster-major under a
    topology: the reference's ``place`` reads only ``num_shards`` and
    ``_cluster_of``, so both run unbound."""
    ours, ref = executor.MeshExecutor(), jexecutor.MeshExecutor()
    ours.num_shards = ref.num_shards = shards
    cluster_of = np.array([2, 0, 1, 0, 2, 1, 0, 1])
    if clustered:
        ours._cluster_of = ref._cluster_of = cluster_of
    clients = [5, 0, 7, 2, 3, 6, 1][:n]
    got = ours.place([Arrival(c, 0, float(i)) for i, c in enumerate(clients)])
    want = ref.place([JArrival(c, 0, float(i))
                      for i, c in enumerate(clients)])
    assert [(a.client, a.shard) for a in got] == \
        [(a.client, a.shard) for a in want]
    assert ours._slot_count(n) == ref._slot_count(n)


# ---------------------------------------------------------------------------
# make_mesh_step in process, world of one
# ---------------------------------------------------------------------------

def _models():
    jm = JFemnistCNN(pq=JPQConfig(*PQ_ARGS, kmeans_iters=ITERS,
                                  backend="jnp"), lam=1e-4, client_batch=B)
    tm = FemnistCNN(pq=PQConfig(*PQ_ARGS, kmeans_iters=ITERS,
                                backend="torch"),
                    lam=1e-4, client_batch=B, device=CPU)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(from_jax_params(params))
    return jm, tm, params


def _flat_ref(params):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree.map(np.asarray, params)).items()}


@pytest.mark.parametrize("scope,equal,padded,cut", [
    ("cohort", True, False, False), ("cohort", True, True, True),
    ("cohort", False, True, False), ("client", False, False, True),
    ("client", False, True, False)],
    ids=["cohort-fused", "cohort-fused-padded-cut", "cohort-weighted-padded",
         "client-cut", "client-padded"])
def test_mesh_step_matches_the_reference(scope, equal, padded, cut):
    """The shard's clients as one fused batch (the cohort scope with equal
    weights, the synchronous path's) or one by one (unequal weights, the
    client scope) against the reference's vmap. A fused batch reports the
    stacked path's ``pq_compression_ratio``, that of its n·B rows; the
    reference's mesh reports one client's."""
    jm, tm, params = _models()
    jdata = j_image_data(num_clients=CLIENTS, seed=0)
    n = 3
    slots = n + 1 if padded else n
    keys = [jax.random.PRNGKey(10 + c) for c in range(n)]
    jb = [jdata.sample_batch(c, keys[c], B) for c in range(n)]
    jb += [jb[-1]] * (slots - n)
    weights = [0.5] * slots if equal else [1.0, 0.5, 0.25, 1.0][:slots]
    mask = [1.0] * n + [0.0] * (slots - n)
    r = np.random.default_rng(0)
    dsub = FemnistCNN.cut_dim // PQ_ARGS[0]
    cb = r.standard_normal((slots, 1, PQ_ARGS[1], dsub)).astype(np.float32)
    ef = (0.01 * r.standard_normal((slots, B, FemnistCNN.cut_dim))
          ).astype(np.float32)
    rounds = np.ones(slots, np.int32)

    jstate = JTrainState.create(params, jsgd(LR))
    jstep = j_make_mesh_step(jm, jsgd(LR), j_make_clients_mesh(1),
                             donate=False, correction_scope=scope)
    jargs = (jax.tree.map(lambda *xs: jnp.stack(xs), *jb),
             jnp.asarray(weights, jnp.float32), jnp.asarray(mask, jnp.float32))
    jcut = JCutState(quantizer=JQuantizerState(jnp.asarray(cb),
                                               jnp.asarray(rounds)),
                     ef_memory=jnp.asarray(ef)) if cut else None
    jnew, jm_out = jstep(jstate, *jargs, jcut)

    tstate = TrainState.create(dict(tm.named_parameters()), sgd(LR))
    tstep = make_mesh_step(tm, sgd(LR), make_clients_mesh(1, CPU),
                           correction_scope=scope)
    tb = [{"image": torch.from_numpy(np.array(b["image"])),
           "label": torch.from_numpy(np.asarray(b["label"]).astype(np.int64))}
          for b in jb]
    tcut = CutState(quantizer=QuantizerState(torch.from_numpy(cb),
                                             torch.from_numpy(rounds)),
                    ef_memory=torch.from_numpy(ef)) if cut else None
    tnew, tm_out = tstep(tstate, tb, weights, mask, tcut)

    tcut_out, jcut_out = tm_out.pop("cut_state", None), \
        jm_out.pop("cut_state", None)
    assert set(tm_out) == set(jm_out)
    fused = scope == "cohort" and equal
    if fused:
        assert float(tm_out.pop("pq_compression_ratio")) == pytest.approx(
            tm.pq.compression_ratio(n * B, FemnistCNN.cut_dim), rel=1e-6)
    for k in tm_out:
        np.testing.assert_allclose(float(tm_out[k]), float(jm_out[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    before = _flat_ref(params)
    after = _flat_ref(jnew.params)
    for k, v in tnew.params.items():
        np.testing.assert_allclose(v.detach().numpy() - before[k],
                                   after[k] - before[k], rtol=UPD_RTOL,
                                   atol=UPD_ATOL, err_msg=k)
    assert (tcut_out is None) == (not cut) == (jcut_out is None)
    if cut:
        q, jq = tcut_out.quantizer, jcut_out.quantizer
        np.testing.assert_array_equal(q.rounds[:n].numpy(),
                                      np.asarray(jq.rounds)[:n])
        np.testing.assert_allclose(q.codebooks[:n].numpy(),
                                   np.asarray(jq.codebooks)[:n],
                                   rtol=STEP_CUT_RTOL, atol=STEP_CUT_ATOL)
        np.testing.assert_allclose(tcut_out.ef_memory[:n].numpy(),
                                   np.asarray(jcut_out.ef_memory)[:n],
                                   rtol=STEP_CUT_RTOL, atol=STEP_CUT_ATOL)
        assert tcut_out.ef_memory.shape == (slots, B, FemnistCNN.cut_dim)


def test_mesh_step_refuses_a_mesh_without_clients_axis():
    class NoClients:
        mesh_dim_names = ("data",)
    _, tm, _ = _models()
    with pytest.raises(ValueError, match="clients"):
        make_mesh_step(tm, sgd(LR), NoClients())
    with pytest.raises(ValueError, match="correction_scope"):
        make_mesh_step(tm, sgd(LR), make_clients_mesh(1, CPU),
                       correction_scope="global")


def test_clients_mesh_refuses_more_shards_than_ranks():
    """A world of one never stands in for a requested shards=2."""
    mesh = make_clients_mesh(1, CPU)
    assert mesh.mesh_dim_names == (CLIENTS_AXIS,)
    with pytest.raises(RuntimeError, match="nproc-per-node 2"):
        make_clients_mesh(2, CPU)
    with pytest.raises(RuntimeError, match="runs 'gloo'"):
        make_clients_mesh(1, CPU, backend="nccl")
    assert list(local_slots(4, mesh)) == [0, 1, 2, 3]


def _signed_cut(slot):
    """A per-client CutState whose values name the slot, -0.0 among them."""
    cb = torch.tensor([[[[-0.0, slot + 0.5], [0.0, -slot - 0.25]]]])
    ef = torch.tensor([[-0.0, float(slot)], [0.0, -0.0]])
    rounds = torch.tensor([slot], dtype=torch.int32)
    return CutState(quantizer=QuantizerState(cb, rounds), ef_memory=ef)


def _check_gather(mesh, slots):
    """``_gather_cuts`` of every rank's block against the expected states,
    bit for bit (the f32 bits compared as int32)."""
    got = _gather_cuts([_signed_cut(c) for c in local_slots(slots, mesh)],
                       slots, mesh, mesh.get_group(CLIENTS_AXIS))
    want = [_signed_cut(c) for c in range(slots)]
    cb = torch.cat([w.quantizer.codebooks for w in want])
    ef = torch.stack([w.ef_memory for w in want])
    return bool(torch.equal(got.quantizer.codebooks.view(torch.int32),
                            cb.view(torch.int32))
                and torch.equal(got.ef_memory.view(torch.int32),
                                ef.view(torch.int32))
                and torch.equal(got.quantizer.rounds,
                                torch.arange(slots, dtype=torch.int32)))


def test_cut_state_gather_keeps_signed_zeros_in_process():
    assert _check_gather(make_clients_mesh(1, CPU), 3)


# ---------------------------------------------------------------------------
# the trainer at 2 and 4 ranks against the stacked run and the reference
# ---------------------------------------------------------------------------

def _trainer_kw(run, ref):
    """The run's policy, fleet and cut-state flags for either package."""
    policy, straggle, warm, _ = RUNS[run]
    if ref:
        from repro.federated import AsyncBuffer as P_async
        from repro.federated import FullSync as P_sync
        from repro.federated import lognormal_fleet as fleet_of
    else:
        P_async, P_sync, fleet_of = AsyncBuffer, FullSync, lognormal_fleet
    return dict(policy=P_async(2) if policy == "async" else P_sync(),
                fleet=fleet_of(CLIENTS, median_uplink_bps=2e6, seed=3)
                if straggle else None,
                warm_start=warm, error_feedback=warm)


def _port_trainer(run, inputs, executor_spec):
    """The port's trainer of ``run`` from the reference's params, fed the
    reference's batches."""
    data = make_federated_image_data(num_clients=CLIENTS, seed=0,
                                     device=CPU)
    model = FemnistCNN(pq=PQConfig(*PQ_ARGS, kmeans_iters=ITERS,
                                   backend="torch"),
                       lam=1e-4, client_batch=B, device=CPU)
    model.load_state_dict(from_jax_params(inputs["params"]))
    tt = FederatedTrainer(model, sgd(LR), data, cohort=COHORT,
                          client_batch=B, device=CPU, executor=executor_spec,
                          **_trainer_kw(run, ref=False))
    batches = inputs["batches"]

    def ref_batch(cid, round_id, draw=0):
        image, label = batches[(int(cid), int(round_id))]
        return {"image": torch.from_numpy(image),
                "label": torch.from_numpy(label)}

    tt.client_batch_for = ref_batch
    return tt


def _result(trainer, state, hist, to_numpy):
    """What a run is compared on, as host values."""
    return {
        "history": hist,
        "params": {k: to_numpy(v) for k, v in state.items()},
        "records": [{**dataclasses.asdict(r), "metrics": None}
                    for r in trainer.last_trace],
        "meta": dict(trainer.last_trace.meta),
        "ef": {c: to_numpy(m) for c, m in trainer._ef_memory.items()},
        "q": {c: (to_numpy(q.codebooks), to_numpy(q.rounds))
              for c, q in trainer._client_q.items()},
    }


def _torch_numpy(t):
    return t.detach().cpu().numpy()


def _killed_and_resumed(inputs, world, ckpt_dir):
    """A warm-start + EF mesh run killed at round 3 of 4 and resumed from
    its round-2 snapshot, against the run never killed; which snapshots
    this rank wrote."""
    from repro_torch.federated import FaultPlan, recovery, run_with_recovery

    saved = []
    write = recovery.save_checkpoint

    def counted(*args, **kw):
        saved.append(args[1])
        return write(*args, **kw)

    recovery.save_checkpoint = counted
    try:
        runs = []
        for kill in ((), (3,)):
            tt = _port_trainer("warm_ef", inputs, f"mesh(shards={world})")
            tt.fault_plan = FaultPlan(seed=0, server_kill_rounds=kill)
            state, hist = run_with_recovery(tt, 4, 0, ckpt_dir + str(len(kill)),
                                            checkpoint_every=2)
            runs.append(_result(tt, state.params, hist, _torch_numpy))
    finally:
        recovery.save_checkpoint = write
    return {"runs": runs, "saved": saved}


def _rank_main(rank, world, store, inputs_path, out_path):
    """One rank: the three runs on ``mesh(shards=world)``, then the
    cut-state gather; results pickled to ``out_path``."""
    import torch.distributed as dist

    torch.set_num_threads(1)   # six ranks share the host's cores
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for run in RUNS:
            tt = _port_trainer(run, inputs, f"mesh(shards={world})")
            state, hist = tt.run(RUNS[run][3], 0)
            out[run] = _result(tt, state.params, hist, _torch_numpy)
            out[run]["rank"] = tt.executor.rank
        out["gather_ok"] = _check_gather(tt.executor.mesh, 2 * world)
        out["recovery"] = _killed_and_resumed(inputs, world, store + ".ckpt")
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _reference_main(out_path):
    """The reference's three runs on ``executor="mesh"`` at 4 host devices
    (run in a subprocess whose XLA_FLAGS force them)."""
    from repro.federated import FederatedTrainer as JTrainer

    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    for run in RUNS:
        jm = JFemnistCNN(pq=JPQConfig(*PQ_ARGS, kmeans_iters=ITERS,
                                      backend="jnp"),
                         lam=1e-4, client_batch=B)
        jt = JTrainer(jm, jsgd(LR), j_image_data(num_clients=CLIENTS, seed=0),
                      cohort=COHORT, client_batch=B, executor="mesh",
                      **_trainer_kw(run, ref=True))
        state, hist = jt.run(RUNS[run][3], jax.random.PRNGKey(0))
        params = {k: v.numpy() for k, v in from_jax_params(
            jax.tree.map(np.asarray, state.params)).items()}
        out[run] = _result(jt, params, hist, np.asarray)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _inputs():
    """The reference's init params and every batch the runs may draw:
    client ``cid``'s batch of round id r (0: the wire measurement's)."""
    key = jax.random.PRNGKey(0)
    jdata = j_image_data(num_clients=CLIENTS, seed=0)
    params = jax.tree.map(np.asarray, JFemnistCNN().init(key))
    batches = {}
    for rid in range(max(r[3] for r in RUNS.values()) + 2):
        for cid in range(CLIENTS):
            k = jax.random.fold_in(key, 0) if rid == 0 else \
                jax.random.fold_in(jax.random.fold_in(key, rid), cid)
            b = jdata.sample_batch(cid, k, B)
            batches[(cid, rid)] = (np.array(b["image"]),
                                   np.asarray(b["label"]).astype(np.int64))
    return {"params": params, "batches": batches}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every run at once: the reference's mesh in a subprocess, the 2- and
    4-rank port runs in spawned processes, the port's stacked runs here."""
    tmp = tmp_path_factory.mktemp("mesh")
    here = Path(__file__).resolve().parent
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", PYTHONPATH=os.pathsep.join(
                   [str(here.parent / "src"), str(here)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    ref_out = tmp / "ref.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_mesh as t; "
         "t._reference_main(sys.argv[1])", str(ref_out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    inputs = _inputs()
    inputs_path = tmp / "inputs.pkl"
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    procs = {}
    for world in WORLDS:
        store = tmp / f"store{world}"
        for rank in range(world):
            p = ctx.Process(target=_rank_main,
                            args=(rank, world, str(store), str(inputs_path),
                                  str(tmp / f"w{world}r{rank}.pkl")))
            p.start()
            procs[(world, rank)] = p
    try:
        stacked = {}
        for run in RUNS:
            tt = _port_trainer(run, inputs, "stacked")
            state, hist = tt.run(RUNS[run][3], 0)
            stacked[run] = _result(tt, state.params, hist, _torch_numpy)
        _, err = ref.communicate(timeout=JOIN_SECONDS)
        for p in procs.values():
            p.join(timeout=JOIN_SECONDS)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    failed = {k: p.exitcode for k, p in procs.items() if p.exitcode != 0}
    assert not failed, f"ranks failed or hung (exit codes): {failed}"
    ranks = {}
    for world, rank in procs:
        with open(tmp / f"w{world}r{rank}.pkl", "rb") as f:
            ranks[(world, rank)] = pickle.load(f)
    with open(ref_out, "rb") as f:
        reference = pickle.load(f)
    return {"stacked": stacked, "ref": reference, "ranks": ranks}


CASES = [(w, r) for w in WORLDS for r in RUNS]
IDS = [f"{w}ranks-{r}" for w, r in CASES]


def _losses(res, key="loss"):
    return [h[key] for h in res["history"]]


@pytest.mark.parametrize("world,run", CASES, ids=IDS)
def test_mesh_ranks_are_bitwise_equal(mesh_runs, world, run):
    """Every rank ends with the same params, history, trace and per-client
    memories, bit for bit; rank r knows itself as shard r."""
    first = mesh_runs["ranks"][(world, 0)][run]
    for rank in range(world):
        res = mesh_runs["ranks"][(world, rank)][run]
        assert res["rank"] == rank
        assert res["history"] == first["history"]
        assert res["records"] == first["records"]
        for k, v in first["params"].items():
            np.testing.assert_array_equal(res["params"][k], v)
        assert res["ef"].keys() == first["ef"].keys()
        for c in first["ef"]:
            np.testing.assert_array_equal(res["ef"][c].view(np.int32),
                                          first["ef"][c].view(np.int32))
        assert res["q"].keys() == first["q"].keys()
        for c in first["q"]:
            for a, b in zip(res["q"][c], first["q"][c]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world,run", CASES, ids=IDS)
def test_mesh_reproduces_the_port_stacked_run(mesh_runs, world, run):
    """The reference's stacked-vs-mesh contract, on the port: losses and
    ce, final params, the per-client memories, participants and bytes;
    placement recorded across the shards."""
    mesh = mesh_runs["ranks"][(world, 0)][run]
    st = mesh_runs["stacked"][run]
    for key in ("loss", "ce"):
        np.testing.assert_allclose(_losses(mesh, key), _losses(st, key),
                                   rtol=MESH_LOSS_RTOL)
    for k, v in st["params"].items():
        np.testing.assert_allclose(mesh["params"][k], v, rtol=MESH_RTOL,
                                   atol=MESH_ATOL, err_msg=k)
    for field in ("participants", "uplink_bytes", "downlink_bytes",
                  "dropped", "t_end"):
        assert [r[field] for r in mesh["records"]] == \
            [r[field] for r in st["records"]], field
    assert mesh["meta"]["executor"] == "mesh"
    assert mesh["meta"]["executor_shards"] == world
    assert all(max(r["shards"]) > 0 for r in mesh["records"]
               if len(r["participants"]) > 1)
    assert all(set(r["shards"]) == {0} for r in st["records"])
    assert mesh["ef"].keys() == st["ef"].keys()
    for c in st["ef"]:
        np.testing.assert_allclose(mesh["ef"][c], st["ef"][c], rtol=CUT_RTOL,
                                   atol=CUT_ATOL)
    assert mesh["q"].keys() == st["q"].keys()
    for c in st["q"]:
        np.testing.assert_array_equal(mesh["q"][c][1], st["q"][c][1])
        np.testing.assert_allclose(mesh["q"][c][0], st["q"][c][0],
                                   rtol=CUT_RTOL, atol=CUT_ATOL)


@pytest.mark.parametrize("world,run", CASES, ids=IDS)
def test_mesh_matches_the_reference_mesh_run(mesh_runs, world, run):
    """The reference's executor='mesh' at 4 host devices: the trace field
    for field (placement at 4 ranks too), losses and ce within the port's
    parity policy, the final params within its update bounds, the
    per-client round counters equal."""
    mesh = mesh_runs["ranks"][(world, 0)][run]
    ref = mesh_runs["ref"][run]
    for ours, theirs in zip(mesh["records"], ref["records"]):
        if world != 4:
            ours, theirs = dict(ours, shards=None), dict(theirs, shards=None)
        assert ours == theirs
    assert len(mesh["records"]) == len(ref["records"])
    for key in ("loss", "ce", "pq_distortion"):
        np.testing.assert_allclose(_losses(mesh, key), _losses(ref, key),
                                   rtol=LOSS_RTOL, err_msg=key)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(mesh["params"][k], v, rtol=UPD_RTOL,
                                   atol=UPD_ATOL, err_msg=k)
    assert mesh["q"].keys() == ref["q"].keys()
    for c in ref["q"]:
        np.testing.assert_array_equal(mesh["q"][c][1], ref["q"][c][1])
        np.testing.assert_allclose(mesh["q"][c][0], ref["q"][c][0],
                                   rtol=RUN_CUT_RTOL, atol=RUN_CUT_ATOL)
    assert mesh["ef"].keys() == ref["ef"].keys()
    for c in ref["ef"]:
        np.testing.assert_allclose(mesh["ef"][c], ref["ef"][c],
                                   rtol=RUN_CUT_RTOL, atol=RUN_CUT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_cut_state_gather_keeps_signed_zeros_across_ranks(mesh_runs, world):
    assert all(mesh_runs["ranks"][(world, r)]["gather_ok"]
               for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_kill_and_resume_writes_on_rank_zero(mesh_runs, world):
    """A mesh run killed at round 3 and resumed from its snapshot is, on
    every rank, bitwise the run never killed; rank 0 alone wrote the
    snapshots, and every rank restored from them."""
    for rank in range(world):
        rec = mesh_runs["ranks"][(world, rank)]["recovery"]
        unkilled, killed = rec["runs"]
        assert killed["history"] == unkilled["history"]
        for k, v in unkilled["params"].items():
            np.testing.assert_array_equal(killed["params"][k], v)
        for c in unkilled["ef"]:
            np.testing.assert_array_equal(killed["ef"][c], unkilled["ef"][c])
        assert rec["saved"] == ([2, 4, 2, 4] if rank == 0 else [])
