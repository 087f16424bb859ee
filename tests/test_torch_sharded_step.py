"""The port's LM training and serving under a ("data", "model") mesh of 4
gloo ranks on the CPU, against the unsharded port and the reference's
sharded step.

One spawn of 4 ranks (``torch.multiprocessing`` with spawn, a
``FileStore`` under the test's temporary directory, no port), each with a
(data=2, model=2) ``make_debug_mesh``, runs the smoke configs of Llama-3
8B, Mixtral-8x22B (its MoE dispatch in 2 groups, one a batch shard) and
Mamba2-1.3B in f32 through ``launch/train.train`` and
``launch/serve.serve``:

  * 2 FedLite train steps (PQ at the cut) held to the unsharded port:
    losses within 1e-5 relative, params within 1e-5·(1 + |p|), and each
    param's update p_T - p_0 within 1e-4 of the run's largest update. The
    runs use SGD at lr 1 (0.1 and 0.2 after warmup_cosine's warmup), so
    that the updates stand far above the param tolerance and a gradient
    the shards sum wrongly shows: at lr 1e-3 a whole update sits under
    1e-5. Adam's first steps would divide each gradient by its own
    magnitude, so a gradient at rounding level (a sum taken in another
    order on the shards) would move its param by up to the learning rate
    either way;
  * a prefill of 4 prompts and 4 decode steps, logits within
    1e-5·(1 + |v|); for the two attention configs also with the caches'
    slots split over "model" (the layout the cache policy takes past its
    per-device budget, here a budget of 0: each rank writes its block of
    slots and decode combines the blocks' softmax statistics);
  * two sharded runs bitwise equal to each other;
  * the Llama config's run stopped after step 1 with a checkpoint and
    resumed from it: the checkpoint bitwise the step-1 params, the resumed
    step held to the unsharded port's resumed step;
  * the Mixtral config's 2 steps also under Adafactor (its published
    optimizer: factored second moments laid out as their params);
  * the Llama config's 2 steps also on a (data=1, model=4) mesh, where
    its 4 q heads divide the model axis and its 2 k/v heads do not (each
    k/v head is repeated for its q heads);
  * the Llama config for one SplitFed step held to the reference's
    sharded step on a (2, 2) JAX mesh of 4 host devices (a subprocess with
    XLA_FLAGS, from the port's init params and batch): the loss, the
    params, and each rank's local block of every param (its offset and
    size the reference's shard index on the device at the same mesh
    coordinate, its values the shard's).

The unsharded baselines take the mesh's MoE grouping (2 groups), which
decides the experts' capacity.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.base import get_arch
from repro_torch.core.fedlite import flat_params
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe

ARCHS = ("llama3_8b", "mixtral_8x22b", "mamba2_1p3b")
SEQ_SHARDED = ("llama3_8b", "mixtral_8x22b")     # the archs with KV caches
WORLD, MESH = 4, (2, 2)
TRAIN = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32",
         "--lr", "1.0", "--log-every", "100"]
# Adafactor's updates are RMS-scaled (lr 1e-3 gives 3.6e-4 to 1.3e-3)
ADAFACTOR = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
             "32", "--lr", "1e-3", "--log-every", "100"]
SERVE = ["--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "16",
         "--gen", "4"]
REF_STEP = ["--device", "cpu", "--steps", "1", "--batch", "4", "--seq",
            "32", "--no-pq", "--lr", "1.0", "--log-every", "100"]
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5          # of (1 + |p|)
UPDATE_TOL = 1e-4         # of the run's largest |p_T - p_0|
LOGIT_TOL = 1e-5          # of (1 + |v|)
JOIN_SECONDS = 240


def _cfg(arch, optimizer="sgd"):
    return dataclasses.replace(get_arch(arch, smoke=True),
                               optimizer=optimizer)


def _train(arch, argv, mesh=None, optimizer="sgd"):
    state, hist = ttrain.train(_cfg(arch, optimizer), ttrain.parse_args(
        ["--arch", arch] + argv), log=lambda line: None, mesh=mesh)
    return state, [float(h["loss"]) for h in hist]


def _serve(arch, mesh=None):
    logits = []
    tserve.serve(get_arch(arch, smoke=True), tserve.parse_args(
        ["--arch", arch] + SERVE), log=lambda line: None, mesh=mesh,
        on_logits=lambda lg: logits.append(lg.numpy()))
    return logits


def _serve_seq_sharded(arch, mesh):
    """``_serve`` with the caches laid out by a budget of 0 bytes, so
    their slots split over "model"."""
    import functools

    from repro_torch.launch import specs

    real = tserve.distribute_caches
    tserve.distribute_caches = functools.partial(
        specs.distribute_caches, seq_shard_budget=0)
    try:
        return _serve(arch, mesh)
    finally:
        tserve.distribute_caches = real


def _full(params):
    return {k: ttrain.full(v).detach().numpy()
            for k, v in flat_params(params).items()}


def _stop_and_resume(ckpt_dir, mesh=None):
    """The Llama config's run stopped after step 1 with a checkpoint, then
    run to step 2 from it: the params of step 1 and the checkpoint's, the
    resumed run's losses and params."""
    from repro_torch.checkpointing import restore_checkpoint
    ckpt = ["--ckpt-dir", ckpt_dir, "--ckpt-every", "1"]
    state, _ = _train("llama3_8b", TRAIN + ["--steps", "1"] + ckpt, mesh)
    out = {"step1": _full(state.params), "file": {
        k: v.numpy() for k, v in flat_params(restore_checkpoint(
            ckpt_dir, 1, "cpu")["params"]).items()}}
    state, out["loss"] = _train("llama3_8b", TRAIN + ckpt, mesh)
    out["params"] = _full(state.params)
    return out


def _rank_main(rank, store, out_path):
    """One rank: every run on the (2, 2) mesh; results pickled."""
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)   # four ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_debug_mesh(*MESH, device="cpu")
        out = {"coord": mesh.get_coordinate()}
        for arch in ARCHS:
            runs = []
            for _ in range(2):
                state, loss = _train(arch, TRAIN, mesh)
                runs.append({"loss": loss, "params": _full(state.params)})
            out[arch] = {"train": runs, "serve": _serve(arch, mesh)}
            if arch in SEQ_SHARDED:
                out[arch]["serve_seq"] = _serve_seq_sharded(arch, mesh)
        out["resumed"] = _stop_and_resume(
            os.path.join(os.path.dirname(out_path), "ckpt_mesh"), mesh)
        state, loss = _train("mixtral_8x22b", ADAFACTOR, mesh, "adafactor")
        out["adafactor"] = {"loss": loss, "params": _full(state.params)}
        state, loss = _train("llama3_8b", TRAIN,
                             make_debug_mesh(1, WORLD, device="cpu"))
        out["llama_1x4"] = {"loss": loss, "params": _full(state.params)}
        rows = torch.arange(8 * 3).reshape(8, 3)
        from repro_torch.core.fedlite import _microbatch
        from repro_torch.launch.specs import distribute_batch
        sharded = distribute_batch({"tokens": rows}, mesh)["tokens"]
        out["microbatches"] = [
            (_microbatch(sharded, m, i).full_tensor().tolist(),
             tuple(_microbatch(sharded, m, i).placements))
            for m in (2, 4) for i in range(m)]
        state, loss = _train("llama3_8b", REF_STEP, mesh)
        blocks = {}
        for k, v in flat_params(state.params).items():
            size, off = compute_local_shape_and_global_offset(
                v.shape, mesh, v.placements)
            blocks[k] = (tuple(off), tuple(size),
                         v.to_local().detach().numpy())
        out["ref_step"] = {"loss": loss, "params": _full(state.params),
                           "blocks": blocks}
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _reference_main(inputs_path, out_path):
    """The reference's sharded SplitFed step of the Llama smoke config on a
    (2, 2) mesh of 4 host devices, from the port's init params and batch
    (run in a subprocess whose XLA_FLAGS force the devices): loss, params,
    and each param's shard (index, data) per mesh coordinate."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs.base import get_arch as j_get_arch
    from repro.core import fedlite as jfed
    from repro.launch.specs import make_model as j_make_model
    from repro.optim import get_optimizer as j_get_optimizer
    from repro.optim import warmup_cosine as j_warmup_cosine
    from repro.sharding import use_mesh
    from repro.sharding.rules import param_shardings

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    devs = np.array(jax.devices()[:4]).reshape(MESH)
    mesh = Mesh(devs, ("data", "model"))
    coord = {devs[i, j]: (i, j) for i in range(2) for j in range(2)}
    cfg = j_get_arch("llama3_8b", smoke=True)
    model = j_make_model(cfg, with_pq=False, lam=inputs["lam"])
    opt = j_get_optimizer("sgd", j_warmup_cosine(inputs["lr"], 10, 1))
    step = jfed.make_train_step(model, opt, quantize=False, donate=False)
    params = inputs["params"]
    with use_mesh(mesh):
        params = jax.tree.map(lambda x, s: jax.device_put(x, s), params,
                              param_shardings(params, mesh))
        state = jfed.TrainState.create(params, opt)
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, JP("data", None))) for k, v in inputs["batch"].items()}
        state, m = step(state, batch)
    out = {"loss": float(m["loss"]), "params": {}, "shards": {}}
    leaves = jax.tree_util.tree_flatten_with_path(state.params)[0]
    for path, leaf in leaves:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out["params"][key] = np.asarray(leaf)
        out["shards"][key] = {
            coord[s.device]: (tuple(sl.start or 0 for sl in s.index),
                              tuple(np.asarray(s.data).shape),
                              np.asarray(s.data))
            for s in leaf.addressable_shards}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _init(arch, argv):
    """The init params of ``train``'s run of ``argv`` (the same model and
    seeded generator)."""
    args = ttrain.parse_args(["--arch", arch] + argv)
    model = ttrain.make_model(_cfg(arch), with_pq=not args.no_pq,
                              lam=args.lam)
    return model.init(torch.Generator("cpu").manual_seed(args.seed), "cpu")


def _reference_inputs(path):
    """The port's init params (nested numpy) and step-0 batch of the
    REF_STEP run, for the reference."""
    args = ttrain.parse_args(["--arch", "llama3_8b"] + REF_STEP)
    cfg = _cfg("llama3_8b")
    params = _init("llama3_8b", REF_STEP)

    def nested(tree):
        return {k: nested(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}

    batch = ttrain.make_batch(cfg, ttrain.step_rng(args.seed, 0), args.batch,
                              args.seq, "cpu")
    with open(path, "wb") as f:
        pickle.dump({"params": nested(params), "lr": args.lr, "lam": args.lam,
                     "batch": {k: v.numpy().astype(np.int32)
                               for k, v in batch.items()}}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks, the reference's sharded step in a subprocess and the
    unsharded baselines here, all at once."""
    tmp = tmp_path_factory.mktemp("sharded")
    here = Path(__file__).resolve().parent
    _reference_inputs(tmp / "inputs.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(here.parent / "src"), str(here)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_sharded_step as t; "
         "t._reference_main(sys.argv[1], sys.argv[2])",
         str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, str(tmp / "store"), str(tmp / f"r{r}.pkl"))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        base = {}
        groups = moe._num_groups
        moe._num_groups = lambda batch: 2 if batch % 2 == 0 else 1
        try:
            for arch in ARCHS:
                state, loss = _train(arch, TRAIN)
                base[arch] = {"loss": loss, "params": _full(state.params),
                              "p0": _full(_init(arch, TRAIN)),
                              "serve": _serve(arch)}
            base["resumed"] = _stop_and_resume(str(tmp / "ckpt"))
            state, loss = _train("mixtral_8x22b", ADAFACTOR,
                                 optimizer="adafactor")
            base["adafactor"] = {"loss": loss,
                                 "params": _full(state.params)}
        finally:
            moe._num_groups = groups
        _, err = ref.communicate(timeout=JOIN_SECONDS)
        for p in procs:
            p.join(timeout=JOIN_SECONDS)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"ranks failed or hung: {codes}"
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"r{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(tmp / "ref.pkl", "rb") as f:
        reference = pickle.load(f)
    reference["p0"] = _full(_init("llama3_8b", REF_STEP))
    return {"base": base, "ranks": ranks, "ref": reference}


def _param_gap(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]) / (1 + np.abs(a[k]))))
               for k in a)


def _top_update(p0, a):
    """a's largest update |a - p0| over every param; it must stand 100x
    above the param tolerance, or the tolerances could not see it."""
    top = max(float(np.max(np.abs(a[k] - p0[k]))) for k in a)
    assert top >= 100 * PARAM_TOL, top
    return top


def _update_gap(p0, a, b):
    """The largest gap between the updates a - p0 and b - p0 (that is,
    between a and b) over every param, over a's largest update."""
    return max(float(np.max(np.abs(b[k] - a[k]))) for k in a) \
        / _top_update(p0, a)


def _close(p0, base, got):
    """got's params held to base's: values and updates."""
    assert base.keys() == got.keys()
    assert _param_gap(base, got) <= PARAM_TOL
    assert _update_gap(p0, base, got) <= UPDATE_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_the_unsharded_port(runs, arch):
    base, got = runs["base"][arch], runs["ranks"][0][arch]["train"][0]
    np.testing.assert_allclose(got["loss"], base["loss"], rtol=LOSS_RTOL)
    _close(base["p0"], base["params"], got["params"])


def test_sharded_checkpoint_resumes_the_run(runs):
    """The mesh's checkpoint of step 1 (each param put together on the
    first rank's host block by block) holds the step-1 params bitwise, and
    the run resumed from it (each rank moving its own blocks to the mesh)
    matches the unsharded port's resumed run. A resumed run starts a fresh
    optimizer state, as the reference's does."""
    base = runs["base"]["resumed"]
    for rank in runs["ranks"]:
        got = rank["resumed"]
        assert got["file"].keys() == got["step1"].keys()
        for k, v in got["step1"].items():
            assert np.array_equal(got["file"][k], v), k
        np.testing.assert_allclose(got["loss"], base["loss"], rtol=LOSS_RTOL)
        _close(base["step1"], base["params"], got["params"])


def test_microbatches_of_a_sharded_batch(runs):
    """make_train_step's microbatch i of a row-sharded batch: its rows,
    split over the batch axis again where they divide it."""
    from torch.distributed.tensor import Replicate, Shard
    rows = np.arange(8 * 3).reshape(8, 3)
    want = [(rows[i * (8 // m):(i + 1) * (8 // m)].tolist(),
             (Shard(0), Replicate())) for m in (2, 4) for i in range(m)]
    for rank in runs["ranks"]:
        assert rank["microbatches"] == want


def test_sharded_adafactor_matches_the_unsharded_port(runs):
    base = runs["base"]["adafactor"]
    for rank in runs["ranks"]:
        got = rank["adafactor"]
        np.testing.assert_allclose(got["loss"], base["loss"], rtol=LOSS_RTOL)
        _close(runs["base"]["mixtral_8x22b"]["p0"], base["params"],
               got["params"])


def test_kv_heads_repeated_over_a_wide_model_axis(runs):
    base = runs["base"]["llama3_8b"]
    for rank in runs["ranks"]:
        got = rank["llama_1x4"]
        np.testing.assert_allclose(got["loss"], base["loss"], rtol=LOSS_RTOL)
        _close(base["p0"], base["params"], got["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_the_unsharded_port(runs, arch):
    base, got = runs["base"][arch]["serve"], runs["ranks"][0][arch]["serve"]
    assert len(got) == len(base) == 5
    for a, b in zip(base, got):
        assert a.shape == b.shape
        assert float(np.max(np.abs(a - b) / (1 + np.abs(a)))) <= LOGIT_TOL


@pytest.mark.parametrize("arch", SEQ_SHARDED)
def test_slot_sharded_caches_serve_as_the_unsharded_port(runs, arch):
    base = runs["base"][arch]["serve"]
    for rank in runs["ranks"]:
        got = rank[arch]["serve_seq"]
        assert len(got) == len(base) == 5
        for a, b in zip(base, got):
            assert float(np.max(np.abs(a - b) / (1 + np.abs(a)))) \
                <= LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_runs_are_bitwise_repeatable_and_equal_on_every_rank(runs,
                                                                     arch):
    first = runs["ranks"][0][arch]
    for rank in runs["ranks"]:
        for run in rank[arch]["train"]:
            assert run["loss"] == first["train"][0]["loss"]
            for k, v in first["train"][0]["params"].items():
                assert np.array_equal(run["params"][k], v), k
        for a, b in zip(rank[arch]["serve"], first["serve"]):
            assert np.array_equal(a, b)


def test_sharded_step_matches_the_reference_sharded_step(runs):
    ref = runs["ref"]
    for rank in runs["ranks"]:
        got = rank["ref_step"]
        np.testing.assert_allclose(got["loss"][0], ref["loss"],
                                   rtol=LOSS_RTOL)
        _close(ref["p0"], ref["params"], got["params"])
        top = _top_update(ref["p0"], ref["params"])
        coord = tuple(rank["coord"])
        for k, (off, size, block) in got["blocks"].items():
            r_off, r_size, r_block = ref["shards"][k][coord]
            assert (off, size) == (r_off, r_size), (k, coord)
            assert float(np.max(np.abs(block - r_block)
                                / (1 + np.abs(r_block)))) <= PARAM_TOL, k
            assert float(np.max(np.abs(block - r_block))) \
                <= UPDATE_TOL * top, k
