"""Driver of the federated-rounds cells: FedLite (or SplitFed) rounds of
a paper model through ``repro_torch.federated.FederatedTrainer``.

The configuration's file names what is model-specific, so one driver
serves every paper model: ``program`` (the class in
``repro_torch.models.paper_models`` and its arguments), ``reference`` (the
module under ``fedbench/reference/`` with the plain model, its
parameters' names and shapes, its cut's shape and the clients' data) and
``counts`` (the module under ``fedbench/counts/`` with its FLOPs).

Set-up makes the clients' data and the model's weights on the device from
the seed, builds one trainer (the executor and fleet the file names,
``FullSync``) and drives its first rounds through ``run`` -- the window's
own call -- whose states and losses the reference checks. The window then
runs back-to-back ``run(rounds_per_call)`` calls that continue the state,
each under the next batch seed, so each call's wire measurement and
metrics flush are paid at the rate a user pays them; ``round_ms`` is the
window's wall time over the whole rounds it ran.

A ``--trace 1`` run adds two stretches after the window: one ``run`` call
with the program's obs spans recorded and a span around every
``batched_lloyd`` call; then one under the profiler, which opens and
closes on round boundaries inside the call (``trace_rounds``), after its
wire measurement.

A client's batch is a draw without replacement from its pool under the
generator the trainer hands it.
"""

from __future__ import annotations

import contextlib
import importlib
import time
import types
from typing import Dict

import numpy as np
import torch

from fedbench import compare, hooks, tracing
from fedbench.harness import process_age_s, seed_of
from fedbench.counts import peaks
from fedbench.reference import pq as ref_pq

# seed streams of one run, each from SeedSequence([seed, stream])
DATA, WEIGHTS, TRAINER, BATCHES = 1, 2, 3, 4


def reference_of(cfg: dict):
    return importlib.import_module(f"fedbench.reference.{cfg['reference']}")


def counts_of(cfg: dict):
    return importlib.import_module(f"fedbench.counts.{cfg['counts']}")


def set_precision(cfg: dict) -> None:
    tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# inputs: the clients' data and the weights, made on the device
# ---------------------------------------------------------------------------

def make_pools(cfg: dict, seed: int, device: torch.device):
    """The clients' pools, {key: (K, n, ...)}, from the seed."""
    return reference_of(cfg).make_pools(
        cfg, (seed_of(seed, DATA), seed_of(seed, DATA, 1)), device)


def draw(rng: np.random.Generator, pool: int, batch: int) -> np.ndarray:
    return rng.choice(pool, size=batch, replace=False)


def make_dataset(pools, fed: dict):
    from repro_torch.data.synthetic import FederatedDataset
    first = next(iter(pools.values()))
    (k, n), device = first.shape[:2], first.device

    def sample(cid: int, rng: np.random.Generator, batch: int):
        idx = torch.from_numpy(draw(rng, n, batch)).to(device)
        return {key: v[cid].index_select(0, idx) for key, v in pools.items()}

    def eval_batch(rng: np.random.Generator, batch: int):
        cid = int(rng.integers(k))
        return sample(cid, rng, batch)

    return FederatedDataset(k, np.full(k, 1.0 / k), sample, eval_batch)


def init_weights(shapes: Dict[str, tuple], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """He-normal weights (fan-in: a convolution's I·H·W, a dense layer's
    rows) and zero biases, from one draw on the device."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, WEIGHTS))
    weights = [k for k, s in shapes.items() if len(s) > 1]
    total = sum(int(np.prod(shapes[k])) for k in weights)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) == 1:
            out[k] = torch.zeros(s, device=device)
            continue
        size = int(np.prod(s))
        fan = int(np.prod(s[1:])) if len(s) == 4 else s[0]
        out[k] = flat[at:at + size].reshape(s) * (2.0 / fan) ** 0.5
        at += size
    return out


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def quant_of(traffic: dict):
    if traffic["baseline"]:
        return None
    return dict(traffic["pq"], lam=traffic["lam"])


def build(cfg: dict, traffic: dict, seed: int, device: torch.device):
    """The trainer of one run, with the benchmark's weights and data."""
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.federated import FederatedTrainer
    from repro_torch.models import paper_models
    from repro_torch.optim import sgd

    fed, prog = cfg["federation"], cfg["program"]
    qt = quant_of(traffic)
    pqc = None if qt is None else PQConfig(
        num_subvectors=qt["q"], num_clusters=qt["L"],
        num_groups=qt.get("groups", 1), kmeans_iters=qt["iters"])
    model = getattr(paper_models, prog["model"])(
        **prog.get("kwargs", {}), pq=pqc, lam=traffic["lam"],
        client_batch=fed["client_batch"], device=device)
    shapes = reference_of(cfg).param_shapes(cfg["model"])
    if shapes != {k: tuple(p.shape) for k, p in model.named_parameters()}:
        raise ValueError("the model's parameters are not the "
                         "configuration's")
    p0 = init_weights(shapes, seed, device)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(p0[k])
    data = make_dataset(make_pools(cfg, seed, device), fed)
    trainer = FederatedTrainer(
        model, sgd(cfg["optimizer"]["lr"]), data, cohort=fed["cohort"],
        client_batch=fed["client_batch"], quantize=qt is not None,
        seed=seed_of(seed, TRAINER), executor=fed["executor"],
        device=device)
    return trainer


def plant(trainer, fault: str):
    """A context that breaks the timed path underneath while open (the
    fault checks only): the trainer's own step, batch or wire, or the
    quantizer (``hooks.FAULTS``)."""
    if fault in hooks.FAULTS:
        return hooks.FAULTS[fault]()
    if fault == "state_unchanged":
        real = trainer.executor.execute

        def execute(state, *a, **kw):
            return state, real(state, *a, **kw)[1]
        trainer.executor.execute = execute
    elif fault == "half_batch":
        real_stack = trainer.stack_batches
        trainer.stack_batches = lambda parts: real_stack(
            parts[:len(parts) // 2])
    elif fault == "wire_f32":
        # the codebooks shipped at f32 where the frame carries f16
        trainer.codebook_wire_dtype = "float32"
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return contextlib.nullcontext()


def flat(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in state.params.items()}


def setup(cell, seed: int, device: torch.device, fault: str = None):
    """(trainer, its state after the checked rounds, the program's
    readings of those rounds for the reference, the batch seeds' source):
    the trainer built and driven through its first three rounds by the
    window's own call. ``fault`` plants a fault in the program for those
    rounds (the fault checks only; the command line cannot reach it)."""
    cfg, traffic = cell.config, cell.traffic
    set_precision(cfg)
    trainer = build(cfg, traffic, seed, device)
    calls = iter(range(1 << 30))

    def batch_seed():
        return seed_of(seed, BATCHES, next(calls))

    s0 = trainer.init_state()
    with plant(trainer, fault), hooks.Capture() as cap:
        s1, h1 = trainer.run(1, batch_seed(), state=s0)
        p1 = flat(s1)
        state, h2 = trainer.run(2, batch_seed(), state=s1)
    prog = {"losses": [h["loss"] for h in h1 + h2], "p1": p1,
            "p3": flat(state), "cuts": cap.cuts,
            "decisions": cap.decisions, "centroids": cap.centroids,
            "uplink": trainer.last_trace.meta["uplink_bytes_per_client"]}
    return trainer, state, prog, batch_seed


def check(cell, seed: int, device: torch.device, prog: dict):
    """(correct, the checks for the result line)."""
    readings = reference_readings(cell.config, cell.traffic, seed, device,
                                  prog)
    return compare.decide(readings, cell.workload["limits"])


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, fault: str = None) -> types.SimpleNamespace:
    """One run of the cell (``fault``: see ``setup``)."""
    from repro_torch import obs

    cfg, traffic = cell.config, cell.traffic
    fed = cfg["federation"]
    trainer, state, prog, batch_seed = setup(cell, seed, device, fault)
    tracing.sync(device)
    setup_s = process_age_s()

    rpc = traffic["rounds_per_call"]
    calls_ms = []

    def stretch(limit_s):
        nonlocal state
        rounds, t0 = 0, time.perf_counter()
        while True:
            t = time.perf_counter()
            state, _ = trainer.run(rpc, batch_seed(), state=state)
            calls_ms.append((time.perf_counter() - t) / rpc * 1e3)
            rounds += rpc
            if time.perf_counter() - t0 >= limit_s:
                break
        tracing.sync(device)
        return rounds, time.perf_counter() - t0

    t_window = time.perf_counter()
    rounds, wall = stretch(seconds)
    e2e = {"setup_s": setup_s, "round_ms": wall / rounds * 1e3}

    readings = types.SimpleNamespace(
        kind="round", units=rounds, wall_s=wall,
        unit_flops=fed["cohort"] * fed["client_batch"]
        * counts_of(cfg).train_flops_per_sample(cfg["model"]),
        peak_flop_per_s=peaks.F32_FLOP_PER_S, spans=None, profiled=None,
        profiled_units=0, kernel_calls=[],
        kmeans_calls_per_round=0 if traffic["baseline"] else 1)
    if trace:
        with hooks.KernelCalls(span_lloyd=True):
            obs.configure(run="fedbench")
            try:
                state, _ = trainer.run(rpc, batch_seed(), state=state)
            finally:
                rec = obs.shutdown()
        readings.spans = rec.events
        a, b = traffic["trace_rounds"]
        tracer = tracing.Tracer(device)
        spans = hooks.KernelCalls()

        def on_round(rd, _cursor):
            if rd == a - 1:
                spans.__enter__()
                tracer.start()
            elif rd == b - 1:
                readings.profiled = tracer.stop()
                spans.__exit__()

        state, _ = trainer.run(rpc, batch_seed(), state=state,
                               on_round=on_round)
        readings.profiled_units = b - a
        readings.kernel_calls = spans.calls
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del state, trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the first three rounds
    t_ref = time.perf_counter()
    ok, checks = check(cell, seed, device, prog)
    timings = {"setup_s": setup_s, "window_s": wall,
               "traced_stretches_s": t_ref - t_window - wall,
               "reference_s": time.perf_counter() - t_ref,
               "calls_ms_per_round": [round(v, 4) for v in calls_ms]}
    return types.SimpleNamespace(
        e2e=e2e, readings=readings, attempted=3, failed=0 if ok else 3,
        correct=ok, checks=checks, memory_peak_bytes=peak,
        timings=timings)


def reference_inputs(cfg, traffic, seed, device, rounds=3):
    """The batches of the first ``rounds`` rounds, re-derived from the
    seed as the trainer draws them (frozen copies of its numpy draws):
    the cohort of round r is the r-th ``choice`` of
    ``default_rng(trainer seed)``; client c's batch in round id i of a
    ``run`` under batch seed s comes from
    ``default_rng(SeedSequence([s, i, c]))``."""
    fed = cfg["federation"]
    pools = make_pools(cfg, seed, device)
    n = next(iter(pools.values())).shape[1]
    cohort_rng = np.random.default_rng(seed_of(seed, TRAINER))
    # the set-up's calls: run(1) under batch seed 0, run(2) under 1
    plan = [(0, 1), (1, 1), (1, 2)][:rounds]
    out = []
    for call, round_id in plan:
        ids = cohort_rng.choice(fed["num_clients"], size=fed["cohort"],
                                replace=False)
        bs = seed_of(seed, BATCHES, call)
        idx = [torch.from_numpy(draw(np.random.default_rng(
            np.random.SeedSequence([bs, round_id, int(c)])), n,
            fed["client_batch"])).to(device) for c in ids]
        out.append({key: torch.cat([v[int(c)][i] for c, i in zip(ids, idx)])
                    for key, v in pools.items()})
    return out


def reference_readings(cfg, traffic, seed, device,
                       prog: dict) -> Dict[str, float]:
    """The compared numbers: the program's first rounds (``prog``: their
    losses, the params after one and after three, the quantizer's cuts and
    decisions, the uplink frame's bytes) against the reference's.

    With PQ the reference takes the quantizer's decisions (codebooks and
    codes) from the program and follows the rounds from them: a near-tie
    in the assignment may go either way in f32, and one that flips moves a
    centroid and, through the following iterations, every later number
    (by up to 2e-4 of the loss on the card). So the quantizer's stage is
    checked by itself (``compare.quantizer_stage``): against the
    reference's own seeding and Lloyd run on the program's cut of every
    checked round, and the program's cut at the first round against the
    reference's (``cut_gap``)."""
    fed = cfg["federation"]
    lr = cfg["optimizer"]["lr"]
    qt = quant_of(traffic)
    ref_model = reference_of(cfg)
    p0 = init_weights(ref_model.param_shapes(cfg["model"]), seed, device)
    batches = reference_inputs(cfg, traffic, seed, device)
    if qt and not fits(prog, cfg, qt):
        # decisions of another shape than the rounds' cohorts: no reading
        return dict.fromkeys(ALL_READINGS, float("inf"))
    with f32_products():
        ref = ref_model.train(p0, batches, lr, qt, fed["client_batch"],
                              decisions=prog["decisions"] if qt else None)
    ref_g = compare.norms(ref["grads1"])
    prog_g = compare.norms({k: (p0[k] - prog["p1"][k]) / lr for k in p0})
    leaves = compare.counted_leaves(ref_g)
    grad_gap, grad_leaf = compare.worst_norm_gap(prog_g, ref_g, leaves)
    ref_dp = compare.norms({k: ref["params"][-1][k] - p0[k] for k in p0})
    prog_dp = compare.norms({k: prog["p3"][k] - p0[k] for k in p0})
    change_gap, change_leaf = compare.worst_norm_gap(prog_dp, ref_dp, leaves)
    out = {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
           "grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
           "worst_leaves": f"{grad_leaf} {change_leaf}",
           "uplink_bytes_gap": float(abs(prog["uplink"]
                                         - wire_bytes(cfg, traffic)))}
    if qt:
        out.update(quantizer_readings(prog, ref, qt, fed["client_batch"]))
    return out


ALL_READINGS = ("loss_gap", "grad_norm_gap", "change_norm_gap",
                "uplink_bytes_gap", "cut_gap", "codes_off",
                "codebook_cast_off", "codes_differ_share", "centroid_gap")


def fits(prog, cfg, qt) -> bool:
    """Whether the program's quantizer ran once a checked round, on the
    whole cohort."""
    fed = cfg["federation"]
    rows = fed["cohort"] * fed["client_batch"]
    return len(prog["decisions"]) == 3 and all(
        c.shape[0] == rows for c in prog["cuts"])


def quantizer_readings(prog, ref, qt, client_batch) -> Dict[str, float]:
    """The quantizer's stage, checked by itself (see
    ``reference_readings``)."""
    z0, r0 = prog["cuts"][0].double(), ref["cuts"][0].double()

    def calls():
        for cut, cents, (codebooks, codes) in zip(
                prog["cuts"], prog["centroids"], prog["decisions"]):
            x = ref_pq.to_groups(
                cut.float().reshape(-1, client_batch, cut.shape[-1]),
                qt["q"], qt.get("groups", 1))
            yield x, cents, codebooks, codes, cut.dtype
    out = compare.quantizer_stage(calls(), qt["L"], qt["iters"])
    out["cut_gap"] = float((z0 - r0).norm() / r0.norm())
    return out


def wire_bytes(cfg, traffic) -> int:
    """One client's uplink frame: the pq frame's bytes, or the dense cut's
    f32 bytes for SplitFed."""
    fed, qt = cfg["federation"], quant_of(traffic)
    rows, d = reference_of(cfg).cut_shape(cfg["model"], fed["client_batch"])
    if qt is None:
        return rows * d * 4
    return ref_pq.wire_bytes(rows, d, qt["q"], qt.get("groups", 1), qt["L"])


class f32_products:
    """TF32 off for the reference's products (restored on exit)."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def control_readings(cell, seed: int, device: torch.device,
                     precision: str) -> Dict[str, float]:
    """The compared numbers with the reference computed in ``precision``
    put in the program's place (the control): its own cut, quantizer and
    steps."""
    cfg, traffic = cell.config, cell.traffic
    fed = cfg["federation"]
    ref_model = reference_of(cfg)
    p0 = init_weights(ref_model.param_shapes(cfg["model"]), seed, device)
    batches = reference_inputs(cfg, traffic, seed, device)
    with f32_products():
        ctl = ref_model.train(p0, batches, cfg["optimizer"]["lr"],
                              quant_of(traffic), fed["client_batch"],
                              precision)
    prog = {"losses": ctl["losses"], "p1": ctl["params"][0],
            "p3": ctl["params"][-1], "cuts": ctl["cuts"],
            "decisions": ctl["decisions"],
            "centroids": [d[0] for d in ctl["decisions"] if d is not None],
            "uplink": wire_bytes(cfg, traffic)}
    return reference_readings(cfg, traffic, seed, device, prog)
