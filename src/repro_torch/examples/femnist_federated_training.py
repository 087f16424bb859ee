"""End-to-end driver: federated FedLite training on the paper's FEMNIST task
(twin of ``examples/femnist_federated_training.py``).

Trains the paper's CNN (client: 2 conv layers; server: 2 dense layers, cut
at d=9216) for a few hundred rounds with cohort sampling, grouped-PQ uplink
compression and gradient correction, evaluating accuracy and cumulative
communication as it goes. Compares against the SplitFed baseline. It runs
on the card unless ``--device cpu`` asks for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.femnist_federated_training \\
        --rounds 300 --q 1152 --clusters 2 --lam 1e-4

The reference's other modes run the same way: ``--fleet mobile --policy
deadline`` (the virtual-clock scheduler over a heterogeneous fleet, with
measured wire bytes and simulated wall-clock), ``--downlink
"chain:topk(k=0.1)+scalarq(bits=8)"`` (the cut-layer gradient through a
``core/compressors.py`` codec), ``--autoscale`` (the trace-driven
autoscaler, re-planning every 8 rounds), ``--chaos`` (DEFAULT_CHAOS fault
injection), ``--emit-trace [PATH]`` / ``--perfetto PATH`` (the
``repro_torch.obs`` event log, read by ``python -m repro_torch.obs PATH``)
and ``--ckpt PATH`` (the final params in the reference's checkpoint
format). ``--executor mesh`` runs the cohort-parallel executor: as a
world of one when launched plainly, or across ranks under ``torchrun``
(one process per device; rank 0 alone prints and writes files)::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
        repro_torch.examples.femnist_federated_training --executor mesh \\
        --device cpu

Seeds, not keys. Where the reference takes ``jax.random.PRNGKey(k)``, the
twin takes the int k:
  * the CNN's weights (the reference's ``init_state(PRNGKey(0))``) come
    from ``torch.Generator().manual_seed(0)`` when the model is built;
  * the eval batch (``PRNGKey(99)``) from ``np.random.default_rng(99)``;
  * ``trainer.run(rounds, PRNGKey(0))`` and ``autoscale_run(...,
    PRNGKey(0))`` are ``run(rounds, 0)`` and ``autoscale_run(..., 0)``;
  * the ideal loop's round keys ``fold_in(PRNGKey(1), r)`` are round ids
    r + 1 of ``FederatedTrainer.round`` (its batches drawn under the
    trainer's seed, 0).
So the lines that do not depend on the framework (compression ratio, the
analytic uplink of the ideal loop, measured wire bytes, simulated
wall-clock, stragglers dropped) are the reference's character for
character; losses and accuracies are the same quantities on other draws.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpointing import save_checkpoint
from repro_torch.core.quantizer import PQConfig
from repro_torch.core.split import split_part, tree_bits
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import (DEFAULT_CHAOS, AsyncBuffer, AutoscalePlan,
                                   Deadline, DropSlowestK, FederatedTrainer,
                                   FullSync, TraceAutoscaler, autoscale_run,
                                   lognormal_fleet, make_policy, mobile_fleet)
from repro_torch.launch.mesh import mesh_backend
from repro_torch.models.paper_models import FemnistCNN, to_jax_params
from repro_torch.optim import sgd

FLEETS = {
    "ideal": lambda n: None,  # trainer default: identical ideal clients
    "lognormal": lambda n: lognormal_fleet(n, median_uplink_bps=2e6, seed=0),
    "mobile": lambda n: mobile_fleet(n, flaky_fraction=0.3, seed=0),
}
POLICIES = {
    "full_sync": FullSync,
    "drop2": lambda: DropSlowestK(2),
    "deadline": lambda: Deadline(6.0),
    "async": lambda: AsyncBuffer(4),
}
NUM_CLIENTS = 64


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--q", type=int, default=1152)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--lam", type=float, default=1e-4)
    ap.add_argument("--cohort", type=int, default=10)
    ap.add_argument("--client-batch", type=int, default=20)
    ap.add_argument("--baseline", action="store_true",
                    help="run SplitFed (no compression) instead")
    ap.add_argument("--fleet", choices=sorted(FLEETS), default="ideal",
                    help="client population for the virtual-clock scheduler")
    ap.add_argument("--policy", choices=sorted(POLICIES), default="full_sync",
                    help="round participation policy")
    ap.add_argument("--downlink", default=None, metavar="SPEC",
                    help="downlink gradient codec spec, e.g. "
                         "'chain:topk(k=0.1)+scalarq(bits=8)'")
    ap.add_argument("--warm-start", action="store_true",
                    help="carry PQ codebooks across rounds (half the Lloyd "
                         "iterations on steady-state rounds)")
    ap.add_argument("--delta-bits", type=int, default=0,
                    help="ship codebooks as pq-delta wire payloads at this "
                         "many bits per delta (0 = fresh fp16 codebooks)")
    ap.add_argument("--executor", choices=["stacked", "mesh"],
                    default="stacked",
                    help="cohort execution engine: the stacked one-device "
                         "path, or mesh (cohort-parallel over the ranks "
                         "torchrun launched; a world of one without it)")
    ap.add_argument("--autoscale", action="store_true",
                    help="drive the run with the trace-driven autoscaler "
                         "(re-plans cohort/policy/downlink every 8 rounds)")
    ap.add_argument("--chaos", action="store_true",
                    help="arm DEFAULT_CHAOS fault injection (crashes, "
                         "payload corruption, poisoning) so the recorded "
                         "flight lifecycles exercise retries/quarantine; "
                         "the SLO monitor grades the finished run")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--emit-trace", nargs="?", const="femnist_trace.jsonl",
                    default=None, metavar="PATH",
                    help="record obs telemetry (spans on host + virtual "
                         "lanes, byte ledger) and write it as JSONL; "
                         "summarize with `python -m repro_torch.obs PATH`")
    ap.add_argument("--perfetto", default=None, metavar="PATH",
                    help="Perfetto trace_event JSON output (default: the "
                         "--emit-trace path with .jsonl swapped for "
                         ".perfetto.json)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(model, data, pq, build_trainer) of ``args``, as the reference's
    example builds them: ``build_trainer(cohort, policy, downlink, seed=0)``
    makes the run's `FederatedTrainer`."""
    dev = torch.device(args.device)
    data = make_federated_image_data(num_clients=NUM_CLIENTS, seed=0,
                                     device=dev)
    pq = None if args.baseline else PQConfig(
        num_subvectors=args.q, num_clusters=args.clusters, kmeans_iters=5)
    model = FemnistCNN(pq=pq, lam=args.lam, client_batch=args.client_batch,
                       device=dev, generator=torch.Generator().manual_seed(0))

    def build_trainer(cohort, policy, downlink, seed=0):
        return FederatedTrainer(model, sgd(10 ** -1.5), data, cohort=cohort,
                                client_batch=args.client_batch,
                                quantize=not args.baseline,
                                fleet=FLEETS[args.fleet](NUM_CLIENTS),
                                policy=policy, downlink_compressor=downlink,
                                warm_start=args.warm_start,
                                codebook_delta_bits=args.delta_bits or None,
                                fault_plan=DEFAULT_CHAOS if args.chaos
                                else None,
                                slo_monitor=obs.HealthMonitor()
                                if args.emit_trace else None,
                                seed=seed, executor=args.executor,
                                device=dev)

    return model, data, pq, build_trainer


def accuracy(model: FemnistCNN, state, batch) -> float:
    """Top-1 accuracy of the state's params (loaded into ``model``)."""
    model.load_state_dict({k: v.detach() for k, v in state.params.items()})
    return float(model.accuracy(batch))


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("femnist_federated_training: no CUDA device (use "
                         "--device cpu)")
    launched = args.executor == "mesh" and "WORLD_SIZE" in os.environ \
        and not dist.is_initialized()
    if launched:
        # under torchrun: one rank per device, the rendezvous from the
        # environment
        dev = torch.device(args.device)
        if dev.type == "cuda" and dev.index is None:
            args.device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        dist.init_process_group(mesh_backend(args.device))
    try:
        if dist.is_initialized() and dist.get_rank() != 0:
            with contextlib.redirect_stdout(io.StringIO()):
                return _run(args, writes=False)
        return _run(args, writes=True)
    finally:
        if launched:
            dist.destroy_process_group()


def _run(args: argparse.Namespace, writes: bool) -> int:
    """The example's run; ``writes`` (rank 0, or the only process) opens
    the obs recorder and writes the checkpoint and the trace files."""
    if args.emit_trace and writes:
        obs.configure(run="femnist_example", meta={
            "rounds": args.rounds, "fleet": args.fleet,
            "policy": args.policy, "executor": args.executor,
            "autoscale": args.autoscale, "baseline": args.baseline})

    model, data, pq, build_trainer = build(args)
    eval_batch = data.eval_batch(np.random.default_rng(99), 512)
    heterogeneous = args.fleet != "ideal" or args.policy != "full_sync" \
        or args.downlink is not None or args.warm_start \
        or bool(args.delta_bits) or args.executor != "stacked"

    if args.autoscale:
        # seed the plan with every CLI knob the controller may later move
        policy_specs = {"full_sync": "full_sync", "drop2": "drop_slowest:2",
                        "deadline": "deadline:6.0", "async": "async:4"}
        plan0 = AutoscalePlan(cohort=args.cohort,
                              policy=policy_specs[args.policy],
                              downlink=args.downlink)

        def make_trainer(plan, seg):
            return build_trainer(plan.cohort, make_policy(plan.policy),
                                 plan.downlink, seed=seg)

        t0 = time.time()
        out = autoscale_run(
            make_trainer, plan0, args.rounds, 0,
            controller=TraceAutoscaler(window=8, max_cohort=NUM_CLIENTS),
            interval=8)
        state = out["state"]
        acc = accuracy(model, state, eval_batch)
        print(f"autoscaled run: {args.rounds} rounds, "
              f"{len(out['plans'])} plan(s), acc={acc:.3f} "
              f"({time.time() - t0:.0f}s real)")
        for i, plan in enumerate(out["plans"]):
            print(f"  plan {i}: cohort={plan.cohort} policy={plan.policy} "
                  f"downlink={plan.downlink or 'dense'}  [{plan.reason}]")
        print(f"  simulated wall-clock : {out['simulated_seconds']:10.1f} s")
        print(f"  measured uplink      : {out['uplink_bytes'] / 1e6:10.2f} MB")
        print(f"  measured downlink    : "
              f"{out['downlink_bytes'] / 1e6:10.2f} MB")
        losses = [h["loss"] for h in out["history"] if "loss" in h]
        if losses:
            print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    elif heterogeneous:
        # scheduled run: measured wire bytes + simulated wall-clock per round
        trainer = build_trainer(args.cohort, POLICIES[args.policy](),
                                args.downlink)
        t0 = time.time()
        state, hist = trainer.run(args.rounds, 0)
        trace = trainer.last_trace
        acc = accuracy(model, state, eval_batch)
        s = trace.summary()
        print(f"fleet={args.fleet} policy={args.policy}  "
              f"rounds={s['rounds']}  acc={acc:.3f}  "
              f"({time.time() - t0:.0f}s real)")
        print(f"  simulated wall-clock : {s['simulated_seconds']:10.1f} s")
        print(f"  measured uplink      : {s['uplink_bytes'] / 1e6:10.2f} MB "
              f"({s['uplink_bytes_per_round'] / 1e6:.4f} MB/round)")
        print(f"  measured downlink    : {s['downlink_bytes'] / 1e6:10.2f} MB")
        print(f"  stragglers dropped   : {s['stragglers_dropped']:10d}")
        if s["mean_staleness"]:
            print(f"  mean staleness       : {s['mean_staleness']:10.2f}")
        losses = [h["loss"] for h in hist if "loss" in h]
        if losses:
            print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        # ideal synchronous loop with periodic eval (the paper's simulation);
        # analytic uplink accounting at the params' native phi (fp32: 32-bit)
        trainer = build_trainer(args.cohort, POLICIES[args.policy](),
                                args.downlink)
        state = trainer.init_state()
        client_bits = tree_bits(split_part(state.params, "client"))
        act_bits = 32 * 9216 * args.client_batch
        per_round = client_bits + (pq.message_bits(args.client_batch, 9216,
                                                   phi_bits=32)
                                   if pq else act_bits)
        t0 = time.time()
        for r in range(args.rounds):
            state, metrics = trainer.round(state, r + 1)
            if r % 25 == 0 or r == args.rounds - 1:
                acc = accuracy(model, state, eval_batch)
                mb = per_round * args.cohort * (r + 1) / 8e6
                print(f"round {r:4d}  loss={float(metrics['loss']):.4f}  "
                      f"acc={acc:.3f}  uplink={mb:8.1f} MB  "
                      f"({time.time() - t0:.0f}s)")
    if args.ckpt and writes:
        save_checkpoint(args.ckpt, args.rounds, to_jax_params(state.params))
        print(f"saved params to {args.ckpt}")
    if pq:
        print(f"activation compression (phi=32): "
              f"{pq.compression_ratio(args.client_batch, 9216, phi_bits=32):.0f}x")
    recorder = obs.shutdown()
    if args.emit_trace and recorder is not None:
        n = recorder.write_jsonl(args.emit_trace)
        pf = args.perfetto or (
            args.emit_trace[:-len(".jsonl")] + ".perfetto.json"
            if args.emit_trace.endswith(".jsonl")
            else args.emit_trace + ".perfetto.json")
        recorder.write_perfetto(pf)
        print(f"wrote {n} telemetry events to {args.emit_trace}; "
              f"perfetto trace at {pf}")
        print(f"inspect with: python -m repro_torch.obs {args.emit_trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
