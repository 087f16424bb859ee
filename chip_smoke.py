#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--seed 0] [--steps 20]

Phases (each prints its own lines; any failure exits non-zero):
  1. device  -- the card's name, and its name and power limit from nvidia-smi;
  2. build   -- nvcc builds every kernel from src/repro_torch/csrc/, in
                parallel, and prints what ptxas reports;
  3. parity  -- each kernel against its plain PyTorch version on the card,
                at the main path's shapes and at edge shapes;
  4. slice   -- the FEMNIST FedLite train step at full width (d = 9216,
                q = 1152, L = 2, R = 1, 5 Lloyd iterations, 10 clients of
                20 examples, λ = 1e-4, sgd(10**-1.5)) for --steps steps,
                with the launch counts of the kernels read around the run,
                and step 1 held against the same step on the plain versions;
  5. times   -- each kernel's device time next to its plain version's and
                its bound, and the step time.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA card, or away
from a checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# the FEMNIST run (examples/femnist_federated_training.py, executor.py)
CLIENTS, CLIENT_BATCH, Q, L, R, ITERS, LAM, LR = 10, 20, 1152, 2, 1, 5, \
    1e-4, 10 ** -1.5
CUT_D = 9216
DSUB = CUT_D // Q
M = Q // R * CLIENT_BATCH              # rows of one k-means problem: 23040
M_PAD = -(-M // 4096) * 4096           # padded to the 4096-row chunk: 24576

TIE_RTOL = 1e-5       # top-two scores this close may pick either code
# lloyd_update's dsums: within DSUM_ATOL of the plain version summed in the
# kernel's order (bitwise equal for 0/1 weights), and within
# DSUM_RTOL·(1 + |plain|) of the plain version's own order. Sums of ~1e4
# f32 terms near 2e4 differ by ~0.1 between two orders, so an absolute
# 1e-4 holds only for the same order.
DSUM_ATOL = 1e-4
DSUM_RTOL = 2e-5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def device_ms(fn, calls: int = 50, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events. The graph
    takes the host out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def eager_ms(fn, calls: int = 200) -> float:
    """Time per call of back-to-back eager calls between two CUDA events:
    the host's launch cost where it exceeds the device's work."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(nbytes: float, flops: float):
    """Least time (ms) for the work, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); device 0: {name}")
    print(smi[0], flush=True)
    return name


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    infos = _build.build(["lloyd_update", "pq_quantize"])
    for name, info in infos.items():
        say("build", f"{name}: {info.path.name} in {info.seconds:.1f} s")
        for line in info.ptxas.strip().splitlines():
            say("build", f"  {line.strip()}")
    say("build", f"both kernels built in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc)")


def check_lloyd(tag, x, c, w):
    """lloyd_update vs its plain versions; returns max |dsums − plain in
    the kernel's order|."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lloyd_update import lloyd_update_in_kernel_order

    cp, lmask = ops._pad_centroids(c)
    ties = ref.near_ties(x, cp, lmask, TIE_RTOL)
    # a near-tie row may take either code; weight 0 keeps it out of both
    w = torch.where(ties, 0.0, w)
    ds, cnt = ops.lloyd_update(x, c, w)
    l = c.shape[1]
    ds_o, cnt_o = (t[:, :l] for t in
                   lloyd_update_in_kernel_order(x, w, cp, lmask))
    ds_r, cnt_r = (t[:, :l] for t in ref.lloyd_update_ref(x, w, cp, lmask))
    torch.cuda.synchronize()
    if not (torch.equal(cnt, cnt_r) and torch.equal(cnt, cnt_o)):
        fail(f"lloyd_update {tag}: counts differ from the plain version")
    err = float((ds - ds_o).abs().max())
    err_r = float((ds - ds_r).abs().max())
    rel_r = float(((ds - ds_r).abs() / (1 + ds_r.abs())).max())
    if not err <= DSUM_ATOL:
        fail(f"lloyd_update {tag}: dsums off by {err} from the plain "
             f"version in the kernel's order")
    if not rel_r <= DSUM_RTOL:
        fail(f"lloyd_update {tag}: dsums off by {err_r} (scaled {rel_r}) "
             f"from the plain version")
    say("parity", f"lloyd_update {tag}: x {tuple(x.shape)} L={l}: counts "
        f"equal; max |dsums err| {err:.3e} against the kernel's order, "
        f"{err_r:.3e} (scaled {rel_r:.3e}) against the plain order; "
        f"{int(ties.sum())} near-tie rows weighted 0")
    return err, ds, cnt


def check_pq(tag, x, c):
    """pq_quantize vs its plain version; returns max |err| where codes
    agree (0 when z̃ and the residual are bitwise equal)."""
    from repro_torch.kernels import ops, ref

    cp, lmask = ops._pad_centroids(c)
    zt, resid, codes = ops.pq_quantize(x, c)
    zt_r, resid_r, codes_r = ref.pq_quantize_ref(x, cp, lmask)
    torch.cuda.synchronize()
    differ = codes != codes_r
    ties = ref.near_ties(x, cp, lmask, TIE_RTOL)
    if bool((differ & ~ties).any()):
        fail(f"pq_quantize {tag}: {int((differ & ~ties).sum())} codes "
             f"differ away from near-ties")
    agree = ~differ
    if not (torch.equal(zt[agree], zt_r[agree])
            and torch.equal(resid[agree], resid_r[agree])):
        fail(f"pq_quantize {tag}: z̃ or residual not bitwise equal where "
             f"codes agree")
    keep = agree.unsqueeze(-1)
    err = max(float(torch.where(keep, (zt - zt_r).abs(), 0.0).max()),
              float(torch.where(keep, (resid - resid_r).abs(), 0.0).max()))
    say("parity", f"pq_quantize {tag}: x {tuple(x.shape)} L={c.shape[1]}: "
        f"{int(differ.sum())} codes differ (all near-ties), z̃ and residual "
        f"bitwise equal where codes agree")
    return err, zt, resid, codes


def phase_parity(gen):
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    # main-path shapes: 10 problems, the padded Lloyd rows carry weight 0
    x = torch.zeros((CLIENTS * R, M_PAD, DSUB), device=dev)
    x[:, :M] = normal(CLIENTS * R, M, DSUB)
    c = normal(CLIENTS * R, L, DSUB)
    w = (torch.arange(M_PAD, device=dev) < M).float() \
        .expand(CLIENTS * R, -1).contiguous()
    lloyd_err, ds, cnt = check_lloyd("main", x, c, w)
    ds2, cnt2 = ops.lloyd_update(x, c, torch.where(
        ref.near_ties(x, *ops._pad_centroids(c), TIE_RTOL), 0.0, w))
    if not (torch.equal(ds, ds2) and torch.equal(cnt, cnt2)):
        fail("lloyd_update: two runs are not bitwise identical")
    say("parity", "lloyd_update main: two runs bitwise identical")
    pq_err, *_ = check_pq("main", x[:, :M].contiguous(), c)

    for tag, (p, n, l) in {"ragged N": (3, 1037, 2),
                           "L=3 masked": (4, 5000, 3),
                           "L=16": (4, 5000, 16)}.items():
        xe, ce = normal(p, n, DSUB), normal(p, l, DSUB)
        we = torch.ones((p, n), device=dev)
        lloyd_err = max(lloyd_err,
                        check_lloyd(tag, xe, ce, we)[0])
        pq_err = max(pq_err, check_pq(tag, xe, ce)[0])

    # exact cover: every row is a centroid, so deviations and residuals are
    # exactly 0; a centroid far away is an empty cluster (count 0, sums 0)
    ce = normal(4, 4, DSUB)
    ce[:, 3] = 1e3
    pick = torch.randint(0, 3, (4, 2000), generator=gen).to(dev)
    xe = torch.gather(ce, 1, pick.unsqueeze(-1).expand(-1, -1, DSUB))
    ds, cnt = ops.lloyd_update(xe, ce)
    zt, resid, codes = ops.pq_quantize(xe, ce)
    torch.cuda.synchronize()
    if float(ds.abs().max()) != 0.0 or float(resid.abs().max()) != 0.0 \
            or not torch.equal(zt, xe) or not torch.equal(codes.long(), pick):
        fail("exact cover is not an exact fixed point")
    if float(cnt[:, 3].abs().max()) != 0.0:
        fail("the empty cluster has a nonzero count")
    say("parity", "exact cover: dsums and residual exactly 0; empty "
        "cluster: count 0, dsums 0")
    return lloyd_err, pq_err


def make_batches(make_data, seed, steps):
    """``steps`` cohort batches: 10 clients drawn by weight, 20 examples
    each, concatenated client-major (the stacked executor's layout)."""
    data = make_data(num_clients=64, seed=0, device="cuda")
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        cohort = rng.choice(data.num_clients, size=CLIENTS, replace=False,
                            p=data.client_weights)
        parts = [data.sample_batch(int(k), rng, CLIENT_BATCH)
                 for k in cohort]
        batches.append({k: torch.cat([p[k] for p in parts])
                        for k in parts[0]})
    return batches


def phase_slice(seed, steps):
    from repro_torch.kernels import _build
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    models = {}
    for backend in ("auto", "torch"):
        pq = PQConfig(num_subvectors=Q, num_clusters=L, num_groups=R,
                      kmeans_iters=ITERS, backend=backend)
        models[backend] = FemnistCNN(pq=pq, lam=LAM,
                                     client_batch=CLIENT_BATCH,
                                     device="cuda", generator=gen)
    model = models["auto"]
    state0 = TrainState.create(dict(model.named_parameters()), sgd(LR))
    batches = make_batches(make_federated_image_data, seed, steps)
    say("slice", f"FemnistCNN cut d={CUT_D}, PQ q={Q} L={L} R={R} "
        f"iters={ITERS}, {CLIENTS} clients x {CLIENT_BATCH}, λ={LAM}, "
        f"sgd({LR:.5f}), {steps} steps")

    step = make_train_step(model, sgd(LR))
    state, losses, times = state0, [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for b in batches:
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        if len(losses) == 1:
            state1, met1 = state, met
    counts = _build.launch_counts()
    want = {"lloyd_update": ITERS * steps, "pq_quantize": steps}
    say("slice", f"launches in {steps} steps: {counts} (want {want})")
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite loss: {losses}")
    say("slice", "losses: " + " ".join(f"{v:.5f}" for v in losses))

    # step 1 again, from the same weights and batch, on the plain versions
    plain_step = make_train_step(models["torch"], sgd(LR))
    pstate, pmet = plain_step(state0, batches[0])
    torch.cuda.synchronize()
    if _build.launch_counts() != want:
        fail("the plain step launched a kernel")
    dloss = abs(float(pmet["loss"]) - losses[0])
    dpar = max(float((state1.params[k] - pstate.params[k]).detach().abs()
                     .max()) for k in pstate.params)
    say("slice", f"step 1 vs plain versions: loss {losses[0]:.6f} vs "
        f"{float(pmet['loss']):.6f} (|Δ| {dloss:.3e}), distortion "
        f"{float(met1['pq_distortion']):.4f} vs "
        f"{float(pmet['pq_distortion']):.4f}, max |Δparam| {dpar:.3e}")
    if not dloss <= 1e-4:
        fail(f"step-1 loss differs from the plain step by {dloss}")

    steady = times[2:] if len(times) > 3 else times
    step_ms = statistics.median(steady) * 1e3
    say("times", f"step: median {step_ms:.3f} ms (min "
        f"{min(steady) * 1e3:.3f}, max {max(steady) * 1e3:.3f}) over "
        f"{len(steady)} steps, {len(times) - len(steady) + 1}.."
        f"{len(times)} (host clock + synchronize); first step "
        f"{times[0] * 1e3:.1f} ms")
    return counts, step, state, batches


def phase_profile(step, state, batches):
    """Device busy share of the step: CUDA kernel time over wall time in a
    profiled window of 3 steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:3]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        say("times", "profiled step: device time not measured (the "
            "profiler reported none)")
        return
    say("times", f"profiled 3 steps: wall {wall_ms:.3f} ms, device kernels "
        f"{dev_ms:.3f} ms in {sum(e.count for e in events) / 3:.0f} "
        f"launches per step: busy {dev_ms / wall_ms:.1%}, idle "
        f"{1 - dev_ms / wall_ms:.1%}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        say("times", f"  {e.self_device_time_total / 3e3:9.4f} ms/step  "
            f"{e.count / 3:5.1f} launches/step  {e.key[:70]}")


def phase_times(gen, counts, lloyd_err, pq_err):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lloyd_update import lloyd_update_kernel
    from repro_torch.kernels.pq_quantize import pq_quantize_kernel

    dev = torch.device("cuda")
    x = torch.zeros((CLIENTS * R, M_PAD, DSUB), device=dev)
    x[:, :M] = torch.randn((CLIENTS * R, M, DSUB), generator=gen).to(dev)
    w = (torch.arange(M_PAD, device=dev) < M).float() \
        .expand(CLIENTS * R, -1).contiguous()
    cp, lmask = ops._pad_centroids(
        torch.randn((CLIENTS * R, L, DSUB), generator=gen).to(dev))
    xq = x[:, :M].contiguous()
    p = CLIENTS * R

    rows = []
    # lloyd_update: reads x, w, the codebook and mask; writes dsums, counts
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, cp, lmask)) \
        + p * cp.shape[1] * (DSUB + 1) * 4
    flops = p * M_PAD * (2 * L * DSUB + 3 * DSUB + 1)
    rows.append(("lloyd_update", "src/repro_torch/csrc/lloyd_update.cu",
                 "src/repro/kernels/lloyd_update.py:87", lloyd_err,
                 lambda: lloyd_update_kernel(x, w, cp, lmask),
                 lambda: ref.lloyd_update_ref(x, w, cp, lmask),
                 nbytes, flops))
    # pq_quantize: reads x and the codebook; writes z̃, residual, codes
    nbytes = sum(t.numel() * t.element_size() for t in (xq, cp, lmask)) \
        + 2 * xq.numel() * 4 + p * M * 4
    flops = p * M * (2 * L * DSUB + DSUB)
    rows.append(("pq_quantize", "src/repro_torch/csrc/pq_quantize.cu",
                 "src/repro/kernels/pq_quantize.py:55", pq_err,
                 lambda: pq_quantize_kernel(xq, cp, lmask),
                 lambda: ref.pq_quantize_ref(xq, cp, lmask),
                 nbytes, flops))
    kernels = []
    for name, source, replaces, err, kern, plain, nbytes, flops in rows:
        k_ms = device_ms(kern)
        p_ms = device_ms(plain)
        k_eager = eager_ms(kern)
        b_ms, b_by = bound(nbytes, flops)
        say("times", f"{name}: kernel {k_ms * 1e3:.2f} us (device, CUDA "
            f"graph), {k_eager * 1e3:.2f} us per eager call; plain "
            f"{p_ms * 1e3:.2f} us; bound {b_ms * 1e3:.2f} us by {b_by} "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": counts.get(name, 0),
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))

    name = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(args.seed)
    lloyd_err, pq_err = phase_parity(gen)
    counts, step, state, batches = phase_slice(args.seed, args.steps)
    phase_profile(step, state, batches)
    kernels = phase_times(gen, counts, lloyd_err, pq_err)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
