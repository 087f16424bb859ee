"""Driver of the LM-training cells: FedLite split training of a zoo
architecture through the step that ``repro_torch.launch.train`` builds.

The configuration's file names what is model-specific, so one driver
serves every zoo architecture: ``arch`` (the port's config), ``reference``
(the plain model under ``fedbench/reference/``, which also lists the
params' names and shapes), the optimizer's ``name`` (its plain copy under
``fedbench/reference/``) and ``counts`` (its FLOPs under
``fedbench/counts/``).

Set-up builds the state through the launcher's calls (``make_model``,
``get_optimizer`` with its warm-up and cosine schedule,
``make_train_step``, ``TrainState.create``) on weights the benchmark makes
on the card from the seed, one draw a leaf, in the params' dtype; the
model's ``init`` on the meta device gives their layout. It then drives the
state through its first three steps -- the window's own call, each on a
batch of its own -- whose losses, optimizer state, params and quantizer
decisions the reference checks, and hands the same state to the window.
The window runs steps back to back, each on a fresh batch of token ids
drawn on the card, and synchronizes at its ends: ``train_tokens_per_s`` is
all its tokens over its wall time, ``peak_gib`` the allocator's peak over
it. A ``--trace 1`` run profiles ``trace_steps`` more steps after the
window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import time
import types
from typing import Dict

import torch

from fedbench import compare, hooks, tracing
from fedbench.harness import process_age_s, seed_of
from fedbench.counts import peaks
from fedbench.reference import pq as ref_pq

WEIGHTS, BATCHES = 2, 4
CHECKED = 3           # steps the reference follows
GIB = float(1 << 30)
# a token whose gradient at the cut is under this share of the median
# token's (in the reference) is left out of the cut gradient's gap
TOKEN_FLOOR = 1e-3


def reference_of(cfg: dict):
    """(the plain model, the plain optimizer) the file names."""
    return (importlib.import_module(f"fedbench.reference.{cfg['reference']}"),
            importlib.import_module(
                f"fedbench.reference.{cfg['optimizer']['name']}"))


def counts_of(cfg: dict):
    return importlib.import_module(f"fedbench.counts.{cfg['counts']}")


def make_leaf(key_index: int, key: str, shape, dtype: str, seed: int,
              device) -> torch.Tensor:
    """One parameter, from its own generator: a norm's scale is ones, the
    embedding N(0, 0.02²), every product's weight N(0, 1/d_in) with d_in
    its second last axis; drawn in f32, then cast."""
    dt = getattr(torch, dtype)
    if key.endswith("/scale"):
        return torch.ones(shape, dtype=dt, device=device)
    g = torch.Generator(device=device).manual_seed(
        seed_of(seed, WEIGHTS, key_index))
    std = 0.02 if key.endswith("tok_embed") else shape[-2] ** -0.5
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(std).to(dt)


def make_weights(specs: Dict[str, tuple], seed: int, device,
                 as_f32: bool = False) -> Dict[str, torch.Tensor]:
    out = {}
    for i, (k, (shape, dtype)) in enumerate(specs.items()):
        t = make_leaf(i, k, shape, dtype, seed, device)
        out[k] = t.float() if as_f32 else t
    return out


def make_batch(cfg: dict, traffic: dict, seed: int, step: int, device):
    """Token ids uniform over the vocabulary, (clients, seq); the labels
    are the next tokens, −1 at the last position."""
    g = torch.Generator(device=device).manual_seed(
        seed_of(seed, BATCHES, step))
    b, s = traffic["clients"], traffic["seq"]
    tokens = torch.randint(0, cfg["model"]["vocab_size"], (b, s),
                           generator=g, device=device)
    labels = torch.cat([tokens[:, 1:], torch.full((b, 1), -1,
                                                  device=device)], 1)
    return {"tokens": tokens, "labels": labels}


def arch_config(cfg: dict):
    """The port's architecture config of the configuration file: the
    port's own (its ``smoke`` variant where the file says so, for the
    tests) with the file's keys and optimizer set. Of the port's config,
    only the keys the file lists under ``reduced`` (cut from the source)
    or ``from_source`` (where the port's value is not the source's) may
    change."""
    from repro_torch.configs.base import get_arch
    smoke = cfg.get("smoke", False)
    base = get_arch(cfg["arch"], smoke=smoke)
    arch = dataclasses.replace(base, optimizer=cfg["optimizer"]["name"],
                               **cfg["model"])
    if not smoke:
        free = {*cfg["reduced"], *cfg.get("from_source", {})}
        for k in [*cfg["model"], "optimizer"]:
            if k not in free and getattr(arch, k) != getattr(base, k):
                raise ValueError(f"{cfg['name']}: {k} is "
                                 f"{getattr(base, k)!r} in the port's "
                                 f"config, {getattr(arch, k)!r} here")
    return arch


def build(cfg: dict, seed: int, device):
    """(step function, the state on the benchmark's weights)."""
    from repro_torch.core.fedlite import (TrainState, flat_params,
                                          make_train_step, nest_like)
    from repro_torch.launch.specs import make_model
    from repro_torch.optim import get_optimizer, warmup_cosine

    arch = arch_config(cfg)
    o, cut = cfg["optimizer"], cfg["cut"]
    model = make_model(arch, with_pq=True, lam=cut["lam"])
    pqc = model.pq
    if (pqc.subvector_dim(arch.d_model), pqc.num_clusters,
            pqc.kmeans_iters) != (cut["subvector_dim"], cut["clusters"],
                                  cut["iters"]):
        raise ValueError("the model's cut is not the configuration's")
    opt = get_optimizer(arch.optimizer, warmup_cosine(
        o["lr"], o["warmup_steps"], o["total_steps"]))
    step_fn = make_train_step(model, opt, quantize=True)
    layout = model.init(None, "meta")
    specs = reference_of(cfg)[0].param_specs(cfg["model"])
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in flat_params(layout).items()}
    if got != specs:
        raise ValueError("the model's params are not the configuration's")
    state = TrainState.create(
        nest_like(layout, make_weights(specs, seed, device)), opt)
    return step_fn, state


def diff_norm(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 26):
    """‖a − b‖ in f64, a block of elements at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    tot = 0.0
    for i in range(0, a.numel(), chunk):
        tot += float((a[i:i + chunk].double()
                      - b[i:i + chunk].double()).square().sum())
    return math.sqrt(tot)


def setup(cell, seed: int, device, fault: str = None):
    """(step function, the state after the checked steps, the program's
    readings of those steps): three steps through the window's own call.
    ``fault`` plants a fault in those steps (the fault checks only)."""
    from repro_torch.core.fedlite import flat_params
    cfg, traffic = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    step_fn, state = build(cfg, seed, device)
    ref_lm, ref_opt = reference_of(cfg)
    losses, cap = [], hooks.Capture(device="cpu")
    with plant(fault), cap, hooks.CutGrad() as cut_grad:
        for i in range(CHECKED):
            batch = make_batch(cfg, traffic, seed, i, device)
            if fault == "half_batch":
                batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            new, m = step_fn(state, batch)
            if fault != "state_unchanged":
                state = new
            del new
            losses.append(float(m["loss"]))
            if i == 0:
                g1 = ref_opt.first_grad_norms(state.opt_state)
    specs = ref_lm.param_specs(cfg["model"])
    flat = flat_params(state.params)
    change = {}
    for i, (k, (shape, dtype)) in enumerate(specs.items()):
        change[k] = diff_norm(flat[k].detach(),
                              make_leaf(i, k, shape, dtype, seed, device))
    prog = {"losses": losses, "grad_norms": g1, "change_norms": change,
            "cuts": cap.cuts, "decisions": cap.decisions,
            "centroids": cap.centroids, "cut_grad": cut_grad.grad}
    return step_fn, state, prog


def plant(fault):
    """The faults the step can have that ``setup`` does not plant itself:
    the quantizer's (``hooks.FAULTS``)."""
    if fault in hooks.FAULTS:
        return hooks.FAULTS[fault]()
    if fault not in (None, "state_unchanged", "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    return contextlib.nullcontext()


def run(cell, seed: int, seconds: float, trace: bool, device,
        fault: str = None) -> types.SimpleNamespace:
    """One run of the cell (``fault``: see ``setup``)."""
    cfg, traffic = cell.config, cell.traffic
    step_fn, state, prog = setup(cell, seed, device, fault)
    tracing.sync(device)
    setup_s = process_age_s()
    tokens = traffic["clients"] * traffic["seq"]
    steps = iter(range(CHECKED, 1 << 30))

    def step():
        nonlocal state
        state, _ = step_fn(state, make_batch(cfg, traffic, seed,
                                             next(steps), device))

    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    n, t0 = 0, time.perf_counter()
    while True:
        step()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    tracing.sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    e2e = {"setup_s": setup_s, "train_tokens_per_s": n * tokens / wall,
           "peak_gib": peak / GIB}
    readings = types.SimpleNamespace(
        kind="train", units=n, wall_s=wall,
        unit_flops=counts_of(cfg).train_step_flops(
            cfg["model"], traffic["clients"], traffic["seq"]),
        peak_flop_per_s=peaks.BF16_FLOP_PER_S, spans=None, profiled=None,
        profiled_units=0, kernel_calls=[])
    t_traced = time.perf_counter()
    if trace:
        with hooks.KernelCalls() as calls:
            readings.profiled = tracing.profile(
                lambda: [step() for _ in range(traffic["trace_steps"])],
                device)
        readings.profiled_units = traffic["trace_steps"]
        readings.kernel_calls = calls.calls
    process_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del state, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ok, checks = check(cell, seed, device, prog)
    timings = {"setup_s": setup_s, "window_s": wall,
               "traced_stretch_s": t_ref - t_traced,
               "reference_s": time.perf_counter() - t_ref}
    return types.SimpleNamespace(
        e2e=e2e, readings=readings, attempted=3, failed=0 if ok else 3,
        correct=ok, checks=checks,
        memory_peak_bytes=max(setup_peak, peak, process_peak),
        timings=timings)


def check(cell, seed: int, device, prog: dict):
    readings = reference_readings(cell.config, cell.traffic, seed, device,
                                  prog)
    return compare.decide(readings, cell.workload["limits"])


ALL_READINGS = ("loss_gap", "grad_norm_gap", "change_norm_gap", "cut_gap",
                "cut_grad_gap", "codes_off", "codebook_cast_off",
                "codes_differ_share", "centroid_gap")


def reference_steps(cfg, traffic, seed, device, decisions=None,
                    precision="float32") -> dict:
    """The reference's first ``CHECKED`` steps in f32 from the benchmark's
    weights (``decisions``: the quantizer's, followed as given). Returns
    the losses, the first gradient's norms, the params' change norms, the
    cuts (on the host), the quantizer's decisions and the first step's
    gradient at the cut (on the host)."""
    m, o, cut = cfg["model"], cfg["optimizer"], cfg["cut"]
    ref_lm, ref_opt = reference_of(cfg)
    specs = ref_lm.param_specs(m)
    params = make_weights(specs, seed, device, as_f32=True)
    # the params are stored as the configuration states them
    stored = {k: getattr(torch, dtype) for k, (_, dtype) in specs.items()}
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ost = ref_opt.init(leaves)
    out = {"losses": [], "cuts": [], "decisions": [], "cut_grad": None}

    def keep_cut_grad(g):
        if out["cut_grad"] is None:
            out["cut_grad"] = g.detach().cpu()
    for i in range(CHECKED):
        batch = make_batch(cfg, traffic, seed, i, device)
        loss, z, dec = ref_lm.loss_of(
            leaves, batch, m, cut, precision,
            None if decisions is None else
            tuple(t.to(device) for t in decisions[i]),
            on_cut_grad=keep_cut_grad)
        loss.backward()
        out["losses"].append(float(loss.detach()))
        out["cuts"].append(z.cpu())
        out["decisions"].append(tuple(t.cpu() for t in dec))
        del loss, z, dec
        grads = {k: v.grad for k, v in leaves.items()}
        if i == 0:
            out["grad_norms"] = {k: float(g.double().norm())
                                 for k, g in grads.items()}
        with torch.no_grad():
            ref_opt.update(leaves, grads, ost, ref_opt.rate(
                o["lr"], o["warmup_steps"], o["total_steps"], i), stored)
        for v in leaves.values():
            v.grad = None
        del grads
    change = {}
    with torch.no_grad():
        for i, (k, (shape, dtype)) in enumerate(specs.items()):
            change[k] = diff_norm(leaves[k], make_leaf(i, k, shape, dtype,
                                                       seed, device))
    out["change_norms"] = change
    return out


def reference_readings(cfg, traffic, seed, device, prog) -> Dict[str, float]:
    """The compared numbers: the program's first steps against the
    reference's, which follows the program's quantizer decisions (see
    ``federated_rounds.reference_readings`` for why), and the quantizer's
    stage by itself. ``cut_grad_gap`` holds the server's side -- its
    forward from the same z̃ and its backward down to the cut -- at the
    first step: the median over tokens of the relative gap between the
    program's and the reference's gradient at the cut (a token whose
    top-2 experts differ between the two precisions reads far off, so the
    median, not the worst)."""
    b, s = traffic["clients"], traffic["seq"]
    if len(prog["decisions"]) != CHECKED or any(
            c.shape[0] != b * s for c in prog["cuts"]):
        return dict.fromkeys(ALL_READINGS, float("inf"))
    ref = reference_steps(cfg, traffic, seed, device, prog["decisions"])
    leaves = compare.counted_leaves(ref["grad_norms"])
    grad_gap, grad_leaf = compare.worst_norm_gap(
        prog["grad_norms"], ref["grad_norms"], leaves)
    change_gap, change_leaf = compare.worst_norm_gap(
        prog["change_norms"], ref["change_norms"], leaves)
    out = {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
           "grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
           "worst_leaves": f"{grad_leaf} {change_leaf}"}
    out.update(cut_grad_readings(prog["cut_grad"], ref["cut_grad"]))
    out.update(quantizer_readings(cfg, prog, ref, b, device))
    return out


def cut_grad_readings(prog: torch.Tensor, ref: torch.Tensor):
    """The first step's gradient at the cut, token by token (B, S, d):
    the median relative gap over the tokens whose reference gradient is
    at least ``TOKEN_FLOOR`` of the median token's."""
    if prog is None or ref is None or prog.shape != ref.shape:
        return {"cut_grad_gap": float("inf")}
    p = prog.reshape(-1, prog.shape[-1]).float()
    r = ref.reshape(-1, ref.shape[-1]).float()
    rn = r.norm(dim=-1)
    keep = rn >= TOKEN_FLOOR * rn.median()
    rel = (p - r).norm(dim=-1)[keep] / rn[keep]
    return {"cut_grad_gap": float(rel.median())}


def quantizer_readings(cfg, prog, ref, clients, device) -> Dict[str, float]:
    cut = cfg["cut"]
    d = cfg["model"]["d_model"]
    q = d // cut["subvector_dim"]
    z0, r0 = prog["cuts"][0].double(), ref["cuts"][0].double()

    def calls():
        for z, cents, (codebooks, codes) in zip(
                prog["cuts"], prog["centroids"], prog["decisions"]):
            x = ref_pq.to_groups(z.to(device).float().reshape(clients, -1, d),
                                 q, 1)
            yield (x, cents.to(device), codebooks.to(device),
                   codes.to(device), z.dtype)
    out = compare.quantizer_stage(calls(), cut["clusters"], cut["iters"])
    out["cut_gap"] = float((z0 - r0.reshape(z0.shape)).norm() / r0.norm())
    return out


def control_readings(cell, seed: int, device, precision: str):
    """The compared numbers with the reference computed in ``precision``
    put in the program's place: its own cut, quantizer and steps."""
    cfg, traffic = cell.config, cell.traffic
    ctl = reference_steps(cfg, traffic, seed, device, precision=precision)
    prog = {"losses": ctl["losses"], "grad_norms": ctl["grad_norms"],
            "change_norms": ctl["change_norms"], "cut_grad": ctl["cut_grad"],
            "cuts": [c.reshape(-1, c.shape[-1]) for c in ctl["cuts"]],
            "decisions": ctl["decisions"],
            "centroids": [c for c, _ in ctl["decisions"]]}
    return reference_readings(cfg, traffic, seed, device, prog)
