"""Production-mesh dry run: trace one step of every (arch × input shape ×
mesh) on a fake process group (twin of ``repro/launch/dryrun.py``).

The deliverable that proves the distribution is coherent without the
devices: on a fake process group of 256 ranks (the single-pod (16, 16)
mesh) or 512 (the multi-pod (2, 16, 16) one), the train step (forward,
backward and the optimizer), the prefill or the decode step runs on
DTensors over ``FakeTensor`` locals, so no memory is allocated and no
collective moves data. ``launch/analysis.DeviceCost`` records what rank 0
runs: its FLOPs, bytes, peak memory and collectives, which feed the
roofline with the H100's constants (``launch/mesh.py``) and the
``fits_80GB`` verdict against the card's HBM.

The reference compiles with XLA on 512 host devices and, where XLA-CPU's
bf16 legalisation inflates a record's temp buffers, estimates the TPU's
footprint from an f32 compile (``tpu_bf16_estimate``). Nothing here has
that counterpart: FakeTensors keep bf16 as bf16. The tensors are CPU
fakes, so the cut's PQ runs its plain version (the reference's dry run
traces its jnp path too), whose (rows, L) scores a card's kernels never
hold; the prefill's flash kernel is one op whose fake form holds only
its output (``models/attention._flash_prefill``). The time a dry run
takes and the memory it uses are the host's, printed as such.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
          --shape train_4k --mesh single
      PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, get_arch,
                                      supports_shape)
from repro_torch.core.fedlite import flat_params, make_train_step
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, HBM_KEY,
                                     NVLINK_BW_PER_LINK, NVLINK_LINKS,
                                     PEAK_FLOPS_BF16, make_production_mesh)
from repro_torch.launch.specs import (cache_specs, decode_token_specs,
                                      input_specs, make_model, state_specs)
from repro_torch.optim import get_optimizer
from repro_torch.sharding.ctx import use_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def fake_world(size: int = 512) -> None:
    """A fake process group of ``size`` ranks, this process rank 0 (no
    store traffic, no network); a group already initialised is kept."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def host_peak_rss() -> int:
    """This process's peak resident bytes: the kernel's VmHWM, which
    starts afresh at exec (``ru_maxrss`` keeps the high-water mark of a
    large parent that forked it)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def trace_combo(arch_id: str, shape_id: str, mesh, *, with_pq: bool = True,
                inference_layout: bool = False) -> dict:
    """Trace one (arch, shape) on ``mesh``; return the record."""
    # inference_layout=False by default, as in the reference (its TP-only
    # serving layout measured neutral on dense decode, worse on jamba)
    cfg = get_arch(arch_id)
    shape = INPUT_SHAPES[shape_id]
    model = make_model(cfg, with_pq=with_pq)
    world = mesh.size()
    cost = analysis.DeviceCost()

    t0 = time.perf_counter()
    with FakeTensorMode(), use_mesh(mesh):
        if shape.kind == "train":
            opt = get_optimizer(cfg.optimizer, 1e-4)
            step = make_train_step(model, opt, quantize=with_pq,
                                   microbatches=cfg.train_microbatches)
            state = state_specs(model, opt, mesh)
            for p in flat_params(state.params).values():
                p.requires_grad_()
            batch = input_specs(cfg, shape, mesh)
            cost.hold((flat_params(state.params), state.opt_state, batch))
            with cost:
                state, _ = step(state, batch)
        elif shape.kind == "prefill":
            batch = input_specs(cfg, shape, mesh, with_labels=False)
            caches = cache_specs(model, shape.global_batch, shape.seq_len,
                                 mesh)
            params = state_specs(model, get_optimizer("sgd", 0.0),
                                 mesh).params
            cost.hold((flat_params(params), flat_params(caches), batch))
            with torch.no_grad(), cost:
                model.prefill(params, batch, caches, quantize=with_pq)
        else:  # decode (optionally with the TP-only serving layout)
            caches = cache_specs(model, shape.global_batch, shape.seq_len,
                                 mesh)
            params = state_specs(model, get_optimizer("sgd", 0.0), mesh,
                                 inference=inference_layout).params
            tok = decode_token_specs(cfg, shape, mesh)
            cost.hold((flat_params(params), flat_params(caches), tok))
            with torch.no_grad(), cost:
                model.decode_step(params, caches, tok, shape.seq_len - 1)
    trace_s = time.perf_counter() - t0

    summary = analysis.cost_summary(cost)
    mem = analysis.memory_summary(cost)
    coll = analysis.collective_stats(cost.collectives)
    wire = analysis.total_wire_bytes(coll)
    roof = analysis.roofline_terms(
        summary["flops"], summary["bytes_accessed"], wire,
        peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, ici_bw=NVLINK_BW_PER_LINK,
        num_links=NVLINK_LINKS)

    # MODEL_FLOPS: 6·N_active·tokens (train fwd+bwd) or 2·N_active·tokens
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch
    model_flops_per_device = model_flops / world
    device_bytes = mem["peak_size_in_bytes"]
    return {
        "arch": arch_id, "shape": shape_id,
        "inference_layout": inference_layout if shape.kind == "decode"
        else None,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "world": world, "kind": shape.kind, "with_pq": with_pq,
        "host_trace_s": trace_s,
        "host_peak_rss_bytes": host_peak_rss(),
        "cost": summary, "memory": mem, "collectives": coll,
        "wire_bytes_per_device": wire,
        "device_bytes": device_bytes,
        HBM_KEY: device_bytes <= HBM_BYTES,
        "model_flops_per_device": model_flops_per_device,
        "useful_flops_fraction": (model_flops_per_device /
                                  max(summary["flops"], 1.0)),
        "roofline": roof,
        "params_total": cfg.param_count(),
        "params_active": n_active,
    }


def run_one(arch_id, shape_id, mesh_kind, out_dir, *, with_pq=True,
            force=False, inference_layout=False) -> dict:
    tag = f"{arch_id}__{shape_id}__{mesh_kind}" + ("" if with_pq
                                                   else "__nopq")
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        print(f"[skip] {tag} (exists)")
        with open(path) as f:
            return json.load(f)
    if not supports_shape(arch_id, shape_id):
        rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh_kind,
               "skipped": "long_500k requires sub-quadratic attention "
                          "(sliding window or SSM state)"}
        _dump(rec, path)
        print(f"[skip-noted] {tag}")
        return rec
    try:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device="cpu")
        rec = trace_combo(arch_id, shape_id, mesh, with_pq=with_pq,
                          inference_layout=inference_layout)
        _dump(rec, path)
        r = rec["roofline"]
        print(f"[ok] {tag}: host trace {rec['host_trace_s']:.1f}s; per "
              f"device {rec['device_bytes'] / 2**30:.2f} GiB "
              f"{HBM_KEY}={rec[HBM_KEY]} bound={r['bound']} "
              f"t=(c {r['compute_s'] * 1e3:.2f} | m "
              f"{r['memory_s'] * 1e3:.2f} | coll "
              f"{r['collective_s'] * 1e3:.2f}) ms (H100 SXM5 datasheet "
              f"rates)")
        return rec
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh_kind,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        _dump(rec, path)
        print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}")
        return rec


def _dump(rec: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="input shape id or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-pq", action="store_true",
                    help="trace the SplitFed baseline (no quantizer)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--inference-layout-decode", action="store_true",
                    help="decode with the TP-only serving param layout")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    # the fake world before anything is built: 512 ranks serve both meshes
    fake_world(512 if "multi" in meshes else 256)
    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_one(arch, shape, mesh_kind, args.out,
                              with_pq=not args.no_pq, force=args.force,
                              inference_layout=args.inference_layout_decode)
                failures += 1 if "error" in rec else 0
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
