"""FedLite split training of any architecture of the zoo (twin of
``repro/launch/train.py``).

Each batch row (sequence) is one client: the client runs the embedding and
the first ``cut_periods`` periods, compresses its cut activation with the
paper's grouped PQ (SplitFed with ``--no-pq``), and the server completes
the forward and backward pass; one optimizer update per step (the arch's
optimizer, Adam with ``--smoke``, under ``warmup_cosine(lr, 10, steps)``).
It runs on the card unless ``--device cpu`` asks for the CPU (the tests
do, with ``--smoke``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --smoke --device cpu --steps 3 --batch 2 --seq 32

Without ``--smoke`` it builds the published configuration, which must fit
the card. ``train(cfg, args)`` is the loop as a function, for callers that
build their own (depth-cut) config. Batches are drawn from numpy
generators seeded from (``--seed``, step), in place of the reference's
``jax.random`` draws; checkpoints (``--ckpt-dir``, every ``--ckpt-every``
steps, resumed from the newest) are the reference's format.

``--mesh single|multi`` runs on the production (data=16, model=16) or
(pod=2, data=16, model=16) mesh over the ranks ``torchrun`` starts (a
smaller world exits with the mesh's error; ``launch/dryrun.py`` traces
those meshes without devices): the params are DTensors laid out by
``sharding/rules.py``, each rank draws the same batch and keeps its rows.
``train(..., mesh=...)`` takes any ``("data", "model")`` mesh, such as
``launch/mesh.make_debug_mesh``'s.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpointing import (latest_step, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.configs.base import (ARCH_IDS, PORT_ARCH_IDS, ArchConfig,
                                      get_arch)
from repro_torch.core.fedlite import (TrainState, comm_report, flat_params,
                                      make_train_step, nest_like)
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.launch.mesh import (MeshTooSmall, init_world,
                                     make_production_mesh)
from repro_torch.launch.specs import distribute_batch, make_model
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.sharding.ctx import use_mesh
from repro_torch.sharding.rules import distribute_params, host_full

Batch = Dict[str, torch.Tensor]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=ARCH_IDS + PORT_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lam", type=float, default=1e-4)
    ap.add_argument("--no-pq", action="store_true", help="SplitFed baseline")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_batch(cfg: ArchConfig, rng: np.random.Generator, batch: int,
               seq: int, device) -> Batch:
    """One step's batch, as the reference's launcher makes it: (B, K, S)
    token grids for audio (labels = tokens); for a VLM a quarter of the
    sequence as patch embeddings ahead of the text, M-RoPE positions
    0..S−1 and labels −1 on the vision positions; else tokens with labels
    shifted by one."""
    if cfg.num_codebooks > 1:
        t = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, cfg.num_codebooks, seq))).to(device)
        return {"tokens": t, "labels": t}
    if cfg.family == "vlm":
        s_vis = seq // 4
        toks = rng.integers(0, cfg.vocab_size, (batch, seq - s_vis))
        vis = rng.standard_normal((batch, s_vis, cfg.vision_embed_dim),
                                  dtype=np.float32)
        labels = np.concatenate([np.full((batch, s_vis), -1), toks], axis=1)
        pos = torch.arange(seq, dtype=torch.int32, device=device)
        return {"tokens": torch.from_numpy(toks).to(device),
                "vision_embeds": torch.from_numpy(vis).to(device),
                "positions": pos.expand(3, batch, seq),
                "labels": torch.from_numpy(labels).to(device)}
    return make_lm_batch(rng, batch, seq, cfg.vocab_size, device=device)


def step_rng(seed: int, step: int) -> np.random.Generator:
    """The generator of step ``step``'s batch under base seed ``seed``."""
    return np.random.default_rng([seed + 1, step])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def full(t):
    """A DTensor's full value (a collective: every rank calls it); a plain
    tensor or a number as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def production_mesh(kind: str, device):
    """(mesh, True if this call initialised the process group) for
    ``--mesh kind``: None for "none"; a world too small raises
    ``MeshTooSmall`` (after tearing down a group it made)."""
    if kind == "none":
        return None, False
    owns = init_world(device)
    try:
        return make_production_mesh(multi_pod=kind == "multi",
                                    device=device), owns
    except MeshTooSmall:
        if owns:
            dist.destroy_process_group()
        raise


def train(cfg: ArchConfig, args: argparse.Namespace, *,
          log: Callable[[str], None] = print, mesh=None):
    """The training loop of ``args`` on ``cfg``: returns (final
    ``TrainState``, the metrics of every step run, each with its host
    seconds under ``"seconds"``); ``log`` takes the printed lines.
    ``mesh`` (a ``("data", "model")`` DeviceMesh) overrides ``--mesh``;
    the state's params are then DTensors and the metrics full values."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device (use --device cpu for a CPU "
                         "run)")
    owns = False
    if mesh is None:
        mesh, owns = production_mesh(args.mesh, device)
    try:
        with use_mesh(mesh):
            return _train(cfg, args, device, mesh, log)
    finally:
        if owns:
            dist.destroy_process_group()


def _train(cfg: ArchConfig, args: argparse.Namespace, device, mesh, log):
    model = make_model(cfg, with_pq=not args.no_pq, lam=args.lam)
    opt = get_optimizer(cfg.optimizer if not args.smoke else "adam",
                        warmup_cosine(args.lr, 10, args.steps))
    step_fn = make_train_step(model, opt, quantize=not args.no_pq)
    params = model.init(torch.Generator(device).manual_seed(args.seed),
                        device)
    if mesh is not None:
        params = distribute_params(params, mesh)
    state = TrainState.create(params, opt)
    del params
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        # under a mesh the full params stay on the host: each rank moves
        # its own blocks to its card
        restored = flat_params(restore_checkpoint(
            args.ckpt_dir, start,
            device if mesh is None else "cpu")["params"])
        # the template keeps empty subtrees, which a checkpoint drops
        params = nest_like(state.params, restored)
        if mesh is not None:
            params = distribute_params(params, mesh)
        params = nest_like(state.params, {
            k: v.requires_grad_() for k, v in flat_params(params).items()})
        state = TrainState(params=params, opt_state=state.opt_state,
                           step=start)
        log(f"resumed from step {start}")

    rep = comm_report(model, state.params, tokens_per_client=args.seq)
    if "activation_compression_ratio" in rep:
        log(f"uplink compression: "
            f"{rep['activation_compression_ratio']:.0f}x activations, "
            f"{rep['uplink_reduction_vs_splitfed']:.1f}x total vs SplitFed")

    history: List[Dict] = []
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = make_batch(cfg, step_rng(args.seed, s), args.batch, args.seq,
                           device)
        if mesh is not None:
            batch = distribute_batch(batch, mesh)
        t_step = time.perf_counter()
        state, m = step_fn(state, batch)
        m = {k: full(v) for k, v in m.items()}
        _sync(device)
        history.append(dict(m, seconds=time.perf_counter() - t_step))
        if s % args.log_every == 0 or s == args.steps - 1:
            # a logged step's line reads its metrics: one sync a log line
            log(f"step {s:5d}  loss={float(m['loss']):.4f}  "  # fedlint: disable=host-sync-in-loop
                f"ce={float(m['ce']):.4f}  "  # fedlint: disable=host-sync-in-loop
                f"{(time.perf_counter() - t0):.0f}s")
        if args.ckpt_dir and args.ckpt_every and \
                (s + 1) % args.ckpt_every == 0:
            flat = {k: host_full(v)
                    for k, v in flat_params(state.params).items()}
            if all(v is not None for v in flat.values()):   # mesh's first
                save_checkpoint(args.ckpt_dir, s + 1,
                                {"params": nest_like(state.params, flat)})
            if mesh is not None:     # no rank runs ahead of the snapshot
                dist.barrier()
    log("done")
    return state, history


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        train(get_arch(args.arch, smoke=args.smoke), args)
    except MeshTooSmall as e:
        raise SystemExit(f"train: {e}") from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
