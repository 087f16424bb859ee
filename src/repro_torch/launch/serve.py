"""Batched split-inference entry point (twin of ``repro/launch/serve.py``).

The client runs the embedding and the first ``cut_periods`` periods of the
prompt, compresses the cut-layer activation with the paper's grouped PQ
(one client per sequence) and the server completes the prefill; then a
decode loop runs against the KV and SSM caches. Every architecture of the
zoo serves (an audio model's prompts and tokens are (B, K, ·) grids over
its K codebooks). It runs on the card unless
``--device cpu`` asks for the CPU (the tests do, with ``--smoke``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --batch 4 --prompt-len 2048 --gen 32

``--mesh single|multi`` serves on the production meshes over the ranks
``torchrun`` starts (a smaller world exits with the mesh's error), as the
reference's ``--mesh`` does: params laid out by ``sharding/rules.py``, the
prompt's rows and the caches over the batch axes; ``serve(..., mesh=...)``
takes any ``("data", "model")`` mesh.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import (ARCH_IDS, PORT_ARCH_IDS, ArchConfig,
                                      get_arch)
from repro_torch.launch.mesh import MeshTooSmall
from repro_torch.launch.specs import (distribute_batch, distribute_caches,
                                      make_model)
from repro_torch.launch.train import full, production_mesh
from repro_torch.sharding.ctx import use_mesh
from repro_torch.sharding.rules import distribute_params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=ARCH_IDS + PORT_ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def serve(cfg: ArchConfig, args: argparse.Namespace, *,
          log: Callable[[str], None] = print, mesh=None,
          on_logits: Optional[Callable[[torch.Tensor], None]] = None
          ) -> List[torch.Tensor]:
    """Prefill ``args.batch`` random prompts and decode ``args.gen``
    tokens; returns the tokens fed back, one (B, 1[, K]) tensor a step.
    ``on_logits`` takes the prefill's last-token logits, then each decode
    step's, as full values (the loop keeps none of them); ``mesh``
    overrides ``--mesh``."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device (use --device cpu for a CPU "
                         "run)")
    owns = False
    if mesh is None:
        mesh, owns = production_mesh(args.mesh, device)
    try:
        with use_mesh(mesh), torch.inference_mode():
            return _serve(cfg, args, device, mesh, log, on_logits)
    finally:
        if owns:
            dist.destroy_process_group()


def _serve(cfg, args, device, mesh, log, on_logits) -> List[torch.Tensor]:
    model = make_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    init_gen = torch.Generator(device).manual_seed(args.seed)
    data_gen = torch.Generator(device).manual_seed(args.seed + 1)
    params = model.init(init_gen, device)
    shape = (B, cfg.num_codebooks, P) if cfg.num_codebooks > 1 else (B, P)
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=data_gen,
                           device=device)
    caches = model.init_caches(B, P + G, device)
    batch = {"tokens": prompt}
    if mesh is not None:
        params = distribute_params(params, mesh)
        caches = distribute_caches(caches, B, mesh)
        batch = distribute_batch(batch, mesh)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, caches,
                                   quantize=not args.no_compress)
    logits = full(logits)
    if on_logits is not None:
        on_logits(logits)
    _sync(device)
    log(f"prefill: {B}x{P} tokens in {time.perf_counter() - t0:.2f}s "
        f"(uplink {'raw' if args.no_compress else 'compressed'})")
    if model.pq is not None and not args.no_compress:
        bits = model.pq.message_bits(P, cfg.d_model)
        raw = 64 * cfg.d_model * P
        log(f"uplink per client: {bits / 8e3:.1f} kB vs raw "
            f"{raw / 8e3:.1f} kB ({raw / bits:.0f}x)")

    tokens = []
    t0 = time.perf_counter()
    for i in range(G):
        lg = logits[:, -1:, ..., :cfg.vocab_size]   # (B, 1[, K], V)
        if args.temperature > 0:
            probs = torch.softmax(lg / args.temperature, -1)
            nxt = torch.multinomial(probs.reshape(-1, cfg.vocab_size), 1,
                                    generator=data_gen
                                    ).reshape(lg.shape[:-1])
        else:
            nxt = lg.argmax(-1)
        if cfg.num_codebooks > 1:
            nxt = nxt.movedim(-1, 1)                 # (B, K, 1)
        tokens.append(nxt)
        if mesh is not None:
            nxt = distribute_batch({"tokens": nxt}, mesh)["tokens"]
        logits, caches = model.decode_step(params, caches, nxt, P + i)
        logits = full(logits)
        if on_logits is not None:
            on_logits(logits)
    _sync(device)
    dt = time.perf_counter() - t0
    log(f"decode: {G} steps x{B} in {dt:.2f}s "
        f"({B * G / max(dt, 1e-9):.1f} tok/s)")
    return tokens


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        serve(get_arch(args.arch, smoke=args.smoke), args)
    except MeshTooSmall as e:
        raise SystemExit(f"serve: {e}") from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
