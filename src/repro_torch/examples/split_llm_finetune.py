"""Split-learning fine-tune of a (reduced) assigned LLM with FedLite (twin
of ``examples/split_llm_finetune.py``).

Demonstrates the framework on the transformer zoo: pick any --arch from the
assigned list; its reduced (smoke) variant trains for a few hundred steps on
synthetic non-IID federated text with the cut-layer PQ + gradient
correction. Each sequence is one client (per-client codebooks). It runs on
the card unless ``--device cpu`` asks for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.split_llm_finetune \\
        --arch llama3_8b --steps 200

Seeds, not keys: the params (the reference's ``model.init(PRNGKey(0))``)
come from a ``torch.Generator`` seeded 0 on the device, and client c's
sequence of step s (``fold_in(PRNGKey(s), c)``) from
``np.random.default_rng([s, c])``, drawn by the reference's own numpy
sampler. The ``comm_report`` line is the reference's character for
character; the step lines are the same quantities on other draws.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.core.fedlite import TrainState, comm_report, make_train_step
from repro_torch.data.synthetic import make_federated_lm_data
from repro_torch.launch.specs import make_model
from repro_torch.optim import get_optimizer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3_8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lam", type=float, default=1e-4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("split_llm_finetune: no CUDA device (use --device "
                         "cpu)")

    cfg = get_arch(args.arch, smoke=True)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("use the text archs for this example; see "
                         "tests/test_archs.py for vlm/audio batches")
    model = make_model(cfg, lam=args.lam)
    opt = get_optimizer("adam", args.lr)
    step = make_train_step(model, opt)
    state = TrainState.create(
        model.init(torch.Generator(dev).manual_seed(0), dev), opt)

    data = make_federated_lm_data(num_clients=32, vocab=cfg.vocab_size,
                                  seed=0, device=dev)
    rep = comm_report(model, state.params, tokens_per_client=args.seq)
    print(f"{args.arch} (reduced): client params "
          f"{rep['fedlite_uplink_bits'] / 8e6:.2f} MB uplink/iter vs "
          f"splitfed {rep['splitfed_uplink_bits'] / 8e6:.2f} MB "
          f"({rep['activation_compression_ratio']:.0f}x activation "
          f"compression)")

    t0 = time.time()
    for s in range(args.steps):
        # one cohort: each sequence is a distinct client's minibatch
        parts = [data.sample_batch(c, np.random.default_rng([s, c]), 1,
                                   seq=args.seq)
                 for c in range(args.batch)]
        batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        state, m = step(state, batch)
        if s % 20 == 0 or s == args.steps - 1:
            # a logged step's line reads its metrics: one sync a log line
            print(f"step {s:4d}  loss={float(m['loss']):.4f}  "  # fedlint: disable=host-sync-in-loop
                  f"ce={float(m['ce']):.4f}  "  # fedlint: disable=host-sync-in-loop
                  f"distortion={float(m.get('pq_distortion', 0)):.3f}  "  # fedlint: disable=host-sync-in-loop
                  f"({time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
