"""Split serving with compressed uplink: batched prefill + decode (twin of
``examples/serve_split.py``).

The client side computes the prompt's cut-layer activations, compresses them
with the grouped PQ (the inference uplink is exactly the paper's B·d
message), and the server side completes prefill and serves greedy decode
steps against the KV/SSM caches, written in place. Run with any assigned
arch (reduced variant) on the card, or with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.serve_split \\
        --arch mamba2_1p3b --prompt-len 48 --gen 16 --batch 4

Seeds, not keys: the params (the reference's ``model.init(PRNGKey(0))``)
come from a ``torch.Generator`` seeded 0 on the device and the prompt
(``PRNGKey(1)``) from one seeded 1. The uplink line is the reference's
character for character; the decode rate names the device it ran on.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.launch.specs import make_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2_3b", choices=ARCH_IDS)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_split: no CUDA device (use --device cpu)")

    cfg = get_arch(args.arch, smoke=True)
    if cfg.family in ("vlm",):
        raise SystemExit("text archs only in this example")
    model = make_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    with torch.inference_mode():
        params = model.init(torch.Generator(dev).manual_seed(0), dev)
        shape = (B, cfg.num_codebooks, P) if cfg.num_codebooks > 1 \
            else (B, P)
        prompt = torch.randint(0, cfg.vocab_size, shape, device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
        caches = model.init_caches(B, P + G, dev)

        _sync(dev)
        t0 = time.time()
        logits, caches = model.prefill(params, {"tokens": prompt}, caches,
                                       quantize=not args.no_compress)
        _sync(dev)
        print(f"prefill {P} tokens x{B}: {time.time() - t0:.2f}s "
              f"(uplink {'compressed' if not args.no_compress else 'raw'})")

        if model.pq is not None and not args.no_compress:
            bits = model.pq.message_bits(P, cfg.d_model)
            raw = 64 * cfg.d_model * P
            print(f"uplink per client: {bits / 8e3:.1f} kB vs raw "
                  f"{raw / 8e3:.1f} kB ({raw / bits:.0f}x)")

        generated = []
        t0 = time.time()
        for i in range(G):
            # greedy, on the last position's logits over the vocabulary
            nxt = logits[:, -1:, ..., :cfg.vocab_size].argmax(-1)
            if cfg.num_codebooks > 1:
                nxt = nxt.movedim(-1, 1)  # (B, K, 1)
            generated.append(nxt)
            logits, caches = model.decode_step(params, caches, nxt, P + i)
        _sync(dev)
        dt = time.time() - t0
    print(f"decoded {G} steps x{B} in {dt:.2f}s "
          f"({B * G / dt:.1f} tok/s on {where})")
    print("first generated ids:",
          generated[0].reshape(B, -1)[:, 0].cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
