"""Quickstart: FedLite in ~40 lines (twin of ``examples/quickstart.py``).

Quantizes a batch of activations with the paper's grouped product quantizer,
shows the compression accounting, and runs one gradient-corrected split
training step on the paper's FEMNIST CNN.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Seeds, not keys: the reference's ``jax.random.PRNGKey(k)`` is the int k
here. The activations are numpy normals from ``default_rng(0)``, the CNN's
weights come from ``torch.Generator().manual_seed(0)`` and the batch from
``default_rng(1)``, so the numbers are the reference's in kind, not digit
for digit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.correction import quantize_with_correction
from repro_torch.core.fedlite import TrainState, make_train_step
from repro_torch.core.quantizer import PQConfig, quantize
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.models.paper_models import FemnistCNN
from repro_torch.optim import sgd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart: no CUDA device (use --device cpu)")

    # --- 1. the quantizer by itself -----------------------------------------
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 20, 9216), dtype=np.float32)).to(dev)   # one client, B=20, d=9216
    pq = PQConfig(num_subvectors=1152, num_clusters=2)   # paper's 490x pt
    out = quantize(z, pq)
    print(f"compression ratio : {pq.compression_ratio(20, 9216):.1f}x "
          "(paper §5: 490x)")
    print(f"mean sq distortion: {float(out.distortion[0]):.3f}")

    # --- 2. gradient correction (eq. 5) -------------------------------------
    lam = 1e-4
    zg = z.clone().requires_grad_()
    zt = quantize_with_correction(zg, lam, pq)
    (g,) = torch.autograd.grad(zt, zg, torch.ones_like(zt))
    want = 1.0 + lam * (z - zt.detach())
    print(f"corrected cotangent == g + λ(z − z̃): "
          f"{bool(torch.allclose(g, want, atol=1e-6))}")

    # --- 3. one FedLite training step ---------------------------------------
    data = make_federated_image_data(num_clients=8, device=dev)
    model = FemnistCNN(pq=pq, lam=lam, client_batch=20, device=dev,
                       generator=torch.Generator().manual_seed(0))
    opt = sgd(10 ** -1.5)
    step = make_train_step(model, opt)
    state = TrainState.create(dict(model.named_parameters()), opt)
    batch = data.sample_batch(0, np.random.default_rng(1), 20)
    state, metrics = step(state, batch)
    print(f"step 1: loss={float(metrics['loss']):.3f} "
          f"ratio={metrics['pq_compression_ratio']:.0f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
