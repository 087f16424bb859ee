"""The paper's FEMNIST model, trained by FedLite's split step, plainly.

Client: conv 3x3 (1 -> 32) + ReLU, conv 3x3 (32 -> 64) + ReLU, 2x2 max-pool,
flattened in (height, width, channel) order to the cut (d = 9216); server:
dense 9216 -> 128 + ReLU, dense 128 -> 62; the loss is the mean
cross-entropy over the cohort's samples. With PQ, each client's 20 cut
vectors are quantized with its own codebooks and the cut's gradient is
corrected by eq. 5; SplitFed passes the cut as it is. One SGD update a
round. Images are NHWC; convolution weights OIHW; dense weights
(in, out), applied as ``x @ W``.

The products' inputs go through ``lowprec.rounder(precision)``, so the
same code is the control in a lower precision.

The clients' data stands in for LEAF FEMNIST (``make_pools``): each client
holds a fixed pool of images (a noisy smoothed class prototype each) whose
labels follow its own Dirichlet(alpha) mixture over the classes. A batch
is a dict of the pools' keys, as the program's model reads it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fedbench.reference import lowprec, pq

Params = Dict[str, torch.Tensor]


def param_shapes(m: dict) -> Dict[str, tuple]:
    """The parameters by name, as the configuration's ``model`` sizes
    them: convolutions OIHW, dense layers (in, out)."""
    k = m["kernel"]
    return {
        "client.conv1_w": (m["conv1_channels"], m["in_channels"], k, k),
        "client.conv1_b": (m["conv1_channels"],),
        "client.conv2_w": (m["conv2_channels"], m["conv1_channels"], k, k),
        "client.conv2_b": (m["conv2_channels"],),
        "server.dense1_w": (m["cut_dim"], m["hidden"]),
        "server.dense1_b": (m["hidden"],),
        "server.dense2_w": (m["hidden"], m["num_classes"]),
        "server.dense2_b": (m["num_classes"],),
    }


def cut_shape(m: dict, client_batch: int) -> Tuple[int, int]:
    """(rows, d) of one client's cut."""
    return client_batch, m["cut_dim"]


def make_pools(cfg: dict, seeds: Tuple[int, int],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """The K clients' pools, {"image": (K, n, 28, 28, 1) f32, "label":
    (K, n) int64}, from two seeds (the card's draws, the mixtures')."""
    data, m, fed = cfg["data"], cfg["model"], cfg["federation"]
    k, n, c, hw = (fed["num_clients"], data["samples_per_client"],
                   m["num_classes"], m["image_hw"])
    g = torch.Generator(device=device).manual_seed(seeds[0])
    protos = torch.randn((c, 1, hw, hw), generator=g, device=device)
    protos = F.avg_pool2d(F.pad(protos, (1, 1, 1, 1), mode="replicate"), 3,
                          stride=1).permute(0, 2, 3, 1)
    mix = np.random.default_rng(seeds[1]).dirichlet(
        data["alpha"] * np.ones(c), size=k)
    mix = torch.as_tensor(mix + 1e-9, dtype=torch.float32, device=device)
    labels = torch.multinomial(mix, n, replacement=True, generator=g)
    noise = torch.randn((k, n, hw, hw, 1), generator=g, device=device)
    return {"image": protos[labels] + data["noise"] * noise,
            "label": labels}


def cut_of(params: Params, images: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """The client's forward: (B, 28, 28, 1) images -> (B, 9216) cut."""
    r = lowprec.rounder(precision)
    x = images.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(r(x), r(params["client.conv1_w"]))
               + params["client.conv1_b"][:, None, None])
    x = F.relu(F.conv2d(r(x), r(params["client.conv2_w"]))
               + params["client.conv2_b"][:, None, None])
    x = F.max_pool2d(x, 2)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def loss_of(params: Params, images: torch.Tensor, labels: torch.Tensor,
            quant: Optional[dict], client_batch: int,
            precision: str = "float32", decision=None):
    """(loss, the cut, the quantizer's (codebooks, codes)). ``decision``
    takes the quantizer's codebooks (C·R, L, d/q) and codes (C·R, rows)
    as given instead of clustering."""
    r = lowprec.rounder(precision)
    z = cut_of(params, images, precision)
    cut = z.detach()
    if quant is not None:
        b, d = z.shape
        zc = z.reshape(b // client_batch, client_batch, d)
        if decision is None:
            zt, codes, cents = pq.quantize(zc, quant["q"], quant["L"],
                                           quant["iters"],
                                           quant.get("groups", 1))
            decision = (cents, codes)
        else:
            cents, codes = decision
            zt = pq.from_groups(pq.gather(cents.float(), codes.long()),
                                *zc.shape, quant["q"])
        z = pq.Corrected.apply(zc, zt, quant["lam"]).reshape(b, d)
    h = F.relu(r(z) @ r(params["server.dense1_w"])
               + params["server.dense1_b"])
    logits = r(h) @ r(params["server.dense2_w"]) + params["server.dense2_b"]
    return F.cross_entropy(logits, labels), cut, decision


def train(params: Params, batches: List[Dict[str, torch.Tensor]],
          lr: float, quant: Optional[dict], client_batch: int,
          precision: str = "float32", decisions=None) -> dict:
    """SGD steps from ``params``, one a batch. Returns the losses, the
    first gradient, the params after each step, the cut of each step and
    the quantizer's decisions of each step (``decisions`` given: those,
    followed as they are)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    out = {"losses": [], "grads1": None, "params": [], "cuts": [],
           "decisions": []}
    for i, batch in enumerate(batches):
        leaves = {k: v.requires_grad_() for k, v in p.items()}
        loss, cut, dec = loss_of(leaves, batch["image"], batch["label"],
                                 quant, client_batch, precision,
                                 None if decisions is None else decisions[i])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        g = dict(zip(leaves, grads))
        if out["grads1"] is None:
            out["grads1"] = {k: v.detach().clone() for k, v in g.items()}
        with torch.no_grad():
            p = {k: v.detach() - lr * g[k] for k, v in leaves.items()}
        out["losses"].append(float(loss.detach()))
        out["params"].append(p)
        out["cuts"].append(cut)
        out["decisions"].append(dec)
    return out
