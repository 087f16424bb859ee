"""Adafactor (Shazeer & Stern, 2018) as the LM cell trains with it, plainly:
no momentum; a leaf of rank >= 2 keeps its second moment factored into a
row vector (the mean over the last axis) and a column vector (the mean
over the second last), a leaf of rank 1 keeps it whole; β_t = 1 − t^−0.8;
the update g / sqrt(v̂) has its RMS clipped to 1 and is scaled by the rate
of step t − 1 of a linear warm-up then cosine decay (to a tenth)."""

from __future__ import annotations

import math
from typing import Dict

import torch

EPS = 1e-30


def rate(lr: float, warmup: int, total: int, step: int) -> float:
    if step < warmup:
        return lr * (step + 1) / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return lr * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * t)))


def init(params: Dict[str, torch.Tensor]) -> dict:
    def zs(p):
        if p.dim() >= 2:
            return {"row": torch.zeros(p.shape[:-1], device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       device=p.device)}
        return {"full": torch.zeros_like(p, dtype=torch.float32)}
    return {"step": 0, "v": {k: zs(p) for k, p in params.items()}}


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           state: dict, lr_t: float,
           stored: Dict[str, torch.dtype] = None) -> None:
    """One step, in place on f32 ``params`` and ``state``. A leaf the
    configuration stores in a narrower dtype (``stored``) keeps to it: its
    update is rounded to that dtype, and so is the updated value."""
    stored = stored or {}
    step = state["step"] + 1
    beta = 1.0 - float(torch.tensor(float(step)) ** -0.8)
    for k, g in grads.items():
        v = state["v"][k]
        g2 = g.float().square() + EPS
        if "full" in v:
            v["full"] = beta * v["full"] + (1 - beta) * g2
            rms = v["full"].sqrt()
        else:
            v["row"] = beta * v["row"] + (1 - beta) * g2.mean(-1)
            v["col"] = beta * v["col"] + (1 - beta) * g2.mean(-2)
            mean = v["row"].mean(-1, keepdim=True)[..., None]
            rms = (v["row"][..., None] * v["col"][..., None, :]
                   / mean.clamp_min(EPS)).sqrt()
        del g2
        u = g.float() / rms.clamp_min(EPS)
        del rms
        urms = (u.square().mean() + EPS).sqrt()
        step_k = -lr_t * (u / (urms / 1.0).clamp_min(1.0))
        dt = stored.get(k, torch.float32)
        if dt == torch.float32:
            params[k] += step_k
        else:
            params[k].copy_(params[k].to(dt) + step_k.to(dt))
    state["step"] = step


def first_grad_norms(state: dict) -> Dict[str, float]:
    """Each leaf's first gradient norm, from an Adafactor state after one
    step ({"v": {leaf: {"full"} or {"row", "col"}}}, as ``init`` lays it
    out): β_1 = 0, so v = g² + ε, and a factored leaf's row means times
    its last axis sum to ‖g‖²."""
    out = {}
    for k, v in state["v"].items():
        if "full" in v:
            out[k] = float(v["full"].double().sum().sqrt())
        else:
            n = v["col"].shape[-1]
            out[k] = float((v["row"].double().sum() * n).sqrt())
    return out
