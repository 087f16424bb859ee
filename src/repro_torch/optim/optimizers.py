"""Functional optimizers (twin of ``repro/optim/optimizers.py``).

``Optimizer.update(grads, state, params)`` returns *updates to add to the
params* and the next state; grads, params and updates are dicts of tensors
keyed by parameter name. The paper's three tasks use SGD (FEMNIST), Adam
(SO NWP) and AdaGrad (SO Tag); Adafactor (factored second moments, no
momentum) is the reference's optimizer for the largest architectures.

The numerics are the reference's: every state tensor is f32 per
parameter, updates are computed in f32 and cast to the gradient's dtype,
and a scalar the reference computes in f32 (a learning rate, Adam's bias
corrections, Adafactor's β) enters as its f32 value. The step count is a
Python int, as in ``sgd``; the scalar powers of it are taken on numpy f32
scalars on the host (no step waits for the card), which gives the
reference's f32 ``b ** step`` bit for bit where a Python float power,
taken in f64, differs in the last bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.kernels import ops
from repro_torch.models.layout import inverse, ref_axes

Schedule = Callable[[int], float]
Tensors = Dict[str, torch.Tensor]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: lr


def _f32_pow(base: float, exponent: float) -> np.float32:
    """``base ** exponent`` taken in f32, as the reference's
    ``b ** step.astype(float32)``."""
    return np.float32(base) ** np.float32(exponent)


def _bias_correction(b: float, step: int) -> float:
    """Adam's 1 − b^step, each operation in f32."""
    return float(1 - _f32_pow(b, step))


def _adafactor_beta(step: int) -> Tuple[float, float]:
    """Adafactor's β = 1 − step^−0.8 and 1 − β, each rounded in f32."""
    beta = 1 - _f32_pow(step, -0.8)
    return float(beta), float(1 - beta)


def _zeros_f32(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]
    name: str = "opt"


def sgd(lr) -> Optimizer:
    """Plain SGD: update = −lr(step)·g, computed in f32 and cast back."""
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        del params
        step = state["step"]
        # the f32 tensor times a Python float multiplies by lr rounded to
        # f32, as the reference's jnp.asarray(lr, float32) does
        upd = {k: (g.float() * -sched(step)).to(g.dtype)
               for k, g in grads.items()}
        return upd, {"step": step + 1}

    return Optimizer(init, update, "sgd")


def momentum(lr, beta: float = 0.9) -> Optimizer:
    """Heavy ball: m ← β·m + g, update = −lr(step)·m."""
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0, "m": _zeros_f32(params)}

    def update(grads, state, params):
        del params
        step = state["step"]
        m = {k: beta * state["m"][k] + g.float() for k, g in grads.items()}
        upd = {k: (m[k] * -sched(step)).to(g.dtype)
               for k, g in grads.items()}
        return upd, {"step": step + 1, "m": m}

    return Optimizer(init, update, "momentum")


def adam(lr, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction 1 − b^step (step counted from 1, the power
    in f32) and the learning rate read at ``sched(step − 1)``."""
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0, "m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update(grads, state, params):
        del params
        step = state["step"] + 1
        m = {k: b1 * state["m"][k] + (1 - b1) * g.float()
             for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * g.float().square()
             for k, g in grads.items()}
        bc1, bc2 = _bias_correction(b1, step), _bias_correction(b2, step)
        lr_t = sched(step - 1)
        upd = {k: ((m[k] / bc1) * -lr_t
                   / ((v[k] / bc2).sqrt() + eps)).to(g.dtype)
               for k, g in grads.items()}
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, "adam")


def adagrad(lr, eps: float = 1e-7) -> Optimizer:
    """AdaGrad: acc ← acc + g², update = −lr(step)·g / (√acc + eps)."""
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0, "acc": _zeros_f32(params)}

    def update(grads, state, params):
        del params
        step = state["step"]
        acc = {k: state["acc"][k] + g.float().square()
               for k, g in grads.items()}
        upd = {k: (g.float() * -sched(step)
                   / (acc[k].sqrt() + eps)).to(g.dtype)
               for k, g in grads.items()}
        return upd, {"step": step + 1, "acc": acc}

    return Optimizer(init, update, "adagrad")


def adafactor(lr, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern, 2018), no
    momentum. A parameter of rank >= 2 keeps its f32 second moment as a
    row vector and a column vector over the last two dims of the
    parameter in the reference's layout (``models.layout.ref_axes``: a
    paper model's OIHW conv weight is factored over I and O, as the
    reference factors its HWIO one), and keeps them in that layout; the
    update's RMS is clipped to ``clip_threshold``."""
    sched = _as_schedule(lr)

    def in_ref(key: str, t: torch.Tensor) -> torch.Tensor:
        axes = ref_axes(key)
        return t if axes is None else t.permute(axes).contiguous()

    def from_ref(key: str, t: torch.Tensor) -> torch.Tensor:
        axes = ref_axes(key)
        return t if axes is None else \
            t.permute(inverse(axes)).contiguous()

    def init(params):
        def zs(key, p):
            p = in_ref(key, p)
            if p.dim() >= 2:
                return {"row": _zeros_without(p, p.dim() - 1),
                        "col": _zeros_without(p, p.dim() - 2)}
            return {"full": torch.zeros_like(p, dtype=torch.float32)}
        return {"step": 0, "v": {k: zs(k, p) for k, p in params.items()}}

    def update(grads, state, params):
        del params
        step = state["step"] + 1
        beta, one_minus = _adafactor_beta(step)
        lr_t = sched(step - 1)
        upd, new_v = {}, {}
        for k, g in grads.items():
            u, new_v[k] = ops.adafactor_update(
                in_ref(k, g), state["v"][k], beta=beta, one_minus=one_minus,
                lr=lr_t, eps=eps, clip=clip_threshold)
            upd[k] = from_ref(k, u)
        return upd, {"step": step, "v": new_v}

    return Optimizer(init, update, "adafactor")


def _zeros_without(p: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 zeros of ``p``'s shape without dim ``dim``; for a DTensor laid
    out as ``p`` is on the other dims (a factor of a sharded parameter
    stays sharded, so the rank-2 second moment it rebuilds is too)."""
    shape = p.shape[:dim] + p.shape[dim + 1:]
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    placements = [
        Replicate() if isinstance(pl, Shard) and pl.dim == dim
        else Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > dim
        else pl for pl in p.placements]
    return dtensor_zeros(shape, dtype=torch.float32,
                         device_mesh=p.device_mesh, placements=placements)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    table = {"sgd": sgd, "momentum": momentum, "adam": adam,
             "adagrad": adagrad, "adafactor": adafactor}
    return table[name](lr, **kw)
