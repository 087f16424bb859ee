"""FedLite / SplitFed training step (twin of ``repro/core/fedlite.py``).

One step is a full FedLite iteration (paper Fig. 1): client forward ->
grouped PQ with the gradient-corrected backward -> server forward and
backward -> client backward -> one optimizer update of client and server.
``quantize=False`` is SplitFed, which is exactly mini-batch SGD.

The reference's step is a pure jitted function of a ``TrainState`` pytree;
here the state holds a dict of parameter tensors, the model is driven from
it with ``torch.func.functional_call``, and the step returns a new state
(out of place, as the reference's ``donate=False`` step does). PyTorch runs
eagerly; there is nothing to compile.

Not ported yet: ``cut_state`` (codebook warm start / error feedback) and
``step_key`` (stochastic downlink rounding), both ROADMAP A4; they raise.
``make_weighted_step``, the eval step and ``comm_report`` are ROADMAP A7.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.optim import Optimizer

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Tensors
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params: Tensors, optimizer: Optimizer) -> "TrainState":
        """Starts from copies of ``params`` (e.g. a module's
        ``named_parameters()``), which the steps never write to."""
        own = {k: v.detach().clone().requires_grad_() for k, v in
               dict(params).items()}
        return cls(params=own, opt_state=optimizer.init(own), step=0)


def make_train_step(model: nn.Module, optimizer: Optimizer, *,
                    quantize: bool = True, microbatches: int = 1,
                    lam_schedule: Optional[Callable] = None,
                    step_key=None) -> Callable:
    """Build the FedLite (quantize=True) / SplitFed (False) step.

    ``microbatches > 1`` splits the batch along its leading axis into m
    sequential microbatches and averages their gradients (in f32) before
    the one optimizer update. ``lam_schedule(step) -> λ`` overrides the
    model's correction strength per step.

    The step is ``step(state, batch) -> (next state, metrics)``; metrics
    holds the model's (detached) metrics of the last microbatch and
    ``loss``.
    """
    if step_key is not None:
        raise NotImplementedError(
            "step_key (stochastic downlink rounding) is not ported yet "
            "(ROADMAP A4)")

    def grads_of(params: Tensors, batch, step: int):
        lam = None if lam_schedule is None else lam_schedule(step)
        loss, metrics = torch.func.functional_call(
            model, params, (batch,),
            {"quantize": quantize, "lam_override": lam})
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(state: TrainState, batch,
                   cut_state=None) -> Tuple[TrainState, Dict]:
        if cut_state is not None:
            raise NotImplementedError(
                "cut_state (codebook warm start / error feedback) is not "
                "ported yet (ROADMAP A4)")
        if microbatches == 1:
            loss, metrics, grads = grads_of(state.params, batch, state.step)
        else:
            g_sum = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in state.params.items()}
            loss = 0.0
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                mloss, metrics, g = grads_of(state.params, mb, state.step)
                for k in g_sum:
                    g_sum[k] += g[k].float()
                loss = loss + mloss
            grads = {k: (g_sum[k] / microbatches).to(p.dtype)
                     for k, p in state.params.items()}
            loss = loss / microbatches
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        with torch.no_grad():
            params = {k: (p + updates[k]).requires_grad_()
                      for k, p in state.params.items()}
        return (TrainState(params, opt_state, state.step + 1),
                dict(metrics, loss=loss))

    return train_step
