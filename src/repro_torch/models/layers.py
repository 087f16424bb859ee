"""Basic building blocks: inits, norms, gated MLPs (twin of
``repro/models/layers.py``).

Functions over plain dicts of tensors, as the reference's (init, apply)
pairs over dict pytrees. Dense weights are ``(d_in, d_out)`` and applied as
``x @ W``, the reference's layout. Initializers draw from an explicit
``torch.Generator`` on ``device`` (the reference draws from a PRNG key; the
two give different numbers, so parity tests load the reference's weights).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.ctx import BATCH, gathered, shard, shard_residual

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _normal(generator: Optional[torch.Generator], shape, device):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype, scale: float = 1.0, *,
               device="cuda") -> torch.Tensor:
    """N(0, (scale/√d_in)²) drawn in f32, then cast to ``dtype``."""
    std = scale / math.sqrt(d_in)
    return (_normal(generator, (d_in, d_out), device) * std).to(dtype)


def embed_init(generator: Optional[torch.Generator], vocab: int, d: int,
               dtype: torch.dtype, *, device="cuda") -> torch.Tensor:
    return (_normal(generator, (vocab, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, norm_type: str, dtype: torch.dtype, *,
              device="cuda") -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, norm_type: str,
               eps: float) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, computed in f32 and cast
    back to ``x.dtype``."""
    xf = x.float()
    if norm_type == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    elif norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(norm_type)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLP (swiglu / geglu / gelu)
# ---------------------------------------------------------------------------

def mlp_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             mlp_type: str, use_bias: bool, dtype: torch.dtype, *,
             device="cuda") -> Params:
    p = {}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype,
                                 device=device)
    p["w_up"] = dense_init(generator, d_model, d_ff, dtype, device=device)
    p["w_down"] = dense_init(generator, d_ff, d_model, dtype, device=device)
    if use_bias:
        p["w_up_b"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["w_down_b"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """x: (..., d_model). The gated forms ignore ``w_up_b``, as the
    reference does; GELU is the tanh approximation."""
    if x.ndim == 3:   # the sequence-sharded residual gathered into the MLP
        x = shard(x, BATCH, None, None)
    w = {k: gathered(v) for k, v in p.items()}
    if mlp_type == "swiglu":
        h = F.silu(x @ w["w_gate"]) * (x @ w["w_up"])
    elif mlp_type == "geglu":
        h = F.gelu(x @ w["w_gate"], approximate="tanh") * (x @ w["w_up"])
    else:
        h = x @ w["w_up"]
        if "w_up_b" in p:
            h = h + p["w_up_b"]
        h = F.gelu(h, approximate="tanh")
    h = shard(h, BATCH, None, "model")
    y = h @ w["w_down"]
    if "w_down_b" in p:
        y = y + p["w_down_b"]
    return shard_residual(y) if y.ndim == 3 else y
