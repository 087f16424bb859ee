"""Model FLOPs of a training step of the split LM (dense attention
projections, top-k experts, the LM head), from the configuration.

6 FLOPs per active parameter of the products and per token (forward 2,
backward 4), plus causal attention: q·k and p·v, 2·hd FLOPs each per
(query, key) pair in the window, forward and backward (x3). Counted once:
no rematerialization, no capacity padding, no embedding lookup.
"""

from __future__ import annotations


def product_params_per_token(c: dict) -> int:
    d, hd = c["d_model"], c["head_dim"]
    q, kv = c["num_heads"] * hd, c["num_kv_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    experts = c["experts_per_token"] * 3 * d * c["d_ff"]
    router = d * c["num_experts"]
    return c["num_layers"] * (attn + experts + router) \
        + d * c["vocab_size"]


def causal_pairs(seq: int, window) -> int:
    w = seq if window is None else min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    tokens = batch * seq
    dense = 6 * product_params_per_token(c) * tokens
    attn = 3 * 4 * c["head_dim"] * causal_pairs(seq, c.get("sliding_window")) \
        * c["num_heads"] * batch * c["num_layers"]
    return float(dense + attn)
