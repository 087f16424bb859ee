"""Model FLOPs of a training step of the split hybrid LM (Mamba-2 and
attention layers, each with top-k experts of which a share is held here,
a shared expert, the tied head), from the configuration's ``model``.

Forward and backward are three times the forward (x3). Per token:
  * the products of each weight a token passes through, 2 FLOPs a
    parameter: the Mamba layers' z / x / BC / dt and out projections, the
    attention layers' q / k / v / o, the router, the shared expert, the
    tied head, and of the routed experts the held share of the top k
    (k·held/E experts a token, 3·d·d_ff parameters each);
  * causal attention at the attention layers only: q·k and p·v, 2·hd
    FLOPs each per (query, key) pair (``lm.causal_pairs``);
  * the chunked SSD's products at the Mamba layers, per chunk of Cs
    positions: C·Bᵀ (2·N a causal pair, shared by the heads), its masked
    product with x·dt (2·P a causal pair and head), the chunk's state
    B ⊗ x·dt (2·N·P a position and head) and the carried state's output
    C·h (2·N·P a position and head).
Counted once: no rematerialization, no capacity padding, no embedding
lookup, no elementwise work.
"""

from __future__ import annotations

from fedbench.counts.lm import causal_pairs


def kinds(c: dict):
    """(Mamba layers, attention layers)."""
    pattern = c["layer_pattern"]
    periods = c["num_layers"] // len(pattern)
    attn = periods * sum(k == "attn" for k in pattern)
    return c["num_layers"] - attn, attn


def product_params_per_token(c: dict) -> float:
    d, hd = c["d_model"], c["head_dim"]
    din = c["ssm_expand"] * d
    n, heads = c["ssm_state"], din // c["ssm_head_dim"]
    mamba, attn = kinds(c)
    e = c["num_experts"]
    held = c.get("experts_held") or e
    per_mamba = d * (2 * din + 2 * n + heads) + din * d
    per_attn = 2 * d * c["num_heads"] * hd + 2 * d * c["num_kv_heads"] * hd
    per_ffn = c["experts_per_token"] * held / e * 3 * d * c["d_ff"] \
        + 3 * d * c["shared_d_ff"] + d * e
    return mamba * per_mamba + attn * per_attn \
        + c["num_layers"] * per_ffn + d * c["vocab_size"]


def ssd_flops_per_sequence(c: dict, seq: int) -> float:
    """Forward FLOPs of one Mamba layer's chunked SSD over one sequence."""
    din = c["ssm_expand"] * c["d_model"]
    n, p = c["ssm_state"], c["ssm_head_dim"]
    heads = din // p
    cs = min(c["ssm_chunk"], seq)
    if seq % cs:
        cs = seq
    pairs = (seq // cs) * cs * (cs + 1) // 2
    return 2 * pairs * (n + heads * p) + 4 * seq * heads * n * p


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    mamba, attn = kinds(c)
    dense = 6 * product_params_per_token(c) * batch * seq
    scores = 3 * 4 * c["head_dim"] * causal_pairs(seq, None) \
        * c["num_heads"] * batch * attn
    ssd = 3 * ssd_flops_per_sequence(c, seq) * batch * mamba
    return float(dense + scores + ssd)
