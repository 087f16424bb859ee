"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4 family]: 48 layers,
128-expert top-1 MoE interleaved with dense FFN every other layer,
GQA kv=8, 202k vocab. ~400B total / ~17B active params -> Adafactor + bf16
(Adam's f32 state would need >4.8 TB) (twin of
``repro/configs/llama4_maverick_400b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4_maverick_400b", family="moe",
    num_layers=48, d_model=5120, vocab_size=202_048,
    num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, mlp_type="swiglu",
    num_experts=128, experts_per_token=1, moe_period=2, moe_offset=1,
    layer_pattern=("attn", "attn"),   # period 2: dense FFN / MoE alternation
    capacity_factor=1.0,
    rope_theta=500_000.0,
    cut_periods=6, dtype="bfloat16", param_dtype="bfloat16",
    optimizer="adafactor",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family card)",
)

SMOKE_CONFIG = ArchConfig(
    name="llama4_maverick_400b_smoke", family="moe",
    num_layers=2, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, mlp_type="swiglu",
    num_experts=4, experts_per_token=1, moe_period=2, moe_offset=1,
    layer_pattern=("attn", "attn"),
    cut_periods=0, vocab_pad_to=64, remat=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family card)",
)
