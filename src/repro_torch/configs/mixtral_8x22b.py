"""Mixtral-8x22B [arXiv:2401.04088]: 56-layer MoE, 8 experts top-2 on every
layer, GQA kv=8, SWA (per assignment), SwiGLU, RMSNorm. ~141B params ->
Adafactor + bf16 so the optimizer state stays small (twin of
``repro/configs/mixtral_8x22b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x22b", family="moe",
    num_layers=56, d_model=6144, vocab_size=32768,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, mlp_type="swiglu",
    num_experts=8, experts_per_token=2, moe_period=1, capacity_factor=1.25,
    rope_theta=1_000_000.0, sliding_window=4096,
    cut_periods=7, train_microbatches=2,
    dtype="bfloat16", param_dtype="bfloat16",
    optimizer="adafactor",
    source="arXiv:2401.04088",
)

SMOKE_CONFIG = ArchConfig(
    name="mixtral_8x22b_smoke", family="moe",
    num_layers=2, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, mlp_type="swiglu",
    num_experts=4, experts_per_token=2, moe_period=1, capacity_factor=1.25,
    sliding_window=64,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2401.04088",
)
