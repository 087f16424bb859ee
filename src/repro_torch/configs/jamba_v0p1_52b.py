"""Jamba-v0.1 52B [arXiv:2403.19887]: hybrid Mamba/attention 7:1 interleave
(one attention block per 8 layers), MoE (16 experts top-2) on every other
layer. SSM blocks implemented as Mamba-2/SSD (paper-Jamba
uses Mamba-1) (twin of
``repro/configs/jamba_v0p1_52b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba_v0p1_52b", family="hybrid",
    num_layers=32, d_model=4096, vocab_size=65536,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, mlp_type="swiglu",
    num_experts=16, experts_per_token=2, moe_period=2, moe_offset=1,
    capacity_factor=1.25,
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=256,
    cut_periods=1,  # 8 of 32 layers on clients
    train_microbatches=8,   # grad accumulation: SSD + MoE activations are
                            # the largest in the fleet
    dtype="bfloat16", param_dtype="bfloat16", optimizer="adafactor",
    source="arXiv:2403.19887",
)

SMOKE_CONFIG = ArchConfig(
    name="jamba_v0p1_52b_smoke", family="hybrid",
    num_layers=4, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, mlp_type="swiglu",
    num_experts=4, experts_per_token=2, moe_period=2, moe_offset=1,
    layer_pattern=("ssm", "attn"),
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=32,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2403.19887",
)
