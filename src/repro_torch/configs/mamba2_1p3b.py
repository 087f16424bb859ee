"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD (state-space duality),
48 layers, d_state=128, expand=2, head_dim=64, tied embeddings (twin of
``repro/configs/mamba2_1p3b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_1p3b", family="ssm",
    num_layers=48, d_model=2048, vocab_size=50280,
    d_ff=0, layer_pattern=("ssm",),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=256, tie_embeddings=True,
    cut_periods=6, dtype="bfloat16", param_dtype="bfloat16", optimizer="adam",
    source="arXiv:2405.21060",
)

SMOKE_CONFIG = ArchConfig(
    name="mamba2_1p3b_smoke", family="ssm",
    num_layers=2, d_model=256, vocab_size=512,
    d_ff=0, layer_pattern=("ssm",),
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=32, tie_embeddings=True,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2405.21060",
)
