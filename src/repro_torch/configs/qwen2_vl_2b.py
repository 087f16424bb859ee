"""Qwen2-VL-2B [arXiv:2409.12191]: VLM decoder with M-RoPE (t/h/w frequency
sections of head_dim/2 = 64 -> (16, 24, 24)), GQA kv=2, tied embeddings.
Vision tower is a STUB per the assignment carve-out: batches carry
precomputed patch embeddings (dim 1280) which the in-model projector maps
to d_model (twin of
``repro/configs/qwen2_vl_2b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_2b", family="vlm",
    num_layers=28, d_model=1536, vocab_size=151_936,
    num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, mlp_type="swiglu",
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    vision_embed_dim=1280, vision_tokens_frac=0.25,
    tie_embeddings=True,
    cut_periods=4, dtype="bfloat16", param_dtype="bfloat16", optimizer="adam",
    source="arXiv:2409.12191",
)

SMOKE_CONFIG = ArchConfig(
    name="qwen2_vl_2b_smoke", family="vlm",
    num_layers=2, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, mlp_type="swiglu",
    mrope_sections=(8, 12, 12),
    vision_embed_dim=96, vision_tokens_frac=0.25,
    tie_embeddings=True,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2409.12191",
)
