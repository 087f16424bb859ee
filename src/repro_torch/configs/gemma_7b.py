"""Gemma-7B [arXiv:2403.08295]: dense MHA (kv=16 = heads), head_dim=256,
GeGLU, RMSNorm, tied + sqrt(d)-scaled embeddings, 256k vocab — the LM head
alone is ~0.79B params, the paper's motivating 'classification layer
dominates client memory' regime (twin of
``repro/configs/gemma_7b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma_7b", family="dense",
    num_layers=28, d_model=3072, vocab_size=256_000,
    num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, mlp_type="geglu",
    tie_embeddings=True, scale_embed=True,
    cut_periods=3, dtype="bfloat16", param_dtype="bfloat16", optimizer="adam",
    source="arXiv:2403.08295",
)

SMOKE_CONFIG = ArchConfig(
    name="gemma_7b_smoke", family="dense",
    num_layers=2, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, mlp_type="geglu",
    tie_embeddings=True, scale_embed=True,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2403.08295",
)
