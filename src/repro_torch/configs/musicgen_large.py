"""MusicGen-large [arXiv:2306.05284]: decoder-only LM over EnCodec tokens —
4 parallel codebooks (vocab 2048 each) with summed embeddings and one LM
head per codebook (the delay-pattern interleave reduces to parallel
per-step prediction at the backbone level). EnCodec itself is a STUB per
the assignment carve-out: batches carry (B, K=4, S) token grids (twin of
``repro/configs/musicgen_large.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_large", family="audio",
    num_layers=48, d_model=2048, vocab_size=2048,
    num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, mlp_type="gelu", use_bias=True, norm_type="layernorm",
    num_codebooks=4,
    cut_periods=6, dtype="bfloat16", param_dtype="bfloat16", optimizer="adam",
    source="arXiv:2306.05284",
)

SMOKE_CONFIG = ArchConfig(
    name="musicgen_large_smoke", family="audio",
    num_layers=2, d_model=256, vocab_size=256,
    num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, mlp_type="gelu", use_bias=True, norm_type="layernorm",
    num_codebooks=4,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2306.05284",
)
