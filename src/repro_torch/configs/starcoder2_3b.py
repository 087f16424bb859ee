"""StarCoder2-3B [arXiv:2402.19173]: dense GQA decoder, 4k sliding window,
learned-free RoPE (theta ~1e5), GELU MLP with biases, LayerNorm (twin of
``repro/configs/starcoder2_3b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_3b", family="dense",
    num_layers=30, d_model=3072, vocab_size=49152,
    num_heads=24, num_kv_heads=2, head_dim=128,
    d_ff=12288, mlp_type="gelu", use_bias=True, norm_type="layernorm",
    rope_theta=999_999.0, sliding_window=4096,
    cut_periods=4, pq_backend="auto",  # the CUDA PQ kernels on a card
    dtype="bfloat16", param_dtype="bfloat16", optimizer="adam",
    source="arXiv:2402.19173",
)

SMOKE_CONFIG = ArchConfig(
    name="starcoder2_3b_smoke", family="dense",
    num_layers=2, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, mlp_type="gelu", use_bias=True, norm_type="layernorm",
    rope_theta=999_999.0, sliding_window=64,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2402.19173",
)
