"""Llama-3 8B [arXiv:2407.21783]: dense GQA kv=8, SwiGLU, RMSNorm,
128k vocab, rope theta 500k (twin of ``repro/configs/llama3_8b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3_8b", family="dense",
    num_layers=32, d_model=4096, vocab_size=128_256,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, mlp_type="swiglu",
    rope_theta=500_000.0,
    cut_periods=4, pq_backend="auto",  # the CUDA PQ kernels on a card
    dtype="bfloat16", param_dtype="bfloat16", optimizer="adam",
    source="arXiv:2407.21783",
)

SMOKE_CONFIG = ArchConfig(
    name="llama3_8b_smoke", family="dense",
    num_layers=2, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, mlp_type="swiglu",
    rope_theta=500_000.0,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="arXiv:2407.21783",
)
