"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]: dense GQA kv=8,
no biases, LayerNorm, tied embeddings, 256k vocab (twin of
``repro/configs/command_r_35b.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command_r_35b", family="dense",
    num_layers=40, d_model=8192, vocab_size=256_000,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22528, mlp_type="swiglu", norm_type="layernorm", use_bias=False,
    rope_theta=8_000_000.0, tie_embeddings=True,
    cut_periods=5, dtype="bfloat16", param_dtype="bfloat16", optimizer="adam",
    source="hf:CohereForAI/c4ai-command-r-v01",
)

SMOKE_CONFIG = ArchConfig(
    name="command_r_35b_smoke", family="dense",
    num_layers=2, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, mlp_type="swiglu", norm_type="layernorm", use_bias=False,
    rope_theta=8_000_000.0, tie_embeddings=True,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
