"""Granite-4.0-H-Small (32B-A9B, ibm-granite/granite-4.0-h-small's
config.json): a Mamba-2 / attention hybrid of 40 layers, a period of 10 (5
Mamba-2, 1 attention, 4 Mamba-2), every layer followed by a mixture of 72
SwiGLU experts of width 768 (top-10, the weights renormalized over the
ten) beside a SwiGLU shared expert of width 1536. The attention is GQA (32
query heads, 8 KV heads, head dim 128) with no position embedding (NoPE)
and the score scale 1/128; the Mamba-2 blocks are SSD with 128 heads of 64,
d_state 128, one B/C group, conv width 4 with a bias, chunk 256. The
embedding is multiplied by 12, each sublayer's output by 0.22 before its
residual add, and the logits divided by 16; the embedding is tied to the
head. The port's own architecture: the reference lists no such model."""

from repro_torch.configs.base import PortArchConfig

SOURCE = ("https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/"
          "config.json")
PATTERN = ("ssm",) * 5 + ("attn",) + ("ssm",) * 4

CONFIG = PortArchConfig(
    name="granite_4p0_h_small", family="hybrid",
    num_layers=40, d_model=4096, vocab_size=100352,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=768, mlp_type="swiglu",
    num_experts=72, experts_per_token=10, moe_period=1,
    capacity_factor=1.25, router_aux_weight=0.001,
    layer_pattern=PATTERN,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=256, tie_embeddings=True, norm_eps=1e-5,
    cut_periods=1,  # the client: the embedding and the first 10 layers
    dtype="bfloat16", param_dtype="bfloat16", optimizer="adafactor",
    source=SOURCE,
    shared_d_ff=1536, embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, attention_multiplier=0.0078125,
    position_embedding="nope", ssm_decay_f32=True,
)

SMOKE_CONFIG = PortArchConfig(
    name="granite_4p0_h_small_smoke", family="hybrid",
    num_layers=4, d_model=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=128, mlp_type="swiglu",
    num_experts=8, experts_per_token=4, moe_period=1,
    capacity_factor=1.25, router_aux_weight=0.001,
    layer_pattern=("ssm", "attn"),
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=32, tie_embeddings=True,
    cut_periods=1, vocab_pad_to=64, remat=False,
    source=SOURCE,
    shared_d_ff=256, experts_held=4, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0,
    attention_multiplier=0.015625, position_embedding="nope",
    ssm_decay_f32=True,
)
