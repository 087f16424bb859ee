"""Architecture and input-shape configuration (twin of
``repro/configs/base.py``).

Every architecture the port runs has a ``configs/<id>.py`` exporting
``CONFIG`` (the exact published shape) and ``SMOKE_CONFIG`` (a reduced
variant of the same family, for the CPU tests). The fields, their defaults
and the derived properties are the reference's, value for value;
``compute_dtype`` returns a ``torch.dtype``. ``get_arch`` resolves every
id of ``ARCH_IDS``, and the port's own ids (``PORT_ARCH_IDS``: models the
reference does not list), whose configs are ``PortArchConfig``: the
reference's fields and the port-only ones after them.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention ----------------------------------------------------------
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None    # tokens; None = full attention
    mrope_sections: Optional[Tuple[int, int, int]] = None  # VLM M-RoPE (t,h,w)
    # mlp ------------------------------------------------------------------
    d_ff: int = 0
    mlp_type: str = "swiglu"          # swiglu | geglu | gelu
    use_bias: bool = False
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # MoE --------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1               # layer i is MoE iff i % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM / hybrid -------------------------------------------------------
    layer_pattern: Tuple[str, ...] = ("attn",)   # repeated block pattern
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # modality frontends ---------------------------------------------------
    vision_embed_dim: int = 0         # >0: model has a vision projector input
    vision_tokens_frac: float = 0.25  # fraction of seq that is vision tokens
    num_codebooks: int = 1            # musicgen: 4 parallel EnCodec streams
    # embeddings -------------------------------------------------------------
    tie_embeddings: bool = False
    scale_embed: bool = False         # gemma-style sqrt(d) embedding scale
    vocab_pad_to: int = 256
    # FedLite split --------------------------------------------------------
    cut_periods: int = 1              # client keeps embed + this many periods
    pq_backend: str = "auto"          # quantizer backend: torch | cuda | auto
    # per-direction cut-layer codecs (core/compressors.py spec strings)
    uplink_compressor: str = "pq"
    downlink_compressor: str = "none"
    # cross-round PQ codebook reuse (core/quantizer.QuantizerState)
    pq_warm_iters: Optional[int] = None
    pq_delta_bits: int = 0            # 0 = fresh fp16 codebooks every round
    # numerics / memory -----------------------------------------------------
    dtype: str = "float32"            # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"        # "full" | "dots" (save matmul outputs)
    attn_q_chunk: int = 512           # row-block size for chunked attention
    train_microbatches: int = 1       # in-step gradient accumulation
    optimizer: str = "adam"           # default training optimizer
    source: str = ""                  # citation

    # the port-only knobs at the values that change nothing: fields of
    # ``PortArchConfig`` only, so ArchConfig's fields stay the reference's
    shared_d_ff = 0
    experts_held = 0
    first_expert_held = 0
    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    logits_scaling = 1.0
    attention_multiplier = None
    position_embedding = "rope"
    ssm_decay_f32 = False

    # ---- derived -----------------------------------------------------------
    def __post_init__(self):
        period = len(self.layer_pattern)
        if self.num_layers % period != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {period}")
        if self.moe_period and period % self.moe_period != 0 and self.num_experts:
            raise ValueError(f"{self.name}: pattern period must contain whole moe periods")
        if self.num_periods <= self.cut_periods:
            raise ValueError(f"{self.name}: cut_periods must leave server layers")

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / self.vocab_pad_to) * self.vocab_pad_to)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def block_kind(self, pos: int) -> str:
        return self.layer_pattern[pos % self.period]

    def is_moe_layer(self, layer_idx: int) -> bool:
        return bool(self.num_experts) and (layer_idx % self.moe_period == self.moe_offset)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # parameter count (for MODEL_FLOPS = 6·N·D roofline term) --------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts top-k experts only."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V * self.num_codebooks
        if self.vision_embed_dim:
            n += self.vision_embed_dim * D
        for i in range(self.num_layers):
            kind = self.block_kind(i)
            if kind == "attn":
                n += D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            else:  # ssm
                din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                proj_out = 2 * din + 2 * N + H
                n += D * proj_out + din * D + self.ssm_conv_width * (din + 2 * N)
            if self.is_moe_layer(i):
                e = self.experts_per_token if active_only else self.num_experts
                n += e * (3 if self.mlp_type in ("swiglu", "geglu") else 2) * D * F
                n += D * self.num_experts  # router
            elif F:
                n += (3 if self.mlp_type in ("swiglu", "geglu") else 2) * D * F
            n += 2 * D  # norms
        return n


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An ``ArchConfig`` with the port-only fields, whose defaults change
    nothing (the twinned configs run exactly as they would without them).

    * ``shared_d_ff``: a SwiGLU shared expert of this width beside every
      MoE layer's routed experts (0: none);
    * ``experts_held`` / ``first_expert_held``: this chip's share of each
      MoE layer under expert parallelism, the experts
      [first, first + held) (0: all). The router keeps its
      ``num_experts`` outputs and top-k over all of them, the capacity is
      the whole layer's; only the pairs routed to the held experts are
      computed;
    * ``embedding_multiplier`` (the embedding times it),
      ``residual_multiplier`` (each sublayer's output times it before
      the residual add), ``logits_scaling`` (the logits divided by it);
    * ``attention_multiplier``: the score scale (None: 1/√head_dim);
      ``position_embedding``: "rope", or "nope" for no rotary;
    * ``ssm_decay_f32``: the SSD's decay (dt·A, its cumulative sums and
      exponentials) and the carried state in f32 whatever the stream's
      dtype, as mamba_ssm's kernels keep them; off, the decay takes the
      stream's dtype, as the reference's scan does.
    """
    shared_d_ff: int = 0
    experts_held: int = 0
    first_expert_held: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: Optional[float] = None
    position_embedding: str = "rope"          # rope | nope
    ssm_decay_f32: bool = False

    def __post_init__(self):
        # a pattern read from JSON is a list: the same pattern as a tuple
        object.__setattr__(self, "layer_pattern", tuple(self.layer_pattern))
        super().__post_init__()
        held = self.experts_held or self.num_experts
        if not 0 <= self.first_expert_held <= self.num_experts - held:
            raise ValueError(f"{self.name}: experts [{self.first_expert_held}"
                             f", +{held}) are not among {self.num_experts}")
        if self.position_embedding not in ("rope", "nope"):
            raise ValueError(f"{self.name}: position_embedding "
                             f"{self.position_embedding!r}")

    def param_count(self, active_only: bool = False) -> int:
        """The reference's count with the held experts in place of all
        (top-k of them where ``active_only``) and the shared experts."""
        n = super().param_count(active_only)
        per = (3 if self.mlp_type in ("swiglu", "geglu") else 2) \
            * self.d_model
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        if self.experts_held and not active_only:
            n -= moe_layers * (self.num_experts - self.experts_held) \
                * per * self.d_ff
        return n + moe_layers * per * self.shared_d_ff


# ----------------------------------------------------------------------------
# input shapes
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "starcoder2_3b",
    "mamba2_1p3b",
    "mixtral_8x22b",
    "jamba_v0p1_52b",
    "gemma_7b",
    "llama4_maverick_400b",
    "qwen2_vl_2b",
    "musicgen_large",
    "llama3_8b",
    "command_r_35b",
]

# the port's own architectures: no twin in the reference's ARCH_IDS
PORT_ARCH_IDS = [
    "granite_4p0_h_small",
]


# archs whose long_500k decode runs: sub-quadratic attention or state
LONG_CONTEXT_CAPABLE = {
    "starcoder2_3b",      # native 4k sliding window
    "mamba2_1p3b",        # SSM state decode
    "mixtral_8x22b",      # sliding-window attention
    "jamba_v0p1_52b",     # hybrid: mamba state + few attn layers
}


def supports_shape(arch_name: str, shape_name: str) -> bool:
    """False for long_500k on an arch with full attention only."""
    if shape_name == "long_500k":
        return arch_name in LONG_CONTEXT_CAPABLE
    return True


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    """Load an architecture config by id (also accepts '-' for '_')."""
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS + PORT_ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; known: "
                         f"{', '.join(ARCH_IDS + PORT_ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def all_archs(smoke: bool = False):
    return {a: get_arch(a, smoke=smoke) for a in ARCH_IDS}
