"""Model / parallelism configuration schema.

Every assigned architecture is expressed as a :class:`ModelConfig` built from
repeating *blocks* of layer positions.  A position specifies its sequence
mixer (full attention, sliding-window attention, or Mamba2 SSD) and its MLP
(dense or MoE).  Models scan over stacked block parameters, so HLO size — and
therefore AOT compile time at 512 devices — is O(block) not O(depth).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------- #
# layer-position specs
# ---------------------------------------------------------------------- #

ATTN = "attn"          # full causal attention
ATTN_LOCAL = "attn_local"  # sliding-window attention
MAMBA = "mamba"        # Mamba2 SSD mixer
MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_NONE = "none"      # mixer-only layers (pure SSM)


@dataclasses.dataclass(frozen=True)
class LayerPos:
    """One layer position inside the repeating block."""

    mixer: str = ATTN
    mlp: str = MLP_DENSE


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # deepseek-style always-on shared experts
    group_size: int = 256        # GShard dispatch group (tokens)
    capacity_factor: float = 1.25
    shard: str = "auto"          # 'auto'|'ep'|'tp' — expert-parallel vs
                                 # tensor-parallel expert weights (§Perf)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256             # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv/mel frontend is a stub: ``input_specs``
    supplies precomputed frame embeddings)."""

    num_layers: int
    num_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # 'decoder' | 'encdec'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    block: Tuple[LayerPos, ...] = (LayerPos(),)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    encoder: Optional[EncoderConfig] = None
    sliding_window: int = 4096
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # modality frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"
    num_patches: int = 0         # vision stub: prefix patch embeddings
    # attention is quadratic in seq — archs whose every block contains a full
    # attention position cannot run long_500k (skip noted in DESIGN.md)
    dtype: str = "bfloat16"
    remat: str = "full"          # 'none' | 'dots' | 'full' (full measured best w/ scan)
    attn_chunk: int = 1024       # flash-style KV chunk for jnp attention
    # int8 KV cache with per-(token,head) scales: ~2x less decode HBM
    # traffic and residency (beyond-paper; §Perf deepseek decode iteration)
    kv_quant: bool = False
    # barrier after residual adds (tried to keep TP all-reduces in bf16;
    # refuted — the f32 ARs are XLA:CPU bf16-dot legalization, and the
    # barrier inflated temp memory 16->110 GB.  Kept for ablation; §Perf it.1)
    pin_collective_dtype: bool = False

    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        if self.num_layers < len(self.block):
            raise ValueError("num_layers smaller than one block")
        if self.family not in ("decoder", "encdec"):
            raise ValueError(self.family)

    @property
    def padded_num_heads(self) -> int:
        """Query heads padded to a multiple of 16 so the head dim shards on
        any model-axis size (llava's 56 → 64).  Padded heads have zeroed
        ``wo`` columns, so they contribute nothing to the output — exact."""

        if self.num_heads % 16 == 0 or self.num_heads < 16:
            return self.num_heads
        return ((self.num_heads + 15) // 16) * 16

    @property
    def padded_vocab_size(self) -> int:
        """Embedding-table rows, padded to a multiple of 512 so the vocab dim
        shards over any model-axis size (logits beyond ``vocab_size`` are
        masked to -inf; labels never reference them).  MaxText-style."""

        pad_to = 512
        return ((self.vocab_size + pad_to - 1) // pad_to) * pad_to

    @property
    def num_blocks(self) -> int:
        return self.num_layers // len(self.block)

    @property
    def remainder_layers(self) -> int:
        return self.num_layers % len(self.block)

    @property
    def sub_quadratic(self) -> bool:
        """True iff no position uses *full* attention (SSM or purely local) —
        the gate for the long_500k shape."""

        return all(p.mixer != ATTN for p in self.block)

    @property
    def has_attention(self) -> bool:
        return any(p.mixer in (ATTN, ATTN_LOCAL) for p in self.block)

    @property
    def has_mamba(self) -> bool:
        return any(p.mixer == MAMBA for p in self.block)

    @property
    def has_moe(self) -> bool:
        return any(p.mlp == MLP_MOE for p in self.block)

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests (same family/pattern, tiny dims)."""

        return dataclasses.replace(self, **overrides)


# ---------------------------------------------------------------------- #
# input shapes assigned to every LM architecture
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch × shape) is a runnable cell, and why not if skipped.

    long_500k needs sub-quadratic attention — run for SSM/hybrid (every
    attention position local or state-space *or* the hybrid jamba case where
    full-attention layers are a 1:7 minority with the KV cache sharded along
    sequence); skip for pure full-attention archs, per the assignment.
    """

    if shape.name == "long_500k":
        attn_frac = sum(p.mixer == ATTN for p in cfg.block) / len(cfg.block)
        if cfg.has_mamba or cfg.sub_quadratic:
            return True, ""
        return False, (
            f"long_500k skipped: {cfg.name} is full-attention "
            f"(attention fraction {attn_frac:.2f}, no state-space path)"
        )
    return True, ""
