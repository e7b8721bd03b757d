"""The dense llama-form decoder: every layer RMSNorm, grouped-query causal
attention with rotary embeddings, RMSNorm and a SwiGLU MLP; a final RMSNorm
and the head.  ``reference/decoder.py`` is its plain reference.

The configuration file keeps the published ``config.json``'s keys with the
values as run; ``published`` holds the source's value of every key that
differs, and ``BENCHMARK.json`` lists those keys under ``reduced``.
:func:`dims` refuses a file that the decoder cannot run as written (a
multiplier other than the plain llama form).  The embedding table's padded
row count is the port's own rule; ``harness.sized`` fills ``padded_vocab``
from :func:`port_config`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import yardstick
from reference.decoder import (  # noqa: F401  (the family's plain reference)
    cross_entropy, exact, fp8, last_logits, served_gaps, train)
from weights import Path, Spec

BF16 = yardstick.BF16
EMBED_SCALE = 0.02


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    score_scale: float
    dtype: str
    tie_embeddings: bool
    padded_vocab: int = 0


def dims(name: str, raw: dict) -> Dims:
    d, H = raw["hidden_size"], raw["num_attention_heads"]
    hd = raw.get("head_dim", d // H)
    for key, plain in (("embedding_multiplier", 1.0), ("residual_multiplier", 1.0),
                       ("logits_scaling", 1.0)):
        if raw.get(key, plain) != plain:
            raise ValueError(f"{name}: {key}={raw[key]!r}; the decoder runs only {plain!r}")
    if raw.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{name}: hidden_act {raw['hidden_act']!r}; the decoder runs silu")
    scale = raw.get("attention_multiplier", hd**-0.5)
    if abs(scale - hd**-0.5) > 1e-12:
        raise ValueError(f"{name}: attention_multiplier {scale}; the decoder scales by hd**-0.5")
    return Dims(
        name=name,
        num_layers=raw["num_hidden_layers"],
        d_model=d,
        num_heads=H,
        num_kv_heads=raw["num_key_value_heads"],
        head_dim=hd,
        d_ff=raw["intermediate_size"],
        vocab_size=raw["vocab_size"],
        rope_theta=float(raw["rope_theta"]),
        norm_eps=float(raw["rms_norm_eps"]),
        score_scale=float(scale),
        dtype=raw.get("torch_dtype", "bfloat16"),
        tie_embeddings=bool(raw.get("tie_word_embeddings", False)),
    )


def port_config(d: Dims, **overrides):
    """The port's configuration object for these sizes; ``overrides`` (a
    mix's ``remat``) are further fields of it."""

    from repro_torch.configs.base import ATTN, MLP_DENSE, LayerPos, ModelConfig

    cfg = ModelConfig(
        name=d.name, family="decoder", num_layers=d.num_layers, d_model=d.d_model,
        num_heads=d.num_heads, num_kv_heads=d.num_kv_heads, head_dim=d.head_dim,
        d_ff=d.d_ff, vocab_size=d.vocab_size, block=(LayerPos(mixer=ATTN, mlp=MLP_DENSE),),
        rope_theta=d.rope_theta, norm_eps=d.norm_eps, dtype=d.dtype,
        tie_embeddings=d.tie_embeddings, **overrides,
    )
    if cfg.padded_num_heads != d.num_heads:
        raise ValueError(f"{d.name}: the port pads the heads")
    return cfg


def leaf_specs(d: Dims) -> List[Spec]:
    """(path in the port's tree, shape, init) of every leaf, in draw order."""

    specs = embed_specs(d)
    for b in range(d.num_layers):
        p = ("blocks", b, "pos0")
        specs += attention_specs(d, p) + mlp_specs(d, p)
    specs.append((("final_norm", "scale"), (d.d_model,), "ones"))
    return specs


def embed_specs(d) -> List[Spec]:
    """The embedding table, padded as the port pads it, and the head unless
    it is tied (then the head is the table's transpose)."""

    specs = [(("embed", "tok"), (d.padded_vocab, d.d_model), EMBED_SCALE)]
    if not d.tie_embeddings:
        specs.append((("embed", "head"), (d.d_model, d.padded_vocab), EMBED_SCALE))
    return specs


def attention_specs(d, p: Path) -> List[Spec]:
    """A layer's first norm and its attention, under ``p``."""

    dm, H, KV, hd = d.d_model, d.num_heads, d.num_kv_heads, d.head_dim
    if H % 16 and H > 16:
        raise ValueError(f"{d.name}: {H} query heads would be padded by the port")
    return [
        (p + ("norm1", "scale"), (dm,), "ones"),
        (p + ("attn", "wq"), (dm, H, hd), dm**-0.5),
        (p + ("attn", "wk"), (dm, KV, hd), dm**-0.5),
        (p + ("attn", "wv"), (dm, KV, hd), dm**-0.5),
        (p + ("attn", "wo"), (H, hd, dm), (H * hd) ** -0.5),
    ]


def mlp_specs(d, p: Path) -> List[Spec]:
    """A layer's second norm and its SwiGLU MLP, under ``p``."""

    dm, ff = d.d_model, d.d_ff
    return [
        (p + ("norm2", "scale"), (dm,), "ones"),
        (p + ("mlp", "w_gate"), (dm, ff), dm**-0.5),
        (p + ("mlp", "w_up"), (dm, ff), dm**-0.5),
        (p + ("mlp", "w_down"), (ff, dm), ff**-0.5),
    ]


# ---------------------------------------------------------------------- #
# the arithmetic
# ---------------------------------------------------------------------- #

def layer_matmul_params(d: Dims) -> int:
    """Weights of one decoder layer that enter a product: the q, k, v and
    output projections and the three SwiGLU matrices."""

    dm, H, KV, hd, ff = d.d_model, d.num_heads, d.num_kv_heads, d.head_dim, d.d_ff
    return dm * (H + 2 * KV) * hd + H * hd * dm + 3 * dm * ff


def head_params(d: Dims) -> int:
    """The LM head over the real vocabulary (the padded columns are no
    model work)."""

    return d.d_model * d.vocab_size


def attention_fwd_flops(d: Dims, B: int, S: int) -> float:
    """QK^T and PV of a causal self-attention over S positions, every
    layer: 2 products x 2 FLOP a multiply-add x hd, on the live pairs."""

    return 4.0 * d.head_dim * d.num_heads * B * yardstick.causal_pairs(S) * d.num_layers


def train_step_flops(d: Dims, B: int, S: int) -> float:
    """Model FLOPs of one training step: 6 a weight a token for the
    products (the head at every position) and attention forward plus its
    backward (twice the forward).  Remat's recompute is not model work."""

    n = d.num_layers * layer_matmul_params(d) + head_params(d)
    return 6.0 * n * B * S + 3.0 * attention_fwd_flops(d, B, S)


def prefill_flops(d: Dims, B: int, S: int) -> float:
    """Model FLOPs of a prefill call: 2 a weight a token through the layers,
    the head at the last position only (as the serve path computes it),
    and causal attention forward."""

    return (2.0 * d.num_layers * layer_matmul_params(d) * B * S
            + 2.0 * head_params(d) * B + attention_fwd_flops(d, B, S))


def decode_step_bytes(d: Dims, B: int, cache_len: int) -> float:
    """HBM bytes one decode step needs: every layer weight and the head read
    once, the B embedding rows, the norm scales (f32), the K/V of the
    ``cache_len`` live positions read once and the new K/V written once."""

    weights = (d.num_layers * layer_matmul_params(d) + head_params(d)) * BF16
    weights += B * d.d_model * BF16 + (2 * d.num_layers + 1) * d.d_model * 4
    kv_row = 2 * d.num_kv_heads * d.head_dim * BF16 * d.num_layers
    return weights + B * cache_len * kv_row + B * kv_row


def flash_calls(d: Dims, B: int, S: int) -> List[Tuple[int, ...]]:
    """A prefill call's flash calls: one causal S x S call a layer."""

    return [(B, S, S, d.num_heads, d.num_kv_heads, d.head_dim)] * d.num_layers
