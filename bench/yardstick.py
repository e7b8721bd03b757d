"""The benchmark's frozen arithmetic: the card's peaks, and the operations
and bytes that each timed call needs, computed from shapes alone.

Nothing here reads the program.  The flash bound is a copy of
``chip_smoke.flash_bound`` / ``live_pairs`` as of the benchmark's first
version (the bf16 route's three terms: bytes, products, one exp2 a live
pair), kept here so that a later change to the program cannot move it.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM, dense rates at the 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# ex2 on the special-function units: 16 a clock an SM, 132 SMs, at the
# 1830 MHz that the bf16 figure assumes
EX2_PER_S = 16 * 132 * 1830e6
BF16 = 2  # bytes


def live_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int],
               q_offset: int = 0) -> int:
    """The (query, key) pairs the mask keeps: query i at position
    ``q_offset + i`` sees keys ``(pos - window, pos]`` when causal."""

    total = 0
    for i in range(Sq):
        q = q_offset + i
        hi = min(q + 1, Sk) if causal else Sk
        lo = max(q - window + 1, 0) if window is not None else 0
        total += max(hi - lo, 0)
    return total


def causal_pairs(S: int) -> int:
    """``live_pairs(S, S, True, None)`` in closed form."""

    return S * (S + 1) // 2


def flash_bound_s(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                  causal: bool = True, window: Optional[int] = None) -> float:
    """The least time of one bf16 flash call: the largest of each input
    read once and the output written once over the memory rate, QK^T and
    PV on the live pairs over the bf16 peak, and one exp2 a live pair over
    the special-function units' rate."""

    pairs = B * H * (causal_pairs(Sq) if causal and window is None and Sq == Sk
                     else live_pairs(Sq, Sk, causal, window))
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * BF16
    return max(nbytes / HBM_BYTES_PER_S, 4.0 * hd * pairs / PEAK_BF16_FLOPS,
               pairs / EX2_PER_S)


def layer_matmul_params(dims) -> int:
    """Weights of one decoder layer that enter a product: the q, k, v and
    output projections and the three SwiGLU matrices."""

    d, H, KV, hd, ff = dims.d_model, dims.num_heads, dims.num_kv_heads, dims.head_dim, dims.d_ff
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff


def head_params(dims) -> int:
    """The LM head over the real vocabulary (the padded columns are no
    model work)."""

    return dims.d_model * dims.vocab_size


def attention_fwd_flops(dims, B: int, S: int) -> float:
    """QK^T and PV of a causal self-attention over S positions, every
    layer: 2 products x 2 FLOP a multiply-add x hd, on the live pairs."""

    return 4.0 * dims.head_dim * dims.num_heads * B * causal_pairs(S) * dims.num_layers


def train_step_flops(dims, B: int, S: int) -> float:
    """Model FLOPs of one training step: 6 a weight a token for the
    products (the head at every position) and attention forward plus its
    backward (twice the forward).  Remat's recompute is not model work."""

    n = dims.num_layers * layer_matmul_params(dims) + head_params(dims)
    return 6.0 * n * B * S + 3.0 * attention_fwd_flops(dims, B, S)


def prefill_flops(dims, B: int, S: int) -> float:
    """Model FLOPs of a prefill call: 2 a weight a token through the layers,
    the head at the last position only (as the serve path computes it),
    and causal attention forward."""

    return (2.0 * dims.num_layers * layer_matmul_params(dims) * B * S
            + 2.0 * head_params(dims) * B + attention_fwd_flops(dims, B, S))


def decode_step_bytes(dims, B: int, cache_len: int) -> float:
    """HBM bytes one decode step needs: every layer weight and the head read
    once, the B embedding rows, the norm scales (f32), the K/V of the
    ``cache_len`` live positions read once and the new K/V written once."""

    weights = (dims.num_layers * layer_matmul_params(dims) + head_params(dims)) * BF16
    weights += B * dims.d_model * BF16 + (2 * dims.num_layers + 1) * dims.d_model * 4
    kv_row = 2 * dims.num_kv_heads * dims.head_dim * BF16 * dims.num_layers
    return weights + B * cache_len * kv_row + B * kv_row
