"""The benchmark's frozen arithmetic: the card's peaks and the least time of
a flash call, computed from shapes alone.  The operations and bytes of a
model's calls are its family's (``families/<family>.py``).

Nothing here reads the program.  The flash bound is a copy of
``chip_smoke.flash_bound`` / ``live_pairs`` as of the benchmark's first
version (the bf16 route's three terms: bytes, products, one exp2 a live
pair), kept here so that a later change to the program cannot move it.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence, Tuple

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


def flash_bound_sum(calls: Sequence[Tuple[int, ...]]) -> float:
    """The least time of a list of causal flash calls, each a (B, Sq, Sk,
    H, KV, hd) shape (a family's ``flash_calls``): the bound of each
    distinct shape times the number of its calls, in the order the shapes
    first appear."""

    return sum(n * flash_bound_s(*shape) for shape, n in Counter(calls).items())
