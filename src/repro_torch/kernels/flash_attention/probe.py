"""One-hot probes of a flash-attention kernel: inputs whose output is known
exactly, so that a layout mistake shows position by position.

Each query row puts a score margin of at least :data:`MARGIN` (after the
``hd**-0.5`` scale) on one live key, drawn at random among the keys its
mask keeps.  Every other live key then gets a softmax weight below
``exp(-MARGIN)``, which is 0 in f32, so the output row is that key's v row
bit for bit, in f32 and in bf16 alike (every value here is exact in bf16).
With ``identity_v`` the v rows are unit vectors (key j is ``e_{j mod hd}``),
so the output returns P itself: a P fragment in the wrong place, a V
operand read transposed or a descriptor stride in the wrong position moves
the one 1 of a row.

The keys are random ±1 vectors, distinct within a head, and query row i
is ``λ k_{π(i)}``: its score on key j is ``λ (hd - k_{π(i)} · k_j) /
sqrt(hd)`` below the chosen key's; λ is the least power of two that lifts
the smallest such margin over all rows to :data:`MARGIN`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

MARGIN = 128.0  # exp(-128) is 0 in f32 (below half the least subnormal)


def live_range(Sq: int, Sk: int, causal: bool, window: Optional[int]):
    """The keys ``[lo, hi)`` each query position keeps."""

    qp = np.arange(Sq)
    hi = np.minimum(qp + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qp - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    return lo, hi


def one_hot_probe(
    B: int,
    Sq: int,
    Sk: int,
    H: int,
    KV: int,
    hd: int,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    identity_v: bool = False,
    seed: int = 0,
    first_picks: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(q, k, v, expected)`` as float32 arrays in the wrapper's layout (q
    and ``expected`` ``(B, Sq, H, hd)``, k and v ``(B, Sk, KV, hd)``).

    Each (b, h, query) row picks a random live key; ``first_picks`` sets
    the keys of the first rows in that order (row-major over (B, H, Sq)),
    so that a probe can hold given keys, such as the last tile's."""

    rng = np.random.default_rng(seed)
    lo, hi = live_range(Sq, Sk, causal, window)
    if np.any(hi <= lo):
        raise ValueError("one_hot_probe: a query row keeps no key")
    if Sk > 2**min(hd, 62):
        raise ValueError(f"one_hot_probe: {Sk} keys cannot have distinct codes of {hd} signs")
    signs = np.array([-1.0, 1.0], np.float32)
    k = rng.choice(signs, size=(B, Sk, KV, hd))
    # a head's keys have distinct codes: a code drawn twice is drawn again
    # (at hd 16 a few hundred keys share some code; from hd 32 on, none)
    for b in range(B):
        for g in range(KV):
            while True:
                _, first = np.unique(k[b, :, g], axis=0, return_index=True)
                again = np.setdiff1d(np.arange(Sk), first)
                if again.size == 0:
                    break
                k[b, again, g] = rng.choice(signs, size=(again.size, hd))
    pick = lo + (rng.random((B, H, Sq)) * (hi - lo)).astype(np.int64)  # (B, H, Sq)
    if first_picks is not None:
        first = np.asarray(first_picks, np.int64).ravel()
        rows = np.arange(first.size) % Sq
        if first.size > pick.size or np.any(first < lo[rows]) or np.any(first >= hi[rows]):
            raise ValueError("one_hot_probe: first_picks holds a key its row does not keep")
        pick.ravel()[: first.size] = first
    kv_of = np.arange(H) // (H // KV)
    b_idx = np.arange(B)[:, None, None]
    chosen = k[b_idx, pick, kv_of[None, :, None]]  # (B, H, Sq, hd)

    # the smallest raw margin hd - k_pick . k_j over the other live keys
    keys = k.transpose(0, 2, 3, 1)[:, kv_of]  # (B, H, hd, Sk)
    dots = np.matmul(chosen, keys)  # (B, H, Sq, Sk), integers
    kp = np.arange(Sk)
    other = (kp[None, :] >= lo[:, None]) & (kp[None, :] < hi[:, None])
    other = other[None, None] & (kp[None, None, None, :] != pick[..., None])
    worst = np.where(other, dots, -np.inf).max()
    margin = hd - worst if np.isfinite(worst) else float(hd)
    if margin <= 0:
        raise ValueError("one_hot_probe: two live keys share a code; change the seed")
    lam = 2.0 ** math.ceil(math.log2(MARGIN / (hd**-0.5 * margin)))

    q = (lam * chosen).transpose(0, 2, 1, 3).astype(np.float32)  # (B, Sq, H, hd)
    if identity_v:
        v = np.zeros((B, Sk, KV, hd), np.float32)
        v[:, kp, :, kp % hd] = 1.0
    else:  # multiples of 1/16 in [-8, 8): exact in bf16
        v = (rng.integers(-128, 128, size=(B, Sk, KV, hd)) / 16.0).astype(np.float32)
    expected = v[b_idx, pick, kv_of[None, :, None]].transpose(0, 2, 1, 3)
    return q, k.astype(np.float32), v, np.ascontiguousarray(expected)


def split_edge_picks(Sk: int, splits: int, rows: int, tile: int = 64) -> np.ndarray:
    """First picks for :func:`one_hot_probe` on a non-causal call that the
    ``flash_decode`` route cuts into ``splits`` key ranges of ``ceil(Sk /
    splits)`` keys: the key before the last range, the range's first key,
    then the keys of its last (ragged) ``tile``-key tile from the end, at
    most ``rows`` of them (one a probe row)."""

    chunk = -(-Sk // splits)
    first = (splits - 1) * chunk
    if splits < 2 or first >= Sk:
        raise ValueError(f"split_edge_picks: {splits} ranges of {Sk} keys have no last range")
    last_tile = first + (Sk - 1 - first) // tile * tile
    picks = np.concatenate([[first - 1, first], np.arange(Sk - 1, last_tile - 1, -1)])
    return picks[:rows]
