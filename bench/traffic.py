"""The one traffic generator: every mix of ``bench/traffic/*.json`` is a set
of parameters that these functions read, whatever its kind.

* ``train``: token blocks from a copy of the port's synthetic data stream
  (``data/pipeline._batch_tokens``: a counter-mode hash of seed, step, row
  and position with a triangular marginal over the vocab), one block a
  step, so every step's rows differ.
* ``prefill_closed``: one client; call ``i`` is a batch of prompts of one
  length.  The lengths come in blocks that hold each length of the mix
  once, in an order drawn from the seed, so every seed sends the same
  sizes.  The prompt tokens are uniform over the vocab.
* ``decode_pool``: one batch of prompts of one length, uniform tokens.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

_MASK = (1 << 64) - 1


def train_tokens(seed: int, step: int, batch: int, seq_len: int, vocab: int) -> np.ndarray:
    """(batch, seq_len + 1) int32 tokens for ``step``: a pure function of
    (seed, step, row, position)."""

    rows = np.arange(batch, dtype=np.uint64)[:, None]
    pos = np.arange(seq_len + 1, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        x = (rows * np.uint64(0x9E3779B97F4A7C15)
             + pos * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64((step * 0x94D049BB133111EB) & _MASK)
             + np.uint64((seed * 0xD6E8FEB86659FD93) & _MASK))
        x ^= x >> np.uint64(31)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
    v = np.uint64(vocab)
    return (((x % v) + ((x >> np.uint64(32)) % v)) // np.uint64(2)).astype(np.int32)


def train_batch(mix: dict, seed: int, step: int, vocab: int, device) -> Dict[str, torch.Tensor]:
    block = train_tokens(seed, step, mix["batch"], mix["seq_len"], vocab)
    return {"tokens": torch.from_numpy(block[:, :-1].copy()).to(device),
            "labels": torch.from_numpy(block[:, 1:].copy()).to(device)}


def prefill_lengths(mix: dict, seed: int, calls: int) -> List[int]:
    """The prompt length of each of the first ``calls`` calls."""

    rng = np.random.default_rng([seed & _MASK, 0x5EED])
    lengths = list(mix["lengths"])
    out: List[int] = []
    while len(out) < calls:
        out += [lengths[i] for i in rng.permutation(len(lengths))]
    return out[:calls]


def prompts(seed: int, stream: int, batch: int, length: int, vocab: int, device) -> torch.Tensor:
    """(batch, length) int32 tokens, uniform over the vocab, drawn on
    ``device`` from a generator seeded by (seed, stream)."""

    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) & _MASK)
    return torch.randint(0, vocab, (batch, length), generator=gen, device=device,
                         dtype=torch.int32)


def sample(seed: int, salt: int, n: int, k: int) -> List[int]:
    """``k`` distinct indices of ``range(n)`` drawn from the seed."""

    rng = np.random.default_rng([seed & _MASK, salt])
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))
