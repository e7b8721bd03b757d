"""Deterministic synthetic token pipeline: sharded, resumable, prefetching.

Production shape without production data: a seeded token stream whose
content is a pure function of (seed, step, position) — so a restart from a
checkpointed ``DataState`` reproduces the exact batch sequence (tested), and
every data-parallel host can generate ONLY its shard (no central dispenser,
scales to any host count).

``host_batch_slice`` mirrors how a multi-host deployment would carve the
global batch: host h of H owns rows [h·B/H, (h+1)·B/H).  On this single-
process container the "hosts" are simulated, but the slicing/resume logic is
the part that must be correct at 1000 nodes — and is what the tests cover.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataState:
    """Everything needed to resume the stream exactly."""

    seed: int
    step: int

    def advance(self, n: int = 1) -> "DataState":
        return DataState(seed=self.seed, step=self.step + n)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    def __post_init__(self) -> None:
        assert self.global_batch % self.num_hosts == 0
        assert 0 <= self.host_id < self.num_hosts

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts


def _batch_tokens(
    cfg: DataConfig, model_cfg: ModelConfig, state: DataState
) -> np.ndarray:
    """Token block for THIS host at ``state.step`` — pure function of
    (seed, step, global row, position)."""

    rows = np.arange(
        cfg.host_id * cfg.host_batch, (cfg.host_id + 1) * cfg.host_batch
    )
    # counter-mode "philox-lite": cheap, deterministic, order-free
    pos = np.arange(cfg.seq_len + 1, dtype=np.uint64)
    r = rows.astype(np.uint64)[:, None]
    mask = (1 << 64) - 1  # fold the step/seed terms in Python ints — numpy
    # scalar uint64 multiplies warn on the (intended) wraparound
    x = (
        r * np.uint64(0x9E3779B97F4A7C15)
        + pos[None, :] * np.uint64(0xBF58476D1CE4E5B9)
        + np.uint64((state.step * 0x94D049BB133111EB) & mask)
        + np.uint64((state.seed * 0xD6E8FEB86659FD93) & mask)
    )
    x ^= x >> np.uint64(31)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    # triangular marginal over the vocab (mean of two independent draws):
    # entropy sits ~0.3 nats below log(vocab), so a model CAN learn the
    # stream's statistics — uniform tokens put the loss at its floor on
    # step 0 and make any "loss decreases" check a coin flip
    v = np.uint64(model_cfg.vocab_size)
    lo = x % v
    hi = (x >> np.uint64(32)) % v
    return ((lo + hi) // np.uint64(2)).astype(np.int32)


def make_batch(
    cfg: DataConfig, model_cfg: ModelConfig, state: DataState
) -> Dict[str, np.ndarray]:
    """One host-local batch: tokens + next-token labels (+ frontend stubs)."""

    block = _batch_tokens(cfg, model_cfg, state)
    batch = {
        "tokens": block[:, :-1],
        "labels": block[:, 1:],
    }
    if model_cfg.family == "encdec":
        rng = np.random.default_rng((cfg.seed, state.step, cfg.host_id, 7))
        batch["frame_embeds"] = rng.standard_normal(
            (cfg.host_batch, model_cfg.encoder.num_frames, model_cfg.d_model),
            dtype=np.float32,
        )
    if model_cfg.frontend == "vision" and model_cfg.num_patches:
        rng = np.random.default_rng((cfg.seed, state.step, cfg.host_id, 13))
        batch["patch_embeds"] = 0.1 * rng.standard_normal(
            (cfg.host_batch, model_cfg.num_patches, model_cfg.d_model),
            dtype=np.float32,
        )
    return batch


class DataIterator:
    """Stateful iterator with single-slot prefetch and exact resume."""

    def __init__(
        self,
        cfg: DataConfig,
        model_cfg: ModelConfig,
        state: Optional[DataState] = None,
    ) -> None:
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.state = state or DataState(seed=cfg.seed, step=0)
        self._prefetched: Optional[Dict[str, np.ndarray]] = None

    def peek_state(self) -> DataState:
        return self.state

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._prefetched is not None:
            batch, self._prefetched = self._prefetched, None
        else:
            batch = make_batch(self.cfg, self.model_cfg, self.state)
        self.state = self.state.advance()
        # prefetch the next host batch eagerly (numpy — cheap, overlaps the
        # device step in a real deployment via a background thread)
        self._prefetched = make_batch(self.cfg, self.model_cfg, self.state)
        return batch
