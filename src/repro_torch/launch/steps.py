"""Prefill and decode steps, as the reference's ``launch/steps.py``
(``make_prefill_step`` / ``make_serve_step``).  PyTorch runs eagerly, so a
step is the plain function, under ``torch.inference_mode``; the train step
is not ported yet (ROADMAP Queue 1 item 11)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch, cache) -> (last-position logits, cache)."""

    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        return zoo.prefill(params, batch, cfg, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B,1), cache, cache_len) -> (next_tokens (B,1), cache),
    greedy, as the reference's."""

    @torch.inference_mode()
    def serve_step(params, tokens, cache, cache_len):
        logits, cache = zoo.decode_step(params, tokens, cfg, cache, cache_len)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step
