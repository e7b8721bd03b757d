"""Unified model API, as the reference's ``models/model_zoo.py``, for the
decoder families the port runs (``transformer``); the encoder-decoder
family raises ``NotImplementedError``.

``batch`` dict contract:
  tokens (B,S) int              — text tokens
  patch_embeds (B,P,d)          — vision frontend stub (llava)

Every entry point runs on the device its tensors lie on; :func:`init` and
:func:`init_cache` take the device, ``"cuda"`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.compile.lowering import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family is not ported yet (ROADMAP Queue 1 item 9)"
        )


def init(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> dict:
    """Random parameters on ``device``, drawn tensor by tensor from a
    ``torch.Generator`` on that device seeded with ``seed``."""

    _decoder_only(cfg)
    generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return transformer.init_decoder(generator, cfg)


def forward_logits(
    params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    _decoder_only(cfg)
    return transformer.forward(
        params, batch["tokens"], cfg, prefix_embeds=batch.get("patch_embeds")
    )


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    _decoder_only(cfg)
    return transformer.init_cache(cfg, batch, max_len, resolve_device(device))


def prefill(
    params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig, cache: dict
) -> Tuple[torch.Tensor, dict]:
    _decoder_only(cfg)
    return transformer.prefill(
        params, batch["tokens"], cfg, cache,
        prefix_embeds=batch.get("patch_embeds"),
    )


def decode_step(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: dict,
    cache_len,
) -> Tuple[torch.Tensor, dict]:
    _decoder_only(cfg)
    return transformer.decode_step(params, tokens, cfg, cache, cache_len)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: dict) -> int:
    return sum(x.numel() for x in _leaves(params))
