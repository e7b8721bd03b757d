"""Unified model API, as the reference's ``models/model_zoo.py``, for the
decoder families the port runs (``transformer``); the encoder-decoder
family raises ``NotImplementedError``.

``batch`` dict contract:
  tokens (B,S) int              — text tokens
  labels (B,S) int              — next-token targets (train)
  patch_embeds (B,P,d)          — vision frontend stub (llava)

``loss_fn`` is the training objective (mean NLL + MoE aux), ``prefill`` /
``decode_step`` the serving path.

Every entry point runs on the device its tensors lie on; :func:`init` and
:func:`init_cache` take the device, ``"cuda"`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.compile.lowering import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import softmax_cross_entropy

AUX_LOSS_WEIGHT = 0.01


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


def loss_fn(
    params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"nll", "aux"}): the mean next-token NLL in f32 over the text
    positions (``loss_mask`` weights them when given) plus the weighted MoE
    aux loss (zero here)."""

    logits, aux = forward_logits(params, batch, cfg)
    labels = batch["labels"]
    if cfg.frontend == "vision" and cfg.num_patches:
        # loss over text positions only (patch prefix produces no targets)
        logits = logits[:, cfg.num_patches :, :]
    nll = softmax_cross_entropy(logits, labels, batch.get("loss_mask"))
    loss = nll + AUX_LOSS_WEIGHT * aux
    return loss, {"nll": nll, "aux": aux}


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


def param_count(params: dict) -> int:
    return sum(x.numel() for x in tree_lib.leaves(params))


def active_param_count(params: dict, cfg: ModelConfig) -> int:
    """Parameters touched per token: all of them in a dense model."""

    if cfg.has_moe:
        raise NotImplementedError(
            "the MoE MLP is not ported yet (ROADMAP Queue 1 item 9)"
        )
    return param_count(params)


def model_flops_per_token(params: dict, cfg: ModelConfig) -> float:
    """6·N(active) per token (the reference's MODEL_FLOPS convention)."""

    return 6.0 * active_param_count(params, cfg)
