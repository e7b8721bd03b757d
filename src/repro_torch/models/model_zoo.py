"""Unified model API over the decoder and encoder-decoder families, as the
reference's ``models/model_zoo.py``.

``batch`` dict contract:
  tokens (B,S) int              — text tokens (decoder input for encdec)
  labels (B,S) int              — next-token targets (train)
  frame_embeds (B,F,d)          — audio frontend stub (whisper)
  patch_embeds (B,P,d)          — vision frontend stub (llava)

``loss_fn`` is the training objective (mean NLL + MoE aux), ``prefill`` /
``decode_step`` the serving path.

Every entry point runs on the device its tensors lie on; :func:`init` and
:func:`init_cache` take the device, ``"cuda"`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.compile.lowering import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import softmax_cross_entropy

AUX_LOSS_WEIGHT = 0.01


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: the
    initialisers then give every parameter's shape and dtype and allocate
    nothing."""

    @property
    def device(self):
        return torch.device("meta")


def _init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.family == "encdec":
        return encdec.init_encdec(generator, cfg)
    return transformer.init_decoder(generator, cfg)


def init(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> dict:
    """Random parameters on ``device``, drawn tensor by tensor from a
    ``torch.Generator`` on that device seeded with ``seed``."""

    return _init(torch.Generator(device=resolve_device(device)).manual_seed(seed), cfg)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors: shapes and dtypes without
    allocating (the reference's ``jax.eval_shape`` of ``init``)."""

    return _init(_MetaGenerator(), cfg)


def forward_logits(
    params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
    act_constrain=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``act_constrain`` (optional, launch-layer injected) relayouts the
    residual stream at block boundaries (:mod:`repro_torch.launch.steps`'s
    ``seq_shard``)."""

    if cfg.family == "encdec":
        return encdec.forward(
            params, batch["frame_embeds"], batch["tokens"], cfg,
            act_constrain=act_constrain,
        )
    return transformer.forward(
        params, batch["tokens"], cfg, prefix_embeds=batch.get("patch_embeds"),
        act_constrain=act_constrain,
    )


def loss_fn(
    params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
    act_constrain=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"nll", "aux"}): the mean next-token NLL in f32 over the text
    positions (``loss_mask`` weights them when given) plus the weighted MoE
    aux loss (zero without MoE)."""

    logits, aux = forward_logits(params, batch, cfg, act_constrain)
    labels = batch["labels"]
    if cfg.frontend == "vision" and cfg.num_patches:
        # loss over text positions only (patch prefix produces no targets)
        logits = logits[:, cfg.num_patches :, :]
    nll = softmax_cross_entropy(logits, labels, batch.get("loss_mask"))
    loss = nll + AUX_LOSS_WEIGHT * aux
    return loss, {"nll": nll, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, resolve_device(device))
    return transformer.init_cache(cfg, batch, max_len, resolve_device(device))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    """The cache tree as ``meta`` tensors (the reference's
    ``abstract_cache``)."""

    meta = torch.device("meta")
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, meta)
    return transformer.init_cache(cfg, batch, max_len, meta)


def prefill(
    params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig, cache
) -> Tuple[torch.Tensor, Any]:
    if cfg.family == "encdec":
        return encdec.prefill(
            params, batch["frame_embeds"], batch["tokens"], cfg, cache
        )
    return transformer.prefill(
        params, batch["tokens"], cfg, cache,
        prefix_embeds=batch.get("patch_embeds"),
    )


def decode_step(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache,
    cache_len,
) -> Tuple[torch.Tensor, Any]:
    if cfg.family == "encdec":
        return encdec.decode_step(params, tokens, cfg, cache, cache_len)
    return transformer.decode_step(params, tokens, cfg, cache, cache_len)


def param_count(params: dict) -> int:
    return sum(x.numel() for x in tree_lib.leaves(params))


def active_param_count(params: dict, cfg: ModelConfig) -> int:
    """Parameters touched per token: the routed experts' weights scaled by
    top_k/E, the router, the shared experts and everything else in full.
    The scaled count is rounded down per leaf of the reference's layout
    (:func:`repro_torch.tree.reference_groups`), as the reference rounds."""

    if not cfg.has_moe:
        return param_count(params)
    assert cfg.moe is not None
    frac = cfg.moe.top_k / cfg.moe.num_experts
    flat = tree_lib.flatten_with_paths(params)
    total = 0
    for idx, _ in tree_lib.reference_groups(params):
        path = flat[idx[0]][0]
        size = sum(flat[i][1].numel() for i in idx)
        routed = len(path) >= 2 and path[-2] == "moe" and path[-1] in (
            "w_gate", "w_up", "w_down"
        )
        total += int(size * frac) if routed else size
    return total


def model_flops_per_token(params: dict, cfg: ModelConfig) -> float:
    """6·N(active) per token (the reference's MODEL_FLOPS convention)."""

    return 6.0 * active_param_count(params, cfg)
