"""Decoder LM over repeating layer blocks, as the reference's
``models/transformer.py``, for the dense decoder families: full attention
(``ATTN``), sliding-window attention (``ATTN_LOCAL``) and the dense SwiGLU
MLP — yi, granite, internlm2, gemma3 (5:1 local:global with remainder
layers) and llava (patch-embedding prefix).  MoE and Mamba positions raise
``NotImplementedError``.

Three entry modes share the layer code: ``train`` (full sequence, no
cache), ``prefill`` (full sequence, fills the cache), ``decode`` (one token
against the cache); in train mode ``cfg.remat`` checkpoints each block as
the reference's ``jax.checkpoint`` does.  The reference stacks the ``num_blocks`` repeats on a
leading axis for ``lax.scan``; here ``params["blocks"]`` is a list of
per-block dicts run by a Python loop (``repro_torch.convert`` unstacks a
reference tree), and the remainder layers follow, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    MAMBA,
    MLP_DENSE,
    MLP_MOE,
    LayerPos,
    ModelConfig,
)
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    cdtype,
    embed,
    embed_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 9)"


def _check_position(pos: LayerPos) -> None:
    if pos.mixer == MAMBA:
        raise NotImplementedError(f"the Mamba mixer {_NOT_PORTED}")
    if pos.mixer not in (ATTN, ATTN_LOCAL):
        raise ValueError(pos.mixer)
    if pos.mlp == MLP_MOE:
        raise NotImplementedError(f"the MoE MLP {_NOT_PORTED}")


def check_config(cfg: ModelConfig) -> None:
    """Raise for a configuration the port's decoder does not run."""

    if cfg.family != "decoder":
        raise NotImplementedError(f"the {cfg.family!r} family {_NOT_PORTED}")
    for pos in cfg.block:
        _check_position(pos)


# ---------------------------------------------------------------------- #
# init
# ---------------------------------------------------------------------- #

def _layer_init(generator: torch.Generator, pos: LayerPos, cfg: ModelConfig) -> dict:
    _check_position(pos)
    dev = generator.device
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dev)}
    p["attn"] = attn_lib.attn_init(generator, cfg)
    if pos.mlp == MLP_DENSE and cfg.d_ff > 0:
        p["norm2"] = rmsnorm_init(cfg.d_model, dev)
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cdtype(cfg))
    return p


def init_decoder(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters drawn from ``generator`` on its device."""

    check_config(cfg)
    params: Dict[str, Any] = {"embed": embed_init(generator, cfg)}
    params["blocks"] = [
        {f"pos{i}": _layer_init(generator, pos, cfg) for i, pos in enumerate(cfg.block)}
        for _ in range(cfg.num_blocks)
    ]
    params["rem"] = {
        f"layer{i}": _layer_init(generator, cfg.block[i], cfg)
        for i in range(cfg.remainder_layers)
    }
    params["final_norm"] = rmsnorm_init(cfg.d_model, generator.device)
    return params


# ---------------------------------------------------------------------- #
# caches
# ---------------------------------------------------------------------- #

def _layer_cache(pos: LayerPos, cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    _check_position(pos)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        sshape = shape[:-1] + (1,)
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=cdtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=cdtype(cfg), device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    check_config(cfg)
    return {
        "blocks": [
            {
                f"pos{i}": _layer_cache(pos, cfg, batch, max_len, device)
                for i, pos in enumerate(cfg.block)
            }
            for _ in range(cfg.num_blocks)
        ],
        "rem": {
            f"layer{i}": _layer_cache(cfg.block[i], cfg, batch, max_len, device)
            for i in range(cfg.remainder_layers)
        },
    }


# ---------------------------------------------------------------------- #
# layer application (shared by all modes)
# ---------------------------------------------------------------------- #

def _apply_layer(
    p: dict,
    x: torch.Tensor,
    pos: LayerPos,
    cfg: ModelConfig,
    mode: str,
    cache: Optional[dict],
    cache_len,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, new_cache).  The cache is updated in place."""

    _check_position(pos)
    window = cfg.sliding_window if pos.mixer == ATTN_LOCAL else None

    # --- mixer ---
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = attn_lib.qkv_project(p["attn"], h)
    if mode == "decode":
        if isinstance(cache_len, int):  # no host-to-device copy
            positions = torch.arange(cache_len, cache_len + 1, device=x.device)
        else:
            positions = torch.as_tensor(cache_len, device=x.device).reshape(1)
    else:
        positions = torch.arange(x.shape[1], device=x.device)
    q = attn_lib.apply_rope(q, positions, cfg.rope_theta)
    k = attn_lib.apply_rope(k, positions, cfg.rope_theta)
    new_cache = cache
    if mode == "train":
        o = attn_lib.chunked_attention(
            q, k, v, causal=True, window=window, chunk=cfg.attn_chunk
        )
    elif mode == "prefill":
        if cfg.kv_quant:
            new_cache = attn_lib.update_kv_cache_q(cache, k, v, 0)
        else:
            kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v, 0)
            new_cache = {"k": kc, "v": vc}
        o = attn_lib.chunked_attention(
            q, k, v, causal=True, window=window, chunk=cfg.attn_chunk
        )
    else:  # decode
        if cfg.kv_quant:
            new_cache = attn_lib.update_kv_cache_q(cache, k, v, cache_len)
            o = attn_lib.decode_attention_q(
                q, new_cache, cache_len + 1, window=window
            )
        else:
            kc, vc = attn_lib.update_kv_cache(
                cache["k"], cache["v"], k, v, cache_len
            )
            new_cache = {"k": kc, "v": vc}
            o = attn_lib.decode_attention(q, kc, vc, cache_len + 1, window=window)
    x = x + attn_lib.out_project(p["attn"], o)

    # --- mlp ---
    if pos.mlp == MLP_DENSE and "mlp" in p:
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h)
    return x, new_cache


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products with no batch dimension (the
    projections and the MLP; einsum lowers them to a batch-1 ``bmm``),
    recompute the rest: ``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims``' counterpart."""

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
        op == aten.bmm.default and args[0].shape[0] == 1
    ):
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed_block(bp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One block in train mode under ``torch.utils.checkpoint``, as the
    reference runs its scan body under ``jax.checkpoint``: ``remat="full"``
    saves only the block's input (``nothing_saveable``), ``"dots"`` also
    the products :func:`_dots_policy` names."""

    def body(xb):
        for i, pos in enumerate(cfg.block):
            xb, _ = _apply_layer(bp[f"pos{i}"], xb, pos, cfg, "train", None, None)
        return xb

    kwargs = {}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _dots_policy
        )
    elif cfg.remat != "full":
        raise ValueError(f"remat={cfg.remat!r}; expected 'none', 'dots' or 'full'")
    return checkpoint.checkpoint(body, x, use_reentrant=False, **kwargs)


def _run_stack(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    cache: Optional[dict],
    cache_len,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The blocks in order, then the remainder layers.  In train mode with
    grad enabled and ``cfg.remat`` other than ``"none"`` each block runs
    under a checkpoint (:func:`_checkpointed_block`); the remainder layers
    run plain, as the reference unrolls them outside its scan."""

    new_cache: Dict[str, Any] = {"blocks": [], "rem": {}}
    remat = mode == "train" and cfg.remat != "none" and torch.is_grad_enabled()
    for b, bp in enumerate(params["blocks"]):
        if remat:
            x = _checkpointed_block(bp, x, cfg)
            continue
        nbc = {}
        for i, pos in enumerate(cfg.block):
            pc = cache["blocks"][b][f"pos{i}"] if cache is not None else None
            x, nbc[f"pos{i}"] = _apply_layer(
                bp[f"pos{i}"], x, pos, cfg, mode, pc, cache_len
            )
        new_cache["blocks"].append(nbc)
    for i in range(cfg.remainder_layers):
        pc = cache["rem"][f"layer{i}"] if cache is not None else None
        x, new_cache["rem"][f"layer{i}"] = _apply_layer(
            params["rem"][f"layer{i}"], x, cfg.block[i], cfg, mode, pc, cache_len
        )
    return x, (new_cache if cache is not None else None)


# ---------------------------------------------------------------------- #
# public entry points
# ---------------------------------------------------------------------- #

def _embed_inputs(params, tokens, cfg, prefix_embeds):
    x = embed(params["embed"], tokens).to(cdtype(cfg))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode forward.  Returns (logits (B,S,V), aux_loss), the aux loss
    zero (no MoE).  ``prefix_embeds`` (B,P,d) are prepended (VLM patch
    embeddings)."""

    check_config(cfg)
    x = _embed_inputs(params, tokens, cfg, prefix_embeds)
    x, _ = _run_stack(params, x, cfg, "train", None, None)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params["embed"], x, cfg), aux


def prefill(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: dict,
    *,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Fill the cache from a full prompt.  Returns (last-position logits,
    cache)."""

    check_config(cfg)
    x = _embed_inputs(params, tokens, cfg, prefix_embeds)
    x, new_cache = _run_stack(params, x, cfg, "prefill", cache, None)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return unembed(params["embed"], x, cfg), new_cache


def decode_step(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: dict,
    cache_len,
) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B,1); cache_len = tokens already cached."""

    check_config(cfg)
    x = embed(params["embed"], tokens).to(cdtype(cfg))
    x, new_cache = _run_stack(params, x, cfg, "decode", cache, cache_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), new_cache
