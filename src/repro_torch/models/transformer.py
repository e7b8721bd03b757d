"""Decoder LM over repeating layer blocks, as the reference's
``models/transformer.py``, for every decoder family through the block
pattern of :class:`repro_torch.configs.base.ModelConfig`: full attention
(``ATTN``), sliding-window attention (``ATTN_LOCAL``), the Mamba2 mixer
(``MAMBA``), the dense SwiGLU MLP and the MoE MLP — yi, granite, internlm2,
gemma3 (5:1 local:global with remainder layers), llava (patch-embedding
prefix), deepseek and mixtral (MoE), jamba (Mamba + attention, MoE every
other layer) and mamba2 (attention-free).

Three entry modes share the layer code: ``train`` (full sequence, no
cache), ``prefill`` (full sequence, fills the cache), ``decode`` (one token
against the cache); in train mode ``cfg.remat`` checkpoints each block as
the reference's ``jax.checkpoint`` does.  The reference stacks the ``num_blocks`` repeats on a
leading axis for ``lax.scan``; here ``params["blocks"]`` is a list of
per-block dicts run by a Python loop (``repro_torch.convert`` unstacks a
reference tree), and the remainder layers follow, as in the reference.
Every layer returns its MoE aux loss (zero without MoE), summed over the
stack.

Spans (:func:`repro_torch.obs.trace.module`, no-ops while tracing is off):
``lm.embed`` and ``lm.unembed`` (the final norm and the head) once a call;
in each layer, with its index, ``lm.norm`` (each RMSNorm), and on the
attention and dense-MLP paths ``lm.qkv``, ``lm.rope``, ``lm.cache_write``,
``lm.attention`` (the core alone), ``lm.out_proj`` and ``lm.mlp``.  All but
``lm.embed`` ask for device time.  Under remat the recompute opens them again.
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
from repro_torch.models.sharded import accumulate, residual
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
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
from repro_torch.obs import trace

# ---------------------------------------------------------------------- #
# init
# ---------------------------------------------------------------------- #

def _layer_init(generator: torch.Generator, pos: LayerPos, cfg: ModelConfig) -> dict:
    dev = generator.device
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dev)}
    if pos.mixer in (ATTN, ATTN_LOCAL):
        p["attn"] = attn_lib.attn_init(generator, cfg)
    elif pos.mixer == MAMBA:
        p["mamba"] = mamba_lib.mamba_init(generator, cfg)
    else:
        raise ValueError(pos.mixer)
    if pos.mlp == MLP_DENSE and cfg.d_ff > 0:
        p["norm2"] = rmsnorm_init(cfg.d_model, dev)
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cdtype(cfg))
    elif pos.mlp == MLP_MOE:
        p["norm2"] = rmsnorm_init(cfg.d_model, dev)
        p["moe"] = moe_lib.moe_init(generator, cfg)
    return p


def init_decoder(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters drawn from ``generator`` on its device."""

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
    if pos.mixer == MAMBA:
        return mamba_lib.mamba_init_state(cfg, batch, device)
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

def positions(mode: str, seq: int, cache_len, device) -> torch.Tensor:
    """The rotary positions of a layer's input: ``cache_len`` for the one
    decode token (a Python int makes no host-to-device copy), else
    0..seq-1."""

    if mode != "decode":
        return torch.arange(seq, device=device)
    if isinstance(cache_len, int):
        return torch.arange(cache_len, cache_len + 1, device=device)
    return torch.as_tensor(cache_len, device=device).reshape(1)


def _attention(p, h, cfg, window, mode, cache, cache_len, layer):
    """The attention mixer: (output, new cache)."""

    with trace.module("lm.qkv", layer, True):
        q, k, v = attn_lib.qkv_project(p, h)
    with trace.module("lm.rope", layer, True):
        pos = positions(mode, h.shape[1], cache_len, h.device)
        q = attn_lib.apply_rope(q, pos, cfg.rope_theta)
        k = attn_lib.apply_rope(k, pos, cfg.rope_theta)
    new_cache = cache
    if mode != "train":
        start = 0 if mode == "prefill" else cache_len
        with trace.module("lm.cache_write", layer, True):
            if cfg.kv_quant:
                new_cache = attn_lib.update_kv_cache_q(cache, k, v, start)
            else:
                kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v, start)
                new_cache = {"k": kc, "v": vc}
    with trace.module("lm.attention", layer, True):
        if mode != "decode":
            o = attn_lib.chunked_attention(
                q, k, v, causal=True, window=window, chunk=cfg.attn_chunk
            )
        elif cfg.kv_quant:
            o = attn_lib.decode_attention_q(
                q, new_cache, cache_len + 1, window=window
            )
        else:
            o = attn_lib.decode_attention(
                q, new_cache["k"], new_cache["v"], cache_len + 1, window=window
            )
    with trace.module("lm.out_proj", layer, True):
        return attn_lib.out_project(p, o), new_cache


def _norm(p: dict, x: torch.Tensor, cfg: ModelConfig, layer: int) -> torch.Tensor:
    with trace.module("lm.norm", layer, True):
        return rmsnorm(p, x, cfg.norm_eps)


def _apply_layer(
    p: dict,
    x: torch.Tensor,
    pos: LayerPos,
    cfg: ModelConfig,
    mode: str,
    cache: Optional[dict],
    cache_len,
    layer: int,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss).  The cache is updated in place;
    ``layer`` is the layer's index in the stack (its spans')."""

    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    # --- mixer ---
    h = _norm(p["norm1"], x, cfg, layer)
    if pos.mixer in (ATTN, ATTN_LOCAL):
        window = cfg.sliding_window if pos.mixer == ATTN_LOCAL else None
        o, new_cache = _attention(p["attn"], h, cfg, window, mode, cache, cache_len, layer)
    elif pos.mixer == MAMBA:
        if mode == "train":
            o, _ = mamba_lib.mamba_apply(p["mamba"], h, cfg, None)
            new_cache = cache
        elif mode == "prefill":
            o, new_cache = mamba_lib.mamba_apply(p["mamba"], h, cfg, cache)
        else:
            o, new_cache = mamba_lib.mamba_decode_step(p["mamba"], h, cfg, cache)
    else:
        raise ValueError(pos.mixer)
    x = residual(x, o)

    # --- mlp ---
    if pos.mlp == MLP_DENSE and "mlp" in p:
        h = _norm(p["norm2"], x, cfg, layer)
        with trace.module("lm.mlp", layer, True):
            y = mlp(p["mlp"], h)
        x = residual(x, y)
    elif pos.mlp == MLP_MOE:
        h = _norm(p["norm2"], x, cfg, layer)
        y, aux = moe_lib.moe_apply(p["moe"], h, cfg)
        x = residual(x, y)
    return x, new_cache, aux


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


def _checkpointed_block(
    bp: dict, x: torch.Tensor, cfg: ModelConfig, b: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block in train mode under ``torch.utils.checkpoint``, as the
    reference runs its scan body under ``jax.checkpoint``: ``remat="full"``
    saves only the block's input (``nothing_saveable``), ``"dots"`` also
    the products :func:`_dots_policy` names.  Returns (x, the block's aux
    loss), both out of the checkpointed body, so the aux keeps its
    gradient.  ``b`` is the block's index.  The recompute joins the span
    the forward ran under, as autograd may run it on another thread."""

    outer = trace.current()

    def body(xb):
        aux = torch.zeros((), dtype=torch.float32, device=xb.device)
        with trace.joined(outer):
            for i, pos in enumerate(cfg.block):
                xb, _, a = _apply_layer(
                    bp[f"pos{i}"], xb, pos, cfg, "train", None, None, b * len(cfg.block) + i
                )
                aux = accumulate(aux, a)
        return xb, aux

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
    act_constrain=None,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """The blocks in order, then the remainder layers; returns (x, new
    cache, the aux loss summed over every layer).  In train mode with
    grad enabled and ``cfg.remat`` other than ``"none"`` each block runs
    under a checkpoint (:func:`_checkpointed_block`); the remainder layers
    run plain, as the reference unrolls them outside its scan.
    ``act_constrain`` relayouts the residual stream on entry and after
    every block, as the reference constrains its scan carry."""

    new_cache: Dict[str, Any] = {"blocks": [], "rem": {}}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = mode == "train" and cfg.remat != "none" and torch.is_grad_enabled()
    constrain = act_constrain or (lambda t: t)
    x = constrain(x)
    for b, bp in enumerate(params["blocks"]):
        if remat:
            x, a = _checkpointed_block(bp, x, cfg, b)
            x = constrain(x)
            aux = accumulate(aux, a)
            continue
        nbc = {}
        block_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, pos in enumerate(cfg.block):
            pc = cache["blocks"][b][f"pos{i}"] if cache is not None else None
            x, nbc[f"pos{i}"], a = _apply_layer(
                bp[f"pos{i}"], x, pos, cfg, mode, pc, cache_len, b * len(cfg.block) + i
            )
            block_aux = accumulate(block_aux, a)
        x = constrain(x)
        aux = accumulate(aux, block_aux)
        new_cache["blocks"].append(nbc)
    for i in range(cfg.remainder_layers):
        pc = cache["rem"][f"layer{i}"] if cache is not None else None
        x, new_cache["rem"][f"layer{i}"], a = _apply_layer(
            params["rem"][f"layer{i}"], x, cfg.block[i], cfg, mode, pc, cache_len,
            cfg.num_blocks * len(cfg.block) + i,
        )
        aux = accumulate(aux, a)
    return x, (new_cache if cache is not None else None), aux


# ---------------------------------------------------------------------- #
# public entry points
# ---------------------------------------------------------------------- #

def _embed_inputs(params, tokens, cfg, prefix_embeds=None):
    with trace.module("lm.embed"):
        x = embed(params["embed"], tokens).to(cdtype(cfg))
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        return x


def _unembed(params, x, cfg):
    """The final norm and the head."""

    with trace.module("lm.unembed", None, True):
        return unembed(params["embed"], rmsnorm(params["final_norm"], x, cfg.norm_eps), cfg)


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    prefix_embeds: Optional[torch.Tensor] = None,
    act_constrain=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode forward.  Returns (logits (B,S,V), aux_loss), the aux loss
    the MoE layers' summed (zero without MoE).  ``prefix_embeds`` (B,P,d)
    are prepended (VLM patch embeddings); ``act_constrain`` as in
    :func:`_run_stack`."""

    x = _embed_inputs(params, tokens, cfg, prefix_embeds)
    x, _, aux = _run_stack(
        params, x, cfg, "train", None, None, act_constrain=act_constrain
    )
    return _unembed(params, x, cfg), aux


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

    x = _embed_inputs(params, tokens, cfg, prefix_embeds)
    x, new_cache, _ = _run_stack(params, x, cfg, "prefill", cache, None)
    return _unembed(params, x[:, -1:, :], cfg), new_cache


def decode_step(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: dict,
    cache_len,
) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B,1); cache_len = tokens already cached."""

    x = _embed_inputs(params, tokens, cfg)
    x, new_cache, _ = _run_stack(params, x, cfg, "decode", cache, cache_len)
    return _unembed(params, x, cfg), new_cache
