"""Whisper-style encoder–decoder backbone, as the reference's
``models/encdec.py``.

The conv/mel audio frontend is a stub: ``frame_embeds`` (B, F, d_model)
are precomputed frame embeddings.  The encoder is a bidirectional
transformer over the frames; the decoder adds cross-attention to the
encoder output.  The cross-attention K/V are computed once at prefill,
written into the cache and only read at decode.

The reference stacks the layers on a leading axis for ``lax.scan``; here
``enc_blocks`` and ``dec_blocks`` are lists of per-layer dicts run by a
Python loop, and the cache is a list of per-layer ``{"k", "v", "ck",
"cv"}`` (``repro_torch.convert`` carries both across).  The encoder's and
the cross-attention's ``chunked_attention`` calls are non-causal, the
decode step's cross-attention included, so on a CUDA tensor each is the
flash kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.sharded import residual
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
from repro_torch.models.transformer import positions


def _sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freq = torch.exp(
        -math.log(10_000.0)
        * torch.arange(half, dtype=torch.float32, device=pos.device)
        / max(half - 1, 1)
    )
    ang = pos[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------- #
# init
# ---------------------------------------------------------------------- #

def _enc_layer_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dev = generator.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dev),
        "attn": attn_lib.attn_init(generator, cfg),
        "norm2": rmsnorm_init(cfg.d_model, dev),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cdtype(cfg)),
    }


def _dec_layer_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dev = generator.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dev),
        "self_attn": attn_lib.attn_init(generator, cfg),
        "norm_x": rmsnorm_init(cfg.d_model, dev),
        "cross_attn": attn_lib.attn_init(generator, cfg),
        "norm2": rmsnorm_init(cfg.d_model, dev),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cdtype(cfg)),
    }


def init_encdec(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters drawn from ``generator`` on its device."""

    assert cfg.encoder is not None
    dev = generator.device
    return {
        "embed": embed_init(generator, cfg),
        "enc_blocks": [
            _enc_layer_init(generator, cfg) for _ in range(cfg.encoder.num_layers)
        ],
        "enc_norm": rmsnorm_init(cfg.d_model, dev),
        "dec_blocks": [_dec_layer_init(generator, cfg) for _ in range(cfg.num_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, dev),
    }


def _remat(fn, cfg: ModelConfig, *args):
    """``fn(*args)``, under a full checkpoint where the reference runs its
    scan body under ``jax.checkpoint`` (``cfg.remat`` other than
    ``"none"``) and a gradient is being taken."""

    if cfg.remat != "none" and torch.is_grad_enabled():
        return checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------- #
# encoder
# ---------------------------------------------------------------------- #

def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B,F,d) — the stubbed conv-frontend output.  Bidirectional
    stack."""

    x = frames.to(cdtype(cfg))
    pe = _sinusoid(torch.arange(x.shape[1], device=x.device), cfg.d_model)
    x = x + pe.to(x.dtype)[None]

    def layer(lp, xc):
        h = rmsnorm(lp["norm1"], xc, cfg.norm_eps)
        q, k, v = attn_lib.qkv_project(lp["attn"], h)
        o = attn_lib.chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        xc = residual(xc, attn_lib.out_project(lp["attn"], o))
        h = rmsnorm(lp["norm2"], xc, cfg.norm_eps)
        return residual(xc, mlp(lp["mlp"], h))

    for lp in params["enc_blocks"]:
        x = _remat(layer, cfg, lp, x)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------- #
# decoder
# ---------------------------------------------------------------------- #

def _dec_layer(
    lp: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    cache: Optional[dict],
    cache_len,
    enc_out: Optional[torch.Tensor],
) -> torch.Tensor:
    """One decoder layer; a given cache is written in place."""

    # self attention
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    q, k, v = attn_lib.qkv_project(lp["self_attn"], h)
    pos = positions(mode, x.shape[1], cache_len, x.device)
    q = attn_lib.apply_rope(q, pos, cfg.rope_theta)
    k = attn_lib.apply_rope(k, pos, cfg.rope_theta)
    if mode == "decode":
        kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v, cache_len)
        o = attn_lib.decode_attention(q, kc, vc, cache_len + 1)
    else:
        if cache is not None:  # prefill
            attn_lib.update_kv_cache(cache["k"], cache["v"], k, v, 0)
        o = attn_lib.chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    x = residual(x, attn_lib.out_project(lp["self_attn"], o))

    # cross attention
    h = rmsnorm(lp["norm_x"], x, cfg.norm_eps)
    qx = attn_lib.project(h, lp["cross_attn"]["wq"])
    if mode == "decode":
        ck, cv = cache["ck"], cache["cv"]
    else:
        assert enc_out is not None
        ck = attn_lib.project(enc_out, lp["cross_attn"]["wk"])
        cv = attn_lib.project(enc_out, lp["cross_attn"]["wv"])
        if cache is not None:
            attn_lib.update_kv_cache(cache["ck"], cache["cv"], ck, cv, 0)
    o = attn_lib.chunked_attention(qx, ck, cv, causal=False, chunk=cfg.attn_chunk)
    x = residual(x, attn_lib.out_project(lp["cross_attn"], o))

    # mlp
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    return residual(x, mlp(lp["mlp"], h))


def _run_decoder(
    params, x, cfg, mode, cache, cache_len, enc_out, act_constrain=None
) -> torch.Tensor:
    """The decoder layers in order; ``act_constrain`` relayouts the
    residual stream on entry and after every layer."""

    constrain = act_constrain or (lambda t: t)
    x = constrain(x)
    for i, lp in enumerate(params["dec_blocks"]):
        lc = cache[i] if cache is not None else None
        if mode == "train":
            x = _remat(
                lambda lp, x: _dec_layer(lp, x, cfg, mode, None, None, enc_out),
                cfg, lp, x,
            )
        else:
            x = _dec_layer(lp, x, cfg, mode, lc, cache_len, enc_out)
        x = constrain(x)
    return x


# ---------------------------------------------------------------------- #
# public API
# ---------------------------------------------------------------------- #

def forward(
    params: dict, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
    *, act_constrain=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (logits (B,S,V), aux=0).  ``act_constrain``
    relayouts the decoder's residual stream at layer boundaries (the
    reference's encoder-decoder takes no such hook)."""

    enc_out = encode(params, frames, cfg)
    x = embed(params["embed"], tokens).to(cdtype(cfg))
    x = _run_decoder(params, x, cfg, "train", None, None, enc_out, act_constrain)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params["embed"], x, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """One ``{"k", "v", "ck", "cv"}`` per decoder layer: the self-attention
    KV cache (B, max_len, KV, hd) and the cross-attention K/V (B, frames,
    KV, hd)."""

    assert cfg.encoder is not None
    kv = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    xkv = (batch, cfg.encoder.num_frames, cfg.num_kv_heads, cfg.head_dim)
    dt = cdtype(cfg)
    return [
        {
            "k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "ck": torch.zeros(xkv, dtype=dt, device=device),
            "cv": torch.zeros(xkv, dtype=dt, device=device),
        }
        for _ in range(cfg.num_layers)
    ]


def prefill(
    params: dict,
    frames: torch.Tensor,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: list,
) -> Tuple[torch.Tensor, list]:
    """Encode the frames and fill the cache from the decoder prompt.
    Returns (last-position logits, cache)."""

    enc_out = encode(params, frames, cfg)
    x = embed(params["embed"], tokens).to(cdtype(cfg))
    x = _run_decoder(params, x, cfg, "prefill", cache, None, enc_out)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return unembed(params["embed"], x, cfg), cache


def decode_step(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: list,
    cache_len,
) -> Tuple[torch.Tensor, list]:
    """One decode step.  tokens (B,1); cache_len = tokens already cached."""

    x = embed(params["embed"], tokens).to(cdtype(cfg))
    x = _run_decoder(params, x, cfg, "decode", cache, cache_len, None)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), cache
