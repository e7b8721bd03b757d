"""Primitive layers: RMSNorm, rotary embeddings, token embedding, SwiGLU MLP.

The PyTorch counterpart of the reference's ``models/layers.py``, function
for function over the same plain dict parameters: every layer is
``*_init(cfg, generator, ...) -> params`` plus ``layer(params, x, ...) ->
y``.  Compute runs in ``cfg.dtype`` (bf16 by default) with f32 where the
reference takes it (norm statistics, rotary angles, the SiLU gate, losses).
Large products are ``torch.matmul`` / ``einsum``, as the reference leaves
them to XLA outside any Pallas kernel.

Initialisers draw from an explicit ``torch.Generator`` on the target
device, one tensor at a time in f32 before the cast, so a full-size model
never holds an f32 copy of more than one tensor.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded

NEG_INF = -1e30


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` of ``shape``, drawn in f32 on the generator's
    device and cast to ``dtype``."""

    x = torch.randn(
        shape, generator=generator, device=generator.device, dtype=torch.float32
    )
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------- #
# RMSNorm
# ---------------------------------------------------------------------- #

def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


# ---------------------------------------------------------------------- #
# Rotary position embeddings
# ---------------------------------------------------------------------- #

@functools.lru_cache(maxsize=64)
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, computed once per (head_dim,
    theta, device); callers must not write to the result."""

    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    )
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""

    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (...,S,hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (...,S,1,hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# Embedding / unembedding
# ---------------------------------------------------------------------- #

def embed_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    V = cfg.padded_vocab_size
    params = {"tok": normal(generator, (V, cfg.d_model), 0.02, cdtype(cfg))}
    if not cfg.tie_embeddings:
        params["head"] = normal(generator, (cfg.d_model, V), 0.02, cdtype(cfg))
    return params


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return sharded.embed(params["tok"], tokens)


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits over the PADDED vocab; padded positions masked to -1e30 so
    they never win argmax and carry ~0 softmax mass."""

    if cfg.tie_embeddings:
        logits = sharded.product(
            lambda a, w: torch.matmul(a, w.t()), "bsd,vd->bsv", x, params["tok"]
        )
    else:
        logits = sharded.product(torch.matmul, "bsd,dv->bsv", x, params["head"])
    V, Vp = cfg.vocab_size, cfg.padded_vocab_size
    if Vp != V:
        padded = torch.arange(Vp, device=logits.device) >= V
        logits = logits.masked_fill(padded, NEG_INF)
    return logits


# ---------------------------------------------------------------------- #
# SwiGLU MLP
# ---------------------------------------------------------------------- #

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    s_in = d_model**-0.5
    s_out = d_ff**-0.5
    return {
        "w_gate": normal(generator, (d_model, d_ff), s_in, dtype),
        "w_up": normal(generator, (d_model, d_ff), s_in, dtype),
        "w_down": normal(generator, (d_ff, d_model), s_out, dtype),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Under a mesh the ff dim follows the weights and the output is a
    ``Partial`` sum where ``w_down`` is ff-sharded
    (:func:`repro_torch.models.sharded.product`)."""

    gate = sharded.product(torch.matmul, "bsd,df->bsf", x, params["w_gate"])
    up = sharded.product(torch.matmul, "bsd,df->bsf", x, params["w_up"])
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return sharded.product(torch.matmul, "bsf,fd->bsd", act, params["w_down"])


# ---------------------------------------------------------------------- #
# losses
# ---------------------------------------------------------------------- #

def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean next-token loss in f32.  logits (..., V), labels (...) int."""

    logits = logits.float()
    if sharded.is_dtensor(logits):
        return sharded.nll_mean(logits, labels, mask)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
