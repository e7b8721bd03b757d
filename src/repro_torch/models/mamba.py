"""Mamba2 (state-space duality) mixer — chunked SSD prefill + O(1) decode,
as the reference's ``models/mamba.py``.

The SSD algorithm of Dao & Gu (arXiv:2405.21060): the sequence is split
into chunks; the intra-chunk terms are dense products, and the state
between chunks is carried by a Python loop over the chunks (the
reference's ``lax.scan``).  Decode updates the (B, H, P, N) state in O(1)
per token.

Every product is ``torch.matmul`` / ``einsum`` of two operands in a fixed
order: ``torch.einsum`` may reorder a product of three (``opt_einsum``),
and an order chosen per machine would form other intermediates, round
otherwise, and at mamba2-2.7b's prefill could ask for far more memory.  No
intermediate is larger than the (B, H, nc, Q, Q) f32 decay matrix.

Projections are split per component (z, x, B, C, dt), as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded
from repro_torch.models.layers import cdtype, normal

NEG_INF = -1e30


def mamba_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    assert cfg.mamba is not None
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.d_inner(d)
    H = mc.num_heads(d)
    N, G = mc.d_state, 1
    dev = generator.device
    s = d**-0.5
    dtype = cdtype(cfg)
    params = {
        "wz": normal(generator, (d, di), s, dtype),
        "wx": normal(generator, (d, di), s, dtype),
        "wB": normal(generator, (d, G * N), s, dtype),
        "wC": normal(generator, (d, G * N), s, dtype),
        "wdt": normal(generator, (d, H), s, dtype),
        "out": normal(generator, (di, d), di**-0.5, dtype),
        "conv_x": normal(generator, (mc.d_conv, di), 0.2, dtype),
    }
    u = torch.rand((H,), generator=generator, device=dev, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    params.update(
        A_log=torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        D=torch.ones((H,), dtype=torch.float32, device=dev),
        dt_bias=torch.log(torch.expm1(dt)),
        norm=torch.ones((di,), dtype=torch.float32, device=dev),
    )
    return params


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``, at every x (``torch.nn.functional.softplus``
    returns x itself above its threshold)."""

    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B,S,C), w (K,C).  ``tail`` (B,K-1,C) is the
    running state for decode/prefill-continuation; returns (y, new_tail)."""

    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, S+K-1, C)
    S = x.shape[1]
    y = xp[:, 0:S, :] * w[0]
    for k in range(1, K):
        y = y + xp[:, k : k + S, :] * w[k]
    new_tail = xp[:, S:, :]  # last K-1 inputs
    return F.silu(y.float()).to(x.dtype), new_tail


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) → (..., Q, Q) lower-triangular segment sums: out[i,j] =
    sum a[j+1..i] for j<=i, -1e30 above the diagonal."""

    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, NEG_INF)


def ssd_chunked(
    x: torch.Tensor,  # (B,S,H,P)
    dt: torch.Tensor,  # (B,S,H) post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B,S,N)   (single group)
    Cm: torch.Tensor,  # (B,S,N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B,S,H,P) f32, final state (B,H,P,N) f32)."""

    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # padded steps have dt=0: decay exp(0)=1 and zero state contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S_pad = S + pad
    nc = S_pad // Q

    xa = (x * dt[..., None]).float()  # fold dt into x
    dA = (dt * A[None, None, :]).float()  # (B,S,H)

    # chunked views
    xc = xa.reshape(B_, nc, Q, H, P)
    dAc = dA.reshape(B_, nc, Q, H).permute(0, 3, 1, 2)  # (B,H,nc,Q)
    Bc = Bm.reshape(B_, nc, Q, N).float()
    Cc = Cm.reshape(B_, nc, Q, N).float()

    cum = torch.cumsum(dAc, dim=-1)  # (B,H,nc,Q)

    # 1. intra-chunk output: (scores ∘ L) @ x per (batch, chunk, head)
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))  # (B,nc,Q,Q)
    L = torch.exp(_segsum(dAc)) * scores[:, None]  # (B,H,nc,Q,Q)
    xh = xc.permute(0, 3, 1, 2, 4)  # (B,H,nc,Q,P)
    y_diag = torch.matmul(L, xh)  # (B,H,nc,Q,P)
    del L

    # 2. per-chunk input → state contribution: (x ∘ decay)ᵀ @ B
    decay_states = torch.exp(cum[..., -1:] - cum)  # (B,H,nc,Q)
    states = torch.matmul(
        (xh * decay_states[..., None]).transpose(-1, -2), Bc[:, None]
    )  # (B,H,nc,P,N)

    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[..., -1])  # (B,H,nc)
    h = (
        torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
        if h0 is None
        else h0.float()
    )
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c]
    h_enter = torch.stack(h_enter, dim=2)  # (B,H,nc,P,N)

    # 4. state → output within each chunk: (C @ hᵀ) ∘ decay
    state_decay = torch.exp(cum)  # (B,H,nc,Q)
    y_off = torch.matmul(Cc[:, None], h_enter.transpose(-1, -2))  # (B,H,nc,Q,P)
    y_off = y_off * state_decay[..., None]

    y = (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(B_, S_pad, H, P)
    if pad:
        y = y[:, :S]
    return y, h


def _project(params: dict, x: torch.Tensor):
    z = torch.matmul(x, params["wz"])
    xin = torch.matmul(x, params["wx"])
    dt_raw = torch.matmul(x, params["wdt"])
    Bm = torch.matmul(x, params["wB"])
    Cm = torch.matmul(x, params["wC"])
    return z, xin, dt_raw, Bm, Cm


def _gated_out(params: dict, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig, dtype):
    """Mamba2's gated RMS norm before the out projection.  On DTensors the
    mean runs over the sharded inner dim by DTensor's rules (one
    all-reduce) and the projection is local
    (:func:`repro_torch.models.sharded.product`)."""

    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * params["norm"]
    return sharded.product(torch.matmul, "bsi,id->bsd", y.to(dtype), params["out"])


def _write_state(state: Optional[dict], h: torch.Tensor, tail: torch.Tensor) -> dict:
    """The new state; a given state dict is updated in place (the cache)."""

    if state is None:
        return {"ssm": h, "conv": tail}
    state["ssm"].copy_(h)
    state["conv"].copy_(tail)
    return state


def _mix(params: dict, x: torch.Tensor, cfg: ModelConfig, state: Optional[dict]):
    """The full-sequence mixer up to the gated norm: (y (B,S,H·P) f32, z,
    new state), for the heads ``params`` holds."""

    assert cfg.mamba is not None
    mc = cfg.mamba
    B_, S, _ = x.shape
    H, P = params["A_log"].shape[0], mc.head_dim

    z, xin, dt_raw, Bm, Cm = _project(params, x)
    conv_tail = state["conv"] if state is not None else None
    xin, new_tail = _causal_conv(xin, params["conv_x"], conv_tail)

    dt = softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    xh = xin.reshape(B_, S, H, P)
    h0 = state["ssm"] if state is not None else None
    y, h = ssd_chunked(xh, dt, A, Bm, Cm, mc.chunk, h0)
    y = y + xh.float() * params["D"][None, None, :, None]
    return y.reshape(B_, S, H * P), z, _write_state(state, h, new_tail)


def _mix_decode(params: dict, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """The one-token mixer up to the gated norm: (y (B,1,H·P) f32, z,
    state), the state updated in place."""

    assert cfg.mamba is not None
    mc = cfg.mamba
    B_ = x.shape[0]
    H, P = params["A_log"].shape[0], mc.head_dim

    z, xin, dt_raw, Bm, Cm = _project(params, x)
    xin, new_tail = _causal_conv(xin, params["conv_x"], state["conv"])

    dt = softplus(dt_raw.float() + params["dt_bias"][None, None, :])[:, 0]  # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])  # (B,H)
    xh = xin.reshape(B_, H, P).float()
    Bf = Bm[:, 0].float()  # (B,N)
    Cf = Cm[:, 0].float()

    h = state["ssm"].float()
    h = h * dA[..., None, None] + (dt[..., None] * xh)[..., None] * Bf[:, None, None, :]
    y = torch.matmul(h, Cf[:, None, :, None])[..., 0] + xh * params["D"][None, :, None]
    return y.reshape(B_, 1, H * P), z, _write_state(state, h, new_tail)


def mamba_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """Full-sequence (train/prefill) Mamba2 mixer starting from ``state``
    (zeros when None).  Returns (y, new_state); a given ``state`` is
    updated in place.  DTensor operands run the mixer on their local heads
    (:func:`repro_torch.models.sharded.mamba_mix`)."""

    y, z, new = sharded.mamba_mix(
        lambda p, xl, st: _mix(p, xl, cfg, st), params, x, state
    )
    return _gated_out(params, y, z, cfg, x.dtype), new


def mamba_decode_step(
    params: dict, x: torch.Tensor, cfg: ModelConfig, state: dict
) -> Tuple[torch.Tensor, dict]:
    """One-token step.  x (B,1,d); state {'ssm': (B,H,P,N), 'conv':
    (B,K-1,di)}, updated in place."""

    y, z, _ = sharded.mamba_mix(
        lambda p, xl, st: _mix_decode(p, xl, cfg, st), params, x, state
    )
    return _gated_out(params, y, z, cfg, x.dtype), state


def mamba_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    assert cfg.mamba is not None
    mc = cfg.mamba
    d = cfg.d_model
    H, P, N = mc.num_heads(d), mc.head_dim, mc.d_state
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros(
            (batch, mc.d_conv - 1, mc.d_inner(d)), dtype=cdtype(cfg), device=device
        ),
    }


def ssd_reference(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-recurrence oracle for the chunked SSD."""

    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (
        torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
        if h0 is None
        else h0.float()
    )
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])  # (B,H)
        inc = (dt[:, t, :, None] * x[:, t].float())[..., None] * Bm[:, t, None, None, :].float()
        h = h * dA[..., None, None] + inc
        ys.append(torch.matmul(h, Cm[:, t, None, :, None].float())[..., 0])
    return torch.stack(ys, dim=1), h
