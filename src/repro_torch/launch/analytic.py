"""Analytic FLOP/byte floors per (arch × shape) cell.

XLA:CPU's ``cost_analysis`` mis-scales loop trip counts on scanned programs
(measured both under- and over-counting vs hand calculation — see
EXPERIMENTS.md §Roofline), so the roofline table reports BOTH the HLO-derived
terms and these analytic floors.  The floors follow the standard conventions:

  * linear/projection FLOPs: 2·N_active per token (6·N with backward);
  * attention: 4·Sq·Sk_eff·H·hd per layer per sequence (QKᵀ + PV), with
    Sk_eff halved for causal masks and clamped to the sliding window;
  * SSD mixer: intra-chunk dual form + state path per token;
  * HBM bytes: per-chip resident parameter reads, KV-cache traffic (decode),
    microbatch activation I/O at the remat=full checkpoint boundaries, and
    optimizer state traffic (train).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    MAMBA,
    MLP_MOE,
    ModelConfig,
    ShapeConfig,
)


def _attn_layer_flops_fwd(
    cfg: ModelConfig, S_q: int, S_k: int, causal: bool, window
) -> float:
    H, hd = cfg.padded_num_heads, cfg.head_dim
    if window is not None:
        sk_eff = min(window, S_k)
    elif causal and S_q == S_k:
        sk_eff = S_k / 2
    else:
        sk_eff = S_k
    return 4.0 * S_q * sk_eff * H * hd


def _ssd_layer_flops_fwd(cfg: ModelConfig, tokens: float) -> float:
    mc = cfg.mamba
    H = mc.num_heads(cfg.d_model)
    P, N, Q = mc.head_dim, mc.d_state, mc.chunk
    per_token_head = 2.0 * Q * (N + P) + 4.0 * N * P
    return per_token_head * H * tokens


def _layer_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Per-model counts of each mixer kind across all layers."""

    n_block = cfg.num_blocks
    counts = {ATTN: 0.0, ATTN_LOCAL: 0.0, MAMBA: 0.0}
    for i, pos in enumerate(cfg.block):
        reps = n_block + (1 if i < cfg.remainder_layers else 0)
        counts[pos.mixer] += reps
    return counts


def forward_flops(cfg: ModelConfig, shape: ShapeConfig, n_active: int) -> float:
    """Total forward FLOPs for one step of the cell (all chips)."""

    B, S = shape.global_batch, shape.seq_len
    counts = _layer_counts(cfg)

    if shape.kind == "decode":
        tokens = float(B)  # one new token per sequence
        lin = 2.0 * n_active * tokens
        attn = B * (
            counts[ATTN] * _attn_layer_flops_fwd(cfg, 1, S, False, None)
            + counts[ATTN_LOCAL]
            * _attn_layer_flops_fwd(cfg, 1, S, False, cfg.sliding_window)
        )
        ssd = counts[MAMBA] * _ssd_layer_flops_fwd(cfg, tokens) if cfg.has_mamba else 0.0
        extra = 0.0
        if cfg.family == "encdec":
            # cross-attention over cached encoder K/V
            extra = B * cfg.num_layers * _attn_layer_flops_fwd(
                cfg, 1, cfg.encoder.num_frames, False, None
            )
        return lin + attn + ssd + extra

    tokens = float(B) * S
    lin = 2.0 * n_active * tokens
    attn = B * (
        counts[ATTN] * _attn_layer_flops_fwd(cfg, S, S, True, None)
        + counts[ATTN_LOCAL]
        * _attn_layer_flops_fwd(cfg, S, S, True, cfg.sliding_window)
    )
    ssd = counts[MAMBA] * _ssd_layer_flops_fwd(cfg, tokens) if cfg.has_mamba else 0.0
    extra = 0.0
    if cfg.family == "encdec":
        F = cfg.encoder.num_frames
        # encoder self-attention (bidirectional) + decoder cross-attention
        extra = B * cfg.encoder.num_layers * _attn_layer_flops_fwd(
            cfg, F, F, False, None
        ) + B * cfg.num_layers * _attn_layer_flops_fwd(cfg, S, F, False, None)
    return lin + attn + ssd + extra


def step_flops(cfg: ModelConfig, shape: ShapeConfig, n_active: int) -> float:
    fwd = forward_flops(cfg, shape, n_active)
    if shape.kind != "train":
        return fwd
    # fwd + bwd(2x) + full-remat recompute (+1 fwd when remat='full')
    remat_extra = 1.0 if cfg.remat == "full" else 0.0
    return (3.0 + remat_extra) * fwd


# ---------------------------------------------------------------------- #
# bytes
# ---------------------------------------------------------------------- #

def _params_bytes_per_chip(cfg: ModelConfig, n_params: int, chips_model: int) -> float:
    return 2.0 * n_params / chips_model  # bf16, tensor-parallel resident


def _cache_bytes_total(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    counts = _layer_counts(cfg)
    # bf16 cache: 2 B/elem; int8-quantized: 1 B + f32 scale per head_dim group
    kv_bytes = (1.0 + 4.0 / cfg.head_dim) if cfg.kv_quant else 2.0
    kv = (counts[ATTN] + counts[ATTN_LOCAL]) * B * S * cfg.num_kv_heads * cfg.head_dim * kv_bytes * 2
    ssm = 0.0
    if cfg.has_mamba:
        mc = cfg.mamba
        ssm = counts[MAMBA] * B * mc.num_heads(cfg.d_model) * mc.head_dim * mc.d_state * 4
    if cfg.family == "encdec":
        kv += cfg.num_layers * B * cfg.encoder.num_frames * cfg.num_kv_heads * cfg.head_dim * 2 * 2
    return kv + ssm


def step_bytes_per_chip(
    cfg: ModelConfig,
    shape: ShapeConfig,
    n_params: int,
    n_active: int,
    chips: int,
    microbatches: int = 8,
) -> float:
    """Per-chip HBM traffic floor for one step."""

    model_shard = 16  # model axis size in both production meshes
    B, S = shape.global_batch, shape.seq_len
    p_chip = _params_bytes_per_chip(cfg, n_params, model_shard)

    if shape.kind == "decode":
        cache_chip = _cache_bytes_total(cfg, shape) / chips
        # all resident (active for MoE) weights + the full cache are read once
        active_chip = 2.0 * n_active / model_shard
        return active_chip + cache_chip

    act_io = B * S * cfg.d_model * 2.0 * cfg.num_layers * 4.0 / chips  # carry r/w
    if shape.kind == "prefill":
        return p_chip + act_io + _cache_bytes_total(cfg, shape) / chips
    # train: fwd+bwd weight reads, f32 grad write+read, ZeRO moments traffic
    grads = 4.0 * n_params / model_shard
    opt = 3.0 * 8.0 * n_params / chips  # mu+nu f32 read+write (ZeRO-1)
    return 2.0 * p_chip * microbatches + grads + opt + 3.0 * act_io


def analytic_record(
    cfg: ModelConfig,
    shape: ShapeConfig,
    n_params: int,
    n_active: int,
    chips: int,
    microbatches: int = 8,
) -> dict:
    flops = step_flops(cfg, shape, n_active)
    bytes_chip = step_bytes_per_chip(
        cfg, shape, n_params, n_active, chips, microbatches
    )
    return {
        "flops_total": flops,
        "flops_per_chip": flops / chips,
        "bytes_per_chip": bytes_chip,
    }
