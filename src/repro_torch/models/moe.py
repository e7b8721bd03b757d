"""Mixture-of-Experts MLP: top-k router + GShard-style grouped dispatch, as
the reference's ``models/moe.py``.

Dispatch is capacity-based within token groups of ``group_size``: each
(token, k) pair takes the next free slot of its expert's ``C`` slots in
token-major, then k, order, and a pair past the last slot is dropped (its
one-hot row is all zeros).  The expert weights stay stacked on their
leading ``E`` axis, ``(E, d, ff)``, and the dispatch, the experts and the
combine are grouped einsums over every expert, as in the reference (the
products are ``torch.einsum`` / ``matmul``, as the reference leaves them to
XLA outside any Pallas kernel).  Supports deepseek-style shared experts
(always-on dense experts added to the routed output).

``torch.einsum`` may reorder a product of three operands (``opt_einsum``);
every product here has two, in a fixed order, so every machine forms the
same intermediates.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import sharded
from repro_torch.models.layers import cdtype, mlp, mlp_init, normal


def moe_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    assert cfg.moe is not None
    mc = cfg.moe
    d, ff, E = cfg.d_model, mc.d_ff_expert, mc.num_experts
    s_in, s_out = d**-0.5, ff**-0.5
    dtype = cdtype(cfg)
    params = {
        "router": normal(generator, (d, E), s_in, torch.float32),
        "w_gate": normal(generator, (E, d, ff), s_in, dtype),
        "w_up": normal(generator, (E, d, ff), s_in, dtype),
        "w_down": normal(generator, (E, ff, d), s_out, dtype),
    }
    if mc.num_shared:
        params["shared"] = mlp_init(generator, d, ff * mc.num_shared, dtype)
    return params


def _capacity(mc: MoEConfig, group: int) -> int:
    cap = int(group * mc.top_k * mc.capacity_factor / mc.num_experts)
    return max(cap, mc.top_k)


def _route(params: dict, xg: torch.Tensor, mc: MoEConfig, C: int):
    """The router over token groups xg (n,G,d): (probs (n,G,E), the
    renormalised top-k probabilities (n,G,K), their experts' one-hot rows
    (n,G,K,E), each (token, k) pair's slot in its expert (n,G,K), and
    whether that slot is below the capacity ``C``)."""

    E, K = mc.num_experts, mc.top_k
    n, G, _ = xg.shape
    logits = torch.matmul(xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)

    # top-k selection per token (ties, rare in f32, may order differently
    # from jax.lax.top_k's lower-index-first)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, k) within its expert's capacity: slots taken
    # in token-major, then k, order
    onehot = (top_e[..., None] == torch.arange(E, device=xg.device)).float()
    flat = onehot.reshape(n, G * K, E)
    pos = torch.cumsum(flat, dim=1) - flat  # slots before this one
    pos = (pos * flat).sum(-1).reshape(n, G, K)
    return probs, top_p, onehot, pos, pos < C


def _experts(params: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """The stacked SwiGLU experts over (E, ..., d) rows, expert by expert
    in one batched product each."""

    E, d = expert_in.shape[0], expert_in.shape[-1]
    rows = expert_in.reshape(E, -1, d)
    gate = torch.bmm(rows, params["w_gate"])
    up = torch.bmm(rows, params["w_up"])
    act = torch.nn.functional.silu(gate.float()).to(rows.dtype) * up
    return torch.bmm(act, params["w_down"]).reshape(expert_in.shape)


def _routed(
    params: dict, x: torch.Tensor, cfg: ModelConfig, G: int, e0: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts' output and the aux loss over the token groups
    of ``x`` (groups of ``G``), for the experts ``params`` holds: all of
    them, or (expert-parallel) ``params["w_gate"].shape[0]`` of them from
    expert ``e0`` on, whose output is then a partial sum."""

    assert cfg.moe is not None
    mc = cfg.moe
    B, S, d = x.shape
    E = mc.num_experts
    El = params["w_gate"].shape[0]
    n = B * S // G
    C = _capacity(mc, G)

    xg = x.reshape(n, G, d)
    probs, top_p, onehot, pos, keep = _route(params, xg, mc, C)
    top_p = top_p * keep

    # dispatch (n,G,E,C) / combine weights; a dropped pair (pos >= C) has
    # an all-zero one-hot row, as jax.nn.one_hot gives it
    slots = torch.arange(C, device=x.device)
    pos_oh = (pos[..., None] == slots).float()  # (n,G,K,C)
    to_experts = onehot.transpose(2, 3)  # (n,G,E,K)
    if El != E:
        to_experts = to_experts[:, :, e0 : e0 + El]
    dispatch = torch.matmul(to_experts, pos_oh * keep[..., None])
    combine = torch.matmul(to_experts, pos_oh * top_p[..., None])

    # expert_in[e, n, c] = the token of group n in expert e's slot c
    expert_in = torch.bmm(
        dispatch.to(x.dtype).permute(0, 2, 3, 1).reshape(n, El * C, G), xg
    ).reshape(n, El, C, d).transpose(0, 1)  # (E,n,C,d)
    expert_out = _experts(params, expert_in)
    yg = torch.matmul(
        combine.to(x.dtype).reshape(n, G, El * C),
        expert_out.permute(1, 0, 2, 3).reshape(n, El * C, d),
    )  # (n,G,d)

    # aux load-balancing loss
    density = onehot.sum(dim=2).mean(dim=1)  # (n,E) token fraction
    router_prob = probs.mean(dim=1)  # (n,E)
    aux = (density * router_prob).sum(-1).mean() * E
    return yg.reshape(B, S, d), aux.float()


def moe_apply(
    params: dict, x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) → (y (B,S,d), aux_loss scalar f32).

    The aux loss is the load-balancing term: the mean over groups of
    sum_e(fraction of tokens routed to e × mean router prob of e) × E.
    DTensor operands run the dispatch on their local shards
    (:func:`repro_torch.models.sharded.moe`)."""

    assert cfg.moe is not None
    mc = cfg.moe
    B, S, d = x.shape
    tokens = B * S
    G = min(mc.group_size, tokens)
    assert (tokens // G) * G == tokens, (tokens, G)

    y, aux = sharded.moe(lambda p, xl, e0: _routed(p, xl, cfg, G, e0), params, x, G)
    if mc.num_shared:
        y = y + mlp(params["shared"], x)
    return y, aux


def moe_reference(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts exactly (no
    capacity drops)."""

    assert cfg.moe is not None
    mc = cfg.moe
    B, S, d = x.shape
    logits = torch.matmul(x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, mc.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    def per_expert(e):
        gate = torch.matmul(x, params["w_gate"][e])
        up = torch.matmul(x, params["w_up"][e])
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        return torch.matmul(act, params["w_down"][e])

    all_out = torch.stack([per_expert(e) for e in range(mc.num_experts)])  # (E,B,S,d)
    sel = torch.gather(
        all_out.permute(1, 2, 0, 3),  # (B,S,E,d)
        2,
        top_e[..., None].expand(B, S, mc.top_k, d),
    )  # (B,S,K,d)
    y = torch.sum(sel * top_p[..., None].to(x.dtype), dim=2)
    if mc.num_shared:
        y = y + mlp(params["shared"], x)
    return y
