"""A test fixture: a family added as files alone.  A tiny decoder whose
layers alternate a dense SwiGLU MLP and a mixture of experts with shared
experts, in the shape of the port's ``deepseek_moe_16b.smoke_config``;
``tests/reference/tiny_moe.py`` is its plain reference.  It gives the
pieces that a ``prefill_closed`` cell and its metrics use.

The configuration file's keys: the dense decoder's, and ``n_routed_experts``,
``num_experts_per_tok``, ``moe_intermediate_size``, ``n_shared_experts``,
``expert_layer_period`` / ``expert_layer_offset`` (layer ``i`` has experts
where ``i % period == offset``), ``moe_group_size`` and
``moe_capacity_factor`` (the port's dispatch group and capacity).
:func:`dims` refuses a capacity at which the port could drop a (token,
expert) pair: the reference drops none.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from families import llama
from reference.tiny_moe import exact, fp8, last_logits  # noqa: F401  (the plain reference)


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    score_scale: float
    dtype: str
    tie_embeddings: bool
    block: Tuple[str, ...]  # "dense" or "moe", a position of the repeating block
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int
    group_size: int
    capacity_factor: float
    padded_vocab: int = 0


def dims(name: str, raw: dict) -> Dims:
    base = llama.dims(name, raw)
    period, offset = raw["expert_layer_period"], raw["expert_layer_offset"]
    if base.num_layers % period:
        raise ValueError(f"{name}: {base.num_layers} layers are no whole number of blocks")
    E, K = raw["n_routed_experts"], raw["num_experts_per_tok"]
    cap = raw["moe_capacity_factor"]
    if int(raw["moe_group_size"] * K * cap / E) < raw["moe_group_size"]:
        raise ValueError(f"{name}: capacity factor {cap} could drop a (token, expert) pair")
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(llama.Dims)}
    return Dims(**fields, block=tuple("moe" if i == offset else "dense" for i in range(period)),
                num_experts=E, top_k=K, d_ff_expert=raw["moe_intermediate_size"],
                num_shared=raw["n_shared_experts"], group_size=raw["moe_group_size"],
                capacity_factor=float(cap))


def port_config(d: Dims, **overrides):
    from repro_torch.configs.base import ATTN, MLP_DENSE, MLP_MOE, LayerPos, ModelConfig, MoEConfig

    return ModelConfig(
        name=d.name, family="decoder", num_layers=d.num_layers, d_model=d.d_model,
        num_heads=d.num_heads, num_kv_heads=d.num_kv_heads, head_dim=d.head_dim,
        d_ff=d.d_ff, vocab_size=d.vocab_size,
        block=tuple(LayerPos(mixer=ATTN, mlp=MLP_MOE if m == "moe" else MLP_DENSE)
                    for m in d.block),
        moe=MoEConfig(num_experts=d.num_experts, top_k=d.top_k, d_ff_expert=d.d_ff_expert,
                      num_shared=d.num_shared, group_size=d.group_size,
                      capacity_factor=d.capacity_factor),
        rope_theta=d.rope_theta, norm_eps=d.norm_eps, dtype=d.dtype,
        tie_embeddings=d.tie_embeddings, **overrides,
    )


def leaf_specs(d: Dims):
    specs = llama.embed_specs(d)
    for b in range(d.num_layers // len(d.block)):
        for i, mlp in enumerate(d.block):
            p = ("blocks", b, f"pos{i}")
            specs += llama.attention_specs(d, p)
            specs += llama.mlp_specs(d, p) if mlp == "dense" else moe_specs(d, p)
    specs.append((("final_norm", "scale"), (d.d_model,), "ones"))
    return specs


def moe_specs(d: Dims, p):
    """The second norm, the router (kept in float32, as the port keeps it),
    the stacked experts and the shared experts' one MLP."""

    dm, E, ffe = d.d_model, d.num_experts, d.d_ff_expert
    ffs, m = ffe * d.num_shared, p + ("moe",)
    return [
        (p + ("norm2", "scale"), (dm,), "ones"),
        (m + ("router",), (dm, E), ("float32", dm**-0.5)),
        (m + ("w_gate",), (E, dm, ffe), dm**-0.5),
        (m + ("w_up",), (E, dm, ffe), dm**-0.5),
        (m + ("w_down",), (E, ffe, dm), ffe**-0.5),
        (m + ("shared", "w_gate"), (dm, ffs), dm**-0.5),
        (m + ("shared", "w_up"), (dm, ffs), dm**-0.5),
        (m + ("shared", "w_down"), (ffs, dm), ffs**-0.5),
    ]


def prefill_flops(d: Dims, B: int, S: int) -> float:
    """The dense decoder's, with each expert layer's MLP replaced by its
    router, ``top_k`` experts and the shared experts, a token."""

    n_moe = d.num_layers // len(d.block) * d.block.count("moe")
    dense_mlp = 3 * d.d_model * d.d_ff
    expert_mlp = d.d_model * d.num_experts + 3 * d.d_model * d.d_ff_expert * (d.top_k + d.num_shared)
    return llama.prefill_flops(d, B, S) + 2.0 * n_moe * (expert_mlp - dense_mlp) * B * S


flash_calls = llama.flash_calls
