"""Abstract stand-ins for every (arch × shape) dry-run cell, as the
reference's ``launch/input_specs.py``.

No device allocation: every tensor is on the ``meta`` device (the caller
may convert under ``FakeTensorMode``), and every sharding comes from the
rules in :mod:`repro_torch.launch.sharding`.  The abstract trees are the
port's layout (per-block leaves), the shardings are the reference's rules
decided on the reference's leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as shard_lib
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.optimizer import AdamW, AdamWState

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Abstract training/prefill batch for the cell."""

    B, S = shape.global_batch, shape.seq_len
    d = getattr(torch, cfg.dtype)
    specs: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        specs["frame_embeds"] = torch.empty(
            (B, cfg.encoder.num_frames, cfg.d_model), dtype=d, device=META
        )
        specs["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    elif cfg.frontend == "vision":
        # patch prefix + text fill the assigned sequence length
        text = S - cfg.num_patches
        assert text > 0
        specs["patch_embeds"] = torch.empty(
            (B, cfg.num_patches, cfg.d_model), dtype=d, device=META
        )
        specs["tokens"] = torch.empty((B, text), dtype=torch.int32, device=META)
    else:
        specs["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    if shape.kind == "train":
        specs["labels"] = torch.empty(
            specs["tokens"].shape, dtype=torch.int32, device=META
        )
    return specs


def abstract_state(cfg: ModelConfig, opt: AdamW):
    params = zoo.abstract_params(cfg)
    return params, opt.init(params)


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[torch.Tensor, Any, int]:
    """(tokens, cache, cache_len) stand-ins for a decode cell: one new token
    against a KV cache filled to seq_len - 1 (the new token's slot is the
    last)."""

    B, S = shape.global_batch, shape.seq_len
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    return tokens, zoo.abstract_cache(cfg, B, S), S - 1


def cell_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, opt: AdamW) -> Dict[str, Any]:
    """All in/out shardings for the cell's step function: ``params``,
    ``opt_state`` and ``grad_shardings`` (train), ``batch`` and ``cache``
    (prefill and decode) as :class:`~repro_torch.launch.sharding.
    NamedSharding` trees, each beside its abstract tree
    (``params_abstract``, ...)."""

    out: Dict[str, Any] = {}
    params = zoo.abstract_params(cfg)

    # parameters: tensor-parallel resident; ZeRO-1 moments and the ZeRO-2
    # gradient accumulator shard over 'data' besides
    out["params_abstract"] = params
    out["params"] = shard_lib.named(mesh, shard_lib.params_pspecs(cfg, mesh, params))

    if shape.kind == "train":
        zspec = shard_lib.zero1_pspecs(cfg, mesh, params)
        out["opt_state_abstract"] = opt.init(params)
        out["opt_state"] = AdamWState(
            step=shard_lib.NamedSharding(mesh, shard_lib.P()),
            mu=shard_lib.named(mesh, zspec),
            nu=shard_lib.named(mesh, zspec),
        )
        out["grad_shardings"] = shard_lib.named(mesh, zspec)

    b = batch_specs(cfg, shape)
    out["batch_abstract"] = b
    out["batch"] = shard_lib.named(mesh, shard_lib.batch_pspecs(cfg, mesh, b))

    if shape.kind in ("prefill", "decode"):
        cache = zoo.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        out["cache_abstract"] = cache
        out["cache"] = shard_lib.named(mesh, shard_lib.cache_pspecs(cfg, mesh, cache))
    return out


def argument_bytes(abstract: Any, shardings: Any) -> int:
    """Bytes this rank holds of ``abstract`` under ``shardings``: each
    leaf's local shard."""

    total = 0
    for leaf, sh in zip(tree_lib.leaves(abstract), tree_lib.leaves(shardings)):
        n = 1
        for s in shard_lib.local_shape(tuple(leaf.shape), sh):
            n *= s
        total += n * leaf.element_size()
    return total
