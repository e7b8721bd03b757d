"""Carry programs, stores and model weights across from the JAX package.

:func:`program_from_reference` rebuilds a reference ``LoopProgram`` from
this package's IR classes, field by field, with the compute callables
passed through unchanged; :func:`store_from_reference` copies a store.
:func:`params_from_jax` turns a reference parameter tree (NumPy arrays)
into the port's parameters (decoder or encoder-decoder),
:func:`opt_state_from_jax` and :func:`snapshot_from_jax` carry an
optimizer state and a training checkpoint across the same way, and
:func:`cache_to_jax_layout` lays the port's cache (KV, Mamba state,
cross-attention K/V) out as the reference's.  All read attributes and
arrays only (duck typing) and import nothing of the reference package, so
the port stays importable without it.  Matmul operands need no converter:
they are NumPy arrays on both sides (``torch.from_numpy``).
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.core.ir import ArrayRef, IndirectRef, LoopProgram, Statement


def _ref(ref):
    """An ``ArrayRef`` / ``IndirectRef`` (or ``None``) of the port."""

    if ref is None:
        return None
    index = getattr(ref, "index", None)
    if index is not None:
        return IndirectRef(ref.array, _ref(index), int(ref.offset))
    return ArrayRef(ref.array, ref.offset)


def _statement(stmt) -> Statement:
    return Statement(
        stmt.name,
        _ref(stmt.write),
        tuple(_ref(r) for r in stmt.reads),
        compute=stmt.compute,
        guard=_ref(stmt.guard),
    )


def program_from_reference(prog) -> LoopProgram:
    """The port's ``LoopProgram`` for a reference one."""

    return LoopProgram(
        statements=tuple(_statement(s) for s in prog.statements),
        bounds=tuple(tuple(b) for b in prog.bounds),
    )


def store_from_reference(store: Mapping[str, Mapping]) -> dict:
    """A copy of a ``{array: {cell: value}}`` store."""

    return {a: dict(cells) for a, cells in store.items()}


# ---------------------------------------------------------------------- #
# Model weights and KV caches
# ---------------------------------------------------------------------- #

def tensor_from_numpy(arr, device="cuda"):
    """A tensor equal to ``arr`` on ``device``.  ``torch.from_numpy``
    rejects ml_dtypes' ``bfloat16``, so a bf16 array crosses as its 16-bit
    pattern (``view(uint16)`` → ``view(torch.bfloat16)``)."""

    import numpy as np
    import torch

    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, n: int, conv) -> list:
    """A stacked reference subtree as a list of ``n`` per-block trees."""

    return [_map(tree, lambda a, b=b: conv(a[b])) for b in range(n)]


def params_from_jax(cfg, tree, *, device="cuda") -> dict:
    """The port's parameters for a reference tree
    (``repro.models.model_zoo.init``'s, as NumPy arrays): the stacked
    ``blocks`` (decoder) or ``enc_blocks`` / ``dec_blocks``
    (encoder-decoder) are unstacked along their leading axis into lists of
    per-block dicts, MoE expert stacks staying whole inside each block;
    every other leaf is copied."""

    def conv(a):
        return tensor_from_numpy(a, device)

    if cfg.family == "encdec":
        return {
            "embed": _map(tree["embed"], conv),
            "enc_blocks": _unstack(tree["enc_blocks"], cfg.encoder.num_layers, conv),
            "enc_norm": _map(tree["enc_norm"], conv),
            "dec_blocks": _unstack(tree["dec_blocks"], cfg.num_layers, conv),
            "final_norm": _map(tree["final_norm"], conv),
        }
    return {
        "embed": _map(tree["embed"], conv),
        "blocks": _unstack(tree["blocks"], cfg.num_blocks, conv),
        "rem": _map(tree.get("rem", {}), conv),
        "final_norm": _map(tree["final_norm"], conv),
    }


def opt_state_from_jax(cfg, state, *, device="cuda"):
    """The port's ``AdamWState`` for a reference one: the step as an int32
    tensor, ``mu`` and ``nu`` unstacked like the params."""

    import numpy as np
    import torch

    from repro_torch.optim.optimizer import AdamWState

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
        mu=params_from_jax(cfg, state.mu, device=device),
        nu=params_from_jax(cfg, state.nu, device=device),
    )


def snapshot_from_jax(cfg, snap, *, device="cuda"):
    """The port's ``Snapshot`` for a reference training checkpoint
    (``repro.checkpoint.manager.Snapshot`` of ``{"params", "opt"}``, as its
    ``train_loop`` saves them): the step, the converted tree and the data
    stream's ``DataState``, so the port resumes where the reference left
    off."""

    from repro_torch.checkpoint.manager import Snapshot
    from repro_torch.data.pipeline import DataState

    ds = snap.data_state
    return Snapshot(
        step=int(snap.step),
        tree={
            "params": params_from_jax(cfg, snap.tree["params"], device=device),
            "opt": opt_state_from_jax(cfg, snap.tree["opt"], device=device),
        },
        data_state=DataState(seed=ds.seed, step=ds.step) if ds is not None else None,
    )


def cache_to_jax_layout(cfg, cache) -> dict:
    """The port's cache as NumPy arrays in the reference's layout.  A
    decoder's per-block caches (KV entries, Mamba ``ssm`` / ``conv``
    states) are stacked on a leading ``num_blocks`` axis under ``blocks``
    (absent without blocks), ``rem`` as it is; an encoder-decoder's
    per-layer ``{"k", "v", "ck", "cv"}`` are stacked on a leading layer
    axis, with no ``blocks`` / ``rem``.  bf16 entries come back as float32
    (exact)."""

    import numpy as np
    import torch

    def host(t):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()

    def stacked(trees):
        if isinstance(trees[0], Mapping):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return np.stack([host(t) for t in trees])

    if cfg.family == "encdec":
        return stacked(cache)
    out = {"rem": _map(cache["rem"], host)}
    if cfg.num_blocks:
        out["blocks"] = stacked(cache["blocks"])
    return out
