"""Sharding rules: parameter/cache/batch specs per (config, mesh), as the
reference's ``launch/sharding.py``, and their DTensor placements.

MaxText-style logical rules resolved against the concrete mesh: an axis gets
a mesh axis only when the dimension size divides the mesh axis size —
otherwise the next candidate (or replication) applies.  This is what makes
one rule set serve GQA models whose kv_heads (4, 8, 16) may or may not
divide the 16-way model axis, MoE models with 8/16/64 experts, and the
long-context decode cells where the KV-cache *sequence* dimension takes the
spare mesh axes (flash-decoding layout).

A spec (:class:`P`) holds one entry per tensor dimension: a mesh axis name,
a tuple of them, or None.  The rules decide each leaf from the REFERENCE's
path and shape: the reference stacks a decoder's blocks (and an
encoder-decoder's layers, and their caches) on a leading axis, the port
keeps a list of per-block leaves (:mod:`repro_torch.tree`).  So a port leaf
is mapped to its reference leaf (:func:`reference_leaf`), the reference's
rule runs on it (whose stack dimension is never sharded), and the port's
spec is that spec without the stack entry.  :func:`placements` turns a
spec into DTensor placements, one per mesh dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, data_axes, model_axis_size


class P:
    """A partition spec: one entry per tensor dimension (an axis name, a
    tuple of axis names, or None), ``jax.sharding.PartitionSpec``'s
    counterpart.  Not a tuple, so a tree of specs keeps them as leaves."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _fits(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _pick(mesh, dim: int, *candidates):
    """First candidate mesh axis (or tuple) that divides ``dim``; a
    1-tuple collapses to its bare axis name, as in the reference."""

    for c in candidates:
        if c is None:
            continue
        if _fits(dim, _axis_size(mesh, c)):
            if isinstance(c, tuple) and len(c) == 1:
                return c[0]
            return c
    return None


# ---------------------------------------------------------------------- #
# the port's leaves as the reference's
# ---------------------------------------------------------------------- #

def reference_leaf(path: tuple, shape: Tuple[int, ...], tree) -> Tuple[tuple, Tuple[int, ...], bool]:
    """(reference path, reference shape, stacked) of the port leaf at
    ``path`` in ``tree``: a leaf of block ``b`` under a stacked list
    (``params["blocks"][b]``, an encoder-decoder cache's ``cache[b]``)
    is the reference's leaf of every block, with the block count leading."""

    if len(path) >= 2 and path[0] in tree_lib.STACKED and isinstance(path[1], int):
        n = len(tree[path[0]])
        return (path[0],) + tuple(path[2:]), (n,) + tuple(shape), True
    if path and isinstance(path[0], int):
        return tuple(path[1:]), (len(tree),) + tuple(shape), True
    return tuple(path), tuple(shape), False


def _port_specs(tree, rule):
    """A tree of ``tree``'s structure holding, per leaf, ``rule(reference
    path, reference shape)`` with the stack entry dropped."""

    out = []
    for path, leaf in tree_lib.flatten_with_paths(tree):
        rpath, rshape, stacked = reference_leaf(path, tuple(leaf.shape), tree)
        spec = tuple(rule(tuple(str(p) for p in rpath), rshape))
        spec = spec + (None,) * (len(rshape) - len(spec))
        if stacked:
            assert spec[0] is None, (path, spec)  # the stack dim stays whole
            spec = spec[1:]
        out.append(P(*spec))
    return tree_lib.unflatten(tree, out)


# ---------------------------------------------------------------------- #
# parameters
# ---------------------------------------------------------------------- #

def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig, mesh) -> P:
    """Spec of one parameter leaf of the REFERENCE's layout, identified by
    its tree path (stacked leaves lead with the block count)."""

    m = "model"
    ms = model_axis_size(mesh)
    name = path[-1]
    stacked = any(p in tree_lib.STACKED for p in path)
    lead: Tuple[Optional[str], ...] = (None,) if stacked else ()
    body = shape[1:] if stacked else shape

    def spec(*dims):
        return P(*lead, *dims)

    # shared experts are a plain dense MLP (not expert-stacked)
    in_moe = "moe" in path and "shared" not in path
    in_mamba = "mamba" in path

    if name == "tok":  # (V, d)
        return spec(_pick(mesh, body[0], m), None)
    if name == "head":  # (d, V)
        return spec(None, _pick(mesh, body[1], m))
    if name in ("wq",):  # (d, H, hd)
        return spec(None, _pick(mesh, body[1], m), None)
    if name in ("wk", "wv"):  # (d, KV, hd)
        return spec(None, _pick(mesh, body[1], m), None)
    if name == "wo":  # (H, hd, d)
        return spec(_pick(mesh, body[0], m), None, None)
    if in_moe and name in ("w_gate", "w_up"):  # (E, d, ff)
        mode = cfg.moe.shard if cfg.moe else "auto"
        if mode != "tp" and _fits(body[0], ms):
            return spec(m, None, None)          # expert-parallel
        return spec(None, None, _pick(mesh, body[2], m))  # TP within experts
    if in_moe and name == "w_down":  # (E, ff, d)
        mode = cfg.moe.shard if cfg.moe else "auto"
        if mode != "tp" and _fits(body[0], ms):
            return spec(m, None, None)
        return spec(None, _pick(mesh, body[1], m), None)
    if name == "router":  # (d, E)
        return spec(None, None)
    if name in ("w_gate", "w_up"):  # dense mlp (d, ff)
        return spec(None, _pick(mesh, body[1], m))
    if name == "w_down":  # (ff, d)
        return spec(_pick(mesh, body[0], m), None)
    if in_mamba and name in ("wz", "wx"):  # (d, di)
        return spec(None, _pick(mesh, body[1], m))
    if in_mamba and name == "wdt":  # (d, H)
        return spec(None, _pick(mesh, body[1], m))
    if in_mamba and name in ("wB", "wC"):  # (d, G*N) — small, replicate
        return spec(None, None)
    if in_mamba and name == "out":  # (di, d)
        return spec(_pick(mesh, body[0], m), None)
    if in_mamba and name == "conv_x":  # (K, di)
        return spec(None, _pick(mesh, body[1], m))
    if in_mamba and name in ("A_log", "D", "dt_bias"):  # (H,)
        return spec(_pick(mesh, body[0], m))
    if in_mamba and name == "norm":  # (di,)
        return spec(_pick(mesh, body[0], m))
    # norms / scalars: replicated
    return spec(*(None,) * len(body))


def params_pspecs(cfg: ModelConfig, mesh, params: Any):
    """Spec tree matching a (meta or real) port params tree."""

    return _port_specs(params, lambda path, shape: param_spec(path, shape, cfg, mesh))


def fsdp_pspecs(cfg: ModelConfig, mesh, params: Any):
    """FSDP/ZeRO sharding: the parameter spec plus the 'data' axis on the
    first still-unsharded *weight* dimension that divides it.  Used for the
    training cells' optimizer moments and gradient accumulator: cuts their
    per-rank residency by the DP degree.

    The leading stack dimension of the reference's stacked block leaves is
    never sharded (the port has no such dimension)."""

    if "data" not in mesh.mesh_dim_names:
        return params_pspecs(cfg, mesh, params)
    ds = axis_sizes(mesh)["data"]

    def rule(path, shape):
        spec = list(param_spec(path, shape, cfg, mesh))
        spec += [None] * (len(shape) - len(spec))
        stacked = any(p in tree_lib.STACKED for p in path)
        for i in range(1 if stacked else 0, len(shape)):
            dim, ax = shape[i], spec[i]
            if ax is None and dim % ds == 0 and dim >= ds:
                spec[i] = "data"
                break
        return P(*spec)

    return _port_specs(params, rule)


# backwards-compatible alias (moments-only use)
zero1_pspecs = fsdp_pspecs


# ---------------------------------------------------------------------- #
# batches
# ---------------------------------------------------------------------- #

def batch_pspecs(cfg: ModelConfig, mesh, batch: Any):
    dp = data_axes(mesh)

    def spec(leaf):
        b = _pick(mesh, leaf.shape[0], dp, "data")
        return P(b, *(None,) * (leaf.dim() - 1))

    return tree_lib.tree_map(spec, batch)


# ---------------------------------------------------------------------- #
# KV / state caches
# ---------------------------------------------------------------------- #

KV_NAMES = ("k", "v", "ck", "cv", "k_q", "v_q", "k_s", "v_s")


def cache_spec(path: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig, mesh) -> P:
    """Spec of one cache leaf of the REFERENCE's layout: batch→data when
    divisible; kv_heads→model when divisible, else the sequence dim takes
    the model axis (flash-decoding); with batch=1 (long-context) the
    sequence dim takes every leftover axis."""

    dp = data_axes(mesh)
    name = path[-1]
    ndim = len(shape)
    # stacked caches: scan-over-blocks (decoder) or the enc-dec cache
    # whose leaves are (L, B, S, KV, hd) without a 'blocks' path entry
    stacked = "blocks" in path or (
        name in KV_NAMES and ndim == 5
    ) or (name == "ssm" and ndim == 5) or (name == "conv" and ndim == 4)
    body = shape[1:] if stacked else shape
    lead = (None,) if stacked else ()

    if name in KV_NAMES:  # (B, S, KV, hd|1)
        Bdim, Sdim, KV, _ = body
        b = _pick(mesh, Bdim, dp, "data")
        kvh = _pick(mesh, KV, "model")
        seq_axes = []
        if b is None:
            seq_axes.extend(dp)
        if kvh is None:
            seq_axes.append("model")
        s = _pick(mesh, Sdim, tuple(seq_axes) if seq_axes else None)
        return P(*lead, b, s, kvh, None)
    if name == "ssm":  # (B, H, P, N)
        b = _pick(mesh, body[0], dp, "data")
        h = _pick(mesh, body[1], "model")
        return P(*lead, b, h, None, None)
    if name == "conv":  # (B, K-1, di)
        b = _pick(mesh, body[0], dp, "data")
        return P(*lead, b, None, _pick(mesh, body[2], "model"))
    return P(*lead, *(None,) * len(body))


def cache_pspecs(cfg: ModelConfig, mesh, cache: Any):
    return _port_specs(cache, lambda path, shape: cache_spec(path, shape, cfg, mesh))


# ---------------------------------------------------------------------- #
# DTensor placements
# ---------------------------------------------------------------------- #

def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where tensor dim ``d`` names that mesh dimension, else
    ``Replicate()``.  A tuple such as ("pod", "data") on one tensor
    dimension shards it over both, in mesh order (DTensor's order)."""

    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        order = [mesh.mesh_dim_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: axes of dim {d} out of mesh order")
        for a in names:
            if a in where:
                raise ValueError(f"spec {spec!r} names mesh axis {a!r} twice")
            where[a] = d
    return tuple(
        Shard(where[a]) if a in where else Replicate() for a in mesh.mesh_dim_names
    )


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, ``jax.sharding.NamedSharding``'s counterpart."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def named(mesh, pspec_tree):
    return tree_lib.tree_map(lambda s: NamedSharding(mesh, s), pspec_tree)


def local_shape(shape: Tuple[int, ...], sharding: NamedSharding) -> Tuple[int, ...]:
    """This rank's shard of a tensor of ``shape`` under ``sharding``."""

    from repro_torch.models.sharded import local_shape_and_offset

    return local_shape_and_offset(tuple(shape), sharding.mesh, sharding.placements)[0]


def distribute(tree, shardings):
    """Each leaf of ``tree`` as a DTensor under its sharding.  A real
    tensor is split from the full value every rank holds (no
    communication: every rank of the callers builds the same tensor from
    one seed); a meta or fake tensor gives an empty shard of its local
    shape on the mesh's device type, fake under ``FakeTensorMode``: the
    device-free dry run."""

    import torch
    from torch.distributed.tensor import DTensor

    def one(x, sh):
        if x.device.type == "meta" or _is_fake(x):
            local = torch.empty(
                local_shape(x.shape, sh), dtype=x.dtype, device=sh.mesh.device_type
            )
        else:
            local = _shard_of(x, sh)
        return DTensor.from_local(
            local, sh.mesh, sh.placements, run_check=False,
            shape=x.shape, stride=_contiguous_stride(x.shape),
        )

    return tree_lib.tree_map(one, tree, shardings)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


def _shard_of(x, sh: NamedSharding):
    """This rank's contiguous shard of the full tensor ``x``."""

    from repro_torch.models.sharded import local_shape_and_offset

    local, offset = local_shape_and_offset(tuple(x.shape), sh.mesh, sh.placements)
    out = x
    for d, (n, o) in enumerate(zip(local, offset)):
        if n != x.shape[d]:
            out = out.narrow(d, o, n)
    return out.contiguous()


def validate_divisibility(pspec_tree, shapes_tree, mesh) -> list:
    """(path, shape, spec) of every leaf whose spec does NOT divide it —
    must be empty before lowering (tested)."""

    bad = []
    flat = tree_lib.flatten_with_paths(shapes_tree)
    for (path, leaf), spec in zip(flat, tree_lib.leaves(pspec_tree)):
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 8):
            if ax is not None and dim % _axis_size(mesh, ax) != 0:
                bad.append((path, tuple(leaf.shape), spec))
    return bad
