"""Nested-container helpers over the port's parameter and state trees.

A tree is a dict, list, tuple or NamedTuple of trees, and anything else is a
leaf.  Dict children go in sorted key order, as ``jax.tree`` orders them, so
a flattened tree lists its leaves in the reference's order wherever the two
layouts agree.

The reference stacks a decoder's ``num_blocks`` repeating blocks, and an
encoder-decoder's encoder and decoder layers, on a leading axis, so one of
its leaves holds that tensor of every block; the port keeps
``params["blocks"]``, ``["enc_blocks"]`` and ``["dec_blocks"]`` as lists
of per-block dicts (:func:`repro_torch.convert.params_from_jax`).  :func:`reference_groups`
maps the port's leaves back onto the reference's: what the reference
computes per leaf (the rank that decides weight decay, an int8 scale, a
top-k set) the port computes per group.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a container, or [] for a leaf."""

    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """Every (path, leaf) in order; a path is the keys and indices down."""

    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for k, child in _children(tree):
        out.extend(flatten_with_paths(child, prefix + (k,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""

    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def _rebuild(like, it):
    if _is_leaf(like):
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the structure holds")
        return leaf
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: done[k] for k in like}
    children = [_rebuild(c, it) for c in like]
    if _is_namedtuple(like):
        return type(like)(*children)
    return type(like)(children)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""

    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])


STACKED = ("blocks", "enc_blocks", "dec_blocks")


def reference_groups(tree) -> List[Tuple[List[int], bool]]:
    """The port's leaves grouped as the reference's: a leaf under
    ``[g][b]``, for ``g`` in :data:`STACKED` and a list ``tree[g]``, joins
    the same leaf of every other block of ``g`` (in block order, the
    reference's stacking order); any other leaf is a group of its own.
    Each group is (leaf indices in flattened order, stacked)."""

    lists = (
        {g for g in STACKED if isinstance(tree.get(g), list)}
        if isinstance(tree, dict) else set()
    )
    groups: Dict[Path, List[int]] = {}
    for i, (path, _) in enumerate(flatten_with_paths(tree)):
        key = (path[0],) + path[2:] if path and path[0] in lists else path
        groups.setdefault(key, []).append(i)
    return [(idx, bool(key) and key[0] in lists) for key, idx in groups.items()]


def reference_ndims(tree) -> List[int]:
    """Each leaf's rank in the reference's layout, in flattened order: a
    block leaf has the reference's leading ``num_blocks`` axis besides."""

    flat = leaves(tree)
    out = [0] * len(flat)
    for idx, stacked in reference_groups(tree):
        for i in idx:
            out[i] = flat[i].ndim + (1 if stacked else 0)
    return out
