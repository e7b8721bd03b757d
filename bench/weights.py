"""Seeded weights, made on the device in a few large calls and laid out as
the port's parameter tree, from the leaves a family lists
(``families/<family>.py``'s ``leaf_specs``).

One ``torch.randn`` stream (in chunks of at most ``CHUNK`` elements) fills
one bf16 buffer; every drawn leaf is a view of it, scaled in place.  The same
seed gives the same weights on the same device, so the program and the
plain reference are handed the same values, and the reference can make
them again after the program's state is freed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30

Path = Tuple[object, ...]
Spec = Tuple[Path, Tuple[int, ...], object]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_flat(specs: List[Spec], seed: int, device) -> Dict[Path, torch.Tensor]:
    """Every leaf of ``specs`` (path, shape, init) by path.  An init is a
    scale: a bf16 view of the seeded buffer times it; ``(dtype, scale)``:
    that draw in another dtype (an MoE router the port keeps in float32);
    or ``"ones"``: float32 ones (a norm scale)."""

    total = sum(_numel(s) for _, s, init in specs if init != "ones")
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    for lo in range(0, total, CHUNK):
        hi = min(lo + CHUNK, total)
        buf[lo:hi] = torch.randn(hi - lo, generator=gen, device=device, dtype=torch.bfloat16)
    out: Dict[Path, torch.Tensor] = {}
    off = 0
    for path, shape, init in specs:
        if init == "ones":
            out[path] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = _numel(shape)
        draw = buf[off:off + n].view(shape)
        if isinstance(init, tuple):
            dtype, scale = init
            out[path] = draw.to(getattr(torch, dtype)).mul_(scale)
        else:
            out[path] = draw.mul_(init)
        off += n
    return out


def tree_of(flat: Dict[Path, torch.Tensor]) -> dict:
    """The port's nested parameter tree of a flat ``{path: tensor}``."""

    tree: dict = {"blocks": [], "rem": {}}
    for path, t in flat.items():
        node = tree
        for i, key in enumerate(path[:-1]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(path[i + 1], int) else {})
        node[path[-1]] = t
    return tree


def paths_of(tree, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) of a nested dict / list / tuple tree, depth first."""

    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += paths_of(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, c in enumerate(tree):
            out += paths_of(c, prefix + (i,))
        return out
    return [(prefix, tree)]
