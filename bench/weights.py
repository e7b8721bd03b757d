"""Seeded weights of a dense decoder, made on the device in a few large
calls and laid out as the port's parameter tree.

One ``torch.randn`` stream (in chunks of at most ``CHUNK`` elements) fills
one bf16 buffer; every matrix is a view of it, scaled in place.  The same
seed gives the same weights on the same device, so the program and the
plain reference are handed the same values, and the reference can make
them again after the program's state is freed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30
EMBED_SCALE = 0.02

Path = Tuple[object, ...]


def leaf_specs(dims) -> List[Tuple[Path, Tuple[int, ...], str]]:
    """(path in the port's tree, shape, init) of every leaf, in draw order;
    init is a scale for a N(0, 1) draw, or ``"ones"`` for a norm scale."""

    d, H, KV, hd = dims.d_model, dims.num_heads, dims.num_kv_heads, dims.head_dim
    ff, Vp = dims.d_ff, dims.padded_vocab
    if H % 16 and H > 16:
        raise ValueError(f"{dims.name}: {H} query heads would be padded by the port")
    specs = [(("embed", "tok"), (Vp, d), EMBED_SCALE)]
    if not dims.tie_embeddings:  # tied: the head is the table's transpose
        specs.append((("embed", "head"), (d, Vp), EMBED_SCALE))
    for b in range(dims.num_layers):
        p = ("blocks", b, "pos0")
        specs += [
            (p + ("norm1", "scale"), (d,), "ones"),
            (p + ("attn", "wq"), (d, H, hd), d**-0.5),
            (p + ("attn", "wk"), (d, KV, hd), d**-0.5),
            (p + ("attn", "wv"), (d, KV, hd), d**-0.5),
            (p + ("attn", "wo"), (H, hd, d), (H * hd) ** -0.5),
            (p + ("norm2", "scale"), (d,), "ones"),
            (p + ("mlp", "w_gate"), (d, ff), d**-0.5),
            (p + ("mlp", "w_up"), (d, ff), d**-0.5),
            (p + ("mlp", "w_down"), (ff, d), ff**-0.5),
        ]
    specs.append((("final_norm", "scale"), (d,), "ones"))
    return specs


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_flat(dims, seed: int, device) -> Dict[Path, torch.Tensor]:
    """Every leaf by path: the matrices bf16 views of one seeded buffer, the
    norm scales f32 ones."""

    specs = leaf_specs(dims)
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
        out[path] = buf[off:off + n].view(shape).mul_(init)
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
