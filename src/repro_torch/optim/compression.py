"""Error-feedback gradient compression for the DP all-reduce, as the
reference's ``optim/compression.py``.

Two compressors, both with error feedback (the residual between the true
and compressed gradient is carried into the next step, preserving
convergence — Karimireddy et al. style):

  * :class:`Int8Compressor` — per-tensor symmetric int8 quantization:
    4× fewer all-reduce bytes (f32→int8) at ~1/255 relative rounding,
    absorbed by the EF residual.
  * :class:`TopKCompressor` — magnitude top-k sparsification (k as a
    fraction): for k=1% the all-reduce payload drops ~50×(index+value).

"Per tensor" means per leaf of the reference's tree: a decoder block leaf
there is that tensor of every block stacked, so the int8 scale and the
top-k set are taken over the same leaf of all blocks together
(:func:`repro_torch.tree.reference_groups`), and the port sends the
gradients the reference sends.  The residual trees mirror the grads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch import tree as tree_lib


def _zeros_like_f32(tree: Any) -> Any:
    return tree_lib.tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree
    )


def _per_reference_leaf(fn, grads: Any, *trees: Any) -> List[Any]:
    """``fn(g, *others)`` over each reference leaf, on the group's leaves
    stacked as the reference stacks them; returns, for each output of
    ``fn``, the per-port-leaf results as a list in flattened order."""

    flat_g = tree_lib.leaves(grads)
    flats = [tree_lib.leaves(t) for t in trees]
    outs: List[List[Any]] = []
    for idx, stacked in tree_lib.reference_groups(grads):
        args = [
            torch.stack([f[i] for i in idx]) if stacked else f[idx[0]]
            for f in [flat_g] + flats
        ]
        results = fn(*args)
        if not outs:
            outs = [[None] * len(flat_g) for _ in results]
        for out, r in zip(outs, results):
            parts = list(r.unbind(0)) if stacked and r.ndim else [r] * len(idx)
            for i, part in zip(idx, parts):
                out[i] = part
    return outs


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """Symmetric per-tensor int8 with error feedback."""

    def init(self, params: Any) -> Any:
        return _zeros_like_f32(params)

    def compress(self, grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
        """→ (quantized int8 tree, scales, new residual).  A block leaf's
        scale is its reference leaf's, one for all its blocks."""

        def one(g, r):
            g = g.float() + r
            scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            deq = q.float() * scale
            return q, scale, g - deq

        qs, scales, res = _per_reference_leaf(one, grads, residual)
        return (
            tree_lib.unflatten(grads, qs),
            tree_lib.unflatten(grads, scales),
            tree_lib.unflatten(grads, res),
        )

    def decompress(self, q: Any, scales: Any) -> Any:
        return tree_lib.tree_map(lambda x, s: x.float() * s, q, scales)

    def apply(self, grads: Any, residual: Any) -> Tuple[Any, Any]:
        """grads → (dequantized grads as sent over the wire, new residual)."""

        q, scales, res = self.compress(grads, residual)
        return self.decompress(q, scales), res

    @staticmethod
    def compressed_bytes(grads: Any) -> int:
        return sum(x.numel() for x in tree_lib.leaves(grads))  # 1 B/elem

    @staticmethod
    def raw_bytes(grads: Any) -> int:
        return sum(x.numel() * 4 for x in tree_lib.leaves(grads))


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Magnitude top-k with error feedback.  k = fraction of entries kept,
    over each reference leaf (all blocks of a block leaf together)."""

    fraction: float = 0.01

    def init(self, params: Any) -> Any:
        return _zeros_like_f32(params)

    def _k(self, size: int) -> int:
        return max(1, int(size * self.fraction))

    def apply(self, grads: Any, residual: Any) -> Tuple[Any, Any]:
        def one(g, r):
            g = g.float() + r
            flat = g.reshape(-1)
            _, idx = torch.topk(torch.abs(flat), self._k(flat.numel()))
            mask = torch.zeros_like(flat)
            mask[idx] = 1.0
            kept = flat * mask
            return kept.reshape(g.shape), (flat - kept).reshape(g.shape)

        outs, res = _per_reference_leaf(one, grads, residual)
        return tree_lib.unflatten(grads, outs), tree_lib.unflatten(grads, res)

    def compressed_bytes(self, grads: Any) -> int:
        # value (4B) + index (4B) per kept entry, per reference leaf
        flat = tree_lib.leaves(grads)
        return sum(
            8 * self._k(sum(flat[i].numel() for i in idx))
            for idx, _ in tree_lib.reference_groups(grads)
        )
