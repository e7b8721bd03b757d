"""Plain PyTorch versions of the pipelined matmul's kernels: ``C = A @ B``
with f32 accumulation, cast back to the input dtype (the reference's
``matmul_ref``), the bf16 route's stage of an operand at a 16-byte row
stride, and the 3xTF32 route's split of an f32 operand."""

from __future__ import annotations

from typing import Optional


def matmul_ref(a, b):
    import torch

    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def _padded(x, ld: Optional[int]):
    """``x`` (rows, cols) in a zeroed (rows, ld) array (``ld`` None: x)."""

    import torch

    if ld is None or ld == x.shape[-1]:
        return x.contiguous()
    rows, cols = x.shape
    if ld < cols:
        raise ValueError(f"leading dimension {ld} below the {cols} columns")
    out = torch.zeros((rows, ld), dtype=x.dtype, device=x.device)
    out[:, :cols] = x
    return out


def stage_ref(x, ld: int):
    """``x`` (rows, cols) copied into a (rows, ld) array, its padding
    columns zero: the bf16 route's stage (``pm_stage_bf16``)."""

    return _padded(x, ld)


def rna_tf32_ref(x):
    """``x`` rounded to TF32 (10 fraction bits) to nearest, ties away from
    zero, as f32: ``cvt.rna.tf32.f32`` on the int32 view.  Finite inputs."""

    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_ref(x, transpose: bool = False, ld: Optional[int] = None):
    """``(hi, lo)`` of an f32 matrix: ``hi = rna_tf32(x)`` and ``lo =
    rna_tf32(x - hi)``, so that ``hi + lo`` keeps 22 of x's 24 significant
    bits; with ``transpose`` both are of ``x.T``, row-major.  ``ld`` is
    their leading dimension (None: their own width); the padding columns
    are zero, the split of 0."""

    if transpose:
        x = x.t()
    hi = rna_tf32_ref(x)
    lo = rna_tf32_ref(x.contiguous() - hi)
    return _padded(hi, ld), _padded(lo, ld)
