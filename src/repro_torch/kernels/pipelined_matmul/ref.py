"""Plain PyTorch versions of the pipelined matmul's kernels: ``C = A @ B``
with f32 accumulation, cast back to the input dtype (the reference's
``matmul_ref``), and the 3xTF32 route's split of an f32 operand."""

from __future__ import annotations


def matmul_ref(a, b):
    import torch

    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def rna_tf32_ref(x):
    """``x`` rounded to TF32 (10 fraction bits) to nearest, ties away from
    zero, as f32: ``cvt.rna.tf32.f32`` on the int32 view.  Finite inputs."""

    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_ref(x, transpose: bool = False):
    """``(hi, lo)`` of an f32 matrix: ``hi = rna_tf32(x)`` and ``lo =
    rna_tf32(x - hi)``, so that ``hi + lo`` keeps 22 of x's 24 significant
    bits; with ``transpose`` both are of ``x.T``, row-major."""

    if transpose:
        x = x.t()
    hi = rna_tf32_ref(x)
    return hi, rna_tf32_ref(x.contiguous() - hi)
