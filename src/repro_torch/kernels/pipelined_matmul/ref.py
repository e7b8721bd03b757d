"""Plain PyTorch version of the pipelined matmul: ``C = A @ B`` with f32
accumulation, cast back to the input dtype (the reference's ``matmul_ref``)."""

from __future__ import annotations


def matmul_ref(a, b):
    import torch

    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)
