"""Public wrapper of the pipelined matmul: the Hopper kernel of
``csrc/pipelined_matmul.cu`` for CUDA tensors, :func:`ref.matmul_ref` for
CPU tensors.

The kernel's shared-memory ring depth and its per-K-step waits are not
constants: :func:`kernel_schedule` reads them from the K-loop plan that the
synchronization compiler derives (:func:`schedule.plan_pipeline`), and the
wrapper raises on a plan whose retained dependences the kernel has no wait
for.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Optional, Tuple

from repro_torch.kernels.pipelined_matmul.ref import matmul_ref
from repro_torch.kernels.pipelined_matmul.schedule import (
    PROCESSORS,
    min_buffers,
    plan_pipeline,
)

SOURCE = Path(__file__).parent / "csrc" / "pipelined_matmul.cu"
MAX_STAGES = 4  # csrc: MAX_STAGES


def _wait_for(dep, depth: int) -> Optional[str]:
    """How the kernel realizes one retained cross-processor dependence of
    the K-loop plan at each K-step (None: it has no wait for it).

    issue    ISSUE -> LOAD at prefetch distance 1: the block's threads start
             the copy of the next tile themselves, so it begins once issued
    arrival  LOAD -> COMPUTE: cp.async.wait_all + __syncthreads
    credit   COMPUTE -> LOAD at the ring depth (slot reuse): a second
             __syncthreads before the refill of the slot just read
    """

    (dist,) = dep.distance
    return {
        ("flow", "ISSUE", "LOAD", 1): "issue",
        ("flow", "LOAD", "COMPUTE", 0): "arrival",
        ("anti", "COMPUTE", "LOAD", depth): "credit",
    }.get((dep.kind, dep.source, dep.sink, dist))


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """The K-loop plan as the kernel takes it."""

    depth: int                  # shared-memory ring stages
    waits: Tuple[str, ...]      # one mechanism per retained cross wait
    credit: bool                # the D = 1 variant: a second barrier

    @property
    def barriers_per_step(self) -> int:
        return 1 + int(self.credit)


@functools.lru_cache(maxsize=None)
def kernel_schedule(depth: int) -> KernelSchedule:
    """Map ``plan_pipeline(depth)`` onto the kernel, or raise
    ``NotImplementedError`` for a plan shape it does not implement."""

    if not 1 <= depth <= MAX_STAGES:
        raise NotImplementedError(
            f"pipelined matmul: ring depth {depth} outside the kernel's "
            f"1..{MAX_STAGES} stages"
        )
    plan = plan_pipeline(depth)
    waits = []
    for d in plan.retained:
        if PROCESSORS[d.source] == PROCESSORS[d.sink]:
            continue  # same processor: program order, no wait
        mech = _wait_for(d, depth)
        if mech is None:
            raise NotImplementedError(
                f"pipelined matmul: the K-loop plan at depth {depth} retains "
                f"{d.pretty()}, which the kernel has no wait for"
            )
        waits.append(mech)
    if len(waits) != plan.waits_per_step or "arrival" not in waits:
        raise NotImplementedError(
            f"pipelined matmul: plan at depth {depth} asks for waits "
            f"{waits} ({plan.waits_per_step} per step); the kernel needs the "
            "arrival wait and one mechanism per retained wait"
        )
    credit = "credit" in waits
    if credit != plan.credit_wait_needed:  # pragma: no cover - plan invariant
        raise NotImplementedError("credit wait disagrees with the plan")
    if depth < 2 and not credit:
        raise NotImplementedError(
            "pipelined matmul: a one-slot ring without the credit wait "
            "would refill the slot being read"
        )
    return KernelSchedule(depth=depth, waits=tuple(waits), credit=credit)


@functools.lru_cache(maxsize=None)
def default_depth() -> int:
    return min_buffers()


@functools.lru_cache(maxsize=None)
def _entry_points():
    """The library's two launchers, built and loaded on first use:
    ``(A, B, C, M, N, K, stages, credit, vec, stream) -> cudaError_t``."""

    import ctypes

    from repro_torch.kernels._build import load

    lib = load(SOURCE)
    fns = {}
    for name in ("pm_matmul_f32", "pm_matmul_bf16"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fns[name] = fn
    return fns


def _launch(a, b, out, sched: KernelSchedule) -> None:
    import torch

    fn = _entry_points()[
        "pm_matmul_bf16" if a.dtype == torch.bfloat16 else "pm_matmul_f32"
    ]
    M, K = a.shape
    N = b.shape[1]
    elt = a.element_size()
    # the 16-byte copy path needs 16-byte row strides and base addresses
    vec = all(
        (t.data_ptr() % 16 == 0) for t in (a, b, out)
    ) and (K * elt) % 16 == 0 and (N * elt) % 16 == 0
    rc = fn(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
        sched.depth, int(sched.credit), int(vec),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"pipelined matmul launch failed: cudaError {rc} "
            f"(M={M}, N={N}, K={K}, dtype={a.dtype}, depth={sched.depth})"
        )


def matmul(
    a,
    b,
    *,
    blk_m: int = 128,
    blk_n: int = 128,
    blk_k: int = 128,
    depth: Optional[int] = None,
):
    """``C = A @ B`` for ``A (M, K)`` and ``B (K, N)`` in f32 or bf16, with
    f32 accumulation.

    ``depth`` is the shared-memory ring depth (default ``min_buffers()``);
    its waits come from ``plan_pipeline(depth)``.  ``blk_m/n/k`` keep the
    reference wrapper's signature; the Hopper kernel's tiles are its own
    (128 x 128, with a K step of 16 in f32 and 32 in bf16).  A CPU tensor
    takes the plain version; a CUDA tensor takes the kernel or raises.
    """

    import torch

    for name, blk in (("blk_m", blk_m), ("blk_n", blk_n), ("blk_k", blk_k)):
        if blk < 1:
            raise ValueError(f"{name} must be positive, got {blk}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul expects A (M, K) and B (K, N); got {tuple(a.shape)} and "
            f"{tuple(b.shape)}"
        )
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"matmul takes two float32 or two bfloat16 tensors; got "
            f"{a.dtype} and {b.dtype}"
        )
    sched = kernel_schedule(default_depth() if depth is None else depth)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"matmul operands must both be on the CPU or on one CUDA device; "
            f"got {a.device} and {b.device}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes row-major contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    _launch(a, b, out, sched)
    matmul.launches += 1
    return out


matmul.launches = 0
