"""Public wrapper of the pipelined matmul: a Hopper kernel for CUDA
tensors, :func:`ref.matmul_ref` for CPU tensors.

A CUDA call takes the TMA route of its dtype (:func:`route`), never
another kernel as a fallback:

    tma_wgmma         bf16: ``csrc/tma_wgmma_matmul.cu`` (TMA ring, wgmma
                      consumers, a producer warpgroup), after one launch of
                      its stage (:func:`stage_bf16`) where an operand's base
                      or row is one TMA cannot describe
    tma_wgmma_tf32x3  f32: ``csrc/tma_wgmma_tf32x3.cu``, a split pre-pass
                      (:func:`split_tf32`, which also pads the rows to
                      16 bytes) and three TF32 wgmma products on the tensor
                      cores, partial sums promoted every ``TF32X3_RUN_K``
                      of K

:func:`staging` says which operands a call restages and at which leading
dimension; the product's tensor maps keep the true extents with the padded
stride, so TMA zero-fills past them and the padding is never read.

Each kernel's shared-memory ring depth and its waits are not constants:
they are read from the K-loop plan that the synchronization compiler
derives, :func:`hopper_schedule` (a producer warpgroup issues and loads,
consumer warpgroups compute) for both TMA kernels.  The wrapper raises on
a plan whose retained dependences a kernel has no wait for.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Optional, Tuple

from repro_torch.core.parallelizer import PlanOptions, plan
from repro_torch.kernels.pipelined_matmul.ref import matmul_ref, split_tf32_ref, stage_ref
from repro_torch.kernels.pipelined_matmul.schedule import (
    kloop_dependences,
    make_kloop_program,
)

TMA_SOURCE = Path(__file__).parent / "csrc" / "tma_wgmma_matmul.cu"
TF32X3_SOURCE = Path(__file__).parent / "csrc" / "tma_wgmma_tf32x3.cu"
MAX_STAGES = 4  # tma_wgmma_matmul.cu: MAX_STAGES

# the routes of a CUDA call (see :func:`route`); the flash kernel's TMA
# routes take the same names
TMA_WGMMA, TMA_WGMMA_TF32X3 = "tma_wgmma", "tma_wgmma_tf32x3"
# TMA's rule: 16-byte aligned bases and row strides
TMA_ALIGN = 16

# tma_wgmma_matmul.cu: a stage is a 128 x 64 tile of A and a 64 x 256 tile
# of B in bf16; the ring also needs 1 KB to align itself and its barriers
HOPPER_STAGE_BYTES = (128 * 64 + 64 * 256) * 2
SMEM_PER_BLOCK = 232448  # H100: 227 KB of dynamic shared memory a block
HOPPER_STAGES = min(MAX_STAGES, (SMEM_PER_BLOCK - 1024 - 64) // HOPPER_STAGE_BYTES)

# tma_wgmma_tf32x3.cu: 128 x 128 block tiles, K-steps of 32 f32 (one
# 128-byte box), a stage holds A_hi, A_lo, B_hi and B_lo; a consumer
# warpgroup's wgmma accumulator restarts every TF32X3_RUN_K of K and is
# added into its register sum (the promotion)
TF32X3_BM, TF32X3_BN, TF32X3_BK = 128, 128, 32
TF32X3_RUN_K = 256
TF32X3_STAGE_BYTES = 2 * (TF32X3_BM + TF32X3_BN) * TF32X3_BK * 4
TF32X3_STAGES = min(MAX_STAGES, (SMEM_PER_BLOCK - 1024 - 64) // TF32X3_STAGE_BYTES)


HOPPER_PROCESSORS = {"ISSUE": "producer", "LOAD": "producer", "COMPUTE": "consumer"}


def _hopper_wait_for(dep, depth: int) -> Optional[str]:
    """How the TMA kernel realizes one retained cross-processor dependence
    of the K-loop plan (None: it has no mechanism for it).

    full   LOAD -> COMPUTE: the consumers wait on the slot's mbarrier, which
           the TMA completes (the producer's expect_tx counts the bytes)
    empty  COMPUTE -> LOAD at the ring depth (slot reuse): the consumers
           arrive once the wgmma that read the slot has retired, and the
           producer waits on it before it refills the slot
    """

    (dist,) = dep.distance
    return {
        ("flow", "LOAD", "COMPUTE", 0): "full",
        ("anti", "COMPUTE", "LOAD", depth): "empty",
    }.get((dep.kind, dep.source, dep.sink, dist))


def hopper_plan(depth: int, steps: int = 16):
    """``plan()`` of the K-loop under :data:`HOPPER_PROCESSORS`: its
    elimination result (``retained`` / ``eliminated`` dependences)."""

    return plan(
        make_kloop_program(steps),
        PlanOptions(
            method="isd",
            deps=tuple(kloop_dependences(depth)),
            model="procmap",
            processors=HOPPER_PROCESSORS,
        ),
    ).elimination


@dataclasses.dataclass(frozen=True)
class HopperSchedule:
    """The K-loop plan as the TMA kernel takes it."""

    depth: int                  # shared-memory ring stages
    waits: Tuple[str, ...]      # one mbarrier per retained cross wait

    @property
    def full(self) -> bool:
        return "full" in self.waits

    @property
    def empty(self) -> bool:
        return "empty" in self.waits


@functools.lru_cache(maxsize=None)
def hopper_schedule(depth: int, max_depth: int = MAX_STAGES) -> HopperSchedule:
    """Map ``hopper_plan(depth)`` onto the TMA kernel's mbarriers, or raise
    ``NotImplementedError`` for a plan shape it does not implement.
    ``max_depth`` is the deepest ring of the kernel asking (flash_decode's
    is deeper than the matmul's)."""

    if not 1 <= depth <= max_depth:
        raise NotImplementedError(
            f"pipelined matmul: ring depth {depth} outside the kernel's "
            f"1..{max_depth} stages"
        )
    waits = []
    for d in hopper_plan(depth).retained:
        if HOPPER_PROCESSORS[d.source] == HOPPER_PROCESSORS[d.sink]:
            continue  # same processor: program order, no wait
        mech = _hopper_wait_for(d, depth)
        if mech is None:
            raise NotImplementedError(
                f"pipelined matmul: the Hopper K-loop plan at depth {depth} "
                f"retains {d.pretty()}, which the kernel has no mbarrier for"
            )
        waits.append(mech)
    if sorted(waits) != ["empty", "full"]:
        raise NotImplementedError(
            f"pipelined matmul: the Hopper K-loop plan at depth {depth} asks "
            f"for waits {waits}; the kernel needs the full and the empty "
            "wait, one each"
        )
    return HopperSchedule(depth=depth, waits=tuple(waits))


def route(dtype, K: int, N: int, a_addr: int, b_addr: int) -> str:
    """Which kernel a CUDA call with contiguous row-major operands ``A (M,
    K)`` at ``a_addr`` and ``B (K, N)`` at ``b_addr`` takes: every bf16
    call the TMA / wgmma product, every f32 call the 3xTF32 one.  Operands
    whose base or row TMA cannot describe are restaged first (bf16) or
    padded by the split (f32): :func:`staging` says how.  The signature
    keeps the shape and the addresses, which :func:`staging` reads."""

    import torch

    return TMA_WGMMA_TF32X3 if dtype == torch.float32 else TMA_WGMMA


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Staging:
    """What a CUDA call writes before its product.

    bf16: ``a`` / ``b`` say whether A (M, K) / B (K, N) is restaged into a
    (M, lda) / (K, ldb) buffer (:func:`stage_bf16`); an operand that is not
    keeps its own row (lda = K, ldb = N).  f32: the split writes A_hi / A_lo
    (M, lda) and Bᵀ_hi / Bᵀ_lo (N, ldb) always, so ``a`` and ``b`` are True
    and lda = ldb = K rounded up to 4."""

    a: bool
    b: bool
    lda: int
    ldb: int

    @property
    def launches(self) -> int:
        """Stage launches of a bf16 call (one for either or both)."""

        return int(self.a or self.b)


def staging(dtype, M: int, K: int, N: int, a_addr: int, b_addr: int) -> Staging:
    """Which operands a CUDA call of ``A (M, K)`` at ``a_addr`` and ``B (K,
    N)`` at ``b_addr`` restages, and the leading dimension of each.

    bf16: an operand is restaged when its base is not 16-byte aligned or its
    row is not a multiple of 8 elements (16 bytes); its leading dimension is
    then its columns rounded up to 8.  f32: the split always writes new
    arrays, K-major, at K rounded up to 4."""

    import torch

    if dtype == torch.float32:
        ld = _round_up(K, TMA_ALIGN // 4)
        return Staging(a=True, b=True, lda=ld, ldb=ld)
    per_row = TMA_ALIGN // 2
    a = a_addr % TMA_ALIGN != 0 or K % per_row != 0
    b = b_addr % TMA_ALIGN != 0 or N % per_row != 0
    return Staging(a=a, b=b, lda=_round_up(K, per_row), ldb=_round_up(N, per_row))


def tf32x3_schedule(depth: Optional[int] = None) -> HopperSchedule:
    """The 3xTF32 kernel's ring: ``hopper_schedule(depth)``, by default
    ``TF32X3_STAGES`` deep; ``NotImplementedError`` past the
    ``TF32X3_STAGES`` stages of 64 KB that fit shared memory."""

    depth = TF32X3_STAGES if depth is None else depth
    if depth > TF32X3_STAGES:
        raise NotImplementedError(
            f"pipelined matmul: ring depth {depth} outside the "
            f"{TMA_WGMMA_TF32X3} route's 1..{TF32X3_STAGES} stages"
        )
    return hopper_schedule(depth)


def _schedule(path: str, depth: Optional[int]):
    if path == TMA_WGMMA:
        return hopper_schedule(HOPPER_STAGES if depth is None else depth)
    return tf32x3_schedule(depth)


# pointers and ints of each launcher, before the stream
_SIGNATURES = {
    "pm_matmul_bf16_tma": (3, 8),    # A, B, C; M, N, K, lda, ldb, stages, full, empty
    "pm_stage_bf16": (4, 6),         # A, a_dst, B, b_dst; rows, cols, ld of each
    "pm_matmul_f32_tf32x3": (5, 7),  # a_hi, a_lo, bt_hi, bt_lo, C; M, N, K, ld, ...
    "pm_split_tf32": (3, 4),         # X, hi, lo; rows, cols, ld, transpose
}


@functools.lru_cache(maxsize=None)
def _entry_point(src: Path, name: str):
    """One launcher of a library, built and loaded on first use: its
    pointers and ints (:data:`_SIGNATURES`), then the stream, returning a
    ``cudaError_t``."""

    import ctypes

    from repro_torch.kernels._build import load

    fn = getattr(load(src), name)
    ptrs, ints = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
    return fn


def _launch_tma(a, b, out, sched: HopperSchedule) -> None:
    """``tma_wgmma_matmul.cu``'s product of ``A`` and ``B`` as they lie:
    (M, lda) and (K, ldb) row-major buffers whose first K / N columns are
    the operands (``out`` is (M, N)), with the plan's two waits as its
    flags."""

    import torch

    M, N = out.shape
    K = b.shape[0]
    rc = _entry_point(TMA_SOURCE, "pm_matmul_bf16_tma")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, a.shape[1], b.shape[1],
        sched.depth, int(sched.full), int(sched.empty),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _check(rc, TMA_WGMMA, M, N, K, a.dtype, sched.depth)


def _launch_tf32x3(a_hi, a_lo, bt_hi, bt_lo, out, sched: HopperSchedule,
                   K: Optional[int] = None) -> None:
    """``tma_wgmma_tf32x3.cu``'s product of split operands (``a_*`` (M, ld),
    ``bt_*`` (N, ld), their first ``K`` columns live; K defaults to ld),
    with the plan's two waits as its flags."""

    import torch

    M, N = out.shape
    ld = a_hi.shape[1]
    K = ld if K is None else K
    rc = _entry_point(TF32X3_SOURCE, "pm_matmul_f32_tf32x3")(
        a_hi.data_ptr(), a_lo.data_ptr(), bt_hi.data_ptr(), bt_lo.data_ptr(),
        out.data_ptr(), M, N, K, ld, sched.depth, int(sched.full), int(sched.empty),
        torch.cuda.current_stream(a_hi.device).cuda_stream,
    )
    _check(rc, TMA_WGMMA_TF32X3, M, N, K, a_hi.dtype, sched.depth)


def _check(rc: int, path: str, M, N, K, dtype, depth) -> None:
    if rc <= -1000:
        raise RuntimeError(
            f"pipelined matmul ({path}): cuTensorMapEncodeTiled failed "
            f"(CUresult {-1000 - rc}; -1: the CUDA driver lacks it) for M={M}, "
            f"N={N}, K={K}"
        )
    if rc != 0:
        raise RuntimeError(
            f"pipelined matmul launch failed on route {path}: cudaError {rc} "
            f"(M={M}, N={N}, K={K}, dtype={dtype}, depth={depth})"
        )


def _check_2d(x, dtype, what: str) -> None:
    if x.ndim != 2 or x.dtype != dtype:
        raise TypeError(f"{what} takes a 2-D {dtype} tensor; got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} takes a row-major contiguous CUDA or CPU tensor")


def stage_bf16(a, b, st: Staging):
    """``(A, B)`` as the bf16 product reads them: each operand that ``st``
    restages copied into a (rows, ld) buffer (its padding columns zero, and
    never read), the others as they are.  One launch of ``pm_stage_bf16``
    (counted in ``stage_bf16.launches``) restages either or both on CUDA
    tensors, or raises naming the route; CPU tensors take
    :func:`ref.stage_ref`.  The buffers come from ``torch.empty``: the
    kernel writes every element of them."""

    import torch

    for x, what in ((a, "stage_bf16 (A)"), (b, "stage_bf16 (B)")):
        _check_2d(x, torch.bfloat16, what)
    if not (st.a or st.b):
        return a, b
    if a.device.type == "cpu":
        return (stage_ref(a, st.lda) if st.a else a), (stage_ref(b, st.ldb) if st.b else b)
    a_dst = torch.empty((a.shape[0], st.lda), dtype=a.dtype, device=a.device) if st.a else None
    b_dst = torch.empty((b.shape[0], st.ldb), dtype=b.dtype, device=b.device) if st.b else None
    rc = _entry_point(TMA_SOURCE, "pm_stage_bf16")(
        a.data_ptr() if st.a else None, a_dst.data_ptr() if st.a else None,
        b.data_ptr() if st.b else None, b_dst.data_ptr() if st.b else None,
        *a.shape, st.lda, *b.shape, st.ldb,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"pipelined matmul stage launch failed on route {TMA_WGMMA}: cudaError {rc} "
            f"(A {tuple(a.shape)} restaged {st.a} at {st.lda}, B {tuple(b.shape)} "
            f"restaged {st.b} at {st.ldb})"
        )
    stage_bf16.launches += 1
    return (a_dst if st.a else a), (b_dst if st.b else b)


stage_bf16.launches = 0


def split_tf32(x, transpose: bool = False):
    """``(hi, lo)`` of a row-major f32 matrix ``x`` (rows, cols), each a
    TF32 value in an f32 word: ``hi = rna_tf32(x)``, ``lo = rna_tf32(x -
    hi)``; with ``transpose`` both are of ``x.T``.  Either way they are
    written at a leading dimension ``ld`` of their width (cols, or rows)
    rounded up to 4, TMA's 16-byte row stride: (rows, ld), or (cols, ld),
    the padding columns zero.  The 3xTF32 route's pre-pass
    (``pm_split_tf32``): a CUDA tensor at any base launches the kernel or
    raises naming the route; a CPU tensor takes :func:`ref.split_tf32_ref`
    at the same ``ld``."""

    import torch

    _check_2d(x, torch.float32, "split_tf32")
    rows, cols = x.shape
    ld = _round_up(rows if transpose else cols, TMA_ALIGN // 4)
    if x.device.type == "cpu":
        return split_tf32_ref(x, transpose, ld)
    shape = (cols, ld) if transpose else (rows, ld)
    hi = torch.empty(shape, dtype=x.dtype, device=x.device)
    lo = torch.empty(shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return hi, lo
    rc = _entry_point(TF32X3_SOURCE, "pm_split_tf32")(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), rows, cols, ld, int(transpose),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"split_tf32 launch failed on route {TMA_WGMMA_TF32X3}: cudaError "
            f"{rc} (rows={rows}, cols={cols}, ld={ld}, transpose={transpose})"
        )
    split_tf32.launches += 1
    return hi, lo


split_tf32.launches = 0


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

    ``depth`` is the shared-memory ring depth: 1..3 on the 3xTF32 route,
    1..4 on the bf16 one; by default the deepest ring that fits
    (``TF32X3_STAGES``, ``HOPPER_STAGES``).  Its waits come from the
    route's K-loop plan.  ``blk_m/n/k`` keep the reference wrapper's
    signature; the kernels' tiles are their own (bf16: 128 x 256, K step
    64; 3xTF32: 128 x 128, K step 32).  Operands of any layout are taken
    (copied row-major first, as the kernels read them).  The bf16 route
    first restages the operands TMA cannot describe (:func:`staging`,
    :func:`stage_bf16`: one launch for either or both), the 3xTF32 route
    splits A, and B transposed, into padded TF32 halves (:func:`split_tf32`,
    two launches); then the product launches.  A CPU tensor takes the plain
    version; a CUDA tensor takes its route's kernels or raises, and a
    failed stage or split launches no product.
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
    M, K = a.shape
    N = b.shape[1]
    # the kernels read row-major operands: any other layout is copied so
    # (the rule reads the copies' addresses)
    a, b = a.contiguous(), b.contiguous()
    path = route(a.dtype, K, N, a.data_ptr(), b.data_ptr())
    sched = _schedule(path, depth)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"matmul operands must both be on the CPU or on one CUDA device; "
            f"got {a.device} and {b.device}"
        )
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    if path == TMA_WGMMA:
        st = staging(a.dtype, M, K, N, a.data_ptr(), b.data_ptr())
        _launch_tma(*stage_bf16(a, b, st), out, sched)
    else:
        _launch_tf32x3(*split_tf32(a), *split_tf32(b, transpose=True), out, sched, K)
    matmul.launches += 1
    matmul.routes[path] += 1
    return out


matmul.launches = 0
matmul.routes = {TMA_WGMMA: 0, TMA_WGMMA_TF32X3: 0}
