"""Public wrapper of flash attention: the Hopper kernel of
``csrc/flash_attention.cu`` for CUDA tensors, the plain version
(:func:`ref.flash_attention_bshd_ref`) for CPU tensors.

The layout is the reference wrapper's: q ``(B, Sq, H, hd)``, k and v
``(B, Sk, KV, hd)`` with ``H % KV == 0`` (GQA).  The kernel reads all
three by stride and indexes the KV head as ``h // (H / KV)``, so the
wrapper makes no transpose, repeat or padded copy.  Its K/V ring depth and
its per-step waits come from the same K-loop plan as the pipelined matmul's
(:func:`repro_torch.kernels.pipelined_matmul.ops.kernel_schedule` at
``RING_DEPTH``): the kernel has the same producer (copy) / consumer
(compute) structure, and raises if the plan asks for a wait it lacks.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref
from repro_torch.kernels.pipelined_matmul.ops import kernel_schedule

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)  # csrc: the instantiated HD values
RING_DEPTH = 2  # csrc: STAGES
KERNEL_WAITS = ("issue", "arrival")  # csrc: ISSUE(i) and the arrival wait


def _check_schedule() -> None:
    """Raise unless the K-loop plan at ``RING_DEPTH`` asks for exactly the
    waits the kernel has."""

    sched = kernel_schedule(RING_DEPTH)
    if sorted(sched.waits) != sorted(KERNEL_WAITS):
        raise NotImplementedError(
            f"flash attention kernel: the K-loop plan at depth {RING_DEPTH} "
            f"asks for waits {sched.waits}; the kernel has the waits "
            f"{KERNEL_WAITS}"
        )


@functools.lru_cache(maxsize=None)
def _entry_point():
    """``fa_forward(dtype, q, k, v, o, dims[6], strides[12], causal, window,
    scale, stream) -> cudaError_t``, built and loaded on first use."""

    import ctypes

    from repro_torch.kernels._build import load

    fn = load(SOURCE).fa_forward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.POINTER(ctypes.c_longlong)] * 2
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_void_p]
    )
    return fn


def _launch(q, k, v, o, causal: bool, window: Optional[int]) -> None:
    import ctypes

    import torch

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dims = (ctypes.c_longlong * 6)(B, H, KV, Sq, Sk, hd)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3])
    )
    rc = _entry_point()(
        0 if q.dtype == torch.float32 else 1,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dims, strides, int(causal), 0 if window is None else int(window),
        hd**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flash attention launch failed: cudaError {rc} (B={B}, Sq={Sq}, "
            f"Sk={Sk}, H={H}, KV={KV}, hd={hd}, dtype={q.dtype})"
        )


def _check_kernel_call(q, k, v, window) -> None:
    """Raise for a CUDA call outside the kernel's contract, naming the
    argument."""

    import torch

    if q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"flash attention kernel: dtype {q.dtype} (it takes float32 or "
            "bfloat16)"
        )
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention kernel: hd={hd} (it takes hd in {HEAD_DIMS})"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention kernel: an input requires grad, and the kernel "
            "has no backward (the reference kernel has none either)"
        )
    if window is not None and window < 1:
        raise NotImplementedError(f"flash attention kernel: window={window} < 1")
    step = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % step for s in t.stride()[:3]) or (
            t.data_ptr() % 16
        ):
            raise NotImplementedError(
                f"flash attention kernel: {name} with strides {t.stride()} at "
                f"offset {t.data_ptr() % 16} (it reads rows of 16-byte-aligned "
                "chunks: unit last stride, other strides multiples of 16 bytes)"
            )


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
):
    """Softmax attention ``softmax(q kᵀ · hd**-0.5 + mask) v`` with f32
    softmax state, over q ``(B, Sq, H, hd)`` and k, v ``(B, Sk, KV, hd)``.

    ``causal`` masks keys after the query position, ``window`` keys at or
    before ``q_pos - window``; positions start at 0 for q and k alike.  The
    reference wrapper's ``blk_q`` / ``blk_k`` have no counterpart: the
    Hopper kernel's tiles are its own.  A CPU tensor takes the plain
    version; a CUDA tensor takes the kernel or raises.
    """

    import torch

    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            "flash attention expects q (B, Sq, H, hd) and k, v (B, Sk, KV, hd); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(
            f"flash attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
            "(same batch and hd, KV heads dividing H)"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash attention takes one dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    devices = {t.device for t in (q, k, v)}
    if devices == {torch.device("cpu")}:
        return flash_attention_bshd_ref(q, k, v, causal=causal, window=window)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            "flash attention operands must all be on the CPU or on one CUDA "
            f"device; got {[str(d) for d in devices]}"
        )
    _check_kernel_call(q, k, v, window)
    _check_schedule()
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return o
    if k.shape[1] == 0:
        return o.zero_()
    _launch(q, k, v, o, causal, window)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
