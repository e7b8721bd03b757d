"""Public wrapper of flash attention: a Hopper kernel for CUDA tensors,
the plain version (:func:`ref.flash_attention_bshd_ref`) for CPU tensors.

The layout is the reference wrapper's: q ``(B, Sq, H, hd)``, k and v
``(B, Sk, KV, hd)`` with ``H % KV == 0`` (GQA).  The kernels read all
three by stride and index the KV head as ``h // (H / KV)``, so the wrapper
makes no transpose, repeat or padded copy.

A CUDA call takes one of three kernels, by a rule on the operands
(:func:`route`), never as a fallback:

    flash_decode      bf16, hd 64 or 128, 16-byte aligned, with at most
                      ``DECODE_MAX_SQ`` query rows (and at most
                      ``DECODE_MAX_ROWS`` rows a KV head with GQA):
                      ``csrc/flash_decode.cu`` (one launch: a block a KV
                      head and a key range, the head's ranges one thread-
                      block cluster, all of the head's query rows at once,
                      a K/V ring filled by TMA, mma.sync; the ranges'
                      partial softmax states merged through distributed
                      shared memory)
    tma_wgmma         every other bf16 call, hd 16, 32, 64 or 128:
                      ``csrc/tma_wgmma_flash.cu`` (TMA K/V ring filled by a
                      producer warpgroup, wgmma QKᵀ and PV on two consumer
                      warpgroups)
    tma_wgmma_tf32x3  every f32 call, hd 16, 32, 64 or 128:
                      ``csrc/tma_wgmma_flash_tf32x3.cu``, a K/V split
                      pre-pass (:func:`split_kv_tf32`) and both products as
                      three TF32 wgmma products each, on the bf16 TMA
                      kernel's plan

A head dim below 128 that no kernel is built for (hd 8) runs zero-padded on
the next one that is (:func:`padded_head_dim`).  Every operand takes a TMA
route: the tensor maps take any stride that is a multiple of 16 bytes, a
zero one (a broadcast dimension) included; the kernel contract raises for
the others before any launch (:func:`_check_kernel_call`).

Each kernel's K/V ring depth and its waits come from the K-loop plan that
the synchronization compiler derives, as the pipelined matmul's do:
:func:`~repro_torch.kernels.pipelined_matmul.ops.hopper_schedule` (a
producer issues and loads, consumers compute; its two retained dependences
are the full and empty mbarriers).  The wrapper raises on a plan whose
retained dependences a kernel has no wait for.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bshd_ref,
    live_span,
    pad_head_dim,
    split_kv_tf32_ref,
)
from repro_torch.kernels.pipelined_matmul.ops import (
    SMEM_PER_BLOCK,
    TMA_WGMMA,
    TMA_WGMMA_TF32X3,
    hopper_schedule,
)

TMA_SOURCE = Path(__file__).parent / "csrc" / "tma_wgmma_flash.cu"
TF32X3_SOURCE = Path(__file__).parent / "csrc" / "tma_wgmma_flash_tf32x3.cu"
DECODE_SOURCE = Path(__file__).parent / "csrc" / "flash_decode.cu"

FLASH_DECODE = "flash_decode"
# flash_decode.cu: a block takes the Sq * H / KV query rows of one KV head
# (at most DECODE_MAX_ROWS: four 16-row mma tiles) over one key range, in
# K/V stages of DECODE_BK keys; the route takes calls of at most
# DECODE_MAX_SQ query rows, where phase 6 of chip_smoke.py measured it
# faster than tma_wgmma.  decode_splits lays out at most DECODE_BLOCKS_PER_SM
# blocks an SM (a third block an SM measured slower at every shape timed)
# and at most DECODE_MAX_CLUSTER ranges, the portable cluster size: a KV
# head's ranges are one cluster.  The route's ring is DECODE_DEPTH stages
# deep (fewer for a range of fewer tiles): phase 6 of chip_smoke.py and
# tools/flash_decode_rows.py measured deeper rings no faster; the kernel
# holds up to DECODE_MAX_STAGES
DECODE_HEAD_DIMS = (64, 128)
DECODE_MAX_SQ = 16
DECODE_MAX_ROWS = 64
DECODE_BK = 64
DECODE_BLOCKS_PER_SM = 2
DECODE_MAX_CLUSTER = 8
DECODE_DEPTH = 2
DECODE_MAX_STAGES = 6
DECODE_WAITS = ("full", "empty")
LOG2E = math.log2(math.e)
# chip_smoke.py clears this to time tma_wgmma on the calls the rule sends to
# flash_decode; nothing else sets it
_decode_route = True

# tma_wgmma_flash.cu, instantiated at TMA_HEAD_DIMS: 128-row Q tiles and
# 128-key K/V tiles, loaded as boxes of min(hd, TMA_BOX) hd columns (rows
# of 32, 64 or 128 bytes, each box swizzled by its row); a stage holds K
# and V of one tile; the ring also needs 1 KB to align itself, two
# mbarriers for Q and two a stage
TMA_HEAD_DIMS = (16, 32, 64, 128)
TMA_BQ = 128
TMA_BK = 128
TMA_BOX = 64
MAX_STAGES = 4
TMA_SMEM_EXTRA = 1024 + 8 * (2 + 2 * MAX_STAGES)


def tma_smem_bytes(hd: int, depth: int) -> int:
    """Dynamic shared memory of the TMA kernel at ``hd`` with a ring of
    ``depth`` stages: the Q tile, the K/V stages, alignment and barriers."""

    return TMA_BQ * hd * 2 + depth * 2 * TMA_BK * hd * 2 + TMA_SMEM_EXTRA


def default_depth(hd: int) -> int:
    """The deepest ring the shared-memory budget takes, at most
    ``MAX_STAGES``: 3 at hd 128 (32 KB of Q and 64 KB a stage), 4 at hd 64,
    32 and 16."""

    stage = 2 * TMA_BK * hd * 2
    return min(MAX_STAGES, (SMEM_PER_BLOCK - tma_smem_bytes(hd, 0)) // stage)


# tma_wgmma_flash_tf32x3.cu: the same 128-row Q tiles, in f32 as two
# buffers (hi and lo, split in shared memory), loaded as boxes of
# min(hd, TF32X3_BOX) hd columns (rows of 64 or 128 bytes); a stage holds K
# hi / lo and Vᵀ hi / lo of BK keys, the tile with the deeper ring at each
# hd: BK 16 at hd 128 (D <= 3; 32 keys would fit D = 1 only), BK 32 at hd
# 64 (D <= 4); at hd 16 and 32 every depth fits, and the wider BK 64 (Vᵀ
# in two boxes of 32 keys) halves the tiles of an item
TF32X3_BOX = 32
TF32X3_BK = {16: 64, 32: 64, 64: 32, 128: 16}


def tf32x3_smem_bytes(hd: int, depth: int) -> int:
    """Dynamic shared memory of the 3xTF32 kernel at ``hd`` with a ring of
    ``depth`` stages of ``TF32X3_BK[hd]`` keys: Q hi and lo, the stages,
    alignment and barriers."""

    return 2 * TMA_BQ * hd * 4 + depth * 4 * TF32X3_BK[hd] * hd * 4 + TMA_SMEM_EXTRA


def tf32x3_default_depth(hd: int) -> int:
    """The deepest ring the budget takes, at most ``MAX_STAGES``: 3 at hd
    128 (128 KB of Q hi / lo and 32 KB a stage), 4 at hd 64, 32 and 16."""

    stage = 4 * TF32X3_BK[hd] * hd * 4
    return min(MAX_STAGES, (SMEM_PER_BLOCK - tf32x3_smem_bytes(hd, 0)) // stage)


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """A 4-D TMA tensor map of one ``(B, S, heads, hd)`` operand, innermost
    dimension first, as the kernel's host entry encodes it."""

    dims: Tuple[int, int, int, int]     # (hd, heads, S, B)
    strides: Tuple[int, int, int]       # bytes: heads, S, B
    box: Tuple[int, int, int, int]      # (columns, 1, rows, 1)

    def flat(self) -> Tuple[int, ...]:
        return (*self.dims, *self.strides, *self.box)


def tensor_map(shape: Sequence[int], stride: Sequence[int], rows: int,
               elt: int = 2) -> TensorMap:
    """The tensor map of an operand of ``shape`` ``(B, S, heads, hd)`` and
    element strides ``stride`` (``elt`` bytes an element), read in boxes of
    min(hd, 128 / elt) hd columns (at most 128 bytes: 64 in bf16, 32 in
    f32; the kernel swizzles by the box's row, 32, 64 or 128 bytes) by
    ``rows`` positions of one head of one batch.  A 4-D map, not a
    flattened 2-D one, is what keeps a box at a ragged end of S inside its
    own batch: TMA zero-fills past S instead of reading the next batch's
    rows.  A zero stride (a broadcast dimension) is a stride TMA takes."""

    B, S, heads, hd = shape
    sb, ss, sh = stride[:3]
    return TensorMap(
        dims=(hd, heads, S, B),
        strides=(sh * elt, ss * elt, sb * elt),
        box=(min(hd, 128 // elt), 1, rows, 1),
    )


def route(dtype, hd: int, strides: Sequence[Sequence[int]],
          addresses: Sequence[int], sq: Optional[int] = None, group: int = 1) -> str:
    """Which kernel a CUDA call takes, from the operands' dtype, head dim,
    the (batch, sequence, head) element strides of q, k and v, their base
    addresses, the query rows ``sq`` (None where there are none) and the
    GQA group ``H / KV``.

    Every f32 call takes the 3xTF32 kernel.  A bf16 call takes flash_decode
    where that kernel can read it (hd 64 or 128, 16-byte aligned bases and
    strides that are multiples of 16 bytes) and it has at most
    ``DECODE_MAX_SQ`` query rows and at most ``DECODE_MAX_ROWS`` rows a KV
    head; every other bf16 call takes the TMA kernel, whatever Sq and Sk
    are (ragged ends are zero-filled and masked).  Operands the TMA
    kernels cannot read either (strides or bases off 16 bytes) are refused
    by :func:`_check_kernel_call` before any launch."""

    import torch

    if dtype == torch.float32:
        return TMA_WGMMA_TF32X3
    decode = (
        hd in DECODE_HEAD_DIMS
        and sq is not None and sq <= DECODE_MAX_SQ and sq * group <= DECODE_MAX_ROWS
        and all((2 * s) % 16 == 0 for st in strides for s in st[:3])
        and all(a % 16 == 0 for a in addresses)
    )
    return FLASH_DECODE if decode else TMA_WGMMA


def decode_splits(B: int, KV: int, Sk: int, sms: int) -> int:
    """The key ranges of a flash_decode call over ``Sk`` live keys: as
    many as keep the ``B * KV * splits`` blocks within
    ``DECODE_BLOCKS_PER_SM`` an SM of ``sms`` (one range at least), no more
    ranges than ``DECODE_BK``-key tiles nor than a cluster's
    ``DECODE_MAX_CLUSTER``, none empty (the ranges are ``ceil(Sk /
    splits)`` keys, the last one short)."""

    want = min(DECODE_BLOCKS_PER_SM * sms // max(1, B * KV), DECODE_MAX_CLUSTER)
    splits = max(1, min(want, -(-Sk // DECODE_BK)))
    return -(-Sk // -(-Sk // splits)) if Sk > 0 else 1


def decode_row_tiles(rows: int) -> int:
    """flash_decode.cu's 16-row mma tiles for ``rows`` query rows a KV head
    (its instantiations: 1, 2 and 4)."""

    return 1 if rows <= 16 else 2 if rows <= 32 else 4


def decode_smem_bytes(hd: int, rows: int, depth: int) -> int:
    """flash_decode.cu's dynamic shared memory (``Shape::bytes``): 1 KB to
    align the ring, the ring of ``depth`` stages of a K and a V tile (the
    TMA boxes, unpadded) or, if larger, the merge's states (four warps' and
    the block's, f32, ``hd + 2`` a row), the block's query rows (padded to
    ``hd + 8`` elements) and the barriers (full and empty a stage, and
    Q's)."""

    rt = decode_row_tiles(rows)
    merge = (4 * 16 + rt * 16) * (hd + 2) * 4
    return (1024 + max(depth * 2 * DECODE_BK * hd * 2, merge) + rt * 16 * (hd + 8) * 2
            + (2 * DECODE_MAX_STAGES + 1) * 8)


def _decode_schedule(depth: int = DECODE_DEPTH):
    """The K-loop plan of flash_decode's ring at ``depth`` (the route's
    ``DECODE_DEPTH``, or fewer stages for a range of fewer tiles), or
    ``NotImplementedError`` for a plan whose waits are not the kernel's
    full and empty mbarriers."""

    sched = hopper_schedule(depth, DECODE_MAX_STAGES)
    if sorted(sched.waits) != sorted(DECODE_WAITS):
        raise NotImplementedError(
            f"flash attention ({FLASH_DECODE}): the Hopper K-loop plan at depth {depth} "
            f"asks for waits {sched.waits}; the kernel has the waits {DECODE_WAITS}"
        )
    return sched


def _tma_schedule(hd: int, depth: Optional[int], path: str = TMA_WGMMA):
    """The K-loop plan of a TMA kernel (``path``: ``tma_wgmma`` or
    ``tma_wgmma_tf32x3``) at ``depth`` (default: the deepest ring that
    fits), or ``NotImplementedError`` for a plan without both of its
    mbarriers or a ring that does not fit."""

    if path == TMA_WGMMA:
        fits, smem = default_depth(hd), tma_smem_bytes
    else:
        fits, smem = tf32x3_default_depth(hd), tf32x3_smem_bytes
    depth = fits if depth is None else depth
    if not 1 <= depth <= MAX_STAGES or smem(hd, depth) > SMEM_PER_BLOCK:
        raise NotImplementedError(
            f"flash attention ({path}): ring depth {depth} at hd={hd} "
            f"(1..{fits} stages fit in {SMEM_PER_BLOCK} bytes)"
        )
    sched = hopper_schedule(depth)
    if not (sched.full and sched.empty):
        raise NotImplementedError(
            f"flash attention ({path}): the Hopper K-loop plan at depth "
            f"{depth} asks for waits {sched.waits}; the kernel needs the full "
            "and the empty mbarrier"
        )
    return sched


@functools.lru_cache(maxsize=None)
def _tma_entry_point():
    """``fa_forward_tma(q, k, v, o, dims[6], maps[33], o_strides[3], causal,
    window, q_offset, scale_log2, stages, full, empty, stream) ->
    cudaError_t``."""

    import ctypes

    from repro_torch.kernels._build import load

    fn = load(TMA_SOURCE).fa_forward_tma
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.POINTER(ctypes.c_longlong)] * 3
        + [ctypes.c_int] * 3 + [ctypes.c_float]
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    return fn


@functools.lru_cache(maxsize=None)
def _tf32x3_entry_point(name: str):
    """The two launchers of ``tma_wgmma_flash_tf32x3.cu``:
    ``fa_split_kv_tf32(k, v, ws, dims[4], kv_strides[6], stream)`` (the
    pre-pass alone) and ``fa_forward_tf32x3(q, k, v, ws, o, dims[6],
    q_map[11], kv_strides[6], o_strides[3], causal, window, q_offset,
    scale_log2, stages, full, empty, stream)`` (the pre-pass and the
    product), each returning a ``cudaError_t``."""

    import ctypes

    from repro_torch.kernels._build import load

    fn = getattr(load(TF32X3_SOURCE), name)
    fn.restype = ctypes.c_int
    arrays = [ctypes.POINTER(ctypes.c_longlong)]
    if name == "fa_split_kv_tf32":
        fn.argtypes = [ctypes.c_void_p] * 3 + arrays * 2 + [ctypes.c_void_p]
    else:
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + arrays * 4
            + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p]
        )
    return fn


@functools.lru_cache(maxsize=None)
def _decode_entry_point(name: str):
    """The entries of ``flash_decode.cu``, each returning a ``cudaError_t``
    (or -1000 less a ``CUresult``): ``fa_decode_maps(k, v, dims[10],
    strides[12], maps)`` (k's and v's tensor maps, 256 bytes),
    ``fa_decode(q, o, maps, dims[10], strides[12], causal, window,
    q_offset, scale_log2, stages, full, empty, stream)`` (the launch),
    ``fa_decode_probe(.., stream, stop)`` (a timing probe that leaves the
    output unwritten) and ``fa_decode_clusters(dims[10], strides[12],
    stages, &clusters)`` (how many of the launch's clusters the card holds
    at once)."""

    import ctypes

    from repro_torch.kernels._build import load

    fn = getattr(load(DECODE_SOURCE), name)
    fn.restype = ctypes.c_int
    arrays = [ctypes.POINTER(ctypes.c_longlong)] * 2
    launch = ([ctypes.c_void_p] * 3 + arrays + [ctypes.c_int] * 3 + [ctypes.c_float]
              + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.argtypes = {
        "fa_decode_maps": [ctypes.c_void_p] * 2 + arrays + [ctypes.c_void_p],
        "fa_decode": launch,
        "fa_decode_probe": launch + [ctypes.c_int],
        "fa_decode_clusters": arrays + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    }[name]
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """flash_decode's launch for one call: the ctypes arrays ``fa_decode``
    takes (``dims`` carries the call's live span, its key ranges and their
    length), the key ranges (the cluster's blocks), the ring's K-loop plan at
    the depth it runs and how many of the launch's clusters the card holds
    at once."""

    dims: object
    strides: object
    splits: int
    sched: object
    clusters: int


# tensor maps kept (by k's and v's addresses, shape and strides) before all
# are dropped: a decode step holds one pair a layer, 64 at most in the configs
DECODE_MAPS_KEPT = 256
_DECODE_MAPS: dict = {}


@functools.lru_cache(maxsize=1024)
def _decode_clusters(shape: Tuple[int, ...], strides: Tuple[int, ...], splits: int,
                     depth: int, device: int) -> int:
    """How many clusters of ``splits`` blocks of flash_decode's launch at
    ``shape`` / ``strides`` (as :func:`_decode_plan` takes them) and ring
    ``depth`` card ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``), queried once for each: the count
    reads no live span, so the query's ``dims`` give it ``splits`` ranges
    of one key.  Raises where the card cannot place one cluster."""

    import ctypes

    B, Sq, H, KV, Sk, hd = shape
    dims = (ctypes.c_longlong * 10)(B, H, KV, Sq, Sk, hd, 0, splits, 1, splits)
    c = ctypes.c_int(0)
    rc = _decode_entry_point("fa_decode_clusters")(
        dims, (ctypes.c_longlong * 12)(*strides), depth, ctypes.byref(c))
    if rc != 0 or c.value < 1:
        raise RuntimeError(
            f"flash attention ({FLASH_DECODE}): the card cannot place a cluster of {splits} "
            f"blocks of {decode_smem_bytes(hd, Sq * (H // KV), depth)} bytes of shared memory "
            f"for B={B}, Sq={Sq}, H={H}, KV={KV}, Sk={Sk}, hd={hd} (cudaError {rc})"
        )
    return c.value


def _decode_plan(shape: Tuple[int, ...], strides: Tuple[int, ...], lo: int, hi: int,
                 sms: int, device: int) -> DecodePlan:
    """flash_decode's launch for one call.  ``shape`` is ``(B, Sq, H, KV, Sk,
    hd)``, ``strides`` the (batch, sequence, head) strides of q, k, v and o,
    ``[lo, hi)`` the live keys (:func:`ref.live_span`), ``sms`` the card's
    SMs, ``device`` its index.  The ring is ``DECODE_DEPTH`` stages deep, at
    most a range's tiles, and the plan is read at that depth.  The span
    fills ``dims`` anew at every call; the cluster count is queried once a
    shape, strides, splits, depth and card (:func:`_decode_clusters`), so a
    decode step one key longer than the last queries nothing."""

    import ctypes

    B, Sq, H, KV, Sk, hd = shape
    splits = decode_splits(B, KV, hi - lo, sms)
    chunk = -(-(hi - lo) // splits)
    depth = min(DECODE_DEPTH, -(-chunk // DECODE_BK))
    dims = (ctypes.c_longlong * 10)(B, H, KV, Sq, Sk, hd, lo, hi, chunk, splits)
    stride_arr = (ctypes.c_longlong * 12)(*strides)
    sched = _decode_schedule(depth)
    clusters = _decode_clusters(shape, strides, splits, depth, device)
    return DecodePlan(dims, stride_arr, splits, sched, clusters)


def _check(rc: int, path: str, q, k, depth) -> None:
    """Raise for a failed launch, naming the route and the shape."""

    if rc == 0:
        return
    B, Sq, H, hd = q.shape
    shape = (
        f"B={B}, Sq={Sq}, Sk={k.shape[1]}, H={H}, KV={k.shape[2]}, hd={hd}, "
        f"dtype={q.dtype}, depth={depth}"
    )
    if rc <= -1000:
        raise RuntimeError(
            f"flash attention ({path}): cuTensorMapEncodeTiled failed "
            f"(CUresult {-1000 - rc}; -1: the CUDA driver lacks it) for {shape}"
        )
    raise RuntimeError(f"flash attention launch failed ({path}): cudaError {rc} ({shape})")


def _launch_tma(q, k, v, o, causal: bool, window: Optional[int], q_offset: int,
                sched, scale: Optional[float] = None) -> None:
    """``tma_wgmma_flash.cu``, with the tensor maps of :func:`tensor_map` and
    the plan's two waits as its flags."""

    import ctypes

    import torch

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dims = (ctypes.c_longlong * 6)(B, H, KV, Sq, Sk, hd)
    maps = (ctypes.c_longlong * 33)(
        *(
            x
            for t, rows in ((q, TMA_BQ), (k, TMA_BK), (v, TMA_BK))
            for x in tensor_map(t.shape, t.stride(), rows).flat()
        )
    )
    o_strides = (ctypes.c_longlong * 3)(*o.stride()[:3])
    rc = _tma_entry_point()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dims, maps, o_strides, int(causal), 0 if window is None else int(window),
        int(q_offset), (hd**-0.5 if scale is None else scale) * math.log2(math.e),
        sched.depth, int(sched.full), int(sched.empty),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(rc, TMA_WGMMA, q, k, sched.depth)


def _decode_maps(plan: DecodePlan, q, k, v):
    """k's and v's tensor maps for ``plan`` (256 bytes, and their address),
    encoded at the first call over these operands and kept
    (``DECODE_MAPS_KEPT``): the maps span all Sk keys and read no live span,
    so a decode step reads the same maps as the step before it, and
    whisper's cross-attention K and V, which stay in place across decode
    steps, encode nothing either."""

    import ctypes

    key = (k.data_ptr(), v.data_ptr(), tuple(k.shape), k.stride()[:3], v.stride()[:3])
    maps = _DECODE_MAPS.get(key)
    if maps is not None:
        return maps
    buf = (ctypes.c_ubyte * 256)()
    rc = _decode_entry_point("fa_decode_maps")(key[0], key[1], plan.dims, plan.strides, buf)
    _check(rc, FLASH_DECODE, q, k, plan.sched.depth)
    if len(_DECODE_MAPS) >= DECODE_MAPS_KEPT:
        _DECODE_MAPS.clear()
    maps = _DECODE_MAPS[key] = (buf, ctypes.addressof(buf))
    return maps


def _decode_args(plan: DecodePlan, q, k, v, o, causal: bool, window: Optional[int],
                 q_offset: int, scale: Optional[float] = None) -> tuple:
    """``fa_decode``'s arguments for one call on ``plan``, with k's and v's
    kept tensor maps (:func:`_decode_maps`)."""

    import torch

    maps = _decode_maps(plan, q, k, v)
    return (
        q.data_ptr(), o.data_ptr(), maps[1], plan.dims, plan.strides,
        int(causal), 0 if window is None else int(window), int(q_offset),
        (q.shape[-1] ** -0.5 if scale is None else scale) * LOG2E,
        plan.sched.depth, int(plan.sched.full), int(plan.sched.empty),
        torch.cuda.current_stream(q.device).cuda_stream,
    )


def _plan_of(q, k, v, o, causal: bool, window: Optional[int], q_offset: int) -> DecodePlan:
    """The call's :class:`DecodePlan` on its card."""

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lo, hi = live_span(Sq, Sk, causal, window, q_offset)
    index = q.device.index
    return _decode_plan(
        (B, Sq, H, KV, Sk, hd),
        (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]),
        lo, hi, _sm_count(index), index,
    )


def _launch_decode(q, k, v, o, causal: bool, window: Optional[int], q_offset: int,
                   scale: Optional[float] = None) -> DecodePlan:
    """``flash_decode.cu``'s one launch: a cluster a KV head over the key
    ranges of :func:`decode_splits`, merged in distributed shared memory.
    Returns the call's :class:`DecodePlan`."""

    plan = _plan_of(q, k, v, o, causal, window, q_offset)
    rc = _decode_entry_point("fa_decode")(
        *_decode_args(plan, q, k, v, o, causal, window, q_offset, scale))
    _check(rc, FLASH_DECODE, q, k, plan.sched.depth)
    return plan


def _decode_probe(q, k, v, o, causal: bool, window: Optional[int], q_offset: int,
                  stop: int) -> None:
    """A part of ``flash_decode.cu``'s launch alone, to time it (hd 64, at
    most 16 rows a KV head), leaving ``o`` unwritten: ``stop`` 1 the K-loop
    without the cluster merge, 2 the loads without the products.  Not
    counted and no route."""

    plan = _plan_of(q, k, v, o, causal, window, q_offset)
    rc = _decode_entry_point("fa_decode_probe")(
        *_decode_args(plan, q, k, v, o, causal, window, q_offset), stop)
    _check(rc, FLASH_DECODE, q, k, plan.sched.depth)


def _split_workspace(k):
    """One allocation for the pre-pass's four outputs, one after the other
    as ``tma_wgmma_flash_tf32x3.cu`` lays them (each a multiple of 256
    bytes, so 16-byte aligned), and its views ``(k_hi, k_lo, vt_hi,
    vt_lo)``."""

    import torch

    B, Sk, KV, hd = k.shape
    sk8 = -(-Sk // 8) * 8
    n_k, n_v = B * KV * Sk * hd, B * KV * hd * sk8
    ws = torch.empty(2 * (n_k + n_v), dtype=k.dtype, device=k.device)
    k_hi, k_lo, vt_hi, vt_lo = ws.split((n_k, n_k, n_v, n_v))
    return ws, (
        k_hi.view(B, KV, Sk, hd), k_lo.view(B, KV, Sk, hd),
        vt_hi.view(B, KV, hd, sk8), vt_lo.view(B, KV, hd, sk8),
    )


def _kv_strides(k, v):
    import ctypes

    return (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])


def split_kv_tf32(k, v):
    """``(k_hi, k_lo, vt_hi, vt_lo)``: the 3xTF32 route's pre-pass over k
    and v ``(B, Sk, KV, hd)`` f32, read by their strides.  ``k_*`` are
    ``(B, KV, Sk, hd)``, ``vt_*`` ``(B, KV, hd, Sk8)`` (Sk8: Sk rounded up
    to 8, zero-filled) with the keys of each group of 8 in
    :data:`ref.KEY_ORDER`; hi = rna_tf32(x), lo = rna_tf32(x - hi).  CPU
    tensors take :func:`ref.split_kv_tf32_ref`; CUDA tensors (hd 16, 32,
    64 or 128, 16-byte aligned bases, strides that are multiples of 16
    bytes, zero included) launch the kernel or raise.
    The route launches the pass inside its own call
    (:func:`_launch_tf32x3`); this is the pass alone."""

    import ctypes

    import torch

    if k.dtype != torch.float32 or v.dtype != torch.float32 or k.shape != v.shape:
        raise TypeError(
            f"split_kv_tf32 takes float32 k and v of one shape; got {k.dtype} "
            f"{tuple(k.shape)}, {v.dtype} {tuple(v.shape)}"
        )
    if k.device.type == "cpu" and v.device.type == "cpu":
        return split_kv_tf32_ref(k, v)
    B, Sk, KV, hd = k.shape
    if not (
        k.device == v.device and k.device.type == "cuda" and hd in TMA_HEAD_DIMS
        and all(s % 4 == 0 for t in (k, v) for s in t.stride()[:3])
        and k.stride(-1) == v.stride(-1) == 1
        and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    ):
        raise ValueError(
            f"split_kv_tf32: k {tuple(k.shape)} strides {k.stride()}, v strides "
            f"{v.stride()} on {k.device} / {v.device}: it reads hd {TMA_HEAD_DIMS}, "
            "16 bytes at a time from 16-byte aligned CUDA tensors"
        )
    ws, parts = _split_workspace(k)
    if k.numel() == 0:
        return parts
    rc = _tf32x3_entry_point("fa_split_kv_tf32")(
        k.data_ptr(), v.data_ptr(), ws.data_ptr(),
        (ctypes.c_longlong * 4)(B, Sk, KV, hd), _kv_strides(k, v),
        torch.cuda.current_stream(k.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"split_kv_tf32 launch failed on route {TMA_WGMMA_TF32X3}: "
            f"cudaError {rc} (B={B}, Sk={Sk}, KV={KV}, hd={hd})"
        )
    split_kv_tf32.launches += 1
    return parts


split_kv_tf32.launches = 0


def _launch_tf32x3(q, k, v, o, causal: bool, window: Optional[int],
                   q_offset: int, sched, scale: Optional[float] = None) -> None:
    """``tma_wgmma_flash_tf32x3.cu``'s one host call: the pre-pass of k and
    v into a workspace, then the product, with Q's tensor map and the
    plan's two waits as its flags.  Both launches are counted: the
    product's by :func:`flash_attention`, the pre-pass's here."""

    import ctypes

    import torch

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    ws, _ = _split_workspace(k)
    rc = _tf32x3_entry_point("fa_forward_tf32x3")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(), o.data_ptr(),
        (ctypes.c_longlong * 6)(B, H, KV, Sq, Sk, hd),
        (ctypes.c_longlong * 11)(*tensor_map(q.shape, q.stride(), TMA_BQ, 4).flat()),
        _kv_strides(k, v),
        (ctypes.c_longlong * 3)(*o.stride()[:3]),
        int(causal), 0 if window is None else int(window), int(q_offset),
        (hd**-0.5 if scale is None else scale) * math.log2(math.e),
        sched.depth, int(sched.full), int(sched.empty),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(rc, TMA_WGMMA_TF32X3, q, k, sched.depth)
    split_kv_tf32.launches += 1


def padded_head_dim(hd: int) -> int:
    """The head dim a CUDA call with ``hd`` runs at: ``hd`` itself when a
    kernel is built for it (or it is above them all, where the call
    raises), else the next of :data:`TMA_HEAD_DIMS`."""

    return next((h for h in TMA_HEAD_DIMS if h >= hd), hd)


def _check_live_keys(Sq: int, Sk: int, causal: bool, window: Optional[int],
                     q_offset: int) -> None:
    """Raise unless every query row keeps a live key.  A kernel gives a
    row with none 0 (or the mean of the key tiles it visited), where the
    plain version and the reference give the mean of all keys.  Row i sits
    at position p = q_offset + i and keeps keys j < Sk with j <= p (causal)
    and j > p - window: some key is left for all rows iff q_offset >= 0
    (causal) and the last row's p <= Sk + window - 2 (window)."""

    if Sq == 0 or Sk == 0:
        return
    if causal and q_offset < 0:
        raise NotImplementedError(
            f"flash attention kernel: causal with q_offset={q_offset} < 0 "
            "leaves the first query rows no key"
        )
    if window is not None and q_offset + Sq - 1 > Sk + window - 2:
        raise NotImplementedError(
            f"flash attention kernel: window={window} with q_offset={q_offset}, "
            f"Sq={Sq}, Sk={Sk} leaves the last query rows no key"
        )


def _check_kernel_call(q, k, v, window, q_offset: int = 0, causal: bool = True) -> None:
    """Raise for a CUDA call outside the kernel's contract, naming the
    argument."""

    import torch

    if q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"flash attention kernel: dtype {q.dtype} (it takes float32 or "
            "bfloat16)"
        )
    hd = q.shape[-1]
    if hd not in TMA_HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention kernel: hd={hd} (it takes hd in {TMA_HEAD_DIMS})"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention kernel: an input requires grad, and the kernel "
            "has no backward (the reference kernel has none either)"
        )
    if window is not None and window < 1:
        raise NotImplementedError(f"flash attention kernel: window={window} < 1")
    if not -(2**30) < q_offset < 2**30 or max(q.shape[1], k.shape[1]) >= 2**30:
        raise NotImplementedError(
            f"flash attention kernel: q_offset={q_offset}, Sq={q.shape[1]}, "
            f"Sk={k.shape[1]} (the kernels index positions below 2**30)"
        )
    _check_live_keys(q.shape[1], k.shape[1], causal, window, q_offset)
    step = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % step for s in t.stride()[:3]) or (
            t.data_ptr() % 16
        ):
            raise NotImplementedError(
                f"flash attention kernel: {name} with strides {t.stride()} at "
                f"offset {t.data_ptr() % 16} (its tensor maps read rows of "
                "16-byte-aligned chunks: unit last stride, other strides "
                "multiples of 16 bytes, zero included)"
            )


def _route_of(q, k, v, rule_only: bool = False) -> str:
    """:func:`route` for the operands; with ``_decode_route`` cleared (and
    not ``rule_only``) as if the call had no query rows."""

    return route(
        q.dtype, q.shape[-1], [t.stride()[:3] for t in (q, k, v)],
        [t.data_ptr() for t in (q, k, v)],
        sq=q.shape[1] if rule_only or _decode_route else None,
        group=q.shape[2] // max(1, k.shape[2]),
    )


def takes_flash_decode(q, k, v) -> bool:
    """Whether the route rule sends a call over q, k and v to flash_decode:
    all three bf16, and :func:`route` admits them (head dim, query rows,
    rows a KV head, alignment).  chip_smoke.py's A/B, which clears
    ``_decode_route``, sends such a call to tma_wgmma instead; this reads
    the rule alone."""

    import torch

    return (all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and _route_of(q, k, v, rule_only=True) == FLASH_DECODE)


def _check_decode_operands(q, k, v) -> None:
    """Raise unless ``flash_decode.cu`` can read the operands, whatever
    route :func:`route` gives them: bf16 at hd 64 or 128, 16-byte aligned,
    at most ``DECODE_MAX_ROWS`` query rows a KV head (its four row tiles)."""

    import torch

    if q.dtype != torch.bfloat16 or route(
        q.dtype, q.shape[-1], [t.stride()[:3] for t in (q, k, v)],
        [t.data_ptr() for t in (q, k, v)], sq=1,
    ) != FLASH_DECODE or q.shape[1] * (q.shape[2] // k.shape[2]) > DECODE_MAX_ROWS:
        raise NotImplementedError(
            f"flash_decode: q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}: it takes bf16 "
            f"at hd 64 or 128, 16-byte aligned, at most {DECODE_MAX_ROWS} rows a KV head"
        )


def _flash_decode(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0):
    """``flash_decode.cu`` on bf16 operands of hd 64 or 128 that its TMA
    can read, whatever route :func:`route` gives them (at most
    ``DECODE_MAX_ROWS`` query rows a KV head, the kernel's four row tiles),
    to check and time it beside ``tma_wgmma`` where the rule does not send
    a call to it; not counted in the launch counts and no route of
    :func:`flash_attention`."""

    import torch

    _check_kernel_call(q, k, v, window, q_offset, causal)
    _check_decode_operands(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_decode(q, k, v, o, causal, window, q_offset)
    return o


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    depth: Optional[int] = None,
    q_offset: int = 0,
    _scale: Optional[float] = None,
):
    """Softmax attention ``softmax(q kᵀ · hd**-0.5 + mask) v`` with f32
    softmax state, over q ``(B, Sq, H, hd)`` and k, v ``(B, Sk, KV, hd)``.
    A head dim below 128 that no kernel is built for runs on the next one
    that is (:data:`TMA_HEAD_DIMS`): q, k and v zero-padded, the scale of the
    true hd, the output sliced back — exact, since the padding adds 0 to
    every score and fills only the sliced-away columns.

    ``causal`` masks keys after the query position, ``window`` keys at or
    before ``q_pos - window``; query i sits at position ``q_offset + i``
    (the prefill continuation of the reference's ``chunked_attention``),
    key j at j.  On a CUDA tensor every query row must keep at least one
    key (:func:`_check_live_keys` raises otherwise).  ``depth`` is
    the K/V ring depth of the TMA routes (default: the deepest ring that
    fits, :func:`default_depth` / :func:`tf32x3_default_depth`);
    flash_decode has one depth, ``DECODE_DEPTH``.  The reference wrapper's
    ``blk_q`` / ``blk_k`` pick its tiles; here the rule picks a kernel: a
    call with few query rows, the reference's small-``blk_q`` case, takes
    ``flash_decode`` (:func:`route`), whose blocks split the keys instead.
    A CPU tensor takes the plain version; a CUDA tensor takes its route's
    kernel or raises.
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
    on_cpu = devices == {torch.device("cpu")}
    if not on_cpu and (len(devices) != 1 or q.device.type != "cuda"):
        raise ValueError(
            "flash attention operands must all be on the CPU or on one CUDA "
            f"device; got {[str(d) for d in devices]}"
        )
    path = sched = None
    to = padded_head_dim(hd)
    if q.dtype in (torch.float32, torch.bfloat16):
        path = _route_of(q, k, v)
        if path in (TMA_WGMMA, TMA_WGMMA_TF32X3):
            if to in TMA_HEAD_DIMS:  # else the kernel contract raises
                sched = _tma_schedule(to, depth, path)
        else:
            if depth not in (None, DECODE_DEPTH):
                raise NotImplementedError(
                    f"flash attention ({path}): ring depth {depth} (this route "
                    f"has one depth, {DECODE_DEPTH})"
                )
            sched = _decode_schedule()
    if on_cpu:
        return flash_attention_bshd_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset
        )
    if to != hd:
        o = flash_attention(
            *(pad_head_dim(t, to) for t in (q, k, v)),
            causal=causal, window=window, depth=depth, q_offset=q_offset,
            _scale=hd**-0.5,
        )
        return o[..., :hd].contiguous()
    _check_kernel_call(q, k, v, window, q_offset, causal)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return o
    if k.shape[1] == 0:
        return o.zero_()
    if path == FLASH_DECODE:
        _launch_decode(q, k, v, o, causal, window, q_offset, _scale)
    elif path == TMA_WGMMA:
        _launch_tma(q, k, v, o, causal, window, q_offset, sched, _scale)
    else:
        _launch_tf32x3(q, k, v, o, causal, window, q_offset, sched, _scale)
    flash_attention.launches += 1
    flash_attention.routes[path] += 1
    return o


flash_attention.launches = 0
flash_attention.routes = {FLASH_DECODE: 0, TMA_WGMMA: 0, TMA_WGMMA_TF32X3: 0}
