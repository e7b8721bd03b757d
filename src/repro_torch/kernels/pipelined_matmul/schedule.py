"""Producer/consumer synchronization plan for the pipelined matmul kernel —
the paper's algorithms applied to a kernel's K-loop.

The K-loop of a double-buffered blocked matmul has three statement roles on
TWO processors (the paper's §3.2 DSWP setting with an explicit processor
map — ``model="procmap"``):

  compute unit ("mxu"):   ISSUE(i)  — enqueue the DMA for tile i+1
                          COMPUTE(i) — acc += A·buf[i mod D]
  DMA engine   ("dma"):   LOAD(i)   — the asynchronous tile-i write

dependences:
  flow  ISSUE → LOAD,   Δ=1  (a DMA runs only after its descriptor issue;
                              prefetch distance 1 — ISSUE(i) starts tile i+1)
  flow  LOAD → COMPUTE, Δ=0  (arrival: the DMA-completion semaphore)
  anti  COMPUTE → LOAD, Δ=D  (slot reuse: tile i+D overwrites slot i mod D)

Running the paper's ISD transitive reduction (procmap model) proves the
classic double-buffering theorem mechanically:

  * D = 1: the anti dependence is NOT covered — single buffering needs an
    explicit consumed-credit semaphore (2 waits per step);
  * D ≥ 2: COMPUTE(i) →(mxu order) ISSUE(i+1) →(flow) LOAD(i+2) →(dma
    order) LOAD(i+D) covers the anti dependence — only the arrival wait
    survives (1 wait per step), which is exactly the schedule
    ``pl.pallas_call``'s automatic pipelining emits.

``min_buffers()`` returns the smallest depth whose anti dependence is
eliminable = 2.  Asserted in tests and reported by the benchmarks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

from repro_torch.core.dependence import ANTI, FLOW, Dependence
from repro_torch.core.ir import ArrayRef, LoopProgram, Statement
from repro_torch.core.parallelizer import PlanOptions, SyncPlan, plan
from repro_torch.core.wavefront import WavefrontSchedule

PROCESSORS = {"ISSUE": "mxu", "COMPUTE": "mxu", "LOAD": "dma"}


def make_kloop_program(steps: int) -> LoopProgram:
    """The ISSUE/LOAD/COMPUTE loop program.  Lexical order puts ISSUE first
    (prefetch happens before the compute of the current step)."""

    return LoopProgram(
        statements=(
            Statement("ISSUE", ArrayRef("desc", 0), ()),
            Statement("LOAD", ArrayRef("buf", 0), (ArrayRef("desc", -1),)),
            Statement(
                "COMPUTE",
                ArrayRef("acc", 0),
                (ArrayRef("buf", 0), ArrayRef("acc", -1)),
            ),
        ),
        bounds=((0, steps),),
    )


def kloop_dependences(depth: int) -> List[Dependence]:
    """Explicit dependence list (the ``i mod depth`` slot aliasing is not
    affine, so the anti distance is written directly)."""

    return [
        Dependence(FLOW, "ISSUE", "LOAD", "desc", (1,)),
        Dependence(FLOW, "LOAD", "COMPUTE", "buf", (0,)),
        Dependence(ANTI, "COMPUTE", "LOAD", "buf", (depth,)),
        Dependence(FLOW, "COMPUTE", "COMPUTE", "acc", (1,)),
    ]


@dataclasses.dataclass(frozen=True)
class KernelPipelinePlan:
    depth: int
    retained: tuple
    eliminated: tuple
    waits_per_step: int
    credit_wait_needed: bool
    # dependence-level layering of the K-loop under the same retained deps —
    # the steady-state overlap the Pallas pipeline realizes (LOAD of a later
    # tile sharing a level with an earlier COMPUTE)
    wavefront: WavefrontSchedule

    def summary(self) -> dict:
        return {
            "buffer_depth": self.depth,
            "retained": [d.pretty() for d in self.retained],
            "eliminated": [d.pretty() for d in self.eliminated],
            "waits_per_step": self.waits_per_step,
            "credit_wait_needed": self.credit_wait_needed,
            "wavefront_depth": self.wavefront.depth,
            "overlapped_levels": overlapped_levels(self.wavefront),
        }


def _kloop_options(depth: int) -> PlanOptions:
    """The staged pipeline's typed options for the K-loop: explicit
    dependences (the ``i mod depth`` aliasing is not affine) under the
    two-processor ``procmap`` execution model."""

    return PlanOptions(
        method="isd",
        deps=tuple(kloop_dependences(depth)),
        model="procmap",
        processors=PROCESSORS,
    )


@functools.lru_cache(maxsize=32)
def _kloop_plan(depth: int, steps: int) -> SyncPlan:
    """``plan()`` of the K-loop, memoized per (depth, steps).

    The parallelizer memoizes the elimination bounds-free, but fission,
    naive insertion and retained validation would still re-run per call —
    this cache keeps the warm ``compile_kloop`` path analysis-free, like
    the pre-staged ``_KLOOP_RETAINED`` memo did.
    """

    return plan(make_kloop_program(steps), _kloop_options(depth))


def plan_pipeline(depth: int = 2, steps: int = 16) -> KernelPipelinePlan:
    p = _kloop_plan(depth, steps)
    res = p.elimination
    cross = [
        d
        for d in res.retained
        if PROCESSORS[d.source] != PROCESSORS[d.sink]
    ]
    credit = any(d.kind == ANTI for d in res.retained)
    wf = p.compile("wavefront").report().wavefront
    return KernelPipelinePlan(
        depth=depth,
        retained=tuple(res.retained),
        eliminated=tuple(res.eliminated),
        waits_per_step=len(cross),
        credit_wait_needed=credit,
        wavefront=wf,
    )


def kloop_wavefronts(depth: int = 2, steps: int = 16) -> WavefrontSchedule:
    """The K-loop's dependence-level layering (same retained deps as the
    plan) — consumed by tests/benchmarks to check DMA/compute overlap."""

    return plan_pipeline(depth, steps).wavefront


def compile_kloop(depth: int = 2, steps: int = 16, device="cuda"):
    """Resolve the K-loop plan through the structural compile cache.

    Staged end to end: ``plan()`` (bounds-free memoized elimination) →
    ``compile("torch", device=device)`` (structural cache).  The cache key
    covers the statement graph, the retained dependences and the procmap
    model — *not* ``steps`` and not the device — so re-planning the same
    pipeline at a different K extent is a structural hit: only the
    per-bounds level tables are (re)built.  Returns ``(CompiledProgram,
    hit)``.
    """

    exe = _kloop_plan(depth, steps).compile("torch", device=device)
    return exe.artifacts["compiled"], exe.artifacts["compile_hit"]


def overlapped_levels(wf: WavefrontSchedule) -> int:
    """Levels in which a tile LOAD shares a wavefront with a COMPUTE — the
    mechanical signature of double buffering: with D ≥ 2 the layering puts
    LOAD(i+1) beside COMPUTE(i), with D = 1 the credit wait serializes them."""

    count = 0
    for groups in wf.levels:
        names = {g.statement for g in groups}
        if "LOAD" in names and "COMPUTE" in names:
            count += 1
    return count


def min_buffers(steps: int = 16, max_depth: int = 4) -> int:
    """Smallest depth whose buffer-reuse anti dependence is transitively
    covered (→ only the arrival wait remains)."""

    for depth in range(1, max_depth + 1):
        if not plan_pipeline(depth, steps).credit_wait_needed:
            return depth
    return max_depth
