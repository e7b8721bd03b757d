"""Lifting the synchronization optimizer to pipeline-parallel schedules.

A pipeline-parallel run over ``S`` stages × ``M`` microbatches is the
paper's §3.2 setting verbatim: each stage is a processor executing one
"statement" for every iteration (= microbatch) of a loop, and cross-stage
data flow is a set of dependences that must be enforced with
producer/consumer synchronization.  On a TPU pod the send/wait pair is a
``jax.lax.ppermute`` hand-off (plus the implicit fence of the collective).

This module builds the loop program for a stage graph, analyzes its
dependences with the *same* analyzer used for the paper's didactic loops,
and runs the ISD transitive reduction under the ``dswp`` execution model.
What gets eliminated in practice:

  * **skip/fan-out dependences** — e.g. an encoder output consumed by every
    decoder stage (whisper-style cross-attention), or cross-stage residuals:
    the stage-chain hand-offs transitively cover them, so the data can
    piggyback on the chain instead of one collective per consumer stage;
  * **gradient-accumulation dependences** — the optimizer update waits on
    the *last* microbatch's backward only; the per-stage processor order
    covers the other M−1 waits (the paper's "a single send/wait pair can
    synchronize more than one dependence", lifted to DP/PP);
  * **barrier-style over-synchronization** — a naive GPipe flush orders all
    stage pairs; only the data-dependence chain survives reduction.

The retained dependences are emitted as :class:`CommEvent`s consumed by
:mod:`repro_torch.runtime.pipeline`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dependence import Dependence, analyze
from repro_torch.core.elimination import (
    EliminationResult,
    eliminate_transitive,
    synchronized_set,
)
from repro_torch.core.ir import ArrayRef, LoopProgram, Statement
from repro_torch.core.sync import SyncProgram, insert_synchronization, strip_dependences


@dataclasses.dataclass(frozen=True)
class StageGraph:
    """A pipeline stage graph: ``num_stages`` chained stages plus extra
    (producer_stage → consumer_stage) skip edges (cross-attention,
    residuals crossing stage boundaries, multi-tower fusions...)."""

    num_stages: int
    num_microbatches: int
    skips: Tuple[Tuple[int, int], ...] = ()
    with_backward: bool = False
    grad_accumulation: bool = True

    def forward_name(self, s: int) -> str:
        return f"F{s}"

    def backward_name(self, s: int) -> str:
        return f"B{s}"


def build_pipeline_program(graph: StageGraph) -> LoopProgram:
    """Statements = stage computations; 1-D loop over microbatches.

    ``F_s`` writes ``act_s[m]`` and reads ``act_{s-1}[m]`` (+ skip inputs).
    With backward: ``B_s`` writes ``grad_s[m]`` and the per-stage accumulator
    ``gacc_s[m]`` chain (reads ``gacc_s[m-1]``: a self-dependence, free on the
    stage's own processor), reading ``grad_{s+1}[m]`` and ``act_s[m]``.
    """

    S, M = graph.num_stages, graph.num_microbatches
    stmts: List[Statement] = []
    for s in range(S):
        reads = []
        if s > 0:
            reads.append(ArrayRef(f"act{s-1}", 0))
        for src, dst in graph.skips:
            if dst == s:
                reads.append(ArrayRef(f"act{src}", 0))
        stmts.append(Statement(graph.forward_name(s), ArrayRef(f"act{s}", 0), tuple(reads)))
    if graph.with_backward:
        for s in range(S - 1, -1, -1):
            reads = [ArrayRef(f"act{s}", 0)]
            if s < S - 1:
                reads.append(ArrayRef(f"grad{s+1}", 0))
            if graph.grad_accumulation:
                reads.append(ArrayRef(f"gacc{s}", -1))

            # B_s writes both grad_s[m] and gacc_s[m]; our IR has one write
            # per statement, so split into Bs (grad) and As (accumulate).
            stmts.append(
                Statement(graph.backward_name(s), ArrayRef(f"grad{s}", 0), tuple(reads))
            )
            if graph.grad_accumulation:
                stmts.append(
                    Statement(
                        f"A{s}",
                        ArrayRef(f"gacc{s}", 0),
                        (ArrayRef(f"grad{s}", 0), ArrayRef(f"gacc{s}", -1)),
                    )
                )
    return LoopProgram(statements=tuple(stmts), bounds=((0, M),))


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One retained synchronization event: a stage-to-stage hand-off for a
    given microbatch distance.  ``src_stmt``/``dst_stmt`` name the pipeline
    statements; in the runtime this lowers to one ppermute step."""

    src_stmt: str
    dst_stmt: str
    array: str
    distance: int


@dataclasses.dataclass(frozen=True)
class PipelineSyncPlan:
    graph: StageGraph
    program: LoopProgram
    dependences: Tuple[Dependence, ...]
    naive_sync: SyncProgram
    optimized_sync: SyncProgram
    elimination: EliminationResult
    events: Tuple[CommEvent, ...]

    def summary(self) -> dict:
        S, M = self.graph.num_stages, self.graph.num_microbatches
        naive = self.naive_sync.sync_instruction_count()
        opt = self.optimized_sync.sync_instruction_count()
        return {
            "stages": S,
            "microbatches": M,
            "synchronized_deps_naive": len(
                synchronized_set(list(self.dependences), "dswp")
            ),
            "synchronized_deps_optimized": len(self.elimination.retained),
            "eliminated": len(self.elimination.eliminated),
            "naive_sync_instructions": naive["total"],
            "optimized_sync_instructions": opt["total"],
            "naive_comm_events_per_step": naive["sends"] * M,
            "optimized_comm_events_per_step": opt["sends"] * M,
        }


def plan_pipeline_sync(graph: StageGraph) -> PipelineSyncPlan:
    """Analyze + synchronize + transitively reduce a pipeline stage graph."""

    prog = build_pipeline_program(graph)
    deps = analyze(prog)
    naive = insert_synchronization(prog, deps, model="dswp")
    elim = eliminate_transitive(prog, deps, model="dswp")
    optimized = strip_dependences(naive, elim.eliminated)
    events = tuple(
        CommEvent(
            src_stmt=d.source,
            dst_stmt=d.sink,
            array=d.array,
            distance=d.distance[0],
        )
        for d in elim.retained
    )
    return PipelineSyncPlan(
        graph=graph,
        program=prog,
        dependences=tuple(deps),
        naive_sync=naive,
        optimized_sync=optimized,
        elimination=elim,
        events=events,
    )


def stage_of(stmt: str) -> int:
    """Map a pipeline statement name (F3/B2/A1) to its stage index."""

    return int(stmt[1:])


def events_by_kind(plan: PipelineSyncPlan) -> Dict[str, List[CommEvent]]:
    """Split retained events into on-chip (same stage) and cross-stage —
    cross-stage events are the ones that cost ICI hops."""

    out: Dict[str, List[CommEvent]] = {"cross_stage": [], "local": []}
    for e in plan.events:
        if stage_of(e.src_stmt) == stage_of(e.dst_stmt):
            out["local"].append(e)
        else:
            out["cross_stage"].append(e)
    return out
