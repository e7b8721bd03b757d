"""Wavefront (level-synchronous) execution backend for SyncPrograms.

The threaded executor (:mod:`repro_torch.core.executor`) is the paper's machine in
miniature — one thread per iteration, cross-iteration order enforced only by
send/wait — which makes it a fine oracle and a hopeless fast path: a run of
``n`` iterations costs ``n`` OS threads plus a send/wait round-trip per
retained dependence instance.  This module replaces that with *static*
scheduling in the style of graph-based dependence layering (Alluru &
Jeganathan, arXiv:2102.09317; Baghdadi et al., arXiv:1111.6756):

  1. materialize the ISD over the loop's *actual* bounds — nodes are
     statement instances ``S_k(i)``, edges are exactly the orders the sync
     program's execution model enforces (free orders of the model + the
     retained synchronized dependences);
  2. compute each instance's *dependence level* by longest-path layering
     (level = length of the longest enforced-order chain reaching it);
  3. lower each level to one batched statement evaluation per (statement,
     level) group — a single vectorized NumPy gather/compute/scatter.

Soundness rides on the elimination invariant of §4.2: every true dependence
of the program is covered by a path of enforced-order edges, every enforced
edge strictly increases the level, hence any two instances sharing a level
are mutually independent and may execute in one batch, in any order.

The plain longest-path layering is only defined when retained distances are
per-dimension non-negative (the ISD precondition).  Retained sets with
mixed-sign distance components — skewed stencils, cross-iteration cycles
with a Δ-sign mix — route through the SCC-condensed hybrid scheduler
(:mod:`repro_torch.core.scc`): Tarjan condensation of the statement graph, then a
per-SCC strategy from the scheduling-policy engine (:mod:`repro_torch.core.policy`
— chunked DOACROSS, unimodular-skew diagonal wavefront, or per-SCC dswp
lanes; cost model by default, forced via ``scc_policy``) for recurrence
components, instance-level layering with cross-SCC pipelining for
everything else.  Only dependence sets that
contradict sequential execution order (lexicographically negative or
backward zero distances — the send/wait machine would deadlock) still raise
:class:`WavefrontError`, at schedule/parallelize time, naming the offending
SCC's statements and a witness cycle.

Four executors now coexist (see ROADMAP "Execution backends"):

  * :func:`repro_torch.core.ir.run_sequential` — the semantic oracle;
  * :func:`repro_torch.core.executor.run_threaded` — the paper's machine, used to
    demonstrate races and count send/wait traffic;
  * :func:`run_wavefront` (here) — the NumPy interpreter of the level
    schedule: O(depth) vectorized steps instead of O(iterations) threads;
  * :func:`repro_torch.compile.run_xla` — the *compiled* form of the same
    schedule: :class:`WavefrontSchedule` is the hand-off IR that
    :mod:`repro_torch.compile.lowering` packs into padded level buffers and jits
    as a single XLA level loop, cached structurally across bounds.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace as _trace
from repro_torch.core.dependence import Dependence
from repro_torch.core.ir import LoopProgram, is_indirect, run_sequential
from repro_torch.core.isd import Instance, build_isd
from repro_torch.core.policy import LevelCostFn, SccPolicyLike
from repro_torch.core.scc import (
    SccPartition,
    WavefrontError,
    analyze_sccs,
    hybrid_levels,
    validate_retained,
)
from repro_torch.core.sync import SyncProgram

__all__ = [
    "WavefrontError",  # re-exported; defined beside the SCC machinery
    "WavefrontGroup",
    "WavefrontSchedule",
    "WavefrontReport",
    "WavefrontStats",
    "run_wavefront",
    "schedule_levels",
    "schedule_wavefronts",
]


@dataclasses.dataclass(frozen=True)
class WavefrontGroup:
    """One batched evaluation: ``statement`` at every iteration in the group."""

    statement: str
    iterations: Tuple[Tuple[int, ...], ...]

    @property
    def width(self) -> int:
        return len(self.iterations)


@dataclasses.dataclass(frozen=True)
class WavefrontSchedule:
    """Dependence-level layering of a sync program's instance space."""

    program: LoopProgram
    levels: Tuple[Tuple[WavefrontGroup, ...], ...]
    model: str
    retained: Tuple[Dependence, ...]
    # statement → processor assignment (procmap model only) — carried so a
    # schedule is a complete lowering hand-off (repro_torch.compile re-layers it
    # for other bounds under the same model)
    processors: Optional[Dict[str, object]] = None
    # Tarjan condensation of the statement graph (repro_torch.core.scc); carries
    # the per-SCC strategy records (chunk sizes, skew matrices, cost-model
    # reasons) when the hybrid path was taken
    scc: Optional[SccPartition] = None
    # cap on DOACROSS chunk sizes this schedule was built with (the knob is
    # part of the lowering hand-off: re-layering for other bounds must chunk
    # under the same cap)
    chunk_limit: Optional[int] = None
    # the scc_policy spec this schedule was planned under (None/"auto",
    # a strategy name, or a SchedulingPolicy instance) — part of the
    # lowering hand-off for the same reason as chunk_limit
    scc_policy: SccPolicyLike = None

    # ------------------------------------------------------------------ #
    @property
    def depth(self) -> int:
        """Number of wavefronts — the O(depth) step count of the backend."""

        return len(self.levels)

    @functools.cached_property
    def batched_ops(self) -> int:
        """Total vectorized statement evaluations across all levels."""

        return sum(len(level) for level in self.levels)

    @functools.cached_property
    def instances(self) -> int:
        return sum(g.width for level in self.levels for g in level)

    @functools.cached_property
    def max_width(self) -> int:
        widths = [g.width for level in self.levels for g in level]
        return max(widths) if widths else 0

    def level_of(self) -> Dict[Instance, int]:
        """Instance → level index (inverse of ``levels``; test/debug aid)."""

        out: Dict[Instance, int] = {}
        for lvl, groups in enumerate(self.levels):
            for g in groups:
                for it in g.iterations:
                    out[(g.statement, it)] = lvl
        return out

    def summary(self) -> dict:
        out = {
            "depth": self.depth,
            "batched_ops": self.batched_ops,
            "instances": self.instances,
            "max_width": self.max_width,
            "model": self.model,
            "retained": [d.pretty() for d in self.retained],
        }
        if self.scc is not None:
            out["scc"] = self.scc.summary()
        return out


def _sync_dependences(sync: SyncProgram) -> List[Dependence]:
    """The dependences a SyncProgram actually synchronizes (its registers)."""

    out: List[Dependence] = []
    seen = set()
    for ds in sync.registers.values():
        for d in ds:
            key = (d.kind, d.source, d.sink, d.array, d.distance, d.nonaffine)
            if key not in seen:
                seen.add(key)
                out.append(d)
    return out


def schedule_wavefronts(
    sync: SyncProgram,
    retained: Optional[Sequence[Dependence]] = None,
    *,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: "SccPolicyLike" = None,
    level_cost: Optional["LevelCostFn"] = None,
) -> WavefrontSchedule:
    """Dependence-level layering of ``sync`` (hybrid when cycles demand it).

    ``retained`` defaults to the dependences ``sync`` synchronizes (its
    register table) — pass ``EliminationResult.retained`` explicitly when
    scheduling straight from a compiler report.  Raises
    :class:`WavefrontError` only for retained sets that contradict
    sequential execution order (see :func:`repro_torch.core.scc.validate_retained`).
    """

    deps = list(retained) if retained is not None else _sync_dependences(sync)
    return schedule_levels(
        sync.program,
        deps,
        model=model,
        processors=processors,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
        level_cost=level_cost,
    )


def _levels_to_groups(
    prog: LoopProgram,
    raw: Sequence[Mapping[str, Sequence[Tuple[int, ...]]]],
) -> Tuple[Tuple[WavefrontGroup, ...], ...]:
    lex = {name: k for k, name in enumerate(prog.names)}
    return tuple(
        tuple(
            WavefrontGroup(statement=name, iterations=tuple(its))
            for name, its in sorted(groups.items(), key=lambda kv: lex[kv[0]])
        )
        for groups in raw
    )


def schedule_levels(
    prog: LoopProgram,
    retained: Sequence[Dependence],
    *,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: "SccPolicyLike" = None,
    level_cost: Optional["LevelCostFn"] = None,
    instance_edges: Optional[Sequence[Tuple[Instance, Instance]]] = None,
) -> WavefrontSchedule:
    """Layer a bare :class:`LoopProgram` given its retained dependences.

    The sync-program-independent core of :func:`schedule_wavefronts`; used
    directly by the Pallas K-loop plan, whose enforced orders come from an
    explicit processor map rather than a send/wait program.

    ``instance_edges`` injects *exact* instance-level orders — the
    inspector's runtime dependence graph for non-affine accesses
    (:func:`repro_torch.core.inspector.inspect_dependences`) — on top of the
    statement-level retained set.  Pass the affine retained set alongside
    them: the inspector is authoritative only for the indirect array set.

    Per-dimension non-negative retained sets take the classic longest-path
    ISD layering below; sets with mixed-sign distance components route
    through the SCC-condensed hybrid (:func:`repro_torch.core.scc.hybrid_levels`)
    — acyclic components stay instance-layered (pipelined), recurrence
    components execute under the strategy the scheduling-policy engine
    (:mod:`repro_torch.core.policy`) picks per SCC: chunked DOACROSS blocks of at
    most ``chunk_limit`` iterations, a unimodular-skew diagonal wavefront,
    or a per-SCC dswp pipeline.  ``scc_policy`` forces one strategy
    (``"chunk"``/``"skew"``/``"dswp"``); the default runs the cost model,
    through the scheduling backend's ``level_cost`` hook when one is given
    (the compiled backend schedules with its own step-cost model — see
    ``repro_torch.compile.xla_level_cost``).
    """

    deps = list(retained)
    validate_retained(prog, deps)  # WavefrontError before any execution

    extra: Dict[Instance, List[Instance]] = {}
    if instance_edges:
        for u, v in instance_edges:
            if u != v:
                extra.setdefault(u, []).append(v)

    if any(x < 0 for d in deps for x in d.distance):
        raw, part = hybrid_levels(
            prog,
            deps,
            model=model,
            processors=processors,
            chunk_limit=chunk_limit,
            scc_policy=scc_policy,
            level_cost=level_cost,
            instance_edges=instance_edges,
        )
        return WavefrontSchedule(
            program=prog,
            levels=_levels_to_groups(prog, raw),
            model=model,
            retained=tuple(deps),
            processors=dict(processors) if processors else None,
            scc=part,
            chunk_limit=chunk_limit,
            scc_policy=scc_policy,
        )

    try:
        isd = build_isd(prog, deps, prog.bounds, model=model, processors=processors)
    except ValueError as e:  # pragma: no cover - guarded above for deps
        raise WavefrontError(str(e)) from e

    # Kahn layering: level(v) = 1 + max(level(pred)); cycle check for free.
    nodes: List[Instance] = [
        (s.name, it) for it in prog.iterations() for s in prog.statements
    ]
    indeg: Dict[Instance, int] = {v: 0 for v in nodes}
    for u, succs in isd.adj.items():
        for v, _tag in succs:
            indeg[v] = indeg.get(v, 0) + 1
    for u, vs in extra.items():
        for v in vs:
            indeg[v] = indeg.get(v, 0) + 1

    level: Dict[Instance, int] = {}
    frontier = [v for v in nodes if indeg[v] == 0]
    for v in frontier:
        level[v] = 0
    done = 0
    while frontier:
        nxt: List[Instance] = []
        for u in frontier:
            done += 1
            for v, _tag in isd.successors(u):
                level[v] = max(level.get(v, 0), level[u] + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(v)
            for v in extra.get(u, ()):
                level[v] = max(level.get(v, 0), level[u] + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(v)
        frontier = nxt
    if done != len(nodes):
        stuck = [v for v in nodes if indeg[v] > 0][:4]
        raise WavefrontError(
            "enforced-order instance graph is cyclic — no wavefront "
            f"layering exists (unschedulable instances include {stuck}); "
            "check the retained dependences for a cyclic Δ-sign mix"
        )

    depth = max(level.values(), default=-1) + 1
    by_level: List[Dict[str, List[Tuple[int, ...]]]] = [
        {} for _ in range(depth)
    ]
    for it in prog.iterations():  # iteration order → sorted group members
        for s in prog.statements:
            by_level[level[(s.name, it)]].setdefault(s.name, []).append(it)
    return WavefrontSchedule(
        program=prog,
        levels=_levels_to_groups(prog, by_level),
        model=model,
        retained=tuple(deps),
        processors=dict(processors) if processors else None,
        scc=analyze_sccs(
            prog,
            deps,
            model=model,
            processors=processors,
            scc_policy=scc_policy,
            level_cost=level_cost,
        ),
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
    )


# ---------------------------------------------------------------------- #
# Vectorized execution
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class WavefrontStats:
    levels: int
    batched_ops: int
    instances: int
    max_width: int


@dataclasses.dataclass
class WavefrontReport:
    store: dict
    schedule: WavefrontSchedule
    stats: WavefrontStats
    matches_sequential: bool


class _DenseStore:
    """Dict-of-dicts memory image ⇄ dense float64 arrays with an origin.

    A sparse input store (cells missing inside its bounding box) gets a
    per-array coverage mask so that reading an absent cell raises KeyError —
    matching what the sequential/threaded executors do on the same store —
    instead of consuming uninitialized memory.  ``initial_store()`` produces
    full rectangles, so the common path carries no mask and no overhead.
    """

    def __init__(self, store: Mapping[str, dict]) -> None:
        self.origin: Dict[str, Tuple[int, ...]] = {}
        self.data: Dict[str, np.ndarray] = {}
        self.mask: Dict[str, np.ndarray] = {}  # only sparse arrays
        for arr, cells in store.items():
            if not cells:
                raise KeyError(
                    f"array {arr!r} in the provided store has no initialized "
                    "cells — the dense backends need the accessed cells "
                    "up front (sequential execution would fail on its first "
                    "access too)"
                )
            keys = np.asarray(list(cells.keys()), dtype=np.int64)
            lo_v = keys.min(axis=0)
            shape = tuple((keys.max(axis=0) - lo_v + 1).tolist())
            idx = tuple((keys - lo_v).T)
            dense = np.zeros(shape, dtype=np.float64)
            dense[idx] = np.fromiter(
                cells.values(), dtype=np.float64, count=len(cells)
            )
            self.origin[arr] = tuple(lo_v.tolist())
            self.data[arr] = dense
            if len(cells) != dense.size:
                covered = np.zeros(shape, dtype=bool)
                covered[idx] = True
                self.mask[arr] = covered

    def _index(self, arr: str, pts: np.ndarray) -> Tuple[np.ndarray, ...]:
        lo = self.origin[arr]
        idx = tuple(pts[:, d] - lo[d] for d in range(pts.shape[1]))
        shape = self.data[arr].shape
        for d, comp in enumerate(idx):
            if comp.size and (comp.min() < 0 or comp.max() >= shape[d]):
                raise KeyError(
                    f"access to {arr!r} outside the initialized store "
                    f"(dim {d}) — widen the pad of initial_store()"
                )
        return idx

    def gather(self, arr: str, pts: np.ndarray) -> np.ndarray:
        idx = self._index(arr, pts)
        covered = self.mask.get(arr)
        if covered is not None and not covered[idx].all():
            raise KeyError(
                f"read of uninitialized {arr!r} cell — the provided store "
                "does not cover this access"
            )
        return self.data[arr][idx]

    def scatter(self, arr: str, pts: np.ndarray, vals: np.ndarray) -> None:
        idx = self._index(arr, pts)
        self.data[arr][idx] = vals
        covered = self.mask.get(arr)
        if covered is not None:
            covered[idx] = True

    def to_dicts(self) -> dict:
        out: dict = {}
        for arr, dense in self.data.items():
            lo = self.origin[arr]
            covered = self.mask.get(arr)
            if covered is None:
                idx = np.indices(dense.shape).reshape(dense.ndim, -1).T
                vals = dense.ravel()
            else:
                idx = np.argwhere(covered)
                vals = dense[tuple(idx.T)]
            idx = idx + np.asarray(lo, dtype=np.int64)
            out[arr] = dict(
                zip(map(tuple, idx.tolist()), vals.tolist())
            )
        return out


def _batched_compute(stmt, reads: List[np.ndarray], width: int) -> np.ndarray:
    """Evaluate ``stmt.compute`` over whole read vectors at once, falling
    back to an elementwise loop for compute functions that don't broadcast."""

    try:
        vals = np.asarray(stmt.compute(*reads), dtype=np.float64)
        if vals.shape == (width,):
            return vals
        if vals.ndim == 0:  # zero-read statements produce one scalar
            return np.full(width, float(vals), dtype=np.float64)
    except Exception:
        pass
    return np.array(
        [
            float(stmt.compute(*(r[j] for r in reads)))
            for j in range(width)
        ],
        dtype=np.float64,
    )


def run_wavefront(
    sync: SyncProgram,
    *,
    schedule: Optional[WavefrontSchedule] = None,
    store: Optional[Mapping[str, dict]] = None,
    compare: bool = True,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: SccPolicyLike = None,
) -> WavefrontReport:
    """Execute ``sync`` level by level, one vectorized op per group.

    Mirrors :func:`repro_torch.core.executor.run_threaded`: same store format,
    same ``matches_sequential`` contract (bit-equal against the sequential
    oracle).  An under-synchronized program mis-executes *deterministically*
    here — the layering simply places a racing read before its producer —
    which the differential tests exploit.
    """

    sched = schedule or schedule_wavefronts(
        sync,
        model=model,
        processors=processors,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
    )
    prog = sync.program
    init = {a: dict(c) for a, c in (store or prog.initial_store()).items()}
    mem = _DenseStore(init)
    data, origin = mem.data, mem.origin

    # Per-statement lowering, hoisted out of the level loop, for both paths:
    # store-relative scalar offsets (narrow groups) and absolute offset
    # arrays (wide groups), so the hot loop is pure index arithmetic.
    # Indirect accesses carry the index array's lowering instead — their
    # target cell is resolved per instance from the store's index contents.
    def _rel(ref):
        return tuple(
            o - l for o, l in zip(ref.offset_tuple(), origin[ref.array])
        )

    def _lower_ref(ref):
        if is_indirect(ref):
            idx = ref.index
            return (
                "ind",
                ref.array,
                idx.array,
                _rel(idx),
                np.asarray(idx.offset_tuple(), np.int64),
                ref.offset,
            )
        return (
            "aff",
            ref.array,
            _rel(ref),
            np.asarray(ref.offset_tuple(), np.int64),
        )

    lowered = {}
    for s in prog.statements:
        lowered[s.name] = (
            s,
            _lower_ref(s.write),
            tuple(_lower_ref(r) for r in s.reads),
            _lower_ref(s.guard) if s.guard is not None else None,
        )

    masks = mem.mask

    def scalar_cell(arr: str, it, off) -> np.float64:
        idx = tuple(x + o for x, o in zip(it, off))
        shape = data[arr].shape
        for d, x in enumerate(idx):
            if x < 0 or x >= shape[d]:
                raise KeyError(
                    f"access to {arr!r} outside the initialized store "
                    f"(dim {d}) — widen the pad of initial_store()"
                )
        covered = masks.get(arr)
        if covered is not None and not covered[idx]:
            raise KeyError(
                f"read of uninitialized {arr!r} cell — the provided store "
                "does not cover this access"
            )
        return data[arr][idx]

    def scalar_cell_of(acc, it) -> tuple:
        """Dense (store-relative) cell of one access at iteration ``it``."""

        if acc[0] == "aff":
            return tuple(x + o for x, o in zip(it, acc[2]))
        _tag, arr, iarr, irel, _ioff, const = acc
        # int() truncates toward zero — astype(int64) on the wide path agrees
        j = int(scalar_cell(iarr, it, irel)) + const
        return (j - origin[arr][0],)

    def wide_pts(acc, pts: np.ndarray) -> np.ndarray:
        """Absolute coordinates of one access for every point in ``pts``."""

        if acc[0] == "aff":
            return pts + acc[3]
        _tag, _arr, iarr, _irel, ioff, const = acc
        ivals = mem.gather(iarr, pts + ioff)
        return (ivals.astype(np.int64) + const)[:, None]

    # per-level span timing: the enabled check is hoisted so the disabled
    # path pays ONE branch per level (this loop is the interpreter's hot
    # path and the <5% disabled-overhead budget of the bench gate)
    _tracing = _trace.tracing_enabled()
    _t_level = 0
    for _level, groups in enumerate(sched.levels):
        if _tracing:
            _t_level = time.perf_counter_ns()
        for g in groups:
            stmt, w_l, reads_l, guard_l = lowered[g.statement]
            warr = w_l[1]
            width = len(g.iterations)
            if width <= 4:
                # narrow wavefront: scalar evaluation beats gather overhead
                for it in g.iterations:
                    if guard_l is not None and not (
                        scalar_cell(guard_l[1], it, guard_l[2]) > 0
                    ):
                        continue
                    vals = stmt.compute(
                        *(
                            scalar_cell(acc[1], it, acc[2])
                            if acc[0] == "aff"
                            else scalar_cell(
                                acc[1], scalar_cell_of(acc, it), (0,)
                            )
                            for acc in reads_l
                        )
                    )
                    widx = scalar_cell_of(w_l, it)
                    wshape = data[warr].shape
                    if any(
                        x < 0 or x >= n for x, n in zip(widx, wshape)
                    ):
                        raise KeyError(
                            f"write to {warr!r} outside the initialized "
                            "store — widen the pad of initial_store()"
                        )
                    data[warr][widx] = vals
                    covered = masks.get(warr)
                    if covered is not None:
                        covered[widx] = True
                continue
            pts = np.asarray(g.iterations, dtype=np.int64)
            if guard_l is not None:
                mask = mem.gather(guard_l[1], pts + guard_l[3]) > 0
                pts = pts[mask]
                if pts.shape[0] == 0:
                    continue
            reads = [mem.gather(acc[1], wide_pts(acc, pts)) for acc in reads_l]
            vals = _batched_compute(stmt, reads, pts.shape[0])
            mem.scatter(warr, wide_pts(w_l, pts), vals)
        if _tracing:
            _trace.emit(
                "wavefront.level",
                _t_level,
                level=_level,
                groups=len(groups),
                instances=sum(len(g.iterations) for g in groups),
            )

    result = mem.to_dicts()
    matches = True
    if compare:
        matches = run_sequential(prog, init) == result
    return WavefrontReport(
        store=result,
        schedule=sched,
        stats=WavefrontStats(
            levels=sched.depth,
            batched_ops=sched.batched_ops,
            instances=sched.instances,
            max_width=sched.max_width,
        ),
        matches_sequential=matches,
    )
