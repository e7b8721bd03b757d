"""SCC-condensed hybrid scheduling of cyclic retained-dependence sets.

The wavefront layering (:mod:`repro_torch.core.wavefront`) is only defined when
every retained dependence distance is per-dimension non-negative — the ISD
precondition.  Real nests violate it routinely: a skewed stencil like
``a[i,j] = f(a[i-1,j+1])`` carries the lexicographically *positive* but
mixed-sign distance ``(1,-1)``, and until this module existed both fast
backends rejected the whole program with :class:`WavefrontError` while only
the O(iterations)-threads machine could run it.

This module implements the standard condensation recipe (DOACROSS/chunking
after Baghdadi et al., arXiv:1111.6756; cycle detection framing after Alluru
& Jeganathan, arXiv:2102.09317):

  1. condense the statement-level enforced-order graph (retained dependences
     plus the execution model's free orders) into strongly connected
     components with Tarjan's algorithm;
  2. classify each SCC — components whose internal dependences are all
     per-dimension non-negative keep the existing instance-level longest-path
     layering (strategy ``"layer"``); components carrying a mixed-sign
     internal dependence are **recurrence blocks** planned by the pluggable
     scheduling-policy engine (:mod:`repro_torch.core.policy`): a chunked DOACROSS
     (``"chunk"`` — iterations in sequential order, chunks of the minimum
     carried linearized distance), a unimodular-skew diagonal wavefront
     (``"skew"`` — instance layering legalized by a det-±1 change of basis),
     or a per-SCC dswp pipeline (``"dswp"`` — one lane per statement).  A
     cost model picks per SCC by default; ``scc_policy`` forces one.  The
     chosen :class:`~repro_torch.core.policy.StrategyPlan` is recorded on each
     :class:`SccInfo` (strategy, skew matrix, cost, and a human-readable
     ``reason``) and surfaces through every report summary;
  3. layer the mixed granularity — individual instances for layerable,
     skewed, and dswp-piped statements, chunk super-nodes for chunked
     recurrence statements — with one global longest-path pass, which yields
     cross-SCC *pipelining* for free: a downstream acyclic SCC's instances
     level right after the producer chunk (or skewed wavefront) they read,
     not after the whole recurrence finishes.

The result is expressed in the ordinary level/group vocabulary (one batched
evaluation per (statement, level), groups within a level executed in lexical
statement order — both executors already do exactly that), so the NumPy
interpreter and the XLA compile path consume hybrid schedules unchanged;
:mod:`repro_torch.compile.lowering` additionally collapses recurrence bands into a
nested ``lax.fori_loop``.

Genuinely unschedulable sets still raise :class:`WavefrontError`, now with a
real diagnosis: a retained dependence whose distance is lexicographically
negative (or zero against lexical order) contradicts sequential execution
order — the paper's send/wait machine would deadlock on it — and the error
names the offending SCC's statements plus a witness cycle.  Validation runs
at ``parallelize()`` time, not mid-execution.

Import-light on purpose (no numpy, no jax): :mod:`repro_torch.compile.structure`
folds :func:`scc_signature` into the structural cache key without paying any
heavy import.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.core.dependence import Dependence
from repro_torch.core.ir import LoopProgram
from repro_torch.core.policy import (
    LevelCostFn,
    Matrix,
    SccContext,
    SccPolicyLike,
    StrategyPlan,
    find_unimodular_skew,
    linearize as _linearized,
    resolve_policy,
    strides_of as _strides,
)

Instance = Tuple[str, Tuple[int, ...]]
# a scheduling unit: ("i", statement, iteration) for individually layered
# (incl. skewed / per-SCC-dswp) instances, ("c", scc id, chunk index) for
# chunked recurrence blocks
Unit = Tuple


class WavefrontError(ValueError):
    """The retained-dependence set admits no parallel schedule at all.

    Raised only for sets that contradict sequential execution order (the
    send/wait machine would deadlock on them); mixed-sign but
    lexicographically positive sets are *schedulable* via the SCC-condensed
    hybrid and no longer error.
    """


# ---------------------------------------------------------------------- #
# Small vector helpers
# ---------------------------------------------------------------------- #

def _lex_sign(vec: Sequence[int]) -> int:
    for v in vec:
        if v > 0:
            return 1
        if v < 0:
            return -1
    return 0


def _vacuous(distance: Sequence[int], bounds: Sequence[Tuple[int, int]]) -> bool:
    """True when no instance pair of this distance fits inside ``bounds``."""

    return any(abs(d) >= hi - lo for d, (lo, hi) in zip(distance, bounds))


# ---------------------------------------------------------------------- #
# Statement-level enforced-order graph
# ---------------------------------------------------------------------- #

def _free_statement_edges(
    prog: LoopProgram,
    model: str,
    processors: Optional[Dict[str, object]],
) -> List[Tuple[str, str, int]]:
    """The model's free orders, projected to statements.

    Returns ``(source, sink, carried)`` triples; ``carried`` is 0 for
    intra-iteration order and 1 for the lexicographic-successor order
    (per-statement for dswp, per-processor wraparound for procmap).  The
    carried edges are what force recurrence chunks down to size 1 under
    non-doall models: batching a chunk may not reorder anything a processor
    executes sequentially for free.
    """

    names = prog.names
    if model == "doall":
        return [(a, b, 0) for a, b in zip(names, names[1:])]
    if model == "dswp":
        return [(a, a, 1) for a in names]
    if model == "procmap":
        if not processors:
            raise ValueError("procmap model requires a processors mapping")
        edges: List[Tuple[str, str, int]] = []
        by_proc: Dict[object, List[str]] = {}
        for n in names:
            by_proc.setdefault(processors[n], []).append(n)
        for stmts in by_proc.values():
            for a, b in zip(stmts, stmts[1:]):
                edges.append((a, b, 0))
            edges.append((stmts[-1], stmts[0], 1))  # next-iteration wrap
        return edges
    raise ValueError(f"unknown execution model {model!r}")


def tarjan_sccs(
    nodes: Sequence[str], adj: Dict[str, Set[str]]
) -> List[List[str]]:
    """Iterative Tarjan; returns SCCs in topological (condensation) order."""

    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
            recursed = False
            succs = sorted(adj.get(v, ()))
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recursed = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if recursed:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index[v]:
                comp: List[str] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
    sccs.reverse()  # Tarjan emits reverse-topological order
    return sccs


def _witness_cycle(
    dep: Dependence, deps: Sequence[Dependence]
) -> Tuple[Dependence, ...]:
    """A dependence cycle through ``dep``, if one exists (BFS sink→source)."""

    if dep.source == dep.sink:
        return (dep,)
    adj: Dict[str, List[Dependence]] = {}
    for d in deps:
        adj.setdefault(d.source, []).append(d)
    prev: Dict[str, Dependence] = {}
    frontier = [dep.sink]
    seen = {dep.sink}
    while frontier:
        nxt: List[str] = []
        for u in frontier:
            for d in adj.get(u, ()):
                if d.sink in seen:
                    continue
                prev[d.sink] = d
                if d.sink == dep.source:
                    path = [d]
                    while path[-1].source != dep.sink:
                        path.append(prev[path[-1].source])
                    return (dep,) + tuple(path[::-1])
                seen.add(d.sink)
                nxt.append(d.sink)
        frontier = nxt
    return ()


def validate_retained(
    prog: LoopProgram, retained: Sequence[Dependence]
) -> None:
    """Reject dependence sets that contradict sequential execution order.

    A retained dependence demands source(i) execute before sink(i + Δ); when
    ``Δ`` is lexicographically negative — or zero while the sink does not
    follow the source in program text — the sequential oracle itself runs
    the two instances in the opposite order, so *no* backend can both
    enforce the dependence and stay bit-equal to the oracle (the send/wait
    machine deadlocks or races on it).  The diagnostic names each offending
    dependence, its SCC's statements, and a witness cycle when the Δ-sign
    mix closes one.  Everything else — including per-dimension sign mixes
    with lexicographically positive distances — is schedulable by the
    SCC-condensed hybrid and passes.
    """

    problems: List[str] = []
    deps = list(retained)
    for d in deps:
        sign = _lex_sign(d.distance)
        why = None
        if sign < 0:
            why = "its distance is lexicographically negative"
        elif sign == 0 and d.source == d.sink:
            why = "a zero-distance self-dependence orders an instance before itself"
        elif sign == 0 and prog.lexical_index(d.sink) < prog.lexical_index(d.source):
            why = (
                "its distance is zero but the sink precedes the source in "
                "program text"
            )
        if why is None:
            continue
        msg = f"{d.pretty()} runs against sequential execution order ({why})"
        cycle = _witness_cycle(d, deps)
        if cycle:
            stmts = sorted(
                {x for c in cycle for x in (c.source, c.sink)},
                key=prog.lexical_index,
            )
            msg += (
                f"; its Δ-sign mix closes a cycle through SCC "
                f"{{{', '.join(stmts)}}} — witness cycle: "
                + "  ->  ".join(c.pretty() for c in cycle)
            )
        problems.append(msg)
    if problems:
        _metrics.counter("plan.wavefront_rejections").inc()
        raise WavefrontError(
            "no parallel schedule can enforce the retained synchronized "
            "dependences (the send/wait machine would deadlock on them): "
            + "; ".join(problems)
            + " — drop the dependence or reformulate the loop "
            "(reversal/skewing) so every retained distance is "
            "lexicographically non-negative"
        )


# ---------------------------------------------------------------------- #
# Partition
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SccInfo:
    """One strongly connected component of the enforced-order graph.

    For recurrence components, ``strategy``/``skew``/``cost``/``reason``
    record the :class:`~repro_torch.core.policy.StrategyPlan` the policy engine
    chose; layerable components carry strategy ``"layer"``.
    """

    id: int
    statements: Tuple[str, ...]  # lexical order
    cyclic: bool                 # the component contains a dependence cycle
    recurrence: bool             # carries a mixed-sign internal dependence
    chunk: Optional[int] = None  # iterations per chunk (strategy "chunk")
    # min linearized carried distance inside the SCC (recurrence only) —
    # ``chunk`` equals it unless capped by the chunk_limit knob
    carried_min: Optional[int] = None
    strategy: str = "layer"      # "layer" | "chunk" | "skew" | "dswp"
    skew: Optional[Matrix] = None  # unimodular matrix (strategy "skew")
    cost: Optional[float] = None   # cost-model estimate for the choice
    reason: str = ""               # why this strategy won (human-readable)
    # the policy's full predicted scoreboard, (strategy, cost) per offer —
    # empty for forced strategies; feeds the predicted-vs-measured profiler
    offers: Tuple[Tuple[str, float], ...] = ()
    # generation of the calibration profile that priced the auction
    # (0 = hand-set defaults or forced strategy); provenance only, never
    # part of scc_signature
    profile_generation: int = 0


@dataclasses.dataclass(frozen=True)
class SccPartition:
    """Tarjan condensation of the statement graph, in topological order."""

    sccs: Tuple[SccInfo, ...]
    model: str
    policy: str = "auto"  # canonical name of the scheduling policy used

    def scc_of(self) -> Dict[str, int]:
        return {s: info.id for info in self.sccs for s in info.statements}

    @property
    def recurrences(self) -> Tuple[SccInfo, ...]:
        return tuple(s for s in self.sccs if s.recurrence)

    def summary(self) -> dict:
        return {
            "sccs": len(self.sccs),
            "cyclic": sum(1 for s in self.sccs if s.cyclic),
            "recurrences": [
                {
                    "statements": list(s.statements),
                    "strategy": s.strategy,
                    "chunk": s.chunk,
                    "carried_min": s.carried_min,
                    "skew": [list(r) for r in s.skew] if s.skew else None,
                    "cost": s.cost,
                    "reason": s.reason,
                    "offers": {name: cost for name, cost in s.offers},
                    "profile_generation": s.profile_generation,
                }
                for s in self.recurrences
            ],
            "model": self.model,
            "policy": self.policy,
        }


def analyze_sccs(
    prog: LoopProgram,
    retained: Sequence[Dependence],
    *,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: SccPolicyLike = None,
    level_cost: Optional[LevelCostFn] = None,
    instance_edges: Optional[Sequence[Tuple[Instance, Instance]]] = None,
) -> SccPartition:
    """Condense + classify; validates the retained set first (may raise).

    ``chunk_limit`` caps the DOACROSS chunk size (smaller chunks are always
    sound — they only serialize more); ``None`` uses the full minimum
    carried distance.  ``scc_policy`` selects the recurrence strategy per
    SCC: ``None``/``"auto"`` runs the cost model, a strategy name
    (``"chunk"``/``"skew"``/``"dswp"``) forces it, and any
    :class:`~repro_torch.core.policy.SchedulingPolicy` instance plugs in directly.
    ``level_cost`` is the scheduling backend's per-SCC cost hook
    (:attr:`~repro_torch.core.parallelizer.BackendSpec.level_cost`), consulted by
    the default cost model only — never by forced strategies or explicit
    policy instances.

    ``instance_edges`` (the inspector's exact runtime dependence graph) is
    projected onto statements before condensation: instance conflicts can
    run *both* directions between two statements, so leaving them out could
    place mutually dependent statements in separate SCCs and break the
    condensation's topological-order invariant downstream.
    """

    policy = resolve_policy(scc_policy, level_cost=level_cost)
    validate_retained(prog, retained)
    bounds = prog.bounds
    deps = [d for d in retained if not _vacuous(d.distance, bounds)]
    free = _free_statement_edges(prog, model, processors)

    adj: Dict[str, Set[str]] = {n: set() for n in prog.names}
    for d in deps:
        adj[d.source].add(d.sink)
    for a, b, _carried in free:
        adj[a].add(b)
    if instance_edges:
        for (su, _itu), (sv, _itv) in instance_edges:
            if su != sv:
                adj[su].add(sv)

    comps = tarjan_sccs(prog.names, adj)
    member_of: Dict[str, int] = {}
    for cid, comp in enumerate(comps):
        for n in comp:
            member_of[n] = cid

    lex = prog.lexical_index
    infos: List[SccInfo] = []
    for cid, comp in enumerate(comps):
        mset = set(comp)
        internal = [d for d in deps if d.source in mset and d.sink in mset]
        free_internal = [
            (a, b, c) for (a, b, c) in free if a in mset and b in mset
        ]
        cyclic = len(comp) > 1 or any(d.source == d.sink for d in internal)
        recurrence = any(
            any(x < 0 for x in d.distance) for d in internal
        )
        statements = tuple(sorted(comp, key=lex))
        if not recurrence:
            infos.append(
                SccInfo(
                    id=cid,
                    statements=statements,
                    cyclic=cyclic,
                    recurrence=False,
                )
            )
            continue
        ctx = SccContext(
            statements=statements,
            internal_deps=tuple(internal),
            bounds=bounds,
            model=model,
            chunk_limit=chunk_limit,
            carried_free=any(c == 1 for (_a, _b, c) in free_internal),
        )
        plan: Optional[StrategyPlan] = policy.plan(ctx)
        if plan is None:
            # a custom policy may decline an SCC; chunking is always sound
            from repro_torch.core.policy import ChunkedDoacross

            plan = ChunkedDoacross().plan(ctx)
            plan = dataclasses.replace(
                plan,
                reason=f"policy {policy.name!r} declined this SCC; "
                f"fell back to chunk — {plan.reason}",
            )
        infos.append(
            SccInfo(
                id=cid,
                statements=statements,
                cyclic=cyclic,
                recurrence=True,
                chunk=plan.chunk,
                carried_min=plan.carried_min,
                strategy=plan.strategy,
                skew=plan.skew,
                cost=plan.cost,
                reason=plan.reason,
                offers=plan.offers,
                profile_generation=plan.profile_generation,
            )
        )
    return SccPartition(
        sccs=tuple(infos), model=model, policy=policy.name
    )


def scc_signature(
    prog: LoopProgram,
    retained: Sequence[Dependence],
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
) -> Tuple:
    """Bounds-free canonical form of the SCC partition (cache-key component).

    Membership, recurrence flags, and the bounds-free unimodular-skew
    candidate per recurrence SCC (the matrix search depends only on the
    internal distance vectors) — chunk sizes and the cost model's strategy
    choice are evaluated against concrete bounds and belong to the
    per-bounds table cache, not the structural key.
    """

    free = _free_statement_edges(prog, model, processors)
    adj: Dict[str, Set[str]] = {n: set() for n in prog.names}
    for d in retained:
        adj[d.source].add(d.sink)
    for a, b, _carried in free:
        adj[a].add(b)
    comps = tarjan_sccs(prog.names, adj)
    lex = prog.lexical_index
    out = []
    for comp in comps:
        mset = set(comp)
        internal_dists = tuple(
            d.distance
            for d in retained
            if d.source in mset and d.sink in mset
        )
        recurrence = any(any(x < 0 for x in d) for d in internal_dists)
        out.append(
            (
                tuple(sorted(comp, key=lex)),
                recurrence,
                find_unimodular_skew(internal_dists, prog.ndim)
                if recurrence
                else None,
            )
        )
    return tuple(out)


# ---------------------------------------------------------------------- #
# Hybrid layering
# ---------------------------------------------------------------------- #

def hybrid_levels(
    prog: LoopProgram,
    retained: Sequence[Dependence],
    *,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: SccPolicyLike = None,
    level_cost: Optional[LevelCostFn] = None,
    instance_edges: Optional[Sequence[Tuple[Instance, Instance]]] = None,
) -> Tuple[List[Dict[str, List[Tuple[int, ...]]]], SccPartition]:
    """Longest-path layering over mixed instance/chunk scheduling units.

    Returns ``(levels, partition)`` where ``levels[L]`` maps statement name
    to its (iteration-ordered) batch at level ``L``.  The partition's
    per-SCC strategy records decide the scheduling units: ``"chunk"`` SCCs
    become chunk super-nodes, ``"skew"`` and ``"dswp"`` SCCs stay
    instance-granular (``"dswp"`` adds per-statement lane chains).
    Correctness argument:

      * every enforced-order edge between *different* units strictly
        increases the level (Kahn longest path), exactly like the plain
        wavefront layering;
      * edges *inside* one chunk are only intra-iteration orders running
        lexically forward (program order, zero-distance dependences) — the
        executors evaluate a level's groups in lexical statement order, so
        those hold; carried edges can never stay inside a chunk because the
        chunk size is the minimum carried linearized distance;
      * skewed SCCs carry no intra-unit orders at all: every internal
        dependence is an ordinary unit edge, so the longest-path pass — the
        existing machinery, applied to what is isomorphically the
        T-transformed instance space (per-dimension non-negative distances,
        the ISD precondition) — strictly levels it; the levels carry
        original coordinates, i.e. the skew's index remap is already folded
        into the emitted batches;
      * per-SCC dswp adds per-statement lexicographic chains *on top of*
        intra-iteration program order (the elimination assumed program
        order; adding enforced edges is always sound), pipelining the lanes
        across iterations without reordering within one;
      * the unit graph is acyclic: every edge advances the sequential
        (iteration, lexical position) order, and chunks of one SCC are
        totally ordered by construction;
      * inspector ``instance_edges`` run strictly forward in sequential
        order and join the condensation at statement granularity (see
        :func:`analyze_sccs`), so both-direction instance conflicts merge
        into one SCC and cannot close a cross-unit cycle; an instance edge
        that would land *inside* one chunk span shrinks that SCC's chunk to
        1 (always sound — smaller chunks only serialize more).
    """

    part = analyze_sccs(
        prog,
        retained,
        model=model,
        processors=processors,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
        level_cost=level_cost,
        instance_edges=instance_edges,
    )
    bounds = prog.bounds
    deps = [d for d in retained if not _vacuous(d.distance, bounds)]
    strides, total = _strides(bounds)
    lows = [lo for lo, _hi in bounds]
    member_of = part.scc_of()
    chunk_info = {
        info.id: info
        for info in part.recurrences
        if info.strategy == "chunk"
    }
    lane_sccs = [
        info for info in part.recurrences if info.strategy == "dswp"
    ]
    names = prog.names
    pts = list(prog.iterations())

    def pos(it: Tuple[int, ...]) -> int:
        return sum((x - lo) * s for x, lo, s in zip(it, lows, strides))

    def unit(stmt: str, it: Tuple[int, ...]) -> Unit:
        info = chunk_info.get(member_of[stmt])
        if info is not None:
            return ("c", info.id, pos(it) // info.chunk)
        return ("i", stmt, it)

    if instance_edges and chunk_info:
        # an exact instance edge batched away inside one chunk span would be
        # violated — shrink those SCCs to chunk 1 (same-iteration edges are
        # never emitted by the inspector, so chunk 1 can hold no edge)
        shrink: Set[int] = set()
        for (su, itu), (sv, itv) in instance_edges:
            cu = member_of.get(su)
            if cu is None or cu != member_of.get(sv):
                continue
            info = chunk_info.get(cu)
            if info is not None and pos(itu) // info.chunk == pos(itv) // info.chunk:
                shrink.add(cu)
        for cid in shrink:
            chunk_info[cid] = dataclasses.replace(chunk_info[cid], chunk=1)

    in_space = set(pts)
    adj: Dict[Unit, Set[Unit]] = {}
    nodes: List[Unit] = []
    seen_nodes: Set[Unit] = set()
    for it in pts:
        for s in names:
            u = unit(s, it)
            if u not in seen_nodes:
                seen_nodes.add(u)
                nodes.append(u)

    def add(u: Unit, v: Unit) -> None:
        if u != v:
            adj.setdefault(u, set()).add(v)

    # free orders of the execution model, instance-enumerated
    if model == "doall":
        for it in pts:
            for a, b in zip(names, names[1:]):
                add(unit(a, it), unit(b, it))
    elif model == "dswp":
        from repro_torch.core.isd import _next_point

        for it in pts:
            nxt = _next_point(it, bounds)
            if nxt is not None:
                for a in names:
                    add(unit(a, it), unit(a, nxt))
    else:  # procmap
        if not processors:
            raise ValueError("procmap model requires a processors mapping")
        by_proc: Dict[object, List[str]] = {}
        for n in names:
            by_proc.setdefault(processors[n], []).append(n)
        lex = {n: k for k, n in enumerate(names)}
        for stmts in by_proc.values():
            seq = sorted(
                ((it, lex[s], s) for it in pts for s in stmts),
                key=lambda t: (t[0], t[1]),
            )
            for (it_a, _la, sa), (it_b, _lb, sb) in zip(seq, seq[1:]):
                add(unit(sa, it_a), unit(sb, it_b))

    # retained dependence edges
    for d in deps:
        for it in pts:
            dst = tuple(x + dd for x, dd in zip(it, d.distance))
            if dst in in_space:
                add(unit(d.source, it), unit(d.sink, dst))

    # exact inspector instance edges (runtime non-affine dependences)
    if instance_edges:
        for (su, itu), (sv, itv) in instance_edges:
            if itu in in_space and itv in in_space:
                add(unit(su, itu), unit(sv, itv))

    # per-SCC dswp lanes: each statement of the SCC is one sequential
    # processor, so its lexicographic-successor order is enforced for free
    if lane_sccs:
        from repro_torch.core.isd import _next_point

        nxt_of = {it: _next_point(it, bounds) for it in pts}
        for info in lane_sccs:
            for s in info.statements:
                for it in pts:
                    nxt = nxt_of[it]
                    if nxt is not None:
                        add(unit(s, it), unit(s, nxt))

    # chunk sequencing: a chunked recurrence block iterates its carry in order
    for info in chunk_info.values():
        n_chunks = -(-total // info.chunk)
        for t in range(n_chunks - 1):
            add(("c", info.id, t), ("c", info.id, t + 1))

    # Kahn longest-path layering over units
    indeg: Dict[Unit, int] = {u: 0 for u in nodes}
    for u, succs in adj.items():
        for v in succs:
            indeg[v] += 1
    level: Dict[Unit, int] = {}
    frontier = [u for u in nodes if indeg[u] == 0]
    for u in frontier:
        level[u] = 0
    done = 0
    while frontier:
        nxt: List[Unit] = []
        for u in frontier:
            done += 1
            for v in adj.get(u, ()):
                level[v] = max(level.get(v, 0), level[u] + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(v)
        frontier = nxt
    if done != len(nodes):  # pragma: no cover - guarded by validate_retained
        stuck = [u for u in nodes if indeg[u] > 0][:4]
        raise WavefrontError(
            "internal error: hybrid unit graph is cyclic despite validation "
            f"(stuck units include {stuck})"
        )

    depth = max(level.values(), default=-1) + 1
    levels: List[Dict[str, List[Tuple[int, ...]]]] = [
        {} for _ in range(depth)
    ]
    # instance units, visited in iteration order so batches come out sorted
    for it in pts:
        for s in names:
            u = unit(s, it)
            if u[0] == "i":
                levels[level[u]].setdefault(s, []).append(it)
    # chunk units expand to one batch per member statement (lexical order)
    for info in chunk_info.values():
        n_chunks = -(-total // info.chunk)
        for t in range(n_chunks):
            lvl = level[("c", info.id, t)]
            span = pts[t * info.chunk : (t + 1) * info.chunk]
            for s in info.statements:
                levels[lvl][s] = list(span)
    return levels, part
