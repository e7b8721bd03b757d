"""Per-SCC scheduling-policy engine: pluggable strategies for recurrence SCCs.

The SCC-condensed hybrid (:mod:`repro_torch.core.scc`) used to hard-code exactly
one treatment for every SCC carrying a mixed-sign internal dependence: the
chunked DOACROSS.  That is sound but serializes wide recurrences that a
unimodular change of basis would run fully parallel — the classic polyhedral
skewing result (Baghdadi et al., arXiv:1111.6756): a stencil carrying
Δ=(1,-1) admits a diagonal wavefront after the skew ``T = [[1,0],[1,1]]``,
because every transformed distance becomes per-dimension non-negative, which
is exactly the ISD precondition the plain longest-path layering needs.

This module makes that decision first-class.  Each recurrence SCC is planned
by a :class:`SchedulingPolicy` producing a :class:`StrategyPlan` record that
:func:`repro_torch.core.scc.analyze_sccs` stores on the partition:

  * :class:`ChunkedDoacross` — the extracted PR-3 behavior: iterations in
    sequential order, ``chunk`` = the SCC's minimum carried linearized
    distance iterations batched per step (capped by the ``chunk_limit``
    knob; carried free orders of non-doall models pin the chunk to 1).
  * :class:`UnimodularSkew` — search small unimodular (det ±1) matrices
    ``T`` making every retained internal distance per-dimension non-negative
    in the transformed basis.  The SCC's instances are then layered by the
    existing longest-path machinery over the *transformed* instance space;
    because instance layering is basis-invariant (the enforced-order graph is
    isomorphic under the bijection ``i ↦ T·i``), the levels come out already
    carrying original coordinates — the index remapping the lowering would
    otherwise do per level is folded into the level tables for free.
  * :class:`PerSccModel` — run the recurrence SCC ``dswp``-style internally:
    one sequential lane per statement (per-statement lexicographic chains
    become enforced orders) while the surrounding program stays doall.
    Intra-iteration program order among the SCC's statements is *kept* — the
    upstream elimination assumed it, so the lanes may pipeline across
    iterations but may not reorder one iteration's statements.

  * :class:`CostModelPolicy` (the default, ``scc_policy=None``/``"auto"``)
    scores every feasible strategy by estimated batched-step cost — depth ×
    statement groups per level, with per-level width recorded for the report
    — and picks the cheapest, tie-broken toward ``chunk`` (the historical
    behavior).  ``parallelize(..., scc_policy="skew")`` forces one strategy;
    a forced strategy that is infeasible for some SCC (no legal skew matrix
    exists, non-doall execution model) falls back to ``chunk`` and says so
    in the plan's ``reason``.

Import-light on purpose (no numpy, no jax): :mod:`repro_torch.compile.structure`
folds the resolved policy — canonicalized by its content-hashing
``_const_fp`` fingerprint machinery, full instance state included — into
the structural cache key, and :mod:`repro_torch.core.scc` imports the vector
helpers from here, so this module must stay at the bottom of the
dependency stack (:func:`policy_signature` is the lighter, repr-based
identity used by reports and tests, not by the cache).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core.dependence import Dependence

Matrix = Tuple[Tuple[int, ...], ...]

# A backend's per-SCC cost hook (``BackendSpec.level_cost``): estimate the
# execution cost of one strategy's offer on that backend.  ``None`` keeps the
# interpreter model (depth × statement groups) the offers are born with.
LevelCostFn = Callable[["StrategyPlan", "SccContext"], float]


# ---------------------------------------------------------------------- #
# Small vector/matrix helpers (shared with repro_torch.core.scc)
# ---------------------------------------------------------------------- #

def strides_of(bounds: Sequence[Tuple[int, int]]) -> Tuple[List[int], int]:
    """Row-major strides of the iteration space + total iteration count."""

    extents = [hi - lo for lo, hi in bounds]
    strides = [0] * len(extents)
    acc = 1
    for k in range(len(extents) - 1, -1, -1):
        strides[k] = acc
        acc *= max(extents[k], 0)
    return strides, acc


def linearize(distance: Sequence[int], strides: Sequence[int]) -> int:
    return sum(d * s for d, s in zip(distance, strides))


def identity_matrix(ndim: int) -> Matrix:
    return tuple(
        tuple(1 if r == c else 0 for c in range(ndim)) for r in range(ndim)
    )


def mat_vec(mat: Matrix, vec: Sequence[int]) -> Tuple[int, ...]:
    return tuple(sum(m * v for m, v in zip(row, vec)) for row in mat)


def mat_mul(a: Matrix, b: Matrix) -> Matrix:
    n = len(a)
    return tuple(
        tuple(sum(a[r][k] * b[k][c] for k in range(n)) for c in range(n))
        for r in range(n)
    )


def mat_det(mat: Matrix) -> int:
    """Determinant by cofactor expansion — matrices here are tiny (ndim ≤ 3
    in practice, never beyond the loop-nest rank)."""

    n = len(mat)
    if n == 1:
        return mat[0][0]
    if n == 2:
        return mat[0][0] * mat[1][1] - mat[0][1] * mat[1][0]
    det = 0
    for c in range(n):
        minor = tuple(
            tuple(row[k] for k in range(n) if k != c) for row in mat[1:]
        )
        det += (-1) ** c * mat[0][c] * mat_det(minor)
    return det


def mat_inverse_unimodular(mat: Matrix) -> Matrix:
    """Exact integer inverse of a det-±1 matrix via the adjugate."""

    n = len(mat)
    det = mat_det(mat)
    if det not in (1, -1):
        raise ValueError(f"matrix {mat} is not unimodular (det={det})")
    if n == 1:
        return ((det,),)
    adj = []
    for r in range(n):
        row = []
        for c in range(n):
            minor = tuple(
                tuple(mat[i][j] for j in range(n) if j != r)
                for i in range(n)
                if i != c
            )
            row.append((-1) ** (r + c) * mat_det(minor) * det)
        adj.append(tuple(row))
    return tuple(adj)


def skew_point(mat: Matrix, point: Sequence[int]) -> Tuple[int, ...]:
    """Map an iteration point into the skewed basis (``i ↦ T·i``)."""

    return mat_vec(mat, point)


def unskew_point(mat: Matrix, point: Sequence[int]) -> Tuple[int, ...]:
    """Inverse map — exact because ``mat`` is unimodular; round-tripping any
    integer point is the bijectivity the property suite asserts."""

    return mat_vec(mat_inverse_unimodular(mat), point)


# ---------------------------------------------------------------------- #
# Unimodular skew search
# ---------------------------------------------------------------------- #

_SKEW_ENTRY_RANGE = range(-3, 4)


def _feasible(mat: Matrix, distances: Sequence[Tuple[int, ...]]) -> bool:
    return all(
        all(x >= 0 for x in mat_vec(mat, d)) for d in distances
    )


def _elementary_skews(ndim: int) -> List[Matrix]:
    """Row-operation generators: identity with one off-diagonal entry set
    (``row_r += m·row_c``) — each has det 1 by construction."""

    out: List[Matrix] = []
    for r in range(ndim):
        for c in range(ndim):
            if r == c:
                continue
            for m in _SKEW_ENTRY_RANGE:
                if m == 0:
                    continue
                mat = [list(row) for row in identity_matrix(ndim)]
                mat[r][c] = m
                out.append(tuple(tuple(row) for row in mat))
    return out


def find_unimodular_skew(
    distances: Sequence[Tuple[int, ...]], ndim: int
) -> Optional[Matrix]:
    """A small unimodular matrix making every distance per-dim non-negative.

    Returns the identity when the distances already satisfy the ISD
    precondition, the lowest-|entry| feasible matrix otherwise, or ``None``
    when the bounded search finds nothing (the caller falls back to
    chunking).  The search is exhaustive over entries in ``[-3, 3]`` for 2-D
    nests and over products of up to two elementary row operations for
    higher ranks — the determinant is ±1 for every candidate, so any hit is
    a legal change of basis (the instance map ``i ↦ T·i`` is bijective on
    ℤ^ndim, hence on any iteration space).

    Memoized: the search is pure in (distance set, rank) but costs ~1ms for
    a 2-D SCC (2401 candidates), and :func:`repro_torch.core.scc.scc_signature`
    folds it into every structural-cache key — warm ``run_xla`` lookups and
    per-wave serving re-plans must not re-pay it.
    """

    return _find_skew_cached(
        tuple(sorted({tuple(d) for d in distances if any(x != 0 for x in d)})),
        ndim,
    )


@functools.lru_cache(maxsize=256)
def _find_skew_cached(
    dists: Tuple[Tuple[int, ...], ...], ndim: int
) -> Optional[Matrix]:
    ident = identity_matrix(ndim)
    if _feasible(ident, dists):
        return ident
    if ndim == 1:
        return None  # 1-D lex-positive distances are already non-negative
    if ndim == 2:
        best: Optional[Matrix] = None
        best_weight = None
        for a, b, c, d in itertools.product(_SKEW_ENTRY_RANGE, repeat=4):
            if a * d - b * c not in (1, -1):
                continue
            mat = ((a, b), (c, d))
            if not _feasible(mat, dists):
                continue
            weight = (abs(a) + abs(b) + abs(c) + abs(d), (a, b, c, d))
            if best_weight is None or weight < best_weight:
                best, best_weight = mat, weight
        return best
    gens = _elementary_skews(ndim)
    candidates = gens + [mat_mul(g, h) for g in gens for h in gens]
    best = None
    best_weight = None
    for mat in candidates:
        if mat_det(mat) not in (1, -1) or not _feasible(mat, dists):
            continue
        weight = (sum(abs(x) for row in mat for x in row), mat)
        if best_weight is None or weight < best_weight:
            best, best_weight = mat, weight
    return best


# ---------------------------------------------------------------------- #
# Strategy plans
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SccContext:
    """Everything a policy may condition on for one recurrence SCC."""

    statements: Tuple[str, ...]            # lexical order
    internal_deps: Tuple[Dependence, ...]  # non-vacuous retained deps inside
    bounds: Tuple[Tuple[int, int], ...]
    model: str                             # the *global* execution model
    chunk_limit: Optional[int] = None
    # the SCC contains a carried free-order edge of a non-doall model
    # (per-statement dswp chain, procmap wraparound) — batching may not
    # reorder it, so DOACROSS chunks collapse to 1
    carried_free: bool = False


@dataclasses.dataclass(frozen=True)
class StrategyPlan:
    """One strategy's offer for an SCC, with its cost-model estimate."""

    strategy: str            # "chunk" | "skew" | "dswp"
    cost: float              # estimated batched group evaluations
    depth: int               # estimated level-synchronous steps
    width: float             # estimated instances per (statement, level)
    chunk: Optional[int] = None
    carried_min: Optional[int] = None
    skew: Optional[Matrix] = None
    # widest (statement, level) batch the strategy would emit — what a
    # backend whose per-step cost scales with padded lane width (the XLA
    # level loop) conditions its ``level_cost`` hook on
    max_width: Optional[int] = None
    reason: str = ""
    # the full auction scoreboard the winner was picked from, as
    # (strategy, predicted cost) pairs — populated by CostModelPolicy so
    # the predicted-vs-measured profiler (repro_torch.obs.profile) can line every
    # loser's prediction up against the winner's measured wall time; empty
    # for forced strategies (no auction happened)
    offers: Tuple[Tuple[str, float], ...] = ()
    # generation of the repro_torch.calibrate profile whose units priced the
    # auction: 0 = hand-set defaults (or a forced strategy — no auction).
    # Provenance only; deliberately absent from scc_signature and every
    # structural cache key.
    profile_generation: int = 0


class SchedulingPolicy:
    """Protocol: plan one recurrence SCC (return ``None`` when infeasible).

    Concrete strategies subclass this; anything with a ``name`` and a
    ``plan(ctx) -> Optional[StrategyPlan]`` is accepted by
    ``parallelize(..., scc_policy=...)``.
    """

    name: str = "?"

    def plan(self, ctx: SccContext) -> Optional[StrategyPlan]:
        raise NotImplementedError


# The user-facing ``scc_policy`` knob everywhere it appears (``parallelize``,
# ``PlanOptions``, ``schedule_levels``, ...): ``None``/"auto" = cost model, a
# strategy name forces one, a SchedulingPolicy instance plugs in directly.
# (Defined after the class so the Union holds the real type, not a forward
# reference — typing.get_args(SccPolicyLike) must expose SchedulingPolicy.)
SccPolicyLike = Union[None, str, SchedulingPolicy]




def _scc_shape(ctx: SccContext, *, lanes: bool) -> Tuple[int, int]:
    """Exact (depth, max group width) of the SCC's standalone instance graph.

    Edges: intra-iteration program order among the SCC's statements, the
    internal retained dependences, and (``lanes=True``, the per-SCC dswp
    model) per-statement lexicographic-successor chains.  Exact beats an
    analytic bound here: chain length truncates at the iteration-space
    boundary, which closed-form extent formulas overestimate badly enough to
    mis-rank skew against chunking.  The pass is the same O(instances·edges)
    work the scheduler itself does, paid only when the cost model actually
    has competing candidates — and memoized on exactly the inputs the depth
    depends on (NOT the whole context: ``chunk_limit`` doesn't change this
    graph, and the chunk-knob sweep in the tests would otherwise defeat the
    memo), because report summaries and knob sweeps re-analyze the same SCC.
    The max group width — the widest (statement, level) batch — rides along
    for backend ``level_cost`` hooks whose per-step cost scales with padded
    lane width.
    """

    return _scc_shape_cached(
        ctx.statements, ctx.internal_deps, ctx.bounds, lanes
    )


@functools.lru_cache(maxsize=64)
def _scc_shape_cached(
    statements: Tuple[str, ...],
    internal_deps: Tuple[Dependence, ...],
    bounds: Tuple[Tuple[int, int], ...],
    lanes: bool,
) -> Tuple[int, int]:
    from repro_torch.core.ir import iterations_of

    pts = iterations_of(bounds)
    if not pts:
        return 0, 0
    names = statements
    in_space = set(pts)
    nodes = [(s, it) for it in pts for s in names]
    adj: Dict[Tuple[str, Tuple[int, ...]], Set] = {}

    def add(u, v) -> None:
        if u != v:
            adj.setdefault(u, set()).add(v)

    nxt_of = {}
    if lanes:
        from repro_torch.core.isd import _next_point

        nxt_of = {it: _next_point(it, bounds) for it in pts}
    for it in pts:
        for a, b in zip(names, names[1:]):
            add((a, it), (b, it))
        if lanes and nxt_of[it] is not None:
            for s in names:
                add((s, it), (s, nxt_of[it]))
        for d in internal_deps:
            dst = tuple(x + dd for x, dd in zip(it, d.distance))
            if dst in in_space:
                add((d.source, it), (d.sink, dst))

    indeg = {v: 0 for v in nodes}
    for u, succs in adj.items():
        for v in succs:
            indeg[v] += 1
    level = {}
    frontier = [v for v in nodes if indeg[v] == 0]
    for v in frontier:
        level[v] = 0
    while frontier:
        nxt: List = []
        for u in frontier:
            for v in adj.get(u, ()):
                level[v] = max(level.get(v, 0), level[u] + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(v)
        frontier = nxt
    depth = max(level.values(), default=-1) + 1
    group_width: Dict[Tuple[str, int], int] = {}
    for (s, _it), lvl in level.items():
        key = (s, lvl)
        group_width[key] = group_width.get(key, 0) + 1
    return depth, max(group_width.values(), default=0)


class ChunkedDoacross(SchedulingPolicy):
    """The PR-3 behavior, extracted: sequential chunks of the SCC's minimum
    carried linearized distance (always feasible, always sound)."""

    name = "chunk"

    def plan(self, ctx: SccContext) -> Optional[StrategyPlan]:
        strides, total = strides_of(ctx.bounds)
        lins = [
            lin
            for d in ctx.internal_deps
            if (lin := linearize(d.distance, strides)) >= 1
        ]
        if ctx.carried_free:
            lins.append(1)
        # a recurrence SCC always carries something: its mixed-sign dep is
        # lexicographically positive and non-vacuous, hence lin ≥ 1
        carried_min = min(lins) if lins else 1
        chunk = carried_min
        if ctx.chunk_limit is not None:
            chunk = max(1, min(chunk, int(ctx.chunk_limit)))
        n_chunks = -(-total // chunk) if total else 0
        n_stmts = len(ctx.statements)
        return StrategyPlan(
            strategy="chunk",
            cost=float(n_chunks * n_stmts),
            depth=n_chunks,
            width=float(chunk),
            chunk=chunk,
            carried_min=carried_min,
            max_width=chunk,
            reason=(
                f"{total} iterations in {n_chunks} sequential chunks of "
                f"{chunk} (min carried distance {carried_min}"
                + (
                    f", capped by chunk_limit={ctx.chunk_limit}"
                    if ctx.chunk_limit is not None and chunk != carried_min
                    else ""
                )
                + ")"
            ),
        )


class UnimodularSkew(SchedulingPolicy):
    """Diagonal-wavefront execution after a det-±1 change of basis."""

    name = "skew"

    def plan(self, ctx: SccContext) -> Optional[StrategyPlan]:
        if ctx.model != "doall":
            # per-processor free orders serialize each lane regardless of
            # basis — skewing buys nothing and the chains already pin the
            # depth, so don't offer a plan
            return None
        mat = find_unimodular_skew(
            [d.distance for d in ctx.internal_deps], len(ctx.bounds)
        )
        if mat is None:
            return None
        _, total = strides_of(ctx.bounds)
        depth, max_width = _scc_shape(ctx, lanes=False)
        n_stmts = len(ctx.statements)
        width = total / depth if depth else 0.0
        return StrategyPlan(
            strategy="skew",
            cost=float(depth * n_stmts),
            depth=depth,
            width=width,
            skew=mat,
            max_width=max_width,
            reason=(
                f"unimodular skew {mat} makes all internal distances "
                f"per-dim non-negative; transformed-space layering runs "
                f"{total} iterations in {depth} wavefronts "
                f"(mean width {width:.1f})"
            ),
        )


class PerSccModel(SchedulingPolicy):
    """Run the SCC dswp-style internally: one sequential lane per statement,
    pipelined across iterations, while the rest of the program stays doall.

    The depth estimate is analytic, not a graph pass: each lane serializes
    its statement's ``total`` instances (chain length ``total``), and the
    kept intra-iteration program order adds the pipeline fill, so depth ≈
    ``total + n_stmts - 1``.  That bound also proves the cost model can
    never prefer dswp over chunking (chunk depth = ``ceil(total/chunk)`` ≤
    ``total``), so this strategy is effectively *forced-only* — it exists
    to model per-statement-processor machines, not to win the cost race —
    and charging an exact O(instances·edges) layering just to lose the
    auction would be wasted planning work on every auto-planned SCC.
    """

    name = "dswp"

    def plan(self, ctx: SccContext) -> Optional[StrategyPlan]:
        if ctx.model != "doall":
            return None  # the global model already owns the lane structure
        _, total = strides_of(ctx.bounds)
        n_stmts = len(ctx.statements)
        depth = total + n_stmts - 1 if total else 0
        width = total / depth if depth else 0.0
        return StrategyPlan(
            strategy="dswp",
            cost=float(depth * n_stmts),
            depth=depth,
            width=width,
            max_width=1,  # each lane advances one instance per level
            reason=(
                f"per-SCC dswp: {n_stmts} statement lane(s) pipelined over "
                f"{total} iterations in ~{depth} levels (analytic lane-chain "
                "estimate)"
            ),
        )


# Per-batched-group dispatch weight of the interpreters' default
# depth × statement-groups cost model.  A uniform scale that never flips
# an auction on its own — it exists so a calibrated profile
# (repro_torch.calibrate) can express interpreter costs on the same measured
# scale as the backend hooks; resolved late like every other cost unit.
DISPATCH_UNITS = 1.0


# chunk first: it is the tie-breaker (the historical behavior) and the
# universal fallback for forced strategies that turn out infeasible
DEFAULT_STRATEGIES: Tuple[SchedulingPolicy, ...] = (
    ChunkedDoacross(),
    UnimodularSkew(),
    PerSccModel(),
)

STRATEGY_NAMES: Tuple[str, ...] = tuple(s.name for s in DEFAULT_STRATEGIES)


class CostModelPolicy(SchedulingPolicy):
    """Score every feasible strategy, pick the cheapest (ties → first).

    ``level_cost`` is the backend's capability hook
    (:attr:`~repro_torch.core.parallelizer.BackendSpec.level_cost`): when set,
    each offer is re-scored as what it would cost *on that machine* instead
    of the interpreters' depth × statement-groups model the offers are born
    with — which is how ``plan.compile("xla")`` can pick ``chunk`` for the
    same SCC where ``plan.compile("wavefront")`` picks ``skew``.
    """

    name = "auto"

    def __init__(
        self,
        candidates: Sequence[SchedulingPolicy] = DEFAULT_STRATEGIES,
        level_cost: Optional[LevelCostFn] = None,
    ) -> None:
        self.candidates = tuple(candidates)
        self.level_cost = level_cost

    def plan(self, ctx: SccContext) -> Optional[StrategyPlan]:
        offers = [
            p for c in self.candidates if (p := c.plan(ctx)) is not None
        ]
        if not offers:
            return None
        # late import: the auction is priced by whatever calibration state
        # is active *now* (a warmed per-host profile, or the hand-set
        # module constants) — never frozen at import time
        from repro_torch.calibrate import dispatch_units, profile_generation

        if self.level_cost is not None:
            scored = [(float(self.level_cost(p, ctx)), p) for p in offers]
            tag = (
                "cost model "
                f"({getattr(self.level_cost, '__name__', 'level_cost')})"
            )
        else:
            # the interpreters' depth × groups model, weighted by the
            # calibrated per-dispatch cost.  The weight is uniform across
            # offers — it can never flip this auction — so the *recorded*
            # scoreboard keeps the model-space prices (reports stay
            # calibration-invariant; see tests/test_calibrate.py) while
            # the scoring pass reads the profile like every other consumer
            du = dispatch_units()
            scored = [(p.cost * du, p) for p in offers]
            tag = "cost model"
        best_cost, best = min(scored, key=lambda t: t[0])  # tie → first
        if self.level_cost is None:
            # record model-space, not the uniformly-scaled scores
            scored = [(p.cost, p) for p in offers]
            best_cost = best.cost
        scoreboard = ", ".join(f"{p.strategy}={c:.0f}" for c, p in scored)
        return dataclasses.replace(
            best,
            cost=best_cost,
            reason=f"{tag} picked {best.strategy} "
            f"({scoreboard}); {best.reason}",
            offers=tuple((p.strategy, c) for c, p in scored),
            profile_generation=profile_generation(),
        )


class _ForcedPolicy(SchedulingPolicy):
    """Force one strategy; fall back to chunk (and say so) when infeasible."""

    def __init__(self, inner: SchedulingPolicy) -> None:
        self.inner = inner
        self.name = inner.name

    def plan(self, ctx: SccContext) -> Optional[StrategyPlan]:
        offer = self.inner.plan(ctx)
        if offer is not None:
            return dataclasses.replace(
                offer, reason=f"forced scc_policy={self.name!r}; {offer.reason}"
            )
        if ctx.model != "doall":
            cause = (
                f"the {ctx.model!r} execution model already owns the lane "
                "structure (per-processor free orders serialize the SCC)"
            )
        elif self.name == "skew":
            cause = (
                "no unimodular matrix within the bounded search makes "
                "every internal retained distance per-dimension non-negative"
            )
        else:
            cause = "the strategy declined this SCC"
        fallback = ChunkedDoacross().plan(ctx)
        return dataclasses.replace(
            fallback,
            reason=(
                f"forced scc_policy={self.name!r} is infeasible for this "
                f"SCC ({cause}); fell back to chunk — {fallback.reason}"
            ),
        )


def resolve_policy(
    spec: SccPolicyLike, level_cost: Optional[LevelCostFn] = None
) -> SchedulingPolicy:
    """Normalize a user-facing ``scc_policy`` value to a policy object.

    ``None``/``"auto"`` → the cost model; a strategy name forces it (with
    chunk fallback when infeasible); a :class:`SchedulingPolicy` instance
    passes through.  Raises ``ValueError`` for anything else — this is the
    validation ``PlanOptions``/``parallelize()`` runs at entry.

    ``level_cost`` is the scheduling backend's cost hook: it is consulted
    only by the default cost model, so a forced strategy or an explicit
    policy instance is never silently re-scored.  It deliberately does NOT
    participate in the structural compile key (each backend resolves its own
    hook, so within one backend's cache "auto" is unambiguous).
    """

    if spec is None or spec == "auto":
        return CostModelPolicy(level_cost=level_cost)
    if isinstance(spec, SchedulingPolicy):
        return spec
    if isinstance(spec, str):
        for strategy in DEFAULT_STRATEGIES:
            if strategy.name == spec:
                return _ForcedPolicy(strategy)
        raise ValueError(
            f"unknown scc_policy {spec!r}; expected 'auto', one of "
            f"{STRATEGY_NAMES}, or a SchedulingPolicy instance"
        )
    raise ValueError(
        f"scc_policy must be None, 'auto', one of {STRATEGY_NAMES}, or a "
        f"SchedulingPolicy instance — got {type(spec).__name__}: {spec!r}"
    )


def policy_signature(spec: object) -> Tuple:
    """Bounds-free identity of the policy knob (a diagnostics/test helper).

    Class identity participates so a custom policy subclass can never alias
    a built-in of the same name, and instance state participates by
    ``repr`` so differently-configured instances of one class normally
    differ.  Nothing on the compile path calls this: repr is not injective
    (e.g. numpy truncates large arrays), so
    :func:`repro_torch.compile.structure.structural_key` canonicalizes the
    resolved policy's full instance state itself with the same
    content-hashing fingerprint machinery the compute functions get, and
    reports identify the policy by its ``name``.
    """

    def _sig(p: SchedulingPolicy) -> Tuple:
        base: Tuple = (p.name, type(p).__module__, type(p).__qualname__)
        if isinstance(p, _ForcedPolicy):
            return base + (_sig(p.inner),)
        if isinstance(p, CostModelPolicy):
            hook = p.level_cost
            if hook is None:
                hook_id = None
            else:
                # behavioral identity, not qualname: two distinct lambdas
                # both print "<lambda>" — reuse the compute-fingerprint
                # machinery (lazy import: structure imports this module)
                from repro_torch.compile.structure import compute_fingerprint

                hook_id = compute_fingerprint(hook)
            return base + (tuple(_sig(c) for c in p.candidates), hook_id)
        state = getattr(p, "__dict__", None) or {}
        return base + (
            tuple(sorted((k, repr(v)) for k, v in state.items())),
        )

    return ("scc-policy", _sig(resolve_policy(spec)))
