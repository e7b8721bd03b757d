"""Inspector–executor runtime dependence analysis for non-affine loops.

The static analyzer can only bound an indirect access ``a[idx[i]]`` by the
conservative Δ=1 proxy chain (full serialization).  The *inspector* stage
(after the inspector–executor line of work — arXiv 1111.6756 §speculative
loop optimization, and the graph-based dependence identifier of
arXiv 2102.09317) evaluates every subscript against the actual index-array
contents at plan-per-bounds time and produces the **exact instance-level
dependence graph**: one edge per (earlier instance → later instance) pair
that truly touches the same cell.  That graph feeds the existing
longest-path layering (:func:`repro_torch.core.wavefront.schedule_levels`
``instance_edges=``) — a new dependence *source*, not a new scheduler.

Soundness ladder (who decides what):

  * the sequential oracle decides *semantics* — every execution path must
    reproduce its store bit for bit;
  * the inspector graph decides *sufficiency* for the non-affine set — an
    order is safe iff it respects every inspector edge (affine dependences
    stay with the static retained set);
  * speculation (``deps="speculate"``) runs the doall-optimistic schedule
    first and uses :func:`speculation_violations` post-hoc; any violated
    edge triggers rollback to the conservative hybrid schedule.

Caching: instance graphs are bounds- *and* content-dependent by
construction, so results live in a bounded per-bounds memo keyed by
(program fingerprint, bounds, index-array content digest) — beside the
level-table cache, never inside the bounds-free structural key.

Guards are treated as always-executing during inspection (their outcome can
depend on loop-computed values): a superset of the real access set, hence a
superset of the real edges — over-serialization, never under.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.core.ir import (
    ArrayRef,
    IndirectRef,
    LoopProgram,
    Statement,
    is_indirect,
    ref_cell,
)

Instance = Tuple[str, Tuple[int, ...]]
InstanceEdge = Tuple[Instance, Instance]


@dataclasses.dataclass(frozen=True)
class InspectionResult:
    """The exact instance dependence graph over the non-affine array set."""

    program: LoopProgram
    # arrays accessed through at least one indirect subscript — the set the
    # inspector is authoritative for
    arrays: Tuple[str, ...]
    # (earlier instance, later instance) in sequential order; same-iteration
    # conflicts are omitted (intra-iteration program order enforces them)
    edges: Tuple[InstanceEdge, ...]

    @property
    def conflict_free(self) -> bool:
        return not self.edges

    def summary(self) -> Dict[str, object]:
        return {
            "arrays": list(self.arrays),
            "edges": len(self.edges),
            "conflict_free": self.conflict_free,
        }


def validate_inspectable(prog: LoopProgram) -> None:
    """Indirect programs must keep their index arrays loop-invariant.

    :class:`~repro_torch.core.ir.LoopProgram` already rejects direct writes; this
    re-checks at inspection time so hand-built programs that bypassed
    construction (e.g. dataclasses.replace) fail loudly here too.
    """

    clobbered = set(prog.index_arrays()) & {
        s.write.array for s in prog.statements
    }
    if clobbered:
        raise ValueError(
            f"index array(s) {sorted(clobbered)} are written inside the loop"
            f" — the inspector cannot evaluate subscripts at loop entry"
        )


def _inspected_arrays(prog: LoopProgram) -> Tuple[str, ...]:
    seen: List[str] = []
    for s in prog.statements:
        for ref in (s.write, *s.reads):
            if is_indirect(ref) and ref.array not in seen:
                seen.append(ref.array)
    return tuple(seen)


def _compute_edges(
    prog: LoopProgram, store: Mapping[str, dict]
) -> Tuple[InstanceEdge, ...]:
    """One sequential sweep with per-cell last-writer/reader tracking.

    Near-linear in the access count: every read sits in at most one
    "readers since last write" list and is flushed by at most one later
    write, so |edges| = O(|accesses|) — the O(n²) pairwise comparison exists
    only as the test-side cross-check (tests/test_inspector.py).
    """

    targets = set(_inspected_arrays(prog))
    last_write: Dict[Tuple[str, Tuple[int, ...]], Instance] = {}
    readers: Dict[Tuple[str, Tuple[int, ...]], List[Instance]] = {}
    edges: List[InstanceEdge] = []
    seen: set = set()

    def emit(u: Instance, v: Instance) -> None:
        if u[1] == v[1]:
            return  # same iteration: intra-iteration program order covers it
        if (u, v) not in seen:
            seen.add((u, v))
            edges.append((u, v))

    for it in prog.iterations():
        for s in prog.statements:
            inst = (s.name, it)
            reads = list(s.reads)
            if s.guard is not None:
                reads.append(s.guard)  # conservatively always evaluated
            for r in reads:
                if r.array not in targets:
                    continue
                cell = (r.array, ref_cell(r, it, store))
                lw = last_write.get(cell)
                if lw is not None:
                    emit(lw, inst)  # flow
                readers.setdefault(cell, []).append(inst)
            w = s.write
            if w.array in targets:
                cell = (w.array, ref_cell(w, it, store))
                for rd in readers.pop(cell, ()):
                    emit(rd, inst)  # anti
                lw = last_write.get(cell)
                if lw is not None:
                    emit(lw, inst)  # output
                last_write[cell] = inst
    return tuple(edges)


# ---------------------------------------------------------------------- #
# Per-bounds inspector memo (beside the level-table cache — never in the
# bounds-free structural key).
# ---------------------------------------------------------------------- #

_INSPECTOR_MEMO: "collections.OrderedDict[tuple, InspectionResult]" = (
    collections.OrderedDict()
)
_INSPECTOR_MEMO_MAX = 64
_INSPECTOR_LOCK = threading.Lock()
# registry-backed counters (repro_torch.obs.metrics); inspector_cache_stats()
# keeps the exact pre-registry return shape ("misses" doubles as the
# re-inspection count the serving summary reports)
_INSPECTOR_HITS = _metrics.counter("inspector_cache.hits")
_INSPECTOR_MISSES = _metrics.counter("inspector_cache.misses")


def index_content_digest(prog: LoopProgram, store: Mapping[str, dict]) -> str:
    """Content digest of the index arrays — the part of the store the
    instance graph actually depends on (subscripts are loop-invariant)."""

    h = hashlib.sha1()
    for arr in prog.index_arrays():
        h.update(arr.encode())
        for cell, val in sorted(store[arr].items()):
            # normalize the value type: a wave passing {"bin": [0, 1]} and
            # the lowering's float-normalized index view must digest
            # identically, or the same instance graph is re-inspected once
            # per representation (the subscript evaluator int()s the value
            # either way, so float() loses nothing the graph depends on)
            h.update(repr((tuple(cell), float(val))).encode())
    return h.hexdigest()


def inspector_cache_stats() -> Dict[str, int]:
    with _INSPECTOR_LOCK:
        size = len(_INSPECTOR_MEMO)
    return {
        "hits": _INSPECTOR_HITS.value,
        "misses": _INSPECTOR_MISSES.value,
        "size": size,
    }


def clear_inspector_cache() -> None:
    with _INSPECTOR_LOCK:
        _INSPECTOR_MEMO.clear()
    _INSPECTOR_HITS.reset()
    _INSPECTOR_MISSES.reset()


def inspect_dependences(
    prog: LoopProgram, store: Optional[Mapping[str, dict]] = None
) -> InspectionResult:
    """Evaluate all subscripts over ``store`` and build the exact
    instance-level dependence graph for the non-affine array set.

    Affine programs yield an empty graph (nothing to inspect).  Results are
    memoized per (program, bounds, index contents).
    """

    validate_inspectable(prog)
    arrays = _inspected_arrays(prog)
    if not arrays:
        return InspectionResult(program=prog, arrays=(), edges=())
    mem = store if store is not None else prog.initial_store()

    from repro_torch.compile.structure import program_fingerprint

    key = (
        program_fingerprint(prog),
        prog.bounds,
        index_content_digest(prog, mem),
    )
    with _INSPECTOR_LOCK:
        cached = _INSPECTOR_MEMO.get(key)
        if cached is not None:
            _INSPECTOR_MEMO.move_to_end(key)
    if cached is not None:
        _INSPECTOR_HITS.inc()
        return cached
    _INSPECTOR_MISSES.inc()
    with _trace.span("inspect", statements=len(prog.statements)):
        result = InspectionResult(
            program=prog, arrays=arrays, edges=_compute_edges(prog, mem)
        )
    with _INSPECTOR_LOCK:
        _INSPECTOR_MEMO[key] = result
        while len(_INSPECTOR_MEMO) > _INSPECTOR_MEMO_MAX:
            _INSPECTOR_MEMO.popitem(last=False)
    return result


# ---------------------------------------------------------------------- #
# Speculation: run doall-optimistic, validate post-hoc, roll back.
# ---------------------------------------------------------------------- #

def affine_retained(deps: Sequence) -> Tuple:
    """The retained set with non-affine proxies dropped — what the exact
    instance edges replace under ``deps="inspect"``/``"speculate"``."""

    return tuple(d for d in deps if not getattr(d, "nonaffine", False))


def speculation_violations(
    prog: LoopProgram,
    edges: Sequence[InstanceEdge],
    level_of: Mapping[Instance, int],
) -> List[InstanceEdge]:
    """Inspector edges the speculative schedule failed to respect.

    An edge u→v is honored iff level(u) < level(v), or both share a level
    and u's statement is lexically earlier (groups inside a level execute in
    lexical order; lanes of one group are unordered, so a same-statement
    same-level conflict is always a violation).
    """

    lex = prog.lexical_index
    bad: List[InstanceEdge] = []
    for u, v in edges:
        lu, lv = level_of.get(u), level_of.get(v)
        if lu is None or lv is None:
            bad.append((u, v))  # unscheduled instance: cannot be validated
            continue
        if lu < lv:
            continue
        if lu == lv and u[0] != v[0] and lex(u[0]) < lex(v[0]):
            continue
        bad.append((u, v))
    return bad


# ---------------------------------------------------------------------- #
# The canonical non-affine example programs (gather/scatter, sparse
# matvec, histogram) — shared by tests/programs.py, benchmarks and the
# serving demo so every consumer exercises identical structures.
# ---------------------------------------------------------------------- #

def gather_scatter(n: int = 8) -> LoopProgram:
    """b[i] = f(a[idx[i]]); a[perm[i]] = f(b[i]) — gather then scatter."""

    return LoopProgram(
        statements=(
            Statement(
                "S1",
                ArrayRef("b", 0),
                (IndirectRef("a", ArrayRef("idx", 0)),),
            ),
            Statement(
                "S2",
                IndirectRef("a", ArrayRef("perm", 0)),
                (ArrayRef("b", 0),),
            ),
        ),
        bounds=((0, n),),
    )


def sparse_matvec(n: int = 8) -> LoopProgram:
    """COO-style y[row[k]] = f(y[row[k]], v[k], x[col[k]]).

    The accumulate-into-y self conflict serializes exactly the iterations
    sharing a row; distinct rows run doall under ``deps="inspect"``.
    """

    return LoopProgram(
        statements=(
            Statement(
                "S1",
                IndirectRef("y", ArrayRef("row", 0)),
                (
                    IndirectRef("y", ArrayRef("row", 0)),
                    ArrayRef("v", 0),
                    IndirectRef("x", ArrayRef("col", 0)),
                ),
            ),
        ),
        bounds=((0, n),),
    )


def histogram(n: int = 8) -> LoopProgram:
    """h[bin[i]] = f(h[bin[i]], w[i]) — the classic indirect reduction."""

    return LoopProgram(
        statements=(
            Statement(
                "S1",
                IndirectRef("h", ArrayRef("bin", 0)),
                (IndirectRef("h", ArrayRef("bin", 0)), ArrayRef("w", 0)),
            ),
        ),
        bounds=((0, n),),
    )


def indexed_store(
    prog: LoopProgram,
    indices: Mapping[str, Sequence[int]],
    pad: int = 8,
) -> dict:
    """An initial store whose index arrays hold the given subscript values.

    Convenience for tests and benchmarks that need controlled patterns
    (all-distinct → pure doall, all-same → full serialization,
    permutations).  Cells outside the provided values keep the default
    deterministic content.
    """

    store = prog.initial_store(pad=pad)
    (lo, _hi), = prog.bounds
    for arr, vals in indices.items():
        cells = store[arr]
        for k, v in enumerate(vals):
            cells[(lo + k,)] = float(v)
    return store
