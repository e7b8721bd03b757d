"""The paper's two synchronization-elimination algorithms (§4.2).

1. :func:`eliminate_transitive` — ISD transitive reduction (after Midkiff &
   Padua [10]): dependence δe is redundant if, for every placement of its
   source inside one shift-invariant window, a path of *other* enforced
   orders (intra-iteration program order + retained synchronized
   dependences) connects source(δe)(i) to sink(δe)(i+Δe).  Multiple retained
   dependences may cooperate to cover one eliminated dependence.

2. :func:`eliminate_pattern` — pattern matching (after Li & Abu-Sufah [25]):
   eliminate δe when there exists a retained δr with

     (i)   a path from source(δe) to source(δr)      [program flow],
     (ii)  sink(δr) reaches sink(δe)                 [program flow],
     (iii) δr lexically backward (sink precedes source in the program),
     (iv)  |Δr| = 1,
     (v)   sign(Δr) = sign(Δe).

   Unlike the ISD method this needs no constant-distance assumption for δe
   beyond its sign, which is why the paper presents it as the more general
   second approach.

Both return an :class:`EliminationResult` carrying retained/eliminated sets
and, for the ISD method, the witness paths (e.g. Fig. 6's
S1(2)→S2(2)→S3(2)→S2(3)→S3(3)→S2(4)→S3(4)).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.dependence import Dependence, loop_carried
from repro_torch.core.ir import LoopProgram
from repro_torch.core.isd import Instance, build_isd, isd_window


@dataclasses.dataclass(frozen=True)
class EliminationResult:
    retained: Tuple[Dependence, ...]
    eliminated: Tuple[Dependence, ...]
    # witness paths for eliminated deps (ISD method): dep → instance path
    witnesses: Dict[Dependence, Tuple[Instance, ...]]
    method: str

    @property
    def eliminated_fraction(self) -> float:
        total = len(self.retained) + len(self.eliminated)
        return len(self.eliminated) / total if total else 0.0


def _cost(dep: Dependence) -> Tuple:
    """Greedy ordering: try to eliminate the most expensive syncs first —
    longer distances mean more cross-processor traffic, and the paper's
    example eliminates the Δ=2 dependence using the Δ=1 one."""

    return (sum(abs(x) for x in dep.distance), dep.distance)


def _covered(
    prog: LoopProgram,
    dep: Dependence,
    retained: Sequence[Dependence],
    model: str = "doall",
    processors=None,
) -> Tuple[bool, Tuple[Instance, ...]]:
    """Is ``dep`` transitively enforced by ``retained`` + free orders?"""

    ndim = prog.ndim
    distances = [
        d for r in list(retained) + [dep] for d in r.distance
    ]
    w = isd_window(distances)
    reach = max(abs(x) for x in dep.distance) if dep.loop_carried else 1

    # window anchored at the real loop lower bounds (sound at the boundary);
    # extended by `reach` so target instances of every placement are present
    window = tuple((lo, lo + w + reach) for (lo, _hi) in prog.bounds[:ndim])
    try:
        isd = build_isd(
            prog, list(retained), window, model=model, processors=processors
        )
    except ValueError:
        return False, ()

    # every source placement within the first w iterations must be covered
    placements: List[Tuple[int, ...]] = [()]
    for lo, _ in prog.bounds:
        placements = [p + (i,) for p in placements for i in range(lo, lo + w)]

    witness: Tuple[Instance, ...] = ()
    for it in placements:
        dst_it = tuple(i + d for i, d in zip(it, dep.distance))
        ok, path = isd.has_path((dep.source, it), (dep.sink, dst_it))
        if not ok:
            return False, ()
        if not witness:
            witness = tuple(path)
    return True, witness


def synchronized_set(
    deps: Sequence[Dependence],
    model: str = "doall",
    processors=None,
) -> List[Dependence]:
    """The dependences that need explicit synchronization under ``model``.

    doall: loop-carried deps (Δ≠0) — Δ=0 is free via intra-iteration program
    order.  dswp: deps between *different* statements (any Δ, including 0 —
    statements live on different processors); self-deps are free via
    per-processor order.  procmap: deps between statements on different
    processors (same-processor deps are free via that processor's order).
    """

    if model == "doall":
        return list(loop_carried(deps))
    if model == "dswp":
        return [d for d in deps if d.source != d.sink]
    if model == "procmap":
        assert processors is not None
        return [d for d in deps if processors[d.source] != processors[d.sink]]
    raise ValueError(f"unknown execution model {model!r}")


def eliminate_transitive(
    prog: LoopProgram,
    deps: Sequence[Dependence],
    model: str = "doall",
    processors=None,
) -> EliminationResult:
    """ISD transitive reduction over the synchronized dependences."""

    retained: List[Dependence] = synchronized_set(deps, model, processors)
    eliminated: List[Dependence] = []
    witnesses: Dict[Dependence, Tuple[Instance, ...]] = {}

    for cand in sorted(retained, key=_cost, reverse=True):
        others = [r for r in retained if r is not cand]
        ok, path = _covered(
            prog, cand, others, model=model, processors=processors
        )
        if ok:
            retained.remove(cand)
            eliminated.append(cand)
            witnesses[cand] = path
    return EliminationResult(
        retained=tuple(retained),
        eliminated=tuple(eliminated),
        witnesses=witnesses,
        method=f"isd-transitive-reduction[{model}]",
    )


def _sign(x: int) -> int:
    return (x > 0) - (x < 0)


def pattern_matches(
    prog: LoopProgram, de: Dependence, dr: Dependence
) -> bool:
    """The five conditions of §4.2 for eliminating δe using δr (1-D)."""

    if len(de.distance) != 1 or len(dr.distance) != 1:
        return False
    if de is dr:
        return False
    # (iii) δr lexically backward
    if not dr.lexically_backward(prog):
        return False
    # (iv) |Δr| = 1
    if abs(dr.delta) != 1:
        return False
    # (v) same signs
    if _sign(de.delta) != _sign(dr.delta) or de.delta == 0:
        return False
    lex = prog.lexical_index
    if de.delta > 0:
        # (i) path (program flow) source(δe) → source(δr)
        if lex(de.source) > lex(dr.source):
            return False
        # (ii) sink(δr) reaches sink(δe)
        if lex(dr.sink) > lex(de.sink):
            return False
    else:
        # mirrored flow for negative-distance (reversed) loops
        if lex(de.source) < lex(dr.source):
            return False
        if lex(dr.sink) < lex(de.sink):
            return False
    return True


def eliminate_pattern(
    prog: LoopProgram, deps: Sequence[Dependence]
) -> EliminationResult:
    """Pattern-matching elimination over the loop-carried dependences."""

    retained: List[Dependence] = list(loop_carried(deps))
    eliminated: List[Dependence] = []
    for cand in sorted(retained, key=_cost, reverse=True):
        if abs(sum(cand.distance)) <= 1 and len(cand.distance) == 1:
            # a |Δ|≤1 dep can never be strictly covered by this pattern
            # without removing its own enabler; keep it
            continue
        for dr in retained:
            if dr is cand:
                continue
            if pattern_matches(prog, cand, dr):
                retained.remove(cand)
                eliminated.append(cand)
                break
    return EliminationResult(
        retained=tuple(retained),
        eliminated=tuple(eliminated),
        witnesses={},
        method="pattern-matching",
    )
