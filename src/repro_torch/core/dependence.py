"""Dependence analysis over :class:`repro_torch.core.ir.LoopProgram`.

Implements the paper's §2.1/§3 definitions: for statement instances
``S_a^i`` and ``S_b^j``,

  * flow   (``S_a δf S_b``): S_a assigns a value that S_b may later read;
  * anti   (``S_a δa S_b``): S_a fetches a value that S_b may later write;
  * output (``S_a δo S_b``): S_a modifies a value that S_b may later modify.

With affine accesses ``x[i + o]`` and constant offsets, every conflicting
pair induces a *constant dependence distance* Δ = (iteration of sink) −
(iteration of source).  Sequential execution order is lexicographic over the
iteration vector, tie-broken by lexical statement order, so the dependence
runs from the instance that executes first to the one that executes later —
a negative raw distance between a write and a later-lexical read flips the
pair into an antidependence with positive distance, per the classical
definitions the paper cites ([7], [15], [16]).

Only dependences with Δ ≥ 0 exist after this normalization (Δ lexicographic-
nonnegative for nests); Δ = 0 dependences are loop-independent and enforced by
intra-iteration program order (the paper: "code executes serially on a given
processor, ... only dependence with a distance greater than zero need to be
synchronized explicitly").
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

from repro_torch.core.ir import LoopProgram, Statement, is_indirect

FLOW = "flow"
ANTI = "anti"
OUTPUT = "output"
CONTROL = "control"


@dataclasses.dataclass(frozen=True)
class Dependence:
    """A statement-level dependence with constant distance vector.

    ``nonaffine=True`` marks a *conservative proxy* for a conflict through an
    indirect subscript (``a[idx[i]]``): the true runtime distance is unknown,
    so the analyzer emits Δ=1 proxies in both directions (plus the Δ=0
    program-order case), which transitively serialize every possible runtime
    distance.  Non-affine proxies are never fed to the elimination
    algorithms (their distance is not a real constant) and are the exact set
    the inspector (:mod:`repro_torch.core.inspector`) replaces with instance-level
    edges under ``deps="inspect"``.
    """

    kind: str
    source: str
    sink: str
    array: str
    distance: Tuple[int, ...]
    nonaffine: bool = False

    # ------------------------------------------------------------------ #
    @property
    def delta(self) -> int:
        """Scalar distance for 1-D loops (the paper's Δ)."""

        if len(self.distance) != 1:
            raise ValueError("delta is only defined for 1-D loop programs")
        return self.distance[0]

    @property
    def loop_carried(self) -> bool:
        return any(d != 0 for d in self.distance)

    def lexically_backward(self, prog: LoopProgram) -> bool:
        """True iff the sink *precedes* the source in program text (§4.2 iii)."""

        return prog.lexical_index(self.sink) < prog.lexical_index(self.source)

    def pretty(self) -> str:
        d = self.distance[0] if len(self.distance) == 1 else self.distance
        sym = {FLOW: "δf", ANTI: "δa", OUTPUT: "δo", CONTROL: "δc"}[self.kind]
        if self.nonaffine:
            sym += "~"  # conservative non-affine proxy, Δ is an upper bound
        return f"{self.source} {sym}({self.array}, Δ={d}) {self.sink}"


def _lex_nonneg(vec: Tuple[int, ...]) -> bool:
    """Lexicographic ``vec >= 0``."""

    for v in vec:
        if v > 0:
            return True
        if v < 0:
            return False
    return True


def _neg(vec: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(-v for v in vec)


def _oriented(
    prog: LoopProgram,
    first: Statement,
    second: Statement,
    raw: Tuple[int, ...],
    kind_fwd: str,
    kind_bwd: str,
    array: str,
) -> Dependence | None:
    """Orient a conflicting access pair into a dependence running forward in
    sequential execution order.

    ``raw`` is (iteration of ``second``) − (iteration of ``first``) for the
    conflicting instances.  ``kind_fwd`` is the dependence kind when ``first``
    executes before ``second``; ``kind_bwd`` when the order is reversed.
    """

    zero = all(v == 0 for v in raw)
    if zero:
        a, b = prog.lexical_index(first.name), prog.lexical_index(second.name)
        if a == b:
            return None  # same-instance conflict: intra-statement, no dep
        if a < b:
            return Dependence(kind_fwd, first.name, second.name, array, raw)
        return Dependence(kind_bwd, second.name, first.name, array, raw)
    if _lex_nonneg(raw):
        return Dependence(kind_fwd, first.name, second.name, array, raw)
    return Dependence(kind_bwd, second.name, first.name, array, _neg(raw))


def _nonaffine_proxies(
    prog: LoopProgram,
    sa: Statement,
    sb: Statement,
    kind_fwd: str,
    kind_bwd: str,
    array: str,
) -> List[Dependence]:
    """Conservative proxies for a conflict whose distance is not a constant.

    Δ=1 proxies in both directions chain transitively (with the free
    intra-iteration program order) into a cover of *every* runtime distance;
    the Δ=0 case between distinct statements follows lexical order so the
    dswp model (which synchronizes Δ=0 cross-statement deps too) stays sound.
    ``kind_fwd`` is the dependence kind when ``sa``'s access happens first.
    """

    out = [
        Dependence(kind_fwd, sa.name, sb.name, array, (1,), nonaffine=True),
        Dependence(kind_bwd, sb.name, sa.name, array, (1,), nonaffine=True),
    ]
    ia, ib = prog.lexical_index(sa.name), prog.lexical_index(sb.name)
    if ia < ib:
        out.append(
            Dependence(kind_fwd, sa.name, sb.name, array, (0,), nonaffine=True)
        )
    elif ib < ia:
        out.append(
            Dependence(kind_bwd, sb.name, sa.name, array, (0,), nonaffine=True)
        )
    return out


def analyze(prog: LoopProgram) -> List[Dependence]:
    """All flow/anti/output dependences of ``prog``.

    Affine conflicting pairs get constant distances; pairs involving an
    indirect access get non-affine Δ=1/Δ=0 proxies (see
    :func:`_nonaffine_proxies`).
    """

    deps: List[Dependence] = []
    for sa in prog.statements:
        wa = sa.write.offset_tuple()
        for sb in prog.statements:
            # write(sa) vs guard-read(sb): the paper's control dependence δc
            # (whether sb executes depends on sa's outcome) — same distance
            # arithmetic as a flow dep, but tagged CONTROL; the mirrored
            # guard-read-before-write case is an ordinary anti dependence.
            if sb.guard is not None and sb.guard.array == sa.write.array:
                if is_indirect(sa.write):
                    deps.extend(
                        _nonaffine_proxies(
                            prog, sa, sb, CONTROL, ANTI, sa.write.array
                        )
                    )
                else:
                    raw = tuple(
                        w - r for w, r in zip(wa, sb.guard.offset_tuple())
                    )
                    d = _oriented(
                        prog, sa, sb, raw, CONTROL, ANTI, sa.write.array
                    )
                    if d is not None:
                        deps.append(d)
            # write(sa) vs read(sb): flow if write first, anti if read first
            for ref in sb.reads:
                if ref.array != sa.write.array:
                    continue
                if is_indirect(sa.write) or is_indirect(ref):
                    deps.extend(
                        _nonaffine_proxies(prog, sa, sb, FLOW, ANTI, ref.array)
                    )
                    continue
                raw = tuple(w - r for w, r in zip(wa, ref.offset_tuple()))
                d = _oriented(prog, sa, sb, raw, FLOW, ANTI, ref.array)
                if d is not None:
                    deps.append(d)
            # write(sa) vs write(sb): output (count each unordered pair once)
            if sb.write.array == sa.write.array:
                ia, ib = prog.lexical_index(sa.name), prog.lexical_index(sb.name)
                either_indirect = is_indirect(sa.write) or is_indirect(sb.write)
                if ia < ib:
                    if either_indirect:
                        deps.extend(
                            _nonaffine_proxies(
                                prog, sa, sb, OUTPUT, OUTPUT, sa.write.array
                            )
                        )
                    else:
                        raw = tuple(
                            w - v for w, v in zip(wa, sb.write.offset_tuple())
                        )
                        d = _oriented(
                            prog, sa, sb, raw, OUTPUT, OUTPUT, sa.write.array
                        )
                        if d is not None:
                            deps.append(d)
                elif ia == ib:
                    # same statement: impossible with a single constant-offset
                    # write — but an indirect write may revisit a cell, so it
                    # carries a self output dependence of unknown distance
                    if is_indirect(sa.write):
                        deps.append(
                            Dependence(
                                OUTPUT,
                                sa.name,
                                sa.name,
                                sa.write.array,
                                (1,),
                                nonaffine=True,
                            )
                        )
    return _dedup(deps)


def _dedup(deps: Iterable[Dependence]) -> List[Dependence]:
    seen = set()
    out: List[Dependence] = []
    for d in deps:
        key = (d.kind, d.source, d.sink, d.array, d.distance, d.nonaffine)
        if key not in seen:
            seen.add(key)
            out.append(d)
    return out


def loop_carried(deps: Iterable[Dependence]) -> List[Dependence]:
    """Only the cross-iteration dependences (Δ ≠ 0) — the ones that need
    explicit synchronization (paper §3.1)."""

    return [d for d in deps if d.loop_carried]


def paper_alg4_dependences() -> List[Dependence]:
    """The dependence graph *as stated in the paper* for Alg. 4
    (δf Δa=1; δf Δb=2; δf Δc=1).

    Note: our analyzer additionally finds ``S2 δf(b, Δ=1) S1`` (S1 reads
    b[i-1] which S2 writes) — the paper's Fig. 5 / Alg. 5 overlook it, which
    leaves Alg. 5 under-synchronized (demonstrable race; see
    tests/test_executor.py::test_paper_alg5_misses_a_dependence).  We keep
    this helper so the faithful Alg. 5 reproduction can be generated from the
    paper's own graph.
    """

    return [
        Dependence(FLOW, "S1", "S3", "a", (1,)),
        Dependence(FLOW, "S2", "S3", "b", (2,)),
        Dependence(FLOW, "S3", "S2", "c", (1,)),
    ]
