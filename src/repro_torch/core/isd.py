"""Iteration Space Diagram (ISD) construction and window sizing (paper §4.2).

The ISD is a graph over statement *instances* ``S_k(i)`` for iterations ``i``
in a bounded window.  Its edges are the orders that the parallel execution is
guaranteed to enforce:

  * **program order** within one iteration — code executes serially on the
    processor running that iteration (S_k(i) → S_{k+1}(i));
  * **synchronized dependences** — for each retained (synchronized) δ with
    distance Δ: source(δ)(i) → sink(δ)(i + Δ).

Window size (paper): "the number of iterations needed in the ISD for the loop
is equal to the least product of the unique prime factors of the dependence
distance, plus one."  For Alg. 6 (distances {2, 1}) that is 2 + 1 = 3 — the
dotted box of Fig. 6.  Because the enforced-order edges are shift-invariant,
covering every placement inside one window covers the whole iteration space.

All edges advance execution order monotonically (iteration vectors never
decrease, and lexical position strictly increases inside an iteration), so a
window of ``W + max|Δe|`` iterations suffices for the reachability queries.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from repro_torch.core.dependence import Dependence
from repro_torch.core.ir import LoopProgram

Instance = Tuple[str, Tuple[int, ...]]  # (statement name, iteration vector)


def prime_factors(n: int) -> Set[int]:
    n = abs(int(n))
    out: Set[int] = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.add(d)
            n //= d
        d += 1
    if n > 1:
        out.add(n)
    return out


def isd_window(distances: Iterable[int]) -> int:
    """Paper's window formula: product of unique prime factors across the
    dependence distances, plus one (distance 0/±1 contribute no primes)."""

    primes: Set[int] = set()
    max_d = 1
    for d in distances:
        primes |= prime_factors(d)
        max_d = max(max_d, abs(d))
    prod = reduce(lambda a, b: a * b, sorted(primes), 1)
    # never smaller than the longest distance + 1, so every dependence has at
    # least one full instance inside the window
    return max(prod + 1, max_d + 1)


@dataclasses.dataclass
class ISD:
    """Bounded-window instance graph with enforced-order edges."""

    program: LoopProgram
    window: Tuple[Tuple[int, int], ...]  # per-dim [lo, hi) of the window
    # adjacency: instance → list of (successor, tag); tag identifies which
    # enforced order produced the edge ("program-order" or the dependence)
    adj: Dict[Instance, List[Tuple[Instance, object]]]

    def successors(self, inst: Instance) -> List[Tuple[Instance, object]]:
        return self.adj.get(inst, [])

    def has_path(
        self, src: Instance, dst: Instance, *, forbidden_tag: object = None
    ) -> Tuple[bool, List[Instance]]:
        """BFS path search avoiding edges tagged ``forbidden_tag``.

        Returns (found, path) — the path is the witness recorded in
        benchmarks (e.g. the S1(2)→…→S3(4) chain of Fig. 6).
        """

        if src == dst:
            return True, [src]
        prev: Dict[Instance, Instance] = {}
        seen = {src}
        frontier = [src]
        while frontier:
            nxt: List[Instance] = []
            for u in frontier:
                for v, tag in self.successors(u):
                    if tag is forbidden_tag or v in seen:
                        continue
                    prev[v] = u
                    if v == dst:
                        path = [v]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return True, path[::-1]
                    seen.add(v)
                    nxt.append(v)
            frontier = nxt
        return False, []


def build_isd(
    prog: LoopProgram,
    enforced: Sequence[Dependence],
    window: Sequence[Tuple[int, int]],
    model: str = "doall",
    processors: Dict[str, object] | None = None,
) -> ISD:
    """Materialize the ISD over ``window`` with free-order + ``enforced``
    dependence edges.

    ``model`` selects which orders the machine enforces for free:

      * ``"doall"`` — each *iteration* runs on one processor (paper §2.2):
        program order within an iteration is free
        (S_k(i) → S_{k+1}(i));
      * ``"dswp"``  — each *statement* runs on one processor (decoupled
        software pipelining, paper §3.2 / Fig. 4): per-statement order across
        consecutive iterations is free (S_k(i) → S_k(i+1));
      * ``"procmap"`` — explicit statement→processor assignment via
        ``processors``: execution order on each processor (lexicographic
        (iteration, lexical position) over its statements) is free.  Used to
        model kernel pipelines where DMA issue shares the compute unit's
        instruction stream while the DMA engine is its own processor.

    Requires per-dimension non-negative distances (true for all 1-D paper
    programs after normalization and for pipeline schedules); raises
    otherwise so callers fall back to retaining the dep.
    """

    if model not in ("doall", "dswp", "procmap"):
        raise ValueError(f"unknown execution model {model!r}")
    if model == "procmap" and not processors:
        raise ValueError("procmap model requires a processors mapping")

    for d in enforced:
        if any(x < 0 for x in d.distance):
            raise ValueError(
                f"ISD transitive reduction requires per-dim non-negative "
                f"distances, got {d.pretty()}"
            )

    pts: List[Tuple[int, ...]] = [()]
    for lo, hi in window:
        pts = [p + (i,) for p in pts for i in range(lo, hi)]

    names = prog.names
    adj: Dict[Instance, List[Tuple[Instance, object]]] = {}

    def add(u: Instance, v: Instance, tag: object) -> None:
        adj.setdefault(u, []).append((v, tag))

    in_window = set(pts)
    for it in pts:
        if model == "doall":
            # program order within the iteration (one processor per iteration)
            for a, b in zip(names, names[1:]):
                add((a, it), (b, it), "program-order")
        elif model == "dswp":
            # per-statement processor order (one processor per statement);
            # successor iteration in lexicographic order within the window
            nxt = _next_point(it, window)
            if nxt is not None:
                for a in names:
                    add((a, it), (a, nxt), "processor-order")
        else:  # procmap
            pass  # handled below (needs per-processor global order)
        # enforced dependence edges
        for dep in enforced:
            dst_it = tuple(i + d for i, d in zip(it, dep.distance))
            if dst_it in in_window:
                add((dep.source, it), (dep.sink, dst_it), dep)

    if model == "procmap":
        by_proc: Dict[object, List[Instance]] = {}
        for name in names:
            by_proc.setdefault(processors[name], []).append(name)
        lex = {n: k for k, n in enumerate(names)}
        for proc, stmts in by_proc.items():
            seq = sorted(
                ((it, lex[s]) for it in pts for s in stmts),
                key=lambda t: (t[0], t[1]),
            )
            for (it_a, la), (it_b, lb) in zip(seq, seq[1:]):
                add((names[la], it_a), (names[lb], it_b), "processor-order")
    return ISD(program=prog, window=tuple(window), adj=adj)


def _next_point(
    it: Tuple[int, ...], window: Sequence[Tuple[int, int]]
) -> Tuple[int, ...] | None:
    """Lexicographic successor of ``it`` inside the rectangular window."""

    pt = list(it)
    for k in range(len(pt) - 1, -1, -1):
        lo, hi = window[k]
        if pt[k] + 1 < hi:
            pt[k] += 1
            return tuple(pt)
        pt[k] = lo
    return None
