"""Loop fission / distribution (paper §3.1, Alg. 1 → Alg. 2 → Alg. 3).

After SCC condensation and topological sorting, each condensed node becomes
its own loop (Alg. 2).  The locality regrouping pass then merges adjacent-in-
topological-order nodes that are (a) independent (no path between them in the
condensation), (b) both parallel, and (c) read overlapping data — the paper's
step 5: "Group independent, unordered, nodes reading the same data and marked
as parallel into new nodes to optimize data reuse" (Alg. 3 keeps S1 and S4 in
one loop because both read ``b``).
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Sequence, Tuple

from repro_torch.core.dependence import Dependence, analyze
from repro_torch.core.graph import CondensedGraph, DepGraph, condense, topological_order
from repro_torch.core.ir import LoopProgram, Statement


@dataclasses.dataclass(frozen=True)
class FissionedLoop:
    """One loop produced by fission: an ordered statement group."""

    statements: Tuple[Statement, ...]
    parallel: bool

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.statements)


@dataclasses.dataclass(frozen=True)
class FissionResult:
    loops: Tuple[FissionedLoop, ...]
    program: LoopProgram

    def loop_names(self) -> List[Tuple[str, ...]]:
        return [l.names for l in self.loops]

    def as_program(self) -> LoopProgram:
        """Flatten back into a LoopProgram whose statement order is the
        fissioned order — used for semantic-equivalence testing (legal
        fission never changes results when loops execute in sequence)."""

        stmts: List[Statement] = []
        for loop in self.loops:
            stmts.extend(loop.statements)
        return LoopProgram(statements=tuple(stmts), bounds=self.program.bounds)


def _reachable(graph: CondensedGraph, n: int) -> FrozenSet[int]:
    adj = {}
    for a, b, _ in graph.edges:
        adj.setdefault(a, set()).add(b)
    seen = set()
    work = [n]
    while work:
        x = work.pop()
        for y in adj.get(x, ()):  # type: ignore[arg-type]
            if y not in seen:
                seen.add(y)
                work.append(y)
    return frozenset(seen)


def _reads_of(prog: LoopProgram, stmts: FrozenSet[str]) -> FrozenSet[str]:
    arrays = set()
    for name in stmts:
        for r in prog.statement(name).reads:
            arrays.add(r.array)
    return frozenset(arrays)


def fission(
    prog: LoopProgram,
    deps: Sequence[Dependence] | None = None,
    regroup: bool = True,
) -> FissionResult:
    """Distribute ``prog`` into per-node loops (Alg. 2), optionally with the
    locality regrouping of Alg. 3 (``regroup=True``)."""

    deps = list(deps) if deps is not None else analyze(prog)
    graph = DepGraph.build(prog, deps)
    cond = condense(graph)
    order = topological_order(cond, prog)

    # groups of condensed-node indices, initially singleton per node
    groups: List[List[int]] = [[k] for k in order]

    if regroup:
        reach = {k: _reachable(cond, k) for k in order}
        merged = True
        while merged:
            merged = False
            for gi in range(len(groups)):
                for gj in range(gi + 1, len(groups)):
                    a_nodes, b_nodes = groups[gi], groups[gj]
                    if not all(
                        cond.nodes[k].is_parallel for k in a_nodes + b_nodes
                    ):
                        continue
                    # independence: no path in either direction
                    if any(
                        (b in reach[a]) or (a in reach[b])
                        for a in a_nodes
                        for b in b_nodes
                    ):
                        continue
                    reads_a = frozenset().union(
                        *(_reads_of(prog, cond.nodes[k].statements) for k in a_nodes)
                    )
                    reads_b = frozenset().union(
                        *(_reads_of(prog, cond.nodes[k].statements) for k in b_nodes)
                    )
                    if not (reads_a & reads_b):
                        continue
                    # legality: merging moves group gj up to gi's position;
                    # it must not jump over an intervening group that has a
                    # dependence path into it.
                    if any(
                        b in reach[m]
                        for gm in range(gi + 1, gj)
                        for m in groups[gm]
                        for b in b_nodes
                    ):
                        continue
                    groups[gi] = a_nodes + b_nodes
                    del groups[gj]
                    merged = True
                    break
                if merged:
                    break

    loops: List[FissionedLoop] = []
    for grp in groups:
        names = sorted(
            (s for k in grp for s in cond.nodes[k].statements),
            key=prog.lexical_index,
        )
        stmts = tuple(prog.statement(n) for n in names)
        loops.append(
            FissionedLoop(
                statements=stmts,
                parallel=all(cond.nodes[k].is_parallel for k in grp),
            )
        )
    return FissionResult(loops=tuple(loops), program=prog)
