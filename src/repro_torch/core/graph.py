"""Dependence-graph algorithms: Tarjan SCC, contraction, topological sort,
and the pipeline partitioning of §3.2 (decoupled software pipelining).

The paper's §3 recipe (after Midkiff [17]):
  1. build the dependence graph for the loop nest;
  2. find strongly connected components, contract each SCC into one node;
  3. mark single-statement nodes as parallel;
  4. topologically sort so all inter-node dependences are lexically forward;
  5. group independent, unordered nodes reading the same data (locality);
  6. loop fission: one loop per node (see :mod:`repro_torch.core.fission`);
  7. mark loops from parallel nodes as parallel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple

from repro_torch.core.dependence import Dependence
from repro_torch.core.ir import LoopProgram


@dataclasses.dataclass(frozen=True)
class DepGraph:
    """Statement-level dependence graph."""

    nodes: Tuple[str, ...]
    edges: Tuple[Dependence, ...]

    @staticmethod
    def build(prog: LoopProgram, deps: Sequence[Dependence]) -> "DepGraph":
        return DepGraph(nodes=prog.names, edges=tuple(deps))

    def successors(self, node: str) -> List[Tuple[str, Dependence]]:
        return [(e.sink, e) for e in self.edges if e.source == node]

    def adjacency(self) -> Dict[str, List[str]]:
        adj: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for e in self.edges:
            if e.sink not in adj[e.source]:
                adj[e.source].append(e.sink)
        return adj


def tarjan_scc(nodes: Sequence[str], adj: Dict[str, List[str]]) -> List[FrozenSet[str]]:
    """Tarjan's algorithm, iterative (no recursion-limit surprises).

    Returns SCCs in *reverse topological order* of the condensation (Tarjan's
    natural emission order).
    """

    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    sccs: List[FrozenSet[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, ei = work.pop()
            if ei == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            recurse = False
            succs = adj.get(node, [])
            for k in range(ei, len(succs)):
                nxt = succs[k]
                if nxt not in index:
                    work.append((node, k + 1))
                    work.append((nxt, 0))
                    recurse = True
                    break
                if on_stack.get(nxt, False):
                    low[node] = min(low[node], index[nxt])
            if recurse:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(frozenset(comp))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs


@dataclasses.dataclass(frozen=True)
class CondensedNode:
    """A node of the SCC-contracted graph (paper step 2)."""

    statements: FrozenSet[str]

    @property
    def is_parallel(self) -> bool:
        """Paper step 3: single-statement nodes are parallel ... unless the
        statement carries a self-dependence (a genuine 1-cycle)."""

        return len(self.statements) == 1 and not self._self_cycle

    _self_cycle: bool = False

    def label(self) -> str:
        return "+".join(sorted(self.statements))


@dataclasses.dataclass(frozen=True)
class CondensedGraph:
    nodes: Tuple[CondensedNode, ...]
    # edges between condensed nodes, carrying the original dependences
    edges: Tuple[Tuple[int, int, Dependence], ...]

    def node_of(self, stmt: str) -> int:
        for k, n in enumerate(self.nodes):
            if stmt in n.statements:
                return k
        raise KeyError(stmt)


def condense(graph: DepGraph) -> CondensedGraph:
    """Contract SCCs into single nodes (paper steps 2–3)."""

    sccs = tarjan_scc(list(graph.nodes), graph.adjacency())
    self_cycles = {e.source for e in graph.edges if e.source == e.sink}
    nodes = tuple(
        CondensedNode(
            statements=s,
            _self_cycle=(len(s) == 1 and next(iter(s)) in self_cycles),
        )
        for s in sccs
    )
    where: Dict[str, int] = {}
    for k, n in enumerate(nodes):
        for stmt in n.statements:
            where[stmt] = k
    edges = tuple(
        (where[e.source], where[e.sink], e)
        for e in graph.edges
        if where[e.source] != where[e.sink]
    )
    return CondensedGraph(nodes=nodes, edges=edges)


def topological_order(graph: CondensedGraph, prog: LoopProgram) -> List[int]:
    """Kahn topological sort of the condensation.

    Ties are broken by the *lexical* position of the earliest statement in
    the node, which reproduces the paper's Alg. 2 ordering (S2, S1, S4, S3)
    deterministically.
    """

    n = len(graph.nodes)
    indeg = [0] * n
    adj: Dict[int, List[int]] = {k: [] for k in range(n)}
    seen = set()
    for a, b, _ in graph.edges:
        if (a, b) in seen:
            continue
        seen.add((a, b))
        adj[a].append(b)
        indeg[b] += 1

    def lex_key(k: int) -> int:
        return min(prog.lexical_index(s) for s in graph.nodes[k].statements)

    ready = sorted([k for k in range(n) if indeg[k] == 0], key=lex_key)
    order: List[int] = []
    while ready:
        k = ready.pop(0)
        order.append(k)
        for nxt in adj[k]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                ready.append(nxt)
        ready.sort(key=lex_key)
    if len(order) != n:
        raise RuntimeError("condensed dependence graph is not acyclic")
    return order


def pipeline_stages(
    graph: CondensedGraph, prog: LoopProgram, num_threads: int
) -> List[List[int]]:
    """Decoupled-software-pipelining stage assignment (paper §3.2, Fig. 4).

    Contracted nodes, in topological order, are assigned to ``num_threads``
    pipeline stages balancing statement count — SCCs execute sequentially
    within a stage while different iterations overlap across stages.
    """

    order = topological_order(graph, prog)
    total = sum(len(graph.nodes[k].statements) for k in order)
    per = max(1, -(-total // num_threads))  # ceil
    stages: List[List[int]] = [[]]
    count = 0
    for k in order:
        w = len(graph.nodes[k].statements)
        if count + w > per and stages[-1] and len(stages) < num_threads:
            stages.append([])
            count = 0
        stages[-1].append(k)
        count += w
    return stages
