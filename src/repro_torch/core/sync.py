"""send/wait producer–consumer synchronization (paper §4, Alg. 4 → Alg. 5).

``send(reg, i, vars)`` writes value ``i`` to synchronization register ``reg``;
``wait(reg, i - d, vars)`` blocks until iteration ``i - d``'s send on ``reg``
has been posted.  Both carry fence semantics (all memory effects before the
send are visible to anything ordered after the matching wait).

Insertion rule (paper §4.1):
  * after the *source* statement of dependence δ:  ``send(reg_δ, i, vars)``
  * before the *sink*  statement of dependence δ:  ``wait(reg_δ, i − d_δ, vars)``

Only loop-carried dependences (Δ ≠ 0) are synchronized; Δ = 0 dependences are
enforced by intra-iteration program order.

Send-merging (paper §4.2, "allowing a single send/wait pair to synchronize
more than one dependence"): dependences sharing a source statement can share
one register and therefore one ``send`` — the waits remain per-dependence with
their own distances.  :func:`merge_sends` implements this.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.dependence import Dependence, analyze, loop_carried
from repro_torch.core.ir import LoopProgram


@dataclasses.dataclass(frozen=True)
class Send:
    reg: int
    # iteration value posted is the current loop index vector (offset 0)
    vars: Tuple[str, ...]

    def pretty(self, ivar: str = "i") -> str:
        return f"send({self.reg}, {ivar}, {','.join(self.vars)})"


@dataclasses.dataclass(frozen=True)
class Wait:
    reg: int
    distance: Tuple[int, ...]  # wait for iteration (i - distance)
    vars: Tuple[str, ...]

    def pretty(self, ivar: str = "i") -> str:
        if len(self.distance) == 1:
            d = self.distance[0]
            expr = f"{ivar}-{d}" if d else ivar
        else:
            expr = "(" + ",".join(
                f"{ivar}{k}-{d}" if d else f"{ivar}{k}"
                for k, d in enumerate(self.distance)
            ) + ")"
        return f"wait({self.reg}, {expr}, {','.join(self.vars)})"


@dataclasses.dataclass(frozen=True)
class SyncProgram:
    """A loop program with per-statement pre-waits and post-sends."""

    program: LoopProgram
    pre_waits: Dict[str, Tuple[Wait, ...]]
    post_sends: Dict[str, Tuple[Send, ...]]
    # register → the dependences it synchronizes (for reporting/elimination)
    registers: Dict[int, Tuple[Dependence, ...]]

    # ------------------------------------------------------------------ #
    def sync_instruction_count(self) -> Dict[str, int]:
        sends = sum(len(v) for v in self.post_sends.values())
        waits = sum(len(v) for v in self.pre_waits.values())
        return {"sends": sends, "waits": waits, "total": sends + waits}

    def runtime_sync_ops(self) -> int:
        """Static count × iterations: sync operations executed per full run."""

        iters = 1
        for lo, hi in self.program.bounds:
            iters *= max(0, hi - lo)
        return self.sync_instruction_count()["total"] * iters

    def pretty(self) -> str:
        lines = ["for parallel i = ...:"]
        for s in self.program.statements:
            for w in self.pre_waits.get(s.name, ()):
                lines.append(f"  {w.pretty()}")
            lines.append(f"  {s}")
            for snd in self.post_sends.get(s.name, ()):
                lines.append(f"  {snd.pretty()}")
        return "\n".join(lines)


def _register_order(prog: LoopProgram, deps: Sequence[Dependence]) -> List[Dependence]:
    """Register numbering that reproduces Alg. 5: by source statement lexical
    position, then sink lexical position, then distance."""

    return sorted(
        deps,
        key=lambda d: (
            prog.lexical_index(d.source),
            prog.lexical_index(d.sink),
            d.distance,
        ),
    )


def insert_synchronization(
    prog: LoopProgram,
    deps: Sequence[Dependence] | None = None,
    merge: bool = False,
    model: str = "doall",
) -> SyncProgram:
    """Insert send/wait pairs for every dependence that the execution model
    does not enforce for free (Alg. 5).

    ``model="doall"`` (paper §4.1): loop-carried deps only.  ``model="dswp"``
    (§3.2 pipelining): all cross-statement deps, including Δ=0.  With
    ``merge=True``, dependences with the same source statement share a
    register/send (paper §4.2 first optimization).
    """

    from repro_torch.core.elimination import synchronized_set

    if deps is None:
        deps = analyze(prog)
    carried = _register_order(prog, synchronized_set(deps, model))

    reg_of: Dict[int, int] = {}  # index into `carried` → register
    registers: Dict[int, Tuple[Dependence, ...]] = {}
    if merge:
        by_source: Dict[str, int] = {}
        for k, d in enumerate(carried):
            if d.source not in by_source:
                by_source[d.source] = len(by_source)
            reg_of[k] = by_source[d.source]
    else:
        for k in range(len(carried)):
            reg_of[k] = k
    for k, d in enumerate(carried):
        r = reg_of[k]
        registers[r] = registers.get(r, ()) + (d,)

    pre: Dict[str, List[Wait]] = {s: [] for s in prog.names}
    post: Dict[str, List[Send]] = {s: [] for s in prog.names}

    emitted_send: set[int] = set()
    for k, d in enumerate(carried):
        r = reg_of[k]
        if r not in emitted_send:
            emitted_send.add(r)
            vars_ = tuple(sorted({x.array for x in registers.get(r, (d,))})) or (
                d.array,
            )
            post[d.source].append(Send(reg=r, vars=(d.array,) if not merge else vars_))
        pre[d.sink].append(Wait(reg=r, distance=d.distance, vars=(d.array,)))

    # order waits to match the sink statement's read order (Alg. 5 shows
    # wait(1, i-2, b) before wait(0, i-1, a) for S3: b[i-2] + a[i-1])
    for name in prog.names:
        stmt = prog.statement(name)
        read_pos = {r.array: p for p, r in reversed(list(enumerate(stmt.reads)))}
        pre[name].sort(key=lambda w: read_pos.get(w.vars[0], len(stmt.reads)))

    return SyncProgram(
        program=prog,
        pre_waits={k: tuple(v) for k, v in pre.items()},
        post_sends={k: tuple(v) for k, v in post.items()},
        registers=registers,
    )


def strip_dependences(
    sync: SyncProgram, eliminated: Sequence[Dependence]
) -> SyncProgram:
    """Remove the send/wait pairs of eliminated dependences.

    A register's send survives while it still synchronizes at least one
    retained dependence; waits are removed per (register, distance, array).
    """

    gone = {
        (d.source, d.sink, d.array, d.distance, d.kind, d.nonaffine)
        for d in eliminated
    }

    def keep(d: Dependence) -> bool:
        return (
            d.source,
            d.sink,
            d.array,
            d.distance,
            d.kind,
            d.nonaffine,
        ) not in gone

    registers = {
        r: tuple(d for d in ds if keep(d)) for r, ds in sync.registers.items()
    }
    live_regs = {r for r, ds in registers.items() if ds}

    pre = {
        name: tuple(
            w
            for w in ws
            if w.reg in live_regs
            and any(
                d.sink == name and d.distance == w.distance and d.array in w.vars
                for d in registers[w.reg]
            )
        )
        for name, ws in sync.pre_waits.items()
    }
    post = {
        name: tuple(s for s in ss if s.reg in live_regs)
        for name, ss in sync.post_sends.items()
    }
    return SyncProgram(
        program=sync.program,
        pre_waits=pre,
        post_sends=post,
        registers={r: ds for r, ds in registers.items() if ds},
    )
