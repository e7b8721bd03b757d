"""Multi-threaded shared-memory reference executor for SyncPrograms.

This is the paper's target machine in miniature: every loop iteration runs on
its own thread of a shared-memory multiprocessor (§2.2, Fig. 2), statements
within an iteration run in program order, and cross-iteration dependences are
enforced *only* by the send/wait instructions (§4.1) — exactly the guarantees
the ISD's edges model.  It serves three purposes:

  * **semantic validation** — results must equal :func:`repro_torch.core.ir.run_sequential`
    for any correctly synchronized program (used by the hypothesis property
    tests over random loop programs);
  * **race demonstration** — with adversarial per-instance stalls, an
    under-synchronized program (e.g. the paper's own Alg. 5, which misses the
    S2 δf(b,Δ=1) S1 dependence) deterministically produces wrong values;
  * **sync accounting** — counts send/wait events executed and how many waits
    actually blocked, the paper's implied cost metric.

Registers implement the paper's semantics: ``send(reg, i)`` posts value ``i``;
``wait(reg, v)`` blocks until value ``v`` has been posted (a wait for an
iteration below the loop's lower bound is trivially satisfied, matching
"dusty deck" arrays initialized before the loop).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.ir import LoopProgram, ref_cell, run_sequential
from repro_torch.core.sync import SyncProgram


class SyncRegisterFile:
    """Monotone posted-value registers with condition-variable waits."""

    def __init__(self) -> None:
        self._posted: Dict[int, set] = {}
        self._cv = threading.Condition()
        self.sends = 0
        self.waits = 0
        self.blocked_waits = 0

    def send(self, reg: int, value: Tuple[int, ...]) -> None:
        with self._cv:
            self._posted.setdefault(reg, set()).add(value)
            self.sends += 1
            self._cv.notify_all()

    def wait(
        self,
        reg: int,
        value: Tuple[int, ...],
        trivially_satisfied: bool,
        timeout: float,
    ) -> None:
        with self._cv:
            self.waits += 1
            if trivially_satisfied:
                return
            if value not in self._posted.get(reg, ()):  # will block
                self.blocked_waits += 1
                deadline = time.monotonic() + timeout
                while value not in self._posted.get(reg, ()):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"wait(reg={reg}, {value}) timed out — "
                            f"program is under-synchronized or deadlocked"
                        )
                    self._cv.wait(remaining)


@dataclasses.dataclass
class ExecutionStats:
    sends: int
    waits: int
    blocked_waits: int
    threads: int


@dataclasses.dataclass
class ExecutionReport:
    store: dict
    stats: ExecutionStats
    matches_sequential: bool


def run_threaded(
    sync: SyncProgram,
    *,
    stalls: Optional[Mapping[Tuple[str, Tuple[int, ...]], float]] = None,
    timeout: float = 10.0,
    store: Optional[Mapping[str, dict]] = None,
    compare: bool = True,
    model: str = "doall",
) -> ExecutionReport:
    """Run ``sync.program`` on real threads under the chosen execution model.

    ``model="doall"``: one thread per *iteration* (paper §2.2, Fig. 2 — each
    thread executes a subset of the iteration space).  ``model="dswp"``: one
    thread per *statement* (paper §3.2, Fig. 4 — pipelined SCC execution);
    each statement-thread walks all iterations in order.

    ``stalls`` maps (statement name, iteration vector) → seconds of injected
    delay *before* that statement instance executes — the adversarial
    scheduler used to expose missing synchronization deterministically.
    """

    prog = sync.program
    init = {a: dict(c) for a, c in (store or prog.initial_store()).items()}
    mem = {a: dict(c) for a, c in init.items()}
    regs = SyncRegisterFile()
    stalls = dict(stalls or {})
    errors: list[BaseException] = []

    def in_space(it: Tuple[int, ...]) -> bool:
        return all(lo <= x < hi for x, (lo, hi) in zip(it, prog.bounds))

    def exec_instance(s, it: Tuple[int, ...]) -> None:
        if (s.name, it) in stalls:
            time.sleep(stalls[(s.name, it)])
        for w in sync.pre_waits.get(s.name, ()):
            target = tuple(x - d for x, d in zip(it, w.distance))
            regs.wait(
                w.reg,
                target,
                trivially_satisfied=not in_space(target),
                timeout=timeout,
            )
        if s.guard is not None:
            gidx = tuple(x + o for x, o in zip(it, s.guard.offset_tuple()))
            if not mem[s.guard.array][gidx] > 0:
                # a skipped instance must STILL post its sends — the paper's
                # send carries fence semantics, and consumers wait on the
                # iteration regardless of the branch outcome
                for snd in sync.post_sends.get(s.name, ()):
                    regs.send(snd.reg, it)
                return
        reads = [mem[r.array][ref_cell(r, it, mem)] for r in s.reads]
        mem[s.write.array][ref_cell(s.write, it, mem)] = s.compute(*reads)
        for snd in sync.post_sends.get(s.name, ()):
            regs.send(snd.reg, it)

    def iteration_body(it: Tuple[int, ...]) -> None:
        try:
            for s in prog.statements:
                exec_instance(s, it)
        except BaseException as e:  # noqa: BLE001 - surfaced to caller
            errors.append(e)

    def statement_body(s) -> None:
        try:
            for it in prog.iterations():
                exec_instance(s, it)
        except BaseException as e:  # noqa: BLE001 - surfaced to caller
            errors.append(e)

    if model == "doall":
        threads = [
            threading.Thread(target=iteration_body, args=(it,), daemon=True)
            for it in prog.iterations()
        ]
    elif model == "dswp":
        threads = [
            threading.Thread(target=statement_body, args=(s,), daemon=True)
            for s in prog.statements
        ]
    else:
        raise ValueError(f"unknown execution model {model!r}")
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout * 2
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            errors.append(TimeoutError("iteration thread did not finish"))
    if errors:
        raise errors[0]

    matches = True
    if compare:
        expect = run_sequential(prog, init)
        matches = expect == mem

    return ExecutionReport(
        store=mem,
        stats=ExecutionStats(
            sends=regs.sends,
            waits=regs.waits,
            blocked_waits=regs.blocked_waits,
            threads=len(threads),
        ),
        matches_sequential=matches,
    )


def run_loops_sequence(
    loops, prog: LoopProgram, store: Optional[Mapping[str, dict]] = None
) -> dict:
    """Execute a fissioned loop sequence (each loop fully, in order), with
    each *parallel* loop's iterations run in an adversarial (reversed)
    order — legal iff the loop truly has no loop-carried dependence."""

    mem = {a: dict(c) for a, c in (store or prog.initial_store()).items()}
    for loop in loops:
        order = list(prog.iterations())
        if getattr(loop, "parallel", False):
            order = order[::-1]
        for it in order:
            for s in loop.statements:
                reads = [mem[r.array][ref_cell(r, it, mem)] for r in s.reads]
                mem[s.write.array][ref_cell(s.write, it, mem)] = s.compute(
                    *reads
                )
    return mem
