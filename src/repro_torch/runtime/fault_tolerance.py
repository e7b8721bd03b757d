"""Fault tolerance for 1000+-node runs: failure detection, straggler
mitigation, elastic re-meshing.

Design (per-component, host-side control plane):

  * :class:`HeartbeatMonitor` — workers post heartbeats; a worker silent for
    ``timeout_s`` is declared failed.  On real pods the heartbeat transport
    is the cluster scheduler / ICI liveness; here it is injectable time for
    deterministic tests.
  * :class:`StragglerDetector` — per-worker EWMA of step durations; a worker
    slower than ``threshold`` × the fleet median is flagged.  Mitigation
    policy is pluggable: "flag" (report), "backup" (schedule a shadow
    replica — returned as an action), "exclude" (treat as failed → elastic
    shrink).
  * :func:`plan_elastic_mesh` — given the healthy chip count, the largest
    valid (data, model) mesh that preserves the model axis (TP degree is a
    property of the checkpoint) and keeps batch divisibility: data shrinks
    in powers of two; training resumes from the last checkpoint with the
    same global batch (more grad accumulation) or a proportionally smaller
    one.
  * :class:`TrainSupervisor` (see trainer.py) composes these with the
    checkpoint manager: detect → shrink → restore → continue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    step_time_ewma: Optional[float] = None
    alive: bool = True


class HeartbeatMonitor:
    def __init__(
        self,
        workers: List[str],
        *,
        timeout_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self.workers: Dict[str, WorkerState] = {
            w: WorkerState(last_heartbeat=now) for w in workers
        }

    def heartbeat(self, worker: str) -> None:
        self.workers[worker].last_heartbeat = self.clock()

    def check(self) -> List[str]:
        """Returns newly-failed workers and marks them dead."""

        now = self.clock()
        failed = []
        for name, st in self.workers.items():
            if st.alive and now - st.last_heartbeat > self.timeout_s:
                st.alive = False
                failed.append(name)
        return failed

    def alive(self) -> List[str]:
        return [w for w, st in self.workers.items() if st.alive]

    def mark_failed(self, worker: str) -> None:
        self.workers[worker].alive = False


class StragglerDetector:
    def __init__(
        self,
        *,
        alpha: float = 0.2,
        threshold: float = 1.5,
        min_samples: int = 5,
    ) -> None:
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self._ewma: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    def record(self, worker: str, step_time_s: float) -> None:
        prev = self._ewma.get(worker)
        self._ewma[worker] = (
            step_time_s
            if prev is None
            else self.alpha * step_time_s + (1 - self.alpha) * prev
        )
        self._count[worker] = self._count.get(worker, 0) + 1

    def median_ewma(self) -> Optional[float]:
        vals = sorted(self._ewma.values())
        if not vals:
            return None
        return vals[len(vals) // 2]

    def stragglers(self) -> List[str]:
        med = self.median_ewma()
        if med is None or med <= 0:
            return []
        out = []
        for w, v in self._ewma.items():
            if self._count.get(w, 0) >= self.min_samples and v > self.threshold * med:
                out.append(w)
        return out


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    chips: int
    dropped_chips: int
    note: str


def plan_elastic_mesh(
    healthy_chips: int,
    *,
    model_axis: int = 16,
    global_batch: int = 256,
) -> ElasticPlan:
    """Largest (data, model) mesh on the healthy chips.

    TP degree (``model_axis``) is preserved — resharding weights to a new TP
    degree means a different checkpoint layout; DP shrinks to the largest
    power of two whose product fits and which divides the global batch (the
    difference is absorbed by gradient accumulation)."""

    max_data = healthy_chips // model_axis
    data = 1
    while data * 2 <= max_data and global_batch % (data * 2) == 0:
        data *= 2
    if max_data < 1:
        raise RuntimeError(
            f"only {healthy_chips} healthy chips < model axis {model_axis}"
        )
    used = data * model_axis
    return ElasticPlan(
        data=data,
        model=model_axis,
        chips=used,
        dropped_chips=healthy_chips - used,
        note=(
            f"data axis {data} (was shrunk to keep ×{model_axis} TP); "
            f"global batch {global_batch} → {global_batch // data} per replica "
            f"via gradient accumulation"
        ),
    )


class WorkerFailure(RuntimeError):
    """Raised by the (simulated) device layer when a worker dies mid-step."""

    def __init__(self, worker: str):
        super().__init__(f"worker {worker} failed")
        self.worker = worker
