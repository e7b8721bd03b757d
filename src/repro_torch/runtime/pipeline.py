"""Pipeline-parallel executor driven by the paper's optimized sync plan.

``PipelineRunner`` executes a stage-partitioned callable stack over
microbatches in the DSWP regime (paper §3.2): one worker thread per stage,
inter-stage hand-offs ONLY for the communication events that survived the
ISD transitive reduction (``core.schedule.plan_pipeline_sync``).  Events the
reduction eliminated (skip-connection fan-outs, redundant barriers,
grad-accumulation per-microbatch waits) piggyback on retained hand-offs: the
payload dict rides the chain, which is what a TPU lowering does by fusing
skip tensors into the neighbor ``ppermute`` payload.

The runner counts hand-off events so benchmarks can compare naive vs
optimized schedules on identical results — and it is validated against a
plain sequential execution of the same stages.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedule import (
    CommEvent,
    PipelineSyncPlan,
    StageGraph,
    plan_pipeline_sync,
    stage_of,
)

StageFn = Callable[[Any], Any]  # stage input -> stage output


@dataclasses.dataclass
class PipelineStats:
    handoffs: int
    microbatches: int
    stages: int

    @property
    def handoffs_per_microbatch(self) -> float:
        return self.handoffs / max(self.microbatches, 1)


class PipelineRunner:
    """Threaded DSWP execution of a stage chain with a minimal sync plan."""

    def __init__(
        self,
        stage_fns: Sequence[StageFn],
        *,
        skips: Tuple[Tuple[int, int], ...] = (),
        num_microbatches: int = 4,
    ) -> None:
        self.stage_fns = list(stage_fns)
        self.S = len(stage_fns)
        self.M = num_microbatches
        self.skips = skips
        self.plan: PipelineSyncPlan = plan_pipeline_sync(
            StageGraph(
                num_stages=self.S,
                num_microbatches=self.M,
                skips=skips,
            )
        )
        # retained forward hand-offs, grouped by source stage
        self.events_from: Dict[int, List[CommEvent]] = {}
        for e in self.plan.events:
            src, dst = stage_of(e.src_stmt), stage_of(e.dst_stmt)
            if src != dst:
                self.events_from.setdefault(src, []).append(e)

    def run(self, inputs: Sequence[Any]) -> Tuple[List[Any], PipelineStats]:
        """Process ``inputs`` (one per microbatch) through all stages."""

        assert len(inputs) == self.M
        S, M = self.S, self.M
        # one queue per retained (src→dst) channel
        channels: Dict[Tuple[int, int], "queue.Queue"] = {}
        for src, evs in self.events_from.items():
            for e in evs:
                channels[(src, stage_of(e.dst_stmt))] = queue.Queue()
        outputs: List[Any] = [None] * M
        handoffs = [0]
        lock = threading.Lock()
        errors: List[BaseException] = []

        def worker(s: int) -> None:
            try:
                for m in range(M):
                    if s == 0:
                        payload = {"x": inputs[m], "skips": {}}
                    else:
                        payload = channels[(s - 1, s)].get(timeout=30)
                    x = payload["x"]
                    skips = payload["skips"]
                    # skip-connection inputs ride the chain payload — the
                    # eliminated dependences cost no extra hand-off
                    skip_in = [skips[k] for k in sorted(skips) if k[1] == s]
                    y = self.stage_fns[s](
                        (x, *skip_in) if skip_in else x
                    )
                    new_skips = dict(skips)
                    for (src, dst) in self.skips:
                        if src == s:
                            new_skips[(src, dst)] = y
                    new_skips = {
                        k: v for k, v in new_skips.items() if k[1] > s
                    }
                    if s == S - 1:
                        outputs[m] = y
                    else:
                        channels[(s, s + 1)].put(
                            {"x": y, "skips": new_skips}
                        )
                        with lock:
                            handoffs[0] += 1
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [
            threading.Thread(target=worker, args=(s,), daemon=True)
            for s in range(S)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if errors:
            raise errors[0]
        return outputs, PipelineStats(
            handoffs=handoffs[0], microbatches=M, stages=S
        )

    def run_reference(self, inputs: Sequence[Any]) -> List[Any]:
        """Sequential oracle: stage-by-stage, microbatch-by-microbatch."""

        outs = []
        for x in inputs:
            skip_vals: Dict[Tuple[int, int], Any] = {}
            for s, fn in enumerate(self.stage_fns):
                skip_in = [
                    skip_vals[k] for k in sorted(skip_vals) if k[1] == s
                ]
                x = fn((x, *skip_in) if skip_in else x)
                for (src, dst) in self.skips:
                    if src == s:
                        skip_vals[(src, dst)] = x
            outs.append(x)
        return outs

    def naive_handoffs_per_microbatch(self) -> int:
        """What a one-sync-per-dependence schedule would cost: every chain
        edge plus every skip edge is a separate cross-stage transfer."""

        return (self.S - 1) + len(self.skips)
