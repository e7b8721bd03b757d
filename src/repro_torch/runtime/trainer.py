"""Supervised training loop: checkpoint/restart, failure recovery, straggler
accounting, deterministic data resume, as the reference's
``runtime/trainer.py``.

``train_loop`` drives (data iterator → train step → checkpoint → failure
handling) and recovers from :class:`WorkerFailure` by re-planning the mesh
(elastic shrink), restoring the newest snapshot and replaying the data
stream from its saved state.  It runs on one device, ``"cuda"`` unless the
caller passes ``device="cpu"``; failures are injected.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, Snapshot
from repro_torch.compile.lowering import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataIterator, DataState
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.optimizer import AdamW
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    StragglerDetector,
    WorkerFailure,
    plan_elastic_mesh,
)


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: List[float]
    restarts: int
    straggler_reports: List[List[str]]
    state: dict


def train_loop(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    *,
    total_steps: int,
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 10,
    opt: Optional[AdamW] = None,
    microbatches: int = 1,
    seed: int = 0,
    failure_injector: Optional[Callable[[int], None]] = None,
    grad_compressor=None,
    device="cuda",
) -> TrainResult:
    """Run (or resume) training for ``total_steps`` optimizer steps."""

    dev = resolve_device(device)
    # warmup is fixed (not scaled to total_steps) so that a resumed run with
    # a larger total_steps replays the identical LR schedule prefix
    opt = opt or AdamW(warmup_steps=10, total_steps=total_steps)
    step_fn = make_train_step(
        cfg, opt, microbatches=microbatches, grad_compressor=grad_compressor
    )

    def fresh():
        params = zoo.init(cfg, device=dev, seed=seed)
        return params, opt.init(params)

    # ---- restore or init ------------------------------------------------ #
    params, opt_state = fresh()
    start_step = 0
    data_state = DataState(seed=data_cfg.seed, step=0)
    if ckpt is not None:
        snap = ckpt.restore(target={"params": params, "opt": opt_state})
        if snap is not None:
            params, opt_state = snap.tree["params"], snap.tree["opt"]
            start_step = snap.step
            data_state = snap.data_state or data_state

    it = DataIterator(data_cfg, cfg, state=data_state)
    monitor = HeartbeatMonitor([f"w{i}" for i in range(data_cfg.num_hosts)])
    stragglers = StragglerDetector()
    losses: List[float] = []
    reports: List[List[str]] = []
    restarts = 0

    step = start_step
    while step < total_steps:
        try:
            if failure_injector is not None:
                failure_injector(step)
            t0 = time.monotonic()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            dt = time.monotonic() - t0
            for w in monitor.alive():
                monitor.heartbeat(w)
                stragglers.record(w, dt)
            step += 1
            if stragglers.stragglers():
                reports.append(stragglers.stragglers())
            if ckpt is not None and step % ckpt_every == 0:
                ckpt.save(
                    Snapshot(
                        step=step,
                        tree={"params": params, "opt": opt_state},
                        data_state=it.peek_state(),
                    )
                )
        except WorkerFailure as f:
            # ---- elastic recovery ---------------------------------------- #
            restarts += 1
            monitor.mark_failed(f.worker)
            healthy = len(monitor.alive())
            plan = plan_elastic_mesh(
                healthy * 256 // max(data_cfg.num_hosts, 1) or 256,
                global_batch=data_cfg.global_batch,
            )
            del plan  # on a real fleet: rebuild the mesh and reshard
            if ckpt is None:
                raise
            ckpt.wait()
            snap = ckpt.restore(target={"params": params, "opt": opt_state})
            if snap is None:
                # no checkpoint yet: restart from scratch
                params, opt_state = fresh()
                step = 0
                it = DataIterator(data_cfg, cfg)
            else:
                params, opt_state = snap.tree["params"], snap.tree["opt"]
                step = snap.step
                it = DataIterator(data_cfg, cfg, state=snap.data_state)

    if ckpt is not None:
        ckpt.wait()
    return TrainResult(
        final_step=step,
        losses=losses,
        restarts=restarts,
        straggler_reports=reports,
        state={"params": params, "opt": opt_state},
    )
