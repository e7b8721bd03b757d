"""The port's pipeline runner and pipeline-parallel step on the CPU.

* ``repro_torch.runtime.pipeline.PipelineRunner`` (a verbatim copy of the
  reference's) — ``tests/test_runtime.py``'s ``TestPipelineRunner`` on
  torch tensors: outputs equal the sequential oracle, (S-1) hand-offs a
  microbatch with or without skips, skip edges eliminated by the plan.
* ``repro_torch.runtime.pp_lowering.build_pipeline_step`` — one rank a
  stage in spawned gloo worlds of 2 and 4 (``file://`` store in
  ``tmp_path``, every wait bounded by a timeout that kills the children):
  rank S-1's accumulator against a plain single-process run of the same
  stage arithmetic (``PipelineRunner.run_reference``; f32, the default
  ``torch.testing.assert_close`` tolerances, since the ranks run one
  thread and the parent several), ONE hand-off per microbatch step on
  every rank whatever the number of skips, and the plan's retained and
  eliminated sets equal the reference's ``plan_pipeline_sync`` for the
  same ``StageGraph``.
"""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import time
import traceback

import numpy as np
import pytest
import torch

from repro.core.schedule import StageGraph as RefStageGraph
from repro.core.schedule import plan_pipeline_sync as ref_plan_pipeline_sync

from repro_torch.obs import metrics
from repro_torch.runtime.pipeline import PipelineRunner
from repro_torch.runtime.pp_lowering import HANDOFFS, build_pipeline_step

SPAWN_TIMEOUT_S = 180
M, B, D = 6, 3, 16
# every forward pair of 4 stages: six skip edges, three fanning out of stage 0
SKIPS = {2: ((), ((0, 1),)), 4: ((), ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)))}


class TestPipelineRunner:
    def _stages(self, S):
        def mk(s):
            def fn(x):
                if isinstance(x, tuple):
                    base, *skips = x
                    return base * 2.0 + sum(skips) + s
                return x * 2.0 + s

            return fn

        return [mk(s) for s in range(S)]

    def test_matches_sequential_reference(self):
        runner = PipelineRunner(self._stages(4), num_microbatches=3)
        inputs = [torch.full((2,), float(m)) for m in range(3)]
        out, stats = runner.run(inputs)
        ref = runner.run_reference(inputs)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b)
        assert stats.handoffs == 3 * 3  # (S-1) hand-offs × M microbatches

    def test_skip_connections_ride_the_chain(self):
        skips = ((0, 2), (0, 3))
        runner = PipelineRunner(self._stages(4), skips=skips, num_microbatches=2)
        inputs = [torch.ones((2,)) * (m + 1) for m in range(2)]
        out, stats = runner.run(inputs)
        ref = runner.run_reference(inputs)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b)
        # optimized: still only (S-1) hand-offs per microbatch; naive would
        # pay one extra per skip edge
        assert stats.handoffs_per_microbatch == 3
        assert runner.naive_handoffs_per_microbatch() == 5

    def test_plan_eliminates_skips(self):
        runner = PipelineRunner(
            self._stages(5), skips=((0, 2), (1, 4)), num_microbatches=2
        )
        gone = {
            (d.source, d.sink) for d in runner.plan.elimination.eliminated
        }
        assert ("F0", "F2") in gone and ("F1", "F4") in gone


# ---------------------------------------------------------------------- #
# The pipeline step in spawned gloo worlds
# ---------------------------------------------------------------------- #

def _inputs(S):
    rng = np.random.default_rng(S)
    w = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(xs)


def _job(rank, S, w, xs):
    """Each skip set's step on this rank: its accumulator (as NumPy: a
    tensor would cross by a shared-memory handle that dies with this
    process), the hand-offs it counted, and its plan's dependence sets."""

    out = {}
    for skips in SKIPS[S]:
        before = metrics.counter(HANDOFFS).value
        step, plan = build_pipeline_step(M, D, skips, device="cpu")
        acc = step(w[rank], xs)
        out[skips] = {
            "acc": acc.numpy(),
            "handoffs": metrics.counter(HANDOFFS).value - before,
            "retained": sorted(d.pretty() for d in plan.elimination.retained),
            "eliminated": sorted(d.pretty() for d in plan.elimination.eliminated),
            "events": [(e.src_stmt, e.dst_stmt, e.distance) for e in plan.events],
        }
    return out


def _worker(rank, world, init_file, w, xs, results):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world
        )
        try:
            results.put((rank, "ok", _job(rank, world, w, xs)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def _spawn(world, tmp_path, w, xs, timeout=SPAWN_TIMEOUT_S):
    """Run ``_job`` on ``world`` spawned gloo ranks; each rank's result by
    rank.  Every wait is bounded: on the timeout the children are killed
    and the test fails, so a hung hand-off never hangs the suite."""

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = str(tmp_path / f"store_pp_{world}")
    procs = [
        ctx.Process(target=_worker, args=(r, world, init_file, w, xs, results), daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                rank, status, payload = results.get(timeout=min(remaining, 5.0))
            except queue_mod.Empty:
                if all(not p.is_alive() for p in procs) and results.empty():
                    break
                continue
            got[rank] = (status, payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: v for r, (s, v) in got.items() if s == "error"}
    assert not errors, "\n".join(f"rank {r}:\n{tb}" for r, tb in errors.items())
    assert sorted(got) == list(range(world)), (
        f"ranks {sorted(set(range(world)) - set(got))} gave no result within "
        f"{timeout} s (killed)"
    )
    return {r: payload for r, (_, payload) in got.items()}


def _plain_outputs(w, xs, skips):
    """Stage S-1's accumulator of the toy schedule, from a plain run: row m
    holds microbatch m-(S-1)'s pass through every stage, the first S-1
    rows zeros."""

    S = w.shape[0]

    def stage(s):
        def fn(x):
            if isinstance(x, tuple):
                x, *skip_in = x
                extra = torch.zeros_like(x)
                for v in skip_in:
                    extra = extra + v
                x = x + extra
            return torch.tanh(x @ w[s])

        return fn

    runner = PipelineRunner([stage(s) for s in range(S)], skips=skips, num_microbatches=1)
    want = torch.zeros_like(xs)
    for m in range(S - 1, M):
        (want[m],) = runner.run_reference([xs[m - (S - 1)]])
    return want


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_step_in_gloo_worlds(world, tmp_path):
    w, xs = _inputs(world)
    per_rank = _spawn(world, tmp_path, w, xs)
    for skips in SKIPS[world]:
        acc = torch.from_numpy(per_rank[world - 1][skips]["acc"])
        torch.testing.assert_close(acc, _plain_outputs(w, xs, skips))
        assert float(acc[world - 1:].abs().min()) > 0.0
        ref = ref_plan_pipeline_sync(
            RefStageGraph(num_stages=world, num_microbatches=M, skips=skips)
        )
        for rank in range(world):
            row = per_rank[rank][skips]
            # ONE hand-off per microbatch step, however many skips ride it
            assert row["handoffs"] == M, (rank, skips)
            assert row["retained"] == sorted(d.pretty() for d in ref.elimination.retained)
            assert row["eliminated"] == sorted(d.pretty() for d in ref.elimination.eliminated)
            assert row["events"] == [(e.src_stmt, e.dst_stmt, e.distance) for e in ref.events]
            if rank != world - 1:  # only the last stage writes its accumulator
                assert not row["acc"].any()
        if skips:  # every skip edge is eliminated: it rides the chain payload
            gone = {(d.source, d.sink) for d in ref.elimination.eliminated}
            assert {(f"F{a}", f"F{b}") for a, b in skips if b > a + 1} <= gone


def test_pipeline_step_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        build_pipeline_step(M, D, device="cpu")


def test_pipeline_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pipeline_step(M, D)
