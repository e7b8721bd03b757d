"""The port's runtime substrate on the CPU, test for test as
``tests/test_runtime.py`` holds the reference's: data determinism,
checkpoint round-trip and crash recovery, the fault-tolerant training loop,
elastic planning, straggler detection and gradient compression.  The
pipeline executor's tests (``TestPipelineRunner``) are in
``tests/test_torch_pipeline.py``.  The numbers of steps, the data and the
optimizer are the reference tests'; ``tests/test_torch_train.py`` holds the
two packages against each other."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager, Snapshot
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, DataIterator, DataState, make_batch
from repro_torch.optim.compression import Int8Compressor, TopKCompressor
from repro_torch.optim.optimizer import AdamW
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    StragglerDetector,
    WorkerFailure,
    plan_elastic_mesh,
)
from repro_torch.runtime.trainer import train_loop

CFG = get_smoke_config("yi_6b")
DC = DataConfig(global_batch=4, seq_len=16, seed=3)
# convergence-check optimizer: warmup/LR sized to a ~10-step smoke run
SMOKE_OPT = AdamW(learning_rate=1e-2, warmup_steps=2, total_steps=12)
CPU = "cpu"


class TestDataPipeline:
    def test_deterministic(self):
        b1 = make_batch(DC, CFG, DataState(seed=3, step=5))
        b2 = make_batch(DC, CFG, DataState(seed=3, step=5))
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_steps_differ(self):
        b1 = make_batch(DC, CFG, DataState(seed=3, step=5))
        b2 = make_batch(DC, CFG, DataState(seed=3, step=6))
        assert not np.array_equal(b1["tokens"], b2["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = make_batch(DC, CFG, DataState(seed=3, step=0))
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding_partitions_global_batch(self):
        full = make_batch(
            dataclasses.replace(DC, num_hosts=1, host_id=0),
            CFG,
            DataState(seed=3, step=2),
        )
        parts = [
            make_batch(
                dataclasses.replace(DC, num_hosts=2, host_id=h),
                CFG,
                DataState(seed=3, step=2),
            )
            for h in range(2)
        ]
        np.testing.assert_array_equal(
            np.concatenate([p["tokens"] for p in parts]), full["tokens"]
        )

    def test_iterator_resume(self):
        it = DataIterator(DC, CFG)
        seq1 = [next(it)["tokens"] for _ in range(5)]
        state3 = DataState(seed=3, step=3)
        it2 = DataIterator(DC, CFG, state=state3)
        np.testing.assert_array_equal(next(it2)["tokens"], seq1[3])

    def test_tokens_in_vocab(self):
        b = make_batch(DC, CFG, DataState(seed=3, step=9))
        assert b["tokens"].min() >= 0
        assert b["tokens"].max() < CFG.vocab_size


class TestCheckpointManager:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_writes=False)
        tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
        mgr.save(Snapshot(step=7, tree=tree, data_state=DataState(1, 9)))
        snap = mgr.restore()
        assert snap.step == 7
        assert torch.equal(snap.tree["a"], tree["a"])
        assert torch.equal(snap.tree["b"]["c"], tree["b"]["c"])
        assert snap.data_state == DataState(1, 9)

    def test_async_write_and_wait(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_writes=True)
        mgr.save(Snapshot(step=1, tree={"x": torch.ones(3)}))
        mgr.wait()
        assert mgr.committed_steps() == [1]
        mgr.close()

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, async_writes=False)
        for s in (1, 2, 3, 4):
            mgr.save(Snapshot(step=s, tree={"x": torch.ones(2) * s}))
        assert mgr.committed_steps() == [3, 4]

    def test_crash_mid_write_ignored(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_writes=False)
        mgr.save(Snapshot(step=1, tree={"x": torch.ones(2)}))
        # simulate a crash: stale tmp dir + missing manifest
        (tmp_path / "step_000000002.tmp").mkdir()
        (tmp_path / "step_000000003").mkdir()
        assert mgr.restore().step == 1
        # a new manager garbage-collects the tmp
        CheckpointManager(tmp_path, async_writes=False)
        assert not (tmp_path / "step_000000002.tmp").exists()

    def test_namedtuple_restore_with_target(self, tmp_path):
        opt = AdamW()
        params = {"w": torch.ones((2, 2))}
        state = opt.init(params)
        mgr = CheckpointManager(tmp_path, async_writes=False)
        mgr.save(Snapshot(step=5, tree={"params": params, "opt": state}))
        snap = mgr.restore(target={"params": params, "opt": state})
        assert type(snap.tree["opt"]) is type(state)
        assert snap.tree["opt"].step.shape == ()
        assert snap.tree["opt"].step.dtype == torch.int32
        assert torch.equal(snap.tree["params"]["w"], params["w"])

    def test_bf16_roundtrip_is_bit_equal(self, tmp_path):
        """bf16 crosses as its 16-bit pattern: every value comes back bit
        for bit, NaN, infinities, -0.0 and subnormals included."""

        gen = torch.Generator().manual_seed(0)
        x = torch.randn(1000, generator=gen).to(torch.bfloat16)
        special = torch.tensor(
            [float("nan"), float("inf"), -float("inf"), -0.0, 1e-40, -3e38]
        ).to(torch.bfloat16)
        tree = {"p": torch.cat([x, special]), "blocks": [{"s": x[:7]}, {"s": x[7:9]}]}
        mgr = CheckpointManager(tmp_path, async_writes=False)
        mgr.save(Snapshot(step=2, tree=tree))
        for target in (None, tree):
            out = mgr.restore(target=target).tree
            for a, b in ((out["p"], tree["p"]), (out["blocks"][1]["s"], tree["blocks"][1]["s"])):
                assert b.dtype == torch.bfloat16 and a.dtype == torch.bfloat16
                assert torch.equal(a.view(torch.int16), b.view(torch.int16))


class TestFaultTolerance:
    def test_heartbeat_timeout(self):
        t = [0.0]
        mon = HeartbeatMonitor(["w0", "w1"], timeout_s=5, clock=lambda: t[0])
        t[0] = 3.0
        mon.heartbeat("w0")
        t[0] = 7.0
        assert mon.check() == ["w1"]
        assert mon.alive() == ["w0"]

    def test_straggler_detection(self):
        det = StragglerDetector(min_samples=3)
        for _ in range(6):
            for w in ("a", "b", "c"):
                det.record(w, 1.0)
            det.record("slow", 2.5)
        assert det.stragglers() == ["slow"]

    def test_elastic_plan_shrinks_data_axis(self):
        plan = plan_elastic_mesh(240, model_axis=16, global_batch=256)
        assert plan.model == 16
        assert plan.data == 8  # 240//16 = 15 healthy → 8 is largest pow2
        assert plan.chips == 128

    def test_elastic_plan_raises_below_tp(self):
        with pytest.raises(RuntimeError):
            plan_elastic_mesh(8, model_axis=16)


class TestTrainLoop:
    def test_loss_decreases(self):
        res = train_loop(CFG, DC, total_steps=12, opt=SMOKE_OPT, device=CPU)
        assert res.final_step == 12
        assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])

    def test_microbatched_matches_steps(self):
        res = train_loop(CFG, DC, total_steps=4, microbatches=2, device=CPU)
        assert res.final_step == 4
        assert all(np.isfinite(l) for l in res.losses)

    def test_checkpoint_resume_is_exact(self, tmp_path):
        """12 straight steps == 8 steps + restart + 4 steps, on the loss
        trace after the restore point (the reference test's limits)."""

        mgr1 = CheckpointManager(tmp_path / "a", async_writes=False, keep=10)
        full = train_loop(CFG, DC, total_steps=12, ckpt=mgr1, ckpt_every=4, device=CPU)

        mgr2 = CheckpointManager(tmp_path / "b", async_writes=False, keep=10)
        train_loop(CFG, DC, total_steps=8, ckpt=mgr2, ckpt_every=4, device=CPU)
        part2 = train_loop(CFG, DC, total_steps=12, ckpt=mgr2, ckpt_every=4, device=CPU)
        assert part2.final_step == 12
        np.testing.assert_allclose(
            full.losses[8:], part2.losses, rtol=1e-6, atol=1e-6
        )

    def test_failure_recovery(self, tmp_path):
        """A worker failure at step 6 rolls back to the step-4 checkpoint and
        the run still completes all 10 steps."""

        mgr = CheckpointManager(tmp_path, async_writes=False, keep=10)
        fired = []

        def injector(step):
            if step == 6 and not fired:
                fired.append(True)
                raise WorkerFailure("w0")

        res = train_loop(
            CFG,
            DC,
            total_steps=10,
            ckpt=mgr,
            ckpt_every=4,
            failure_injector=injector,
            device=CPU,
        )
        assert res.restarts == 1
        assert res.final_step == 10
        # 6 steps, the failure, then steps 5..10 replayed from the snapshot
        assert len(res.losses) == 6 + 6

    def test_failure_before_any_checkpoint_restarts_from_scratch(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_writes=False, keep=10)
        fired = []

        def injector(step):
            if step == 2 and not fired:
                fired.append(True)
                raise WorkerFailure("w0")

        res = train_loop(
            CFG, DC, total_steps=4, ckpt=mgr, ckpt_every=10,
            failure_injector=injector, device=CPU,
        )
        assert res.restarts == 1 and res.final_step == 4
        # the restart replays steps 1..2 exactly
        np.testing.assert_array_equal(res.losses[:2], res.losses[2:4])


class TestCompression:
    def test_int8_roundtrip_accuracy(self):
        comp = Int8Compressor()
        g = {"w": torch.tensor([[0.5, -1.0], [2.0, 0.01]])}
        res = comp.init(g)
        out, res = comp.apply(g, res)
        np.testing.assert_allclose(out["w"], g["w"], atol=2.0 / 127)

    def test_error_feedback_accumulates(self):
        """Summed compressed grads converge to summed true grads (EF)."""

        comp = Int8Compressor()
        g = {"w": torch.full((4,), 0.003)}
        res = comp.init(g)
        total = torch.zeros(4)
        for _ in range(50):
            out, res = comp.apply(g, res)
            total = total + out["w"]
        np.testing.assert_allclose(total, 50 * g["w"], rtol=0.05)

    def test_int8_bytes_are_4x_smaller(self):
        g = {"w": torch.ones((128, 64))}
        assert Int8Compressor.raw_bytes(g) == 4 * Int8Compressor.compressed_bytes(g)

    def test_topk_keeps_largest(self):
        comp = TopKCompressor(fraction=0.25)
        g = {"w": torch.tensor([10.0, 0.1, -20.0, 0.2, 0.3, 1.0, 0.0, 0.05])}
        out, res = comp.apply(g, comp.init(g))
        kept = np.nonzero(out["w"].numpy())[0]
        assert set(kept) == {0, 2}
        # residual carries everything dropped
        np.testing.assert_allclose(out["w"] + res["w"], g["w"], atol=1e-6)

    def test_train_with_compression_converges(self):
        comp = Int8Compressor()
        state = {"res": None}

        def hook(grads, opt_state):
            if state["res"] is None:
                state["res"] = comp.init(grads)
            out, state["res"] = comp.apply(grads, state["res"])
            return out, opt_state

        res = train_loop(
            CFG, DC, total_steps=10, grad_compressor=hook, opt=SMOKE_OPT, device=CPU
        )
        assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])


class TestEntryPoints:
    def test_train_loop_defaults_to_cuda(self):
        """No CPU fallback: without a card the default device raises."""

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_loop(CFG, DC, total_steps=1)

    def test_train_step_refuses_the_spmd_knobs(self):
        from repro_torch.launch.steps import make_train_step

        for kw in ({"mesh": object()}, {"seq_shard": True}, {"grad_shardings": {}}):
            with pytest.raises(NotImplementedError, match="item 13"):
                make_train_step(CFG, SMOKE_OPT, **kw)
