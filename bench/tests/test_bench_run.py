"""Runs of every kind at a size a test run holds, on the CPU: the harness
refuses to measure without a card; a sound run reads correct; the control
(the plain reference in the program's place, in float8) and each fault a
cell can have, planted under the timed path, read not correct."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH, tiny_cell

import harness

SEED = 2**31 + 101
CONTROL_CALLS = 40  # the control's reading at a fixed amount of work, whatever the host's speed


def _run(kind, trace=False, seconds=0.5):
    return harness.run(tiny_cell(kind), SEED, seconds, trace, torch.device("cpu"),
                       time.perf_counter())


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "yi-6b.prefill-pool", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails before it prints a result, even with a card."""

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['bench/run.py', '--workload', 'yi-6b.prefill-pool', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path('bench/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=""), timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr


@pytest.mark.parametrize("kind", ["train", "prefill_closed", "decode_pool"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_reads_correct(kind, trace):
    out = _run(kind, trace)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0
    names = {m["name"] for m in (tiny_cell(kind).per_layer if trace else tiny_cell(kind).end_to_end)}
    assert set(out["metrics"]) <= names
    if not trace:  # every end-to-end metric is read on any device
        assert set(out["metrics"]) == names
    json.dumps(out)


def _limits_broken(kind, readings):
    limits = tiny_cell(kind).limits
    return any(readings[k] > limits[k]["limit"] for k in readings)


@pytest.mark.parametrize("kind,tied", [("train", True), ("train", False), ("prefill_closed", False),
                                       ("prefill_closed", True), ("decode_pool", False)])
def test_control_reads_not_correct(kind, tied):
    import control

    drv = harness.driver_for(tiny_cell(kind, tied=tied), SEED, torch.device("cpu"))
    drv.setup()
    iters = [dict(drv.call(i), traced=False) for i in range(CONTROL_CALLS)]
    row = control.after_window(drv, iters, True)
    assert not _limits_broken(kind, row["program"]), row
    assert _limits_broken(kind, row["control"]), row


def test_state_left_unchanged_reads_not_correct(monkeypatch):
    from repro_torch.optim import optimizer

    monkeypatch.setattr(optimizer.AdamW, "update", lambda self, grads, state, params: (params, state))
    out = _run("train")
    assert not out["correct"] and out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_left_out_reads_not_correct(monkeypatch):
    from repro_torch.models import model_zoo

    loss_fn = model_zoo.loss_fn

    def half(params, batch, cfg, act=None):
        n = batch["tokens"].shape[0] // 2
        return loss_fn(params, {k: v[:n] for k, v in batch.items()}, cfg, act)

    monkeypatch.setattr(model_zoo, "loss_fn", half)
    assert not _run("train")["correct"]


def test_token_altered_in_prefill_reads_not_correct(monkeypatch):
    from repro_torch.launch import steps

    make = steps.make_prefill_step

    def altered(cfg):
        step = make(cfg)

        def prefill(params, batch, cache):
            logits, cache = step(params, batch, cache)
            best = torch.argmax(logits[0, -1, :cfg.vocab_size])
            logits = logits.clone()
            logits[0, -1, (best + 1) % cfg.vocab_size] += 1e4
            return logits, cache

        return prefill

    monkeypatch.setattr(steps, "make_prefill_step", altered)
    assert not _run("prefill_closed")["correct"]


def test_token_altered_in_decode_reads_not_correct(monkeypatch):
    from repro_torch.launch import steps

    make = steps.make_serve_step

    def altered(cfg):
        step = make(cfg)

        def serve(params, tokens, cache, cache_len):
            nxt, cache = step(params, tokens, cache, cache_len)
            return (nxt + 1) % cfg.vocab_size, cache

        return serve

    monkeypatch.setattr(steps, "make_serve_step", altered)
    assert not _run("decode_pool")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["yi-6b.prefill-pool", "granite-3-2b.prefill-pool"])
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", workload,
                          "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["metrics"]["flash_roofline"]["value"] <= 100
