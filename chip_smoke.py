#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, runs and agrees with its
oracles on the card.

    python3 chip_smoke.py

Phases, one printed line (or block) each; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every CUDA source of the port with ``nvcc`` for ``sm_90a``;
3. the synchronization compiler's main path, ``plan → compile("torch",
   device="cuda") → run``, on the program corpus under every elimination
   method (``deps="inspect"``/``"speculate"`` for the non-affine ones) and
   at the benchmark sizes — Alg. 6 at 1025, the 64×16 chunked recurrence,
   the 96×192 skew that runs the width ladder — every store bit-equal to
   ``run_sequential``, with levels and warm ms per run; then each
   division-family operator with a Python-number operand (``**``, a known
   divergence, is reported rather than checked);
4. the pipelined matmul's K-loop plan at ring depths 1 and 2, and the
   K-loop compiled on the card (bit-equal, structural hit across ``steps``);
5. the pipelined matmul kernel at yi-6b's full widths (d_model 4096, d_ff
   11008) as a 2048-token prefill, plus an unaligned shape, in bf16 and f32
   at depths 1 and 2: launch counts from the main run, the error against
   the plain PyTorch version, the kernel's time beside its bound, the plain
   version's and ``torch.matmul``'s;
6. one JSON line listing every kernel with its numbers;
7. ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # f32: CUDA cores, no TF32
TOL = {"bf16": 3e-2, "f32": 2e-5}  # tests/test_kernels.py; atol x sqrt(K)

KERNEL_SOURCE = "src/repro_torch/kernels/pipelined_matmul/csrc/pipelined_matmul.cu"
TPU_KERNEL = "src/repro/kernels/pipelined_matmul/kernel.py:24"

# yi-6b (src/repro/configs/yi_6b.py): d_model 4096, d_ff 11008; a
# 2048-token prefill through the MLP's up and down projections
MATMUL_SHAPES = [(2048, 4096, 11008), (2048, 11008, 4096), (300, 257, 130)]
MATMUL_DEPTHS = (1, 2)
SEED = 0
WARM_RUNS = 11


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(line: str) -> None:
    print(line, flush=True)


# ---------------------------------------------------------------------- #
# Phase 3 corpus, from the port's own classes
# ---------------------------------------------------------------------- #

def corpus():
    from repro_torch.core import (
        ArrayRef,
        LoopProgram,
        Statement,
        gather_scatter,
        paper_alg1,
        paper_alg4,
        paper_alg6,
        sparse_matvec,
    )

    def skew_recurrence(ni=5, nj=5):
        return LoopProgram(
            statements=(
                Statement("S1", ArrayRef("a", (0, 0)), (ArrayRef("a", (-1, 1)),)),
            ),
            bounds=((0, ni), (0, nj)),
        )

    mixed_cycle_pm1 = LoopProgram(
        statements=(
            Statement("S1", ArrayRef("a", (0, 0)), (ArrayRef("b", (-1, 1)),)),
            Statement("S2", ArrayRef("b", (0, 0)), (ArrayRef("a", (0, -1)),)),
        ),
        bounds=((0, 4), (0, 4)),
    )
    guarded = LoopProgram(
        statements=(
            Statement("S1", ArrayRef("p", 0), (ArrayRef("p", -1),)),
            Statement(
                "S2", ArrayRef("a", 0), (ArrayRef("a", -1),),
                guard=ArrayRef("p", -1),
            ),
        ),
        bounds=((1, 7),),
    )
    wide = LoopProgram(  # {(0,1),(1,-1)}: benchmarks/run.py's wide recurrence
        statements=(
            Statement(
                "S1",
                ArrayRef("a", (0, 0)),
                (ArrayRef("a", (0, -1)), ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, 96), (0, 192)),
    )
    small = [
        ("alg1", paper_alg1(8), (None,)),
        ("alg4", paper_alg4(8), (None,)),
        ("alg6", paper_alg6(8), (None,)),
        ("skew_recurrence", skew_recurrence(), (None,)),
        ("mixed_cycle_pm1", mixed_cycle_pm1, (None,)),
        ("guarded", guarded, (None,)),
        ("gather_scatter", gather_scatter(8), ("inspect", "speculate")),
        ("sparse_matvec", sparse_matvec(8), ("inspect", "speculate")),
    ]
    sized = [
        ("paper_alg6_1025", paper_alg6(1025), {}),
        ("skew_recurrence_64x16_chunk", skew_recurrence(64, 16), {"scc_policy": "chunk"}),
        ("wide_skew_96x192_skew", wide, {"scc_policy": "skew"}),
    ]
    return small, sized


def _profiled_run(torch, fn):
    """Device busy time (the summed durations of the device events: kernels
    and copies, on one stream) and wall time of one call under
    ``torch.profiler``, in ms; busy is None when the trace holds no device
    time."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(
        e.device_time_total
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return (busy_us / 1e3 if busy_us > 0 else None), wall_ms


def level_loop_phase(torch):
    from repro_torch.core import get_backend, plan, run_sequential

    small, sized = corpus()
    runs = 0
    for name, prog, modes in small:
        init = prog.initial_store()
        expect = run_sequential(prog, init)
        for deps in modes:
            for method in ("none", "isd", "pattern", "both"):
                p = plan(prog, method=method, deps=deps)
                out = p.compile("torch", device="cuda").run(store=init)
                naive = get_backend("torch").differential(
                    p.naive_sync, store=init, device="cuda"
                )
                label = f"{name}/{method}/deps={deps}"
                check(out == expect, f"level loop: {label} optimized diverged")
                check(naive == expect, f"level loop: {label} naive diverged")
                runs += 2
    emit(f"level loop corpus: {runs} runs on cuda, all bit-equal to run_sequential")

    for name, prog, knobs in sized:
        init = prog.initial_store()
        expect = run_sequential(prog, init)
        exe = plan(prog, method="isd").compile("torch", device="cuda", **knobs)
        t0 = time.perf_counter()
        out = exe.run(store=init)
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(out == expect, f"level loop: {name} diverged from run_sequential")
        case = next(reversed(exe.compiled._cases.values()))  # this run's
        host, device = [], []
        for _ in range(WARM_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = exe.run(store=init)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            device.append(start.elapsed_time(end))
        check(out == expect, f"level loop: {name} warm run diverged")
        busy_ms, wall_ms = _profiled_run(torch, lambda: exe.run(store=init))
        row = {
            "name": name,
            "levels": case.n_levels,
            "group_steps": len(case._steps),
            "segments": [s[0] for s in case.static.segments or ()],
            "cold_ms": cold_ms,
            "warm_runs": WARM_RUNS,
            "warm_ms_median_events": statistics.median(device),
            "warm_ms_median_host": statistics.median(host),
            "warm_ms_min_host": min(host),
            "warm_ms_max_host": max(host),
            "profiled_wall_ms": wall_ms,
            "profiled_device_busy_ms": busy_ms,
            "device_idle_share": (
                1.0 - busy_ms / wall_ms if busy_ms is not None else None
            ),
            "bit_equal": True,
        }
        emit("level loop: " + json.dumps(row))


def operator_phase():
    """Each division-family operator with a Python-number operand, on 4096
    lanes of one statement: the division ops must be bit-equal to
    ``run_sequential`` on the card; ``**`` is a known divergence (ROADMAP
    Queue 3), so its count of differing cells is reported, not checked."""

    from repro_torch.core import ArrayRef, LoopProgram, Statement, plan, run_sequential

    ops = {
        "x/7": (lambda x: x / 7, True),
        "7/x": (lambda x: 7.0 / (x + 100.0), True),
        "x//3": (lambda x: x // 3, True),
        "x%3": (lambda x: x % 3, True),
        "x**2": (lambda x: x ** 2, False),
        "x**0.5": (lambda x: abs(x) ** 0.5, False),
        "1.3**x": (lambda x: 1.3 ** x, False),
    }
    report = {}
    for name, (fn, exact) in ops.items():
        prog = LoopProgram(
            statements=(
                Statement("S1", ArrayRef("a", 0), (ArrayRef("b", 0),), compute=fn),
            ),
            bounds=((0, 4096),),
        )
        init = prog.initial_store()
        init["b"] = {
            cell: (i * 0.7137) % 11.3 - 5.1
            for i, cell in enumerate(sorted(init["b"]))
        }
        expect = run_sequential(prog, init)["a"]
        out = plan(prog).compile("torch", device="cuda").run(store=init)["a"]
        differ = sum(1 for cell, v in expect.items() if out[cell] != v)
        check(not exact or differ == 0, f"operator {name}: {differ} cells differ on cuda")
        report[name] = differ
    emit(
        "operators on cuda, cells differing from run_sequential of "
        f"{len(expect)} (division ops checked, ** reported): {json.dumps(report)}"
    )


# ---------------------------------------------------------------------- #
# Phase 4: the K-loop plan
# ---------------------------------------------------------------------- #

def kloop_phase():
    from repro_torch.core import PlanOptions, plan, run_sequential
    from repro_torch.kernels.pipelined_matmul import schedule
    from repro_torch.kernels.pipelined_matmul.ops import kernel_schedule

    for depth in (1, 2):
        p = schedule.plan_pipeline(depth)
        ks = kernel_schedule(depth)
        emit(
            "kloop plan: "
            + json.dumps(
                {
                    "depth": depth,
                    "retained": [d.pretty() for d in p.retained],
                    "waits_per_step": p.waits_per_step,
                    "credit_wait_needed": p.credit_wait_needed,
                    "overlapped_levels": schedule.overlapped_levels(p.wavefront),
                    "kernel_waits": list(ks.waits),
                    "kernel_barriers_per_step": ks.barriers_per_step,
                }
            )
        )
        first, _ = schedule.compile_kloop(depth, 16, device="cuda")
        again, hit = schedule.compile_kloop(depth, 128, device="cuda")
        check(hit and again is first, f"kloop depth {depth}: no structural hit across steps")
        for steps in (16, 128):
            prog = schedule.make_kloop_program(steps)
            sp = plan(
                prog,
                PlanOptions(
                    method="isd",
                    deps=tuple(schedule.kloop_dependences(depth)),
                    model="procmap",
                    processors=schedule.PROCESSORS,
                ),
            )
            init = prog.initial_store()
            out = sp.compile("torch", device="cuda").run(store=init)
            check(
                out == run_sequential(prog, init),
                f"kloop depth {depth} steps {steps}: diverged on cuda",
            )
    emit("kloop compile: bit-equal on cuda at steps 16 and 128, structural hit across steps")


# ---------------------------------------------------------------------- #
# Phase 5: the matmul kernel
# ---------------------------------------------------------------------- #

def _time_ms(torch, fn, reps):
    """Median of ``reps`` launches, each between its own CUDA events, after
    two warm-up calls."""

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def matmul_phase(torch):
    from repro_torch.kernels.pipelined_matmul import ops
    from repro_torch.kernels.pipelined_matmul.ref import matmul_ref

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    operands = {}
    for M, K, N in MATMUL_SHAPES:
        a = torch.randn(M, K, device="cuda", generator=gen)
        b = torch.randn(K, N, device="cuda", generator=gen)
        for dt, tdt in dtypes.items():
            operands[(M, K, N, dt)] = (a.to(tdt), b.to(tdt))
    configs = [
        (M, K, N, dt, depth)
        for (M, K, N) in MATMUL_SHAPES
        for dt in dtypes
        for depth in MATMUL_DEPTHS
    ]

    # the main path: every count set to 0 just before, read just after
    ops.matmul.launches = 0
    launches, errors = {}, {}
    for cfg in configs:
        M, K, N, dt, depth = cfg
        a, b = operands[(M, K, N, dt)]
        before = ops.matmul.launches
        out = ops.matmul(a, b, depth=depth)
        launches[cfg] = ops.matmul.launches - before
        torch.cuda.synchronize()
        ref = matmul_ref(a, b)
        errors[cfg] = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(
            out.float(), ref.float(), atol=TOL[dt] * math.sqrt(K), rtol=TOL[dt]
        )
        check(ok and out.shape == (M, N), f"matmul {cfg}: outside tolerance (max err {errors[cfg]})")
        check(bool(torch.isfinite(out.float()).all()), f"matmul {cfg}: non-finite output")
    total = ops.matmul.launches
    check(total == len(configs), f"matmul: {total} launches in the main run, expected {len(configs)}")
    check(all(n == 1 for n in launches.values()), "matmul: a configuration did not launch the kernel")

    entries = []
    for cfg in configs:
        M, K, N, dt, depth = cfg
        a, b = operands[(M, K, N, dt)]
        flops = 2.0 * M * N * K
        reps = 21 if flops > 1e10 else 101
        ms = _time_ms(torch, lambda: ops.matmul(a, b, depth=depth), reps)
        plain_ms = _time_ms(torch, lambda: matmul_ref(a, b), reps)
        library_ms = _time_ms(torch, lambda: torch.matmul(a, b), reps)
        nbytes = (M * K + K * N + M * N) * a.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        entry = {
            "name": f"pipelined_matmul[{dt},D={depth},{M}x{K}x{N}]",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL,
            "launches": launches[cfg],
            "max_abs_err": errors[cfg],
            "atol": TOL[dt] * math.sqrt(K),
            "rtol": TOL[dt],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "reps": reps,
            "tflops": flops / ms / 1e9,
        }
        entries.append(entry)
        emit("matmul: " + json.dumps(entry))
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit(smi)
    emit(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 off"
    )

    # phase 2: build every kernel source, all at once
    from repro_torch.kernels import _build, sources

    t0 = time.perf_counter()
    built = _build.build(sources())
    emit(f"build: {len(built)} source(s) in {time.perf_counter() - t0:.2f} s")
    for log in _build.BUILD_LOG.values():
        for line in log.splitlines():
            if "registers" in line or (
                "spill" in line and " 0 bytes spill" not in line
            ):
                emit("  ptxas: " + line.strip())

    level_loop_phase(torch)  # phase 3
    operator_phase()
    kloop_phase()  # phase 4
    entries = matmul_phase(torch)  # phase 5

    emit(json.dumps({"kernels": entries}))  # phase 6
    emit(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    emit(smi)
    emit(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
