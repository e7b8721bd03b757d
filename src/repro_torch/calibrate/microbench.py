"""Synthetic microbenchmarks behind :func:`repro_torch.calibrate.measure`.

Each benchmark drives the *real* machinery it prices — the ``"torch"``
backend's level loop of :mod:`repro_torch.compile.lowering` (its gather /
compute / scatter steps, masking and scatter to the trash cell), the
sharded variant of :mod:`repro_torch.compile.spmd` with its all-gathers,
and the NumPy wavefront interpreter — instead of an idealized kernel,
because the auction constants only have to be honest about *this* code on
*this* device.  The program it times is a 1-D chain recurrence ``a[i] =
f(a[i-d])`` whose carried distance ``d`` pins the chunk width: forced
``scc_policy="chunk"`` lowers it to one uniform recurrence band of
``~n/d`` levels, each ``d`` lanes wide, so the per-level cost at several
pow2 widths gives a clean (flat, per-lane) linear fit.

Measurement discipline — what is timed is the *level loop alone*, the
counterpart of the reference timing its jitted loop on pre-packed device
buffers; the host fill of the store and the read-back of a run never enter
the clock:

* on CUDA, a case that has run twice, so that it holds its captured graph
  (``CompiledProgram._warm_up`` on the first run, ``_record`` on the
  second): each timed call is one replay of that graph with its static
  buffers in place, between CUDA events.  A case that stays eager (the
  SPMD sweep over more than one process) is timed as its eager sweep on
  buffers loaded once, between CUDA events;
* on the CPU, the eager sweep (``CompiledProgram._sweep_steps``) on store
  and coverage tensors loaded once outside the clock, on the host clock.

The flat per-call cost that remains (a replay's launch, an event) is
cancelled by differencing two problem sizes at the same width (only the
level count changes between them).

All compiles go through *local* :class:`CompileCache` instances so
measurement never pollutes the process-global structural caches.  Every
timed sample ticks ``calibrate.measurements`` — the counter the
persistence tests watch to prove a reused profile re-measures nothing.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from repro_torch.obs import metrics as _metrics

# noise floor for fitted units: timing jitter can drive a least-squares
# intercept (or a collective delta) slightly negative, which a cost model
# must never see
_MIN_UNIT_US = 1e-4

# Default (n, widths) per device type.  The CPU's are the reference's.  On
# the card a level step is a few kernels of about a microsecond each
# whatever its width, and a lane adds only its bytes at HBM rate (some
# tens of bytes, ~1e-5 us), below _MIN_UNIT_US: the lane slope cannot
# resolve above that floor at any width, so the widths reach 8192 lanes
# (where a step moves ~1 MB) only to show how flat it is, and the fit's
# raw slope is recorded in ``meta`` beside whether it cleared the floor.
# n = 2**17 keeps the narrowest chain at 255 levels, so each of its two
# sizes is one short capture, and the host's table build (the NumPy
# schedule of 2**17 instances) at about a second a size.
_DEFAULT_SIZES = {
    "cpu": (8192, (8, 64, 512)),
    "cuda": (1 << 17, (512, 2048, 8192)),
}


def _chain_program(n: int, dist: int):
    from repro_torch.core import ArrayRef, LoopProgram, Statement

    return LoopProgram(
        statements=(
            Statement("S1", ArrayRef("a", 0), (ArrayRef("a", -dist),)),
        ),
        bounds=((dist, n),),
    )


def _chain_store(n: int, dist: int) -> dict:
    """The chain's memory image over the cells ``initial_store(pad=dist)``
    covers, with values that are the same in every process (the SPMD
    timings need one store on every rank, and ``initial_store()`` draws
    from Python's per-process ``hash``)."""

    return {"a": {(i,): (i % 97) / 7.0 - 5.0 for i in range(n + dist)}}


def _sync_for(prog):
    from repro_torch.core import analyze, insert_synchronization

    return insert_synchronization(prog, analyze(prog))


def _best_of(fn, repeats: int) -> float:
    """Best-of-N wall time in seconds; every sample is one measurement."""

    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
        _metrics.counter("calibrate.measurements").inc()
    return best


def _best_of_events(fn, repeats: int, device) -> float:
    """Best-of-N device time in seconds between CUDA events around ``fn``
    on ``device``'s current stream; every sample is one measurement."""

    import torch

    best = float("inf")
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(max(1, repeats)):
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
            _metrics.counter("calibrate.measurements").inc()
    return best


def _fit_line(points) -> Tuple[float, float]:
    """Least-squares ``y = intercept + slope * x`` over ≥ 2 points."""

    xs = [float(x) for x, _ in points]
    ys = [float(y) for _, y in points]
    mx = sum(xs) / len(xs)
    my = sum(ys) / len(ys)
    var = sum((x - mx) ** 2 for x in xs)
    slope = (
        sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var
        if var
        else 0.0
    )
    return my - slope * mx, slope


def _band_seconds(cache, n: int, dist: int, repeats: int, device) -> Tuple[
    float, int
]:
    """Best-of time of the *level loop alone* for one chain program, plus
    its level count.  One ``run_xla`` builds the artifact and the case and
    runs it (eagerly); on CUDA a second run captures it; the timed calls
    then replay the graph (or sweep eagerly, where the case stays eager)
    with the buffers in place — see the module docstring."""

    from repro_torch.compile.executor import run_xla
    from repro_torch.compile.lowering import _WARMED, _CapturedSweep, device_scope
    from repro_torch.core.wavefront import _DenseStore

    prog = _chain_program(n, dist)
    sync = _sync_for(prog)
    init = _chain_store(n, dist)
    with device_scope(device):
        rep = run_xla(
            sync,
            cache=cache,
            scc_policy="chunk",
            compare=False,
            store=init,
        )
        compiled = rep.compiled
        dense = _DenseStore({a: dict(c) for a, c in init.items()})
        case, _ = compiled.prepare(prog, dense)
        if case._sweep is _WARMED:
            compiled.execute(case, dense)  # the second run captures
        sweep = case._sweep
        if isinstance(sweep, _CapturedSweep):
            best = _best_of_events(sweep.graph.replay, repeats, device)
        else:
            store, coverage = compiled._device_buffers(case, dense, device)

            def call():
                compiled._sweep_steps(case, store, coverage, device)

            call()  # warm this exact case outside the clock
            if device.type == "cuda":
                best = _best_of_events(call, repeats, device)
            else:
                best = _best_of(call, repeats)
    return best, rep.stats.levels


def _per_level_us(sample, n: int, dist: int, repeats: int) -> float:
    """Per-level µs via the two-size difference trick: only the level
    count changes between ``n // 2`` and ``n``, so flat per-call overhead
    cancels.  ``sample(size) -> (seconds, levels)``."""

    t_small, l_small = sample(n // 2)
    t_big, l_big = sample(n)
    if l_big <= l_small:  # degenerate sizing; avoid a zero division
        return max((t_big / max(l_big, 1)) * 1e6, _MIN_UNIT_US)
    return max(
        ((t_big - t_small) / (l_big - l_small)) * 1e6, _MIN_UNIT_US
    )


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def measure_units(
    *,
    n: Optional[int] = None,
    widths: Optional[Tuple[int, ...]] = None,
    repeats: int = 3,
    spmd: Optional[bool] = None,
    device="cuda",
) -> Tuple[Optional[Dict[str, float]], Optional[dict]]:
    """Run the suite on ``device``; returns ``(units, meta)`` for a fresh
    CostProfile.

    ``widths`` must be powers of two (each is a carried distance = chunk
    width = padded lane count); ``n`` the largest chain length (the small
    size is ``n // 2``); both default per device type (``_DEFAULT_SIZES``).
    ``spmd=None`` measures collectives only when the process group has
    ≥ 2 devices, else scales the hand-set collective ratios by the measured
    per-lane cost so the profile stays on one unit scale.

    Under a process group every rank calls it: rank 0 times the level
    loop and the interpreter, every rank takes part in the SPMD timings,
    and only rank 0 gets the result (``(None, None)`` on the others).
    """

    from repro_torch.compile import spmd as _spmd
    from repro_torch.compile.cache import CompileCache
    from repro_torch.compile.lowering import resolve_device

    dev = resolve_device(device)
    default_n, default_widths = _DEFAULT_SIZES[dev.type]
    n = default_n if n is None else n
    widths = default_widths if widths is None else widths
    widths = tuple(sorted({_next_pow2(max(2, w)) for w in widths}))
    if len(widths) < 2:
        raise ValueError(
            f"need >= 2 distinct pow2 widths to fit a lane slope, got "
            f"{widths!r}"
        )
    if n // 2 <= 4 * max(widths):
        raise ValueError(
            f"n={n} too small for widths {widths!r}: the smallest run must "
            "still produce a multi-level recurrence band"
        )
    lead = _spmd._group()[0] == 0
    meta: dict = {
        "n": n, "widths": list(widths), "repeats": repeats, "timed": (
            "captured graph replay between CUDA events" if dev.type == "cuda"
            else "eager sweep on the host clock"
        ),
    }

    # -- the level loop's step: flat per-level cost + per padded lane --- #
    if lead:
        xla_cache = CompileCache()
        xla_points = [
            (
                w,
                _per_level_us(
                    lambda size, w=w: _band_seconds(
                        xla_cache, size, w, repeats, dev
                    ),
                    n,
                    w,
                    repeats,
                ),
            )
            for w in widths
        ]
        step, lane_slope = _fit_line(xla_points)
        xla_lane = max(lane_slope, _MIN_UNIT_US)
        xla_step = max(step, _MIN_UNIT_US)
        meta["xla_per_level_us"] = {str(w): y for w, y in xla_points}
        # the fit's own slope; below _MIN_UNIT_US the lane term is flat
        # across the widths measured and xla_lane is the floor
        meta["xla_lane_slope_us"] = lane_slope
        meta["lane_slope_resolved"] = lane_slope > _MIN_UNIT_US

    # -- spmd step: collective flat + per gathered lane ----------------- #
    n_dev = _spmd._actual_devices() if spmd is not False else 1
    if spmd is True or (spmd is None and n_dev >= 2):
        spmd_cache = CompileCache(factory=_spmd.SpmdCompiledProgram)
        per_level = [
            _per_level_us(
                lambda size, w=w: _band_seconds(
                    spmd_cache, size, w, repeats, dev
                ),
                n,
                w,
                repeats,
            )
            for w in widths
        ]
        if lead:
            deltas = []
            for w, y in zip(widths, per_level):
                wp = max(w, n_dev)  # the sharded artifact's lane padding
                deltas.append((wp, y - (xla_step + xla_lane * wp / n_dev)))
            coll, coll_slope = _fit_line(deltas)
            spmd_collective = max(coll, _MIN_UNIT_US)
            spmd_collective_lane = max(coll_slope, _MIN_UNIT_US)
            meta["spmd_delta_us"] = {str(w): d for w, d in deltas}
    elif lead:
        # single-device group: keep the hand-set collective *ratios* (they
        # are expressed in lane units) on the measured lane scale
        spmd_collective = _spmd.SPMD_COLLECTIVE_UNITS * xla_lane
        spmd_collective_lane = _spmd.SPMD_COLLECTIVE_LANE_UNITS * xla_lane
        meta["spmd_delta_us"] = "skipped (single-device group)"
    if not lead:
        return None, None
    meta["spmd_devices"] = n_dev

    # -- interpreter dispatch: per batched group of the NumPy wavefront - #
    from repro_torch.core.wavefront import run_wavefront

    # the interpreter runs on the host whatever device the level loop is
    # measured on; on the card's sizes a group of widths[0] lanes would
    # time the NumPy lanes (6.7 ms a 512-lane group on an H100's host,
    # PERF.md), not a dispatch, so there the CPU's sizes are used
    wf_n, wf_w = (n, widths[0]) if dev.type == "cpu" else (
        _DEFAULT_SIZES["cpu"][0], _DEFAULT_SIZES["cpu"][1][0]
    )

    def wf_sample(size):
        prog = _chain_program(size, wf_w)
        sync = _sync_for(prog)
        init = prog.initial_store(pad=wf_w)
        run_wavefront(  # warm analysis/schedule caches outside the clock
            sync, scc_policy="chunk", compare=False, store=init
        )
        secs = _best_of(
            lambda: run_wavefront(
                sync, scc_policy="chunk", compare=False, store=init
            ),
            repeats,
        )
        levels = run_wavefront(
            sync, scc_policy="chunk", compare=False, store=init
        ).stats.levels
        return secs, levels

    dispatch = max(_per_level_us(wf_sample, wf_n, wf_w, repeats), _MIN_UNIT_US)
    meta["wavefront_per_group_us"] = dispatch
    meta["wavefront_sizes"] = [wf_n, wf_w]

    units = {
        "xla_step": xla_step,
        "xla_lane": xla_lane,
        "spmd_collective": spmd_collective,
        "spmd_collective_lane": spmd_collective_lane,
        "dispatch": dispatch,
    }
    return units, meta
