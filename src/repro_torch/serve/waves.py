"""The serving demo's wave workloads, on the public service surface.

Extracted from ``repro_torch.launch.serve`` (which remains a thin demo client):
four program shapes a decode wave re-plans every iteration — the acyclic
decode chain, the cyclic cross-slot rescoring scan, and the two non-affine
workloads (inspector-planned routing histogram, speculative sparse rescore).
Where the old module memoized each ``SyncPlan`` in an unbounded
``functools.lru_cache``, these helpers resolve through the default
:class:`~repro_torch.serve.service.PlanService` — bounded per-tenant LRUs whose
traffic is observable (``plan_cache.*`` in ``obs.metrics``) instead of
invisible function attributes.  Each workload is its own tenant, so one
chatty structure cannot evict another tenant's plans.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import List, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.core import (
    ArrayRef,
    LoopProgram,
    PlanOptions,
    Statement,
    histogram,
    sparse_matvec,
)
from repro_torch.serve.service import default_service

__all__ = [
    "decode_program",
    "scan_program",
    "plan_wave_sync",
    "plan_scan_sync",
    "plan_route_sync",
    "plan_rescore_sync",
    "run_nonaffine_wave",
    "plan_wave",
]


def decode_program(max_new: int) -> LoopProgram:
    """The per-slot decode chain — the paper's loop in miniature: DECODE
    extends the KV cache from the previous step's cache (flow, Δ=1), SAMPLE
    reads the fresh cache (flow, Δ=0).  The structure is independent of
    which requests occupy the slots, so the plan (and below it the compiled
    artifact — bounds are not part of the structural key) is shared by
    every wave at this ``max_new``."""

    return LoopProgram(
        statements=(
            Statement("DECODE", ArrayRef("kv", 0), (ArrayRef("kv", -1),)),
            Statement("SAMPLE", ArrayRef("tok", 0), (ArrayRef("kv", 0),)),
        ),
        bounds=((1, max(2, max_new)),),
    )


def scan_program(slots: int, horizon: int) -> LoopProgram:
    """The cross-slot rescoring scan — a *cyclic* wave shape.

    RESCORE folds each slot's running score with the previous step's score
    of the same slot (reads ``score[s, t-1]``: flow, Δ=(0,1)) and borrows
    the neighboring slot's one-step-newer score (reads ``score[s-1, t+1]``:
    flow, Δ=(1,-1)) — a mixed-sign recurrence SCC, the request shape the
    acyclic decode plan never produces.  EMIT reads the settled score
    (DOALL, pipelined against the scan).  The (0,1) carried dependence pins
    DOACROSS chunks to 1, and the per-backend cost model decides between
    the unimodular skew and unit chunks at compile time — either way a
    *hybrid* artifact served from the structural cache wave after wave."""

    return LoopProgram(
        statements=(
            Statement(
                "RESCORE",
                ArrayRef("score", (0, 0)),
                (ArrayRef("score", (0, -1)), ArrayRef("score", (-1, 1))),
            ),
            Statement(
                "EMIT", ArrayRef("beam", (0, 0)), (ArrayRef("score", (0, 0)),)
            ),
        ),
        bounds=((0, max(2, slots)), (0, max(2, horizon))),
    )


def _timed_compile(plan_obj):
    options = default_service().options
    t0 = time.perf_counter()
    exe = plan_obj.compile(
        options.backend,
        **({"device": options.device} if options.backend == "torch" else {}),
    )
    _metrics.histogram("serve.compile_ms").observe(
        (time.perf_counter() - t0) * 1e3
    )
    return exe


def plan_wave_sync(max_new: int):
    """One wave's decode-chain report: tenant plan LRU + structural cache."""

    p, _ = default_service().resolve(decode_program(max_new), tenant="decode")
    return _timed_compile(p).report()


def plan_scan_sync(slots: int, horizon: int):
    """One wave's rescoring-scan report (hybrid artifact, see
    :func:`scan_program`)."""

    p, _ = default_service().resolve(
        scan_program(slots, horizon), tenant="scan"
    )
    return _timed_compile(p).report()


def plan_route_sync(tokens: int):
    """One wave's routing-histogram Executable (non-affine,
    ``deps="inspect"``): each decoded token scatters into its expert's bin,
    ``h[bin[i]] += w[i]`` with ``bin`` only known at runtime."""

    p, _ = default_service().resolve(
        histogram(max(2, tokens)), PlanOptions(deps="inspect"), tenant="route"
    )
    return _timed_compile(p)


def plan_rescore_sync(tokens: int):
    """One wave's sparse-rescore Executable (non-affine,
    ``deps="speculate"``): ``y[row[k]] += v[k]*x[col[k]]`` runs
    doall-optimistic, validates against the inspector graph post-hoc, and
    rolls back conservatively on a conflicting wave."""

    p, _ = default_service().resolve(
        sparse_matvec(max(2, tokens)),
        PlanOptions(deps="speculate"),
        tenant="rescore",
    )
    return _timed_compile(p)


def run_nonaffine_wave(route_exe, rescore_exe, sampled: List[int], bins: int):
    """Execute the wave's non-affine workloads with this wave's runtime
    index contents; returns (route store, rescore store) after asserting
    both bit-equal the sequential oracle."""

    from repro_torch.core import indexed_store, run_sequential

    route_prog = route_exe.plan.program
    (lo, hi), = route_prog.bounds
    n = hi - lo
    pattern = [sampled[k % len(sampled)] % bins for k in range(n)]
    store = indexed_store(route_prog, {"bin": pattern})
    init = {a: dict(c) for a, c in store.items()}
    routed = route_exe.run(store=init)
    assert routed == run_sequential(route_prog, init)

    rescore_prog = rescore_exe.plan.program
    (lo, hi), = rescore_prog.bounds
    n = hi - lo
    rows = [sampled[k % len(sampled)] % max(2, n // 2) for k in range(n)]
    store = indexed_store(
        rescore_prog, {"row": rows, "col": list(range(n))}
    )
    init = {a: dict(c) for a, c in store.items()}
    rescored = rescore_exe.run(store=init)
    assert rescored == run_sequential(rescore_prog, init)
    return routed, rescored


def plan_wave(
    max_new: int,
    slots: int,
    pool: Optional[concurrent.futures.ThreadPoolExecutor] = None,
):
    """Resolve one wave's four plans concurrently (decode chain, rescoring
    scan, routing histogram, sparse rescore).

    The planner threads race through ``SyncPlan.compile`` (the default
    service's backend and device) into the structural compile cache — the
    concurrency the cache's locking discipline is built for, now exercised
    by a cyclic workload on every serving wave.  Pass a long-lived ``pool`` from the serving loop: warm
    waves plan in sub-millisecond cache hits, which per-wave executor setup
    would dwarf.
    """

    if pool is None:
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as own:
            return plan_wave(max_new, slots, pool=own)
    f_decode = pool.submit(plan_wave_sync, max_new)
    f_scan = pool.submit(plan_scan_sync, slots, max_new)
    f_route = pool.submit(plan_route_sync, 2 * slots)
    f_rescore = pool.submit(plan_rescore_sync, 2 * slots)
    return (
        f_decode.result(),
        f_scan.result(),
        f_route.result(),
        f_rescore.result(),
    )
