"""repro_torch.obs — observability for the staged pipeline.

Three pieces, all stdlib-only (this package sits at the very bottom of the
dependency stack, below even :mod:`repro_torch.core.policy` — it must import from
nowhere inside ``repro``):

* :mod:`repro_torch.obs.trace` — span tracing.  ``with obs.trace.span("plan"):``
  records Chrome-trace complete events when tracing is enabled (off by
  default; the disabled path is one branch/no-op context manager per span
  site).  Export with ``obs.trace.trace_json()`` or, at the pipeline level,
  ``Executable.trace_json()``.
* :mod:`repro_torch.obs.metrics` — one thread-safe registry of counters, gauges
  and p50/p99 histograms.  The analysis/inspector/compile cache stat dicts
  are registry-backed views now; speculation rollbacks, WavefrontError
  rejections, per-backend run counts and serve per-wave latencies live here
  too.  ``obs.metrics.snapshot()`` is the JSON artifact.
* :mod:`repro_torch.obs.profile` — predicted-vs-measured strategy rows (every
  ``StrategyPlan`` offer's predicted cost next to the winning strategy's
  measured wall time), emitted into ``SYNC_REPORTS`` by
  ``benchmarks/run.py``.

``reset_all()`` is the single test/bench reset: metrics, trace buffer,
profiler records, and the three pipeline caches, in one call.
"""

from __future__ import annotations

from . import metrics, profile, trace

__all__ = ["metrics", "profile", "trace", "reset_all", "obs_summary"]


def obs_summary(backend: str = "") -> dict:
    """The deterministic observability stub attached to every
    ``ParallelizationReport.summary()["obs"]``.

    Deliberately carries NO live counter values: two reports for the same
    plan must summarize identically no matter how many pipeline runs
    happened between them (the shim-vs-staged bit-identity contract), so
    this records only where the volatile data lives, plus the report-stable
    tracing flag state at summary time.
    """

    # repro_torch.calibrate is import-light (stdlib + obs.metrics), so the lazy
    # import keeps this module's no-repro-imports rule at module scope only
    from repro_torch.calibrate import summary_pointer

    return {
        "tracing": trace.tracing_enabled(),
        "trace_export": "Executable.trace_json() / obs.trace.trace_json()",
        "metrics_export": "obs.metrics.snapshot()",
        # where the host cost profile lives (report-stable: names the
        # calibration *state*, never measured values — two reports for the
        # same plan summarize identically regardless of runs in between)
        "calibration": summary_pointer(),
        "backend": backend,
    }


def reset_all() -> None:
    """Zero every observability surface and clear the pipeline caches.

    Replaces the three-surface reset dance tests used to do by hand
    (``clear_analysis_cache()`` + ``clear_inspector_cache()`` +
    ``clear_compile_cache()``).  Imports lazily so ``repro_torch.obs`` itself
    stays import-light and cycle-free.
    """

    metrics.reset()
    trace.clear()
    profile.clear()
    from repro_torch.core.inspector import clear_inspector_cache
    from repro_torch.core.parallelizer import clear_analysis_cache

    clear_analysis_cache()
    clear_inspector_cache()
    import sys

    # the compile cache lives behind the lazily-registered xla backend;
    # only clear it when something already paid that import
    cache_mod = sys.modules.get("repro_torch.compile.cache")
    if cache_mod is not None:
        cache_mod.clear_compile_cache()
    # the SPMD backend memoizes mesh/device handles (and owns its own
    # structural cache); dropping them keeps tests that vary
    # --xla_force_host_platform_device_count order-independent
    spmd_mod = sys.modules.get("repro_torch.compile.spmd")
    if spmd_mod is not None:
        spmd_mod.reset_spmd_caches()
    # likewise the plan service's per-tenant LRUs (repro_torch.serve): discard the
    # process-default service so plan_cache.* counters and cache contents
    # reset together
    serve_mod = sys.modules.get("repro_torch.serve.service")
    if serve_mod is not None:
        serve_mod.reset_default_service()
    # and the in-memory cost profile (repro_torch.calibrate): persisted profile
    # files survive on purpose — a reset process re-loads, never re-measures
    calib_mod = sys.modules.get("repro_torch.calibrate")
    if calib_mod is not None:
        calib_mod.reset()
