"""``run_xla`` — the compiled-executor entry point, API-parallel to
:func:`repro_torch.core.wavefront.run_wavefront` and
:func:`repro_torch.core.executor.run_threaded` so the differential harness
(``tests/oracle.py``) can drive all registered backends uniformly.

Resolution path per call: structural cache (artifact) → per-bounds table
cache (level buffers) → jax jit cache (XLA specialization) → execute.  A
fully warm call touches only the last step plus host/device store conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.core.ir import run_sequential
from repro_torch.core.policy import SccPolicyLike
from repro_torch.core.sync import SyncProgram
from repro_torch.core.wavefront import (
    WavefrontSchedule,
    WavefrontStats,
    _DenseStore,
    _sync_dependences,
)
from repro_torch.compile.cache import GLOBAL_CACHE, CompileCache


def execute_compiled(
    compiled,
    sync: SyncProgram,
    *,
    store: Optional[Mapping[str, dict]] = None,
) -> dict:
    """Run an already-resolved :class:`CompiledProgram` and return the store.

    The :class:`~repro_torch.core.parallelizer.Executable` runner for the xla
    backend: no structural-cache lookup (the artifact is in hand), only the
    per-(bounds, layout) table cache and jax's jit cache underneath — which
    is what makes ``plan once, compile once, run many`` the warm path.
    """

    prog = sync.program
    init = {a: dict(c) for a, c in (store or prog.initial_store()).items()}
    dense = _DenseStore(init)
    case, table_hit = compiled.prepare(prog, dense)
    if compiled.cache is not None:
        compiled.cache.note_tables(table_hit)
    compiled.execute(case, dense)
    if (
        getattr(compiled, "deps_mode", None) == "speculate"
        and prog.has_indirect()
    ):
        # the artifact ran the optimistic (affine-retained) schedule; check
        # it against the inspector's exact instance graph and, on any
        # violated edge, discard the result and re-run the conservative
        # deps=None artifact from the untouched initial store
        from repro_torch.core.inspector import (
            inspect_dependences,
            speculation_violations,
        )
        from repro_torch.compile.cache import GLOBAL_CACHE

        inspection = inspect_dependences(prog, init)
        _metrics.counter("speculation.validations").inc()
        with _trace.span("speculate.validate", backend="xla"):
            violated = bool(
                speculation_violations(
                    prog, inspection.edges, case.schedule.level_of()
                )
            )
        if violated:
            _metrics.counter("speculation.rollbacks").inc()
            with _trace.span("speculate.rollback", backend="xla"):
                cache = (
                    compiled.cache if compiled.cache is not None else GLOBAL_CACHE
                )
                fallback, _ = cache.get_or_compile(
                    prog,
                    compiled.retained,
                    model=compiled.model,
                    processors=compiled.processors,
                    chunk_limit=compiled.chunk_limit,
                    scc_policy=compiled.scc_policy,
                )
                return execute_compiled(fallback, sync, store=init)
    return dense.to_dicts()


@dataclasses.dataclass
class XlaReport:
    """Mirror of :class:`~repro_torch.core.wavefront.WavefrontReport` plus the
    compile-cache provenance of this call."""

    store: dict
    schedule: WavefrontSchedule
    stats: WavefrontStats
    matches_sequential: bool
    compiled: object  # CompiledProgram
    cache_events: Dict[str, str]  # {"structural": hit|miss, "tables": ...}


def run_xla(
    sync: SyncProgram,
    *,
    schedule: Optional[WavefrontSchedule] = None,
    store: Optional[Mapping[str, dict]] = None,
    compare: bool = True,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    cache: Optional[CompileCache] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: SccPolicyLike = None,
    deps: Optional[str] = None,
) -> XlaReport:
    """Execute ``sync`` through the structural compile cache.

    Same store format and ``matches_sequential`` contract as the other
    executors.  ``schedule`` (when given, e.g. from a wavefront-backend
    report) contributes its retained dependence set *and* its execution
    model — the artifact still builds its own level tables per bounds,
    because one structural entry serves many bounds, but it must layer them
    under the schedule's model (a procmap schedule re-layered as doall would
    silently drop same-processor orders).
    """

    cache = cache if cache is not None else GLOBAL_CACHE
    prog = sync.program
    if schedule is not None:
        retained = tuple(schedule.retained)
        model = schedule.model
        if processors is None:
            processors = schedule.processors
        if chunk_limit is None:
            chunk_limit = schedule.chunk_limit
        if scc_policy is None:
            scc_policy = schedule.scc_policy
    else:
        retained = tuple(_sync_dependences(sync))
    compiled, hit = cache.get_or_compile(
        prog,
        retained,
        model=model,
        processors=processors,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
        deps=deps,
    )

    init = {a: dict(c) for a, c in (store or prog.initial_store()).items()}
    if deps == "speculate" and prog.has_indirect():
        # validation + rollback live in execute_compiled; the report's
        # schedule/stats describe the *speculative* attempt either way
        result = execute_compiled(compiled, sync, store=init)
        case, table_hit = compiled.prepare(prog, _DenseStore(init))
        sched = case.schedule
        stats = WavefrontStats(
            levels=sched.depth,
            batched_ops=sched.batched_ops,
            instances=sched.instances,
            max_width=sched.max_width,
        )
    else:
        dense = _DenseStore(init)
        case, table_hit = compiled.prepare(prog, dense)
        cache.note_tables(table_hit)
        stats = compiled.execute(case, dense)
        result = dense.to_dicts()

    matches = True
    if compare:
        matches = run_sequential(prog, init) == result
    return XlaReport(
        store=result,
        schedule=case.schedule,
        stats=stats,
        matches_sequential=matches,
        compiled=compiled,
        cache_events={
            "structural": "hit" if hit else "miss",
            "tables": "hit" if table_hit else "miss",
        },
    )
