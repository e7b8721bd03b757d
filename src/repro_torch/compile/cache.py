"""Structural compile cache: one artifact per dependence structure.

Keyed by :func:`repro_torch.compile.structure.structural_key` — a canonical hash of
(statement graph, retained dependences, execution model), *not* loop bounds —
so the serving path re-planning the same decode loop every batch wave and the
Pallas K-loop plan re-lowering the same ISSUE/LOAD/COMPUTE loop for different
``steps`` all resolve to the same :class:`~repro_torch.compile.lowering.CompiledProgram`.
Below the structural level, each artifact memoizes its per-(bounds, store
layout) level tables, and jax's jit cache memoizes per-shape XLA
specializations; a warm request touches none of the analysis, scheduling or
tracing machinery.

Hit/miss counters (structural and table level) are surfaced through
``ParallelizationReport.summary()`` and the ``compile_cache_*`` benchmarks.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.core.dependence import Dependence
from repro_torch.core.ir import LoopProgram
from repro_torch.core.policy import SccPolicyLike
from repro_torch.compile.structure import structural_key

_FIELDS = ("hits", "misses", "table_hits", "table_misses")


class CacheStats:
    """Hit/miss counters for one :class:`CompileCache`.

    With ``metrics_prefix`` set the four counters live in the unified
    registry (:mod:`repro_torch.obs.metrics`) — that is how the process-global
    cache publishes ``compile_cache.hits`` etc. while keeping this object's
    historical surface (``.hits``, ``.as_dict()``, ``.note()``).  Without a
    prefix (test-local ``CompileCache()`` instances) the counters are
    private unregistered instruments, so per-instance assertions never see
    another cache's traffic.
    """

    __slots__ = ("_counters",)

    def __init__(self, metrics_prefix: Optional[str] = None):
        if metrics_prefix is None:
            self._counters = {f: _metrics.Counter(f) for f in _FIELDS}
        else:
            self._counters = {
                f: _metrics.counter(f"{metrics_prefix}.{f}") for f in _FIELDS
            }

    @property
    def hits(self) -> int:
        return self._counters["hits"].value

    @property
    def misses(self) -> int:
        return self._counters["misses"].value

    @property
    def table_hits(self) -> int:
        return self._counters["table_hits"].value

    @property
    def table_misses(self) -> int:
        return self._counters["table_misses"].value

    def as_dict(self) -> Dict[str, int]:
        return {f: self._counters[f].value for f in _FIELDS}

    def note(self, hit: bool) -> None:
        self._counters["hits" if hit else "misses"].inc()

    def note_tables(self, hit: bool) -> None:
        self._counters["table_hits" if hit else "table_misses"].inc()

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()


class CompileCache:
    """Thread-safe structural LRU cache of compiled sync-program executables.

    Bounded like the per-artifact table cache (CompiledProgram.MAX_CASES):
    a long-running server whose request *structures* vary (e.g. per-tenant
    compute functions) must not pin jitted executables for structures that
    never recur.
    """

    MAX_ENTRIES = 128

    def __init__(
        self,
        metrics_prefix: Optional[str] = None,
        factory: Optional[type] = None,
    ) -> None:
        self._entries: "collections.OrderedDict[str, CompiledProgram]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self.stats = CacheStats(metrics_prefix)
        # the artifact class this cache builds; per-backend caches (xla vs
        # xla_spmd) install their own CompiledProgram subclass so artifacts
        # never alias across backends even though structural_key carries no
        # backend tag
        self._factory = factory

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> Tuple[str, ...]:
        return tuple(self._entries)

    def clear(self) -> None:
        # counters reset in place: the registry (and any holder of this
        # stats object) keeps observing the same instruments
        with self._lock:
            self._entries.clear()
            self.stats.reset()

    def note_tables(self, hit: bool) -> None:
        """Thread-safe table-level counter update (the second cache level
        lives inside each CompiledProgram; its hits are recorded here)."""

        with self._lock:
            self.stats.note_tables(hit)

    def get_or_compile(
        self,
        program: LoopProgram,
        retained: Sequence[Dependence],
        *,
        model: str = "doall",
        processors: Optional[Dict[str, object]] = None,
        chunk_limit: Optional[int] = None,
        scc_policy: SccPolicyLike = None,
        deps: Optional[str] = None,
    ) -> Tuple["CompiledProgram", bool]:
        """Resolve (or build) the artifact for this structure.

        Returns ``(compiled, hit)``.  The build happens *outside* the lock
        (the first one pays the jax import, seconds — holding the lock
        would stall concurrent hits on other keys); a lost build race
        re-checks on insert and reuses the winner.  ``deps`` is the
        non-affine dependence mode (``"inspect"``/``"speculate"``/None) —
        a structural knob like ``chunk_limit``; the store-dependent
        inspector graph itself lives with the artifact's per-bounds tables.
        """

        from repro_torch.compile.lowering import CompiledProgram

        factory = self._factory if self._factory is not None else CompiledProgram
        with _trace.span("compile.structural_lookup"):
            key = structural_key(
                program, retained, model, processors, chunk_limit, scc_policy,
                deps,
            )
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
        if entry is not None:
            self.stats.note(True)
            return entry, True
        with _trace.span("compile.build", key=key[:16]):
            built = factory(
                key,
                program,
                retained,
                model=model,
                processors=processors,
                chunk_limit=chunk_limit,
                scc_policy=scc_policy,
                deps=deps,
            )
        built.cache = self
        with self._lock:
            entry = self._entries.get(key)  # lost a build race: use theirs
            if entry is None:
                self._entries[key] = entry = built
                while len(self._entries) > self.MAX_ENTRIES:
                    self._entries.popitem(last=False)
            self.stats.note(False)
            return entry, False


GLOBAL_CACHE = CompileCache(metrics_prefix="compile_cache")


def get_or_compile(
    program: LoopProgram,
    retained: Sequence[Dependence],
    *,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: SccPolicyLike = None,
    deps: Optional[str] = None,
) -> Tuple["CompiledProgram", bool]:
    """Module-level convenience over the process-global cache."""

    return GLOBAL_CACHE.get_or_compile(
        program,
        retained,
        model=model,
        processors=processors,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
        deps=deps,
    )


def compile_cache_stats() -> Dict[str, int]:
    return GLOBAL_CACHE.stats.as_dict()


def clear_compile_cache() -> None:
    GLOBAL_CACHE.clear()
