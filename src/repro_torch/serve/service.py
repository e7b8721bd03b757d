"""``PlanService`` — a continuous-batching plan service over the staged
pipeline.

The serving-layer form of the paper's amortization promise: analyze a loop
structure once, then serve any number of waves from caches.  A service
instance admits requests for many program *structures* concurrently and
resolves each through the full cache hierarchy —

  per-tenant plan LRU  →  structural compile cache  →  trace bucket
  →  per-bounds tables

— so a warm request touches no analysis, no scheduling, and (for bounds
already prepared on a CUDA device, see :mod:`repro_torch.compile.lowering`)
no graph capture: the level loop replays the case's captured CUDA graph.

Concurrency discipline:

* a fixed worker pool (``ServiceOptions.workers``) runs submitted requests;
* *per-structure admission*: requests for the same program structure are
  serialized through a per-fingerprint lock, so a cold structure is planned
  and lowered exactly once no matter how many submitters race it — the
  structural cache's miss count stays equal to the number of distinct
  structures;
* *bounded admission*: more than ``max_queue_depth`` outstanding requests
  rejects at ``submit()`` instead of queueing without limit.

Cache entries are *artifact-level*: an entry holds the plan plus, once the
first request for it has compiled, the backend executable — warm requests
skip ``SyncPlan.compile`` entirely (``plan_cache.artifact_hits``).  Each
entry carries an estimated byte footprint; eviction enforces both the
per-tenant count bound and a global byte budget
(``ServiceOptions.plan_cache_bytes``), oldest-first from the heaviest
tenant, with the running total on the ``plan_cache.bytes`` gauge.

Observability (all in the unified ``repro_torch.obs.metrics`` registry, so
``obs.reset_all()`` covers them): ``plan_cache.hits`` / ``plan_cache.misses``
/ ``plan_cache.evictions`` / ``plan_cache.artifact_hits`` counters and the
``plan_cache.size`` / ``plan_cache.bytes`` gauges for the per-tenant LRUs,
the ``serve.queue_depth`` gauge, and per-tenant
``serve.latency_ms.<tenant>`` histograms beside the global
``serve.plan_ms`` / ``serve.compile_ms`` ones.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.core.ir import LoopProgram
from repro_torch.core.parallelizer import (
    Executable,
    PlanOptions,
    SyncPlan,
    plan as _plan,
)
from repro_torch.serve.options import ServiceOptions

__all__ = [
    "PlanService",
    "ServiceResult",
    "default_service",
    "reset_default_service",
]


@dataclasses.dataclass(frozen=True)
class ServiceResult:
    """What one admitted request resolved to."""

    tenant: str
    plan: SyncPlan
    executable: Executable
    store: Optional[dict]        # output store when the request ran
    plan_cached: bool            # per-tenant plan-LRU hit?
    latency_ms: float


class _CacheEntry:
    """One artifact-level LRU entry: the plan, the compiled executable once
    a request has built it (so warm requests skip ``SyncPlan.compile``
    entirely), and the entry's estimated byte footprint."""

    __slots__ = ("plan", "executable", "nbytes")

    def __init__(self, plan: SyncPlan, nbytes: int) -> None:
        self.plan = plan
        self.executable: Optional[Executable] = None
        self.nbytes = nbytes


class _TenantCache:
    """One tenant's bounded plan/artifact LRU (counters are plain ints
    here; the registry-backed totals are maintained by the owning
    service)."""

    __slots__ = ("entries", "bytes", "hits", "misses", "evictions")

    def __init__(self) -> None:
        self.entries: "collections.OrderedDict[Tuple, _CacheEntry]" = (
            collections.OrderedDict()
        )
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0


def _options_key(options: PlanOptions) -> object:
    """A hashable stand-in for the plan options (scc_policy instances may
    not be hashable; their repr is stable enough for a cache key)."""

    try:
        hash(options)
        return options
    except TypeError:
        return repr(options)


_SKIP_MODULES = ("_thread", "threading", "concurrent.futures", "builtins")


def _approx_nbytes(obj, _seen=None, _depth: int = 0) -> int:
    """Defensive recursive footprint estimate of a cache entry.

    Arrays report ``.nbytes`` (numpy arrays and torch tensors alike — the
    level tables and device buffers that dominate a compiled artifact); containers,
    dataclasses and slotted objects are walked to a bounded depth with a
    visited set; callables, modules, locks and thread machinery are
    skipped.  This is an *estimate* for eviction accounting, not an exact
    resident-size: structure shared between entries (e.g. one structural
    artifact behind two bounds) is charged to each entry that references
    it, which over-counts — the conservative direction for a byte budget.
    """

    import sys as _sys

    if _seen is None:
        _seen = set()
    if _depth > 8 or id(obj) in _seen:
        return 0
    _seen.add(id(obj))
    try:
        nbytes = getattr(obj, "nbytes", None)
        if isinstance(nbytes, int):
            return nbytes
        if obj is None or isinstance(obj, (bool, int, float, complex)):
            return _sys.getsizeof(obj)
        if isinstance(obj, (str, bytes, bytearray)):
            return _sys.getsizeof(obj)
        if callable(obj) or type(obj).__module__ in _SKIP_MODULES:
            return 0
        total = _sys.getsizeof(obj, 0)
        if isinstance(obj, Mapping):
            items = list(obj.items())[:256]
            for k, v in items:
                total += _approx_nbytes(k, _seen, _depth + 1)
                total += _approx_nbytes(v, _seen, _depth + 1)
            return total
        if isinstance(obj, (list, tuple, set, frozenset)):
            for v in list(obj)[:256]:
                total += _approx_nbytes(v, _seen, _depth + 1)
            return total
        state = getattr(obj, "__dict__", None)
        if state:
            total += _approx_nbytes(state, _seen, _depth + 1)
        for slot in getattr(type(obj), "__slots__", ()) or ():
            total += _approx_nbytes(
                getattr(obj, slot, None), _seen, _depth + 1
            )
        return total
    except Exception:
        return 0


class PlanService:
    """Multi-tenant plan service: ``submit()`` / ``drain()`` / ``stats()`` /
    ``close()`` over per-tenant bounded plan LRUs and a worker pool."""

    def __init__(self, options: Optional[ServiceOptions] = None) -> None:
        self.options = options if options is not None else ServiceOptions()
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantCache] = {}
        self._structure_locks: Dict[str, threading.Lock] = {}
        self._outstanding: set = set()
        self._submitted = 0
        self._completed = 0
        self._closed = False
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.options.workers,
            thread_name_prefix="plan-serve",
        )
        if self.options.warm_profile:
            # load-or-measure the cost profile of the options' device before
            # the first request, so every plan this service builds prices
            # strategy offers with the same (measured) units — a persisted
            # profile makes this a microsecond file read, zero re-measurement
            from repro_torch.calibrate import warm

            warm(device=self.options.device)

    # ------------------------------------------------------------------ #
    # Cache plumbing
    # ------------------------------------------------------------------ #

    def _tenant(self, name: str) -> _TenantCache:
        cache = self._tenants.get(name)
        if cache is None:
            cache = self._tenants.setdefault(name, _TenantCache())
        return cache

    def _structure_lock(self, fingerprint: str) -> threading.Lock:
        with self._lock:
            lock = self._structure_locks.get(fingerprint)
            if lock is None:
                lock = self._structure_locks[fingerprint] = threading.Lock()
            return lock

    def _cache_size(self) -> int:
        return sum(len(t.entries) for t in self._tenants.values())

    def _cache_bytes(self) -> int:
        return sum(t.bytes for t in self._tenants.values())

    def _evict_locked(self, cache: _TenantCache) -> None:
        """Enforce both LRU bounds (caller holds ``self._lock``): the
        per-tenant entry count, then the global byte budget — bytes evict
        oldest-first from whichever tenant currently holds the most."""

        while len(cache.entries) > self.options.plan_cache_capacity:
            self._pop_oldest_locked(cache)
        while self._cache_bytes() > self.options.plan_cache_bytes:
            victim = max(
                (t for t in self._tenants.values() if t.entries),
                key=lambda t: t.bytes,
                default=None,
            )
            if victim is None:
                break
            self._pop_oldest_locked(victim)
        _metrics.gauge("plan_cache.size").set(self._cache_size())
        _metrics.gauge("plan_cache.bytes").set(self._cache_bytes())

    def _pop_oldest_locked(self, cache: _TenantCache) -> None:
        _, entry = cache.entries.popitem(last=False)
        cache.bytes -= entry.nbytes
        cache.evictions += 1
        _metrics.counter("plan_cache.evictions").inc()

    def resolve(
        self,
        program: LoopProgram,
        options: Optional[PlanOptions] = None,
        *,
        tenant: Optional[str] = None,
    ) -> Tuple[SyncPlan, bool]:
        """The synchronous core: per-tenant plan LRU with per-structure
        admission.  Returns ``(plan, cached)``; records ``serve.plan_ms``
        (every call, hits included — the latency a serving wave observes)
        and the per-tenant ``plan_cache.*`` counters."""

        plan_obj, cached, _ = self._resolve_entry(
            program, options, tenant=tenant
        )
        return plan_obj, cached

    def _resolve_entry(
        self,
        program: LoopProgram,
        options: Optional[PlanOptions] = None,
        *,
        tenant: Optional[str] = None,
    ) -> Tuple[SyncPlan, bool, Tuple[str, Tuple]]:
        """``resolve`` plus the ``(tenant, key)`` handle ``_handle`` needs
        to find the entry again when attaching a compiled artifact."""

        tenant = tenant if tenant is not None else self.options.default_tenant
        options = options if options is not None else PlanOptions()
        t0 = time.perf_counter()
        from repro_torch.compile.structure import program_fingerprint

        fp = program_fingerprint(program)
        key = (fp, program.bounds, _options_key(options))
        with self._lock:
            cache = self._tenant(tenant)
            cached = cache.entries.get(key)
            if cached is not None:
                cache.entries.move_to_end(key)
                cache.hits += 1
        if cached is not None:
            _metrics.counter("plan_cache.hits").inc()
            _metrics.histogram("serve.plan_ms").observe(
                (time.perf_counter() - t0) * 1e3
            )
            return cached.plan, True, (tenant, key)
        # per-structure admission: one planner per structure at a time, so
        # racing submitters of a cold structure queue here instead of
        # planning (and structurally compiling) the same thing twice
        with self._structure_lock(fp):
            with self._lock:
                cached = cache.entries.get(key)
                if cached is not None:
                    cache.entries.move_to_end(key)
                    cache.hits += 1
            if cached is not None:
                _metrics.counter("plan_cache.hits").inc()
                _metrics.histogram("serve.plan_ms").observe(
                    (time.perf_counter() - t0) * 1e3
                )
                return cached.plan, True, (tenant, key)
            built = _plan(program, options)
            entry = _CacheEntry(built, _approx_nbytes(built))
            with self._lock:
                cache.misses += 1
                cache.entries[key] = entry
                cache.bytes += entry.nbytes
                self._evict_locked(cache)
        _metrics.counter("plan_cache.misses").inc()
        _metrics.histogram("serve.plan_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
        return built, False, (tenant, key)

    # ------------------------------------------------------------------ #
    # The public request surface
    # ------------------------------------------------------------------ #

    def submit(
        self,
        program: LoopProgram,
        options: Optional[PlanOptions] = None,
        *,
        tenant: Optional[str] = None,
        store: Optional[Mapping[str, dict]] = None,
        run: bool = False,
        deadline_ms: Optional[float] = None,
    ) -> "concurrent.futures.Future[ServiceResult]":
        """Admit one request: plan (through the tenant's LRU), compile for
        the service backend, optionally execute.

        Returns a future of :class:`ServiceResult`.  ``store``/``run=True``
        execute the compiled artifact (``store`` is copied, not mutated).
        Raises ``RuntimeError`` when the service is closed or the admission
        bound (``max_queue_depth``) is reached.

        ``deadline_ms`` bounds the *queueing* delay: a request still waiting
        for a worker past its deadline is dropped at dequeue — its future
        fails with ``RuntimeError`` and ``serve.deadline_drops`` counts it —
        instead of occupying a worker to produce a result the caller has
        already abandoned.  A request that *starts* before the deadline runs
        to completion (the deadline is admission control, not preemption).
        """

        if deadline_ms is not None:
            if (
                isinstance(deadline_ms, bool)
                or not isinstance(deadline_ms, (int, float))
                or not deadline_ms > 0
            ):
                raise ValueError(
                    f"deadline_ms must be a positive number of milliseconds,"
                    f" got {deadline_ms!r}"
                )
        deadline = (
            None
            if deadline_ms is None
            else time.perf_counter() + deadline_ms / 1e3
        )
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "PlanService is closed — create a new service to submit"
                )
            if len(self._outstanding) >= self.options.max_queue_depth:
                raise RuntimeError(
                    f"admission rejected: {len(self._outstanding)} requests "
                    f"outstanding >= max_queue_depth="
                    f"{self.options.max_queue_depth}"
                )
            self._submitted += 1
        future = self._pool.submit(
            self._handle, program, options, tenant, store, run, deadline
        )
        with self._lock:
            self._outstanding.add(future)
            _metrics.gauge("serve.queue_depth").set(len(self._outstanding))
        future.add_done_callback(self._settle)
        return future

    def _settle(self, future) -> None:
        with self._lock:
            self._outstanding.discard(future)
            self._completed += 1
            _metrics.gauge("serve.queue_depth").set(len(self._outstanding))

    def _handle(
        self,
        program: LoopProgram,
        options: Optional[PlanOptions],
        tenant: Optional[str],
        store: Optional[Mapping[str, dict]],
        run: bool,
        deadline: Optional[float] = None,
    ) -> ServiceResult:
        tenant = tenant if tenant is not None else self.options.default_tenant
        t0 = time.perf_counter()
        if deadline is not None and t0 > deadline:
            _metrics.counter("serve.deadline_drops").inc()
            raise RuntimeError(
                f"request dropped at dequeue: queued "
                f"{(t0 - deadline) * 1e3:.1f}ms past its deadline "
                f"(deadline_ms admission control)"
            )
        plan_obj, cached, (tenant, key) = self._resolve_entry(
            program, options, tenant=tenant
        )
        tc = time.perf_counter()
        executable = None
        with self._lock:
            entry = self._tenant(tenant).entries.get(key)
            if entry is not None and entry.executable is not None:
                executable = entry.executable
        if executable is not None:
            _metrics.counter("plan_cache.artifact_hits").inc()
        else:
            # compile under the same per-structure admission lock as
            # planning: get_or_compile counts a lost race as a second
            # structural miss, so without this two workers handling the same
            # cold structure would both lower it and the miss count would
            # exceed #distinct structures
            from repro_torch.compile.structure import program_fingerprint

            with self._structure_lock(program_fingerprint(program)):
                executable = plan_obj.compile(
                    self.options.backend,
                    **(
                        {"device": self.options.device}
                        if self.options.backend == "torch"
                        else {}
                    ),
                )
            extra = _approx_nbytes(executable)
            with self._lock:
                cache = self._tenant(tenant)
                entry = cache.entries.get(key)
                # attach the artifact so later requests skip compile();
                # entry may have been evicted (or replaced by a racing
                # re-plan) since resolve — then the artifact is just not
                # cached, which is correct
                if entry is not None and entry.plan is plan_obj:
                    if entry.executable is None:
                        entry.executable = executable
                        entry.nbytes += extra
                        cache.bytes += extra
                        self._evict_locked(cache)
                    else:
                        executable = entry.executable
        _metrics.histogram("serve.compile_ms").observe(
            (time.perf_counter() - tc) * 1e3
        )
        out = None
        if run or store is not None:
            init = {
                a: dict(c)
                for a, c in (store or program.initial_store()).items()
            }
            out = executable.run(store=init)
        latency = (time.perf_counter() - t0) * 1e3
        _metrics.histogram(f"serve.latency_ms.{tenant}").observe(latency)
        return ServiceResult(
            tenant=tenant,
            plan=plan_obj,
            executable=executable,
            store=out,
            plan_cached=cached,
            latency_ms=latency,
        )

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Block until every outstanding request settles; returns
        :meth:`stats`.  Raises ``TimeoutError`` if ``timeout`` (seconds)
        elapses first."""

        with self._lock:
            pending = tuple(self._outstanding)
        done, not_done = concurrent.futures.wait(pending, timeout=timeout)
        if not_done:
            raise TimeoutError(
                f"drain timed out with {len(not_done)} requests outstanding"
            )
        return self.stats()

    def stats(self) -> dict:
        """A JSON-able snapshot: per-tenant cache traffic, queue state, and
        the level loop's bucket and CUDA-graph counters (``captures`` takes
        the place of the reference's ``traces``: a capture is the port's
        one-time cost of a new prepared case, as a trace is the
        reference's of a new bucket)."""

        snap = _metrics.snapshot()
        with self._lock:
            tenants = {
                name: {
                    "size": len(t.entries),
                    "bytes": t.bytes,
                    "hits": t.hits,
                    "misses": t.misses,
                    "evictions": t.evictions,
                }
                for name, t in sorted(self._tenants.items())
            }
            out = {
                "backend": self.options.backend,
                "device": self.options.device,
                "workers": self.options.workers,
                "tenants": tenants,
                "plan_cache": {
                    "size": self._cache_size(),
                    "bytes": self._cache_bytes(),
                    "bytes_budget": self.options.plan_cache_bytes,
                    "capacity_per_tenant": self.options.plan_cache_capacity,
                    "hits": sum(t.hits for t in self._tenants.values()),
                    "misses": sum(t.misses for t in self._tenants.values()),
                    "evictions": sum(
                        t.evictions for t in self._tenants.values()
                    ),
                },
                "queue_depth": len(self._outstanding),
                "submitted": self._submitted,
                "completed": self._completed,
            }
        out["deadline_drops"] = snap.get("serve.deadline_drops", 0)
        out["captures"] = snap.get("torch.graph_captures", 0)
        out["replays"] = snap.get("torch.graph_replays", 0)
        out["eager_sweeps"] = snap.get("torch.eager_sweeps", 0)
        out["bucket_hits"] = snap.get("torch.bucket_hits", 0)
        out["bucket_misses"] = snap.get("torch.bucket_misses", 0)
        out["latency_ms"] = {
            name.split("serve.latency_ms.", 1)[1]: snap[name]
            for name in snap
            if name.startswith("serve.latency_ms.")
        }
        return out

    def close(self) -> None:
        """Drain the pool and reject further submits (idempotent)."""

        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------- #
# The process-default service (what the launch/serve demo client rides)
# ---------------------------------------------------------------------- #

_DEFAULT: Optional[PlanService] = None
_DEFAULT_LOCK = threading.Lock()


def default_service() -> PlanService:
    """The lazily created process-global service instance."""

    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = PlanService()
        return _DEFAULT


def reset_default_service() -> None:
    """Close and discard the default service (``obs.reset_all()`` hook —
    the next ``default_service()`` call starts cold)."""

    global _DEFAULT
    with _DEFAULT_LOCK:
        svc, _DEFAULT = _DEFAULT, None
    if svc is not None:
        svc.close()
