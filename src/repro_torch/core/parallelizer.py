"""End-to-end auto-parallelization pipeline (paper §5's four steps).

  1. build the dependence graph;
  2. pick a synchronization strategy (here: send/wait, per §4);
  3. insert synchronization for every loop-carried dependence;
  4. eliminate partial dependences and optimize the sync instructions.

The public surface is a *staged* pipeline mirroring that structure:

  * :class:`PlanOptions` — a frozen, validated, hashable bundle of the
    analysis knobs (``method``/``deps``/``merge_sends``/``chunk_limit``/
    ``scc_policy``/``model``/``processors``);
  * :func:`plan` — runs steps 1–4 exactly once and returns a
    :class:`SyncPlan`, the backend-independent artifact (dependences,
    fission, naive and optimized sync, elimination with witnesses, retained
    validation);
  * :meth:`SyncPlan.compile` — targets one registered backend, checking the
    requested options against the backend's *capability contract*
    (:attr:`BackendSpec.accepts`; unknown options raise ``ValueError``
    instead of being silently dropped) and consulting its cost hook
    (:attr:`BackendSpec.level_cost`) so the same plan can schedule
    differently per machine;
  * :class:`Executable` — a uniform ``run(store=None, stalls=None)`` /
    ``report()`` contract across threaded / wavefront / xla.

:func:`parallelize` survives as a thin compatibility shim over
``plan(...).compile(...).report()`` — bit-identical reports, same structural
compile-cache keys — and emits a ``DeprecationWarning`` so in-repo call
sites stay on the staged API (the fast CI job escalates that warning to an
error).

Execution backends are a *registry* (:func:`register_backend`), not a fixed
tuple: each :class:`BackendSpec` knows how to prepare backend-specific
artifacts at compile time and how to execute a SyncProgram for the
differential harness (``tests/oracle.py`` iterates every registered backend,
so a new backend is differentially tested with zero per-test changes).
Built-ins: ``threaded`` (the paper's send/wait machine), ``wavefront`` (the
NumPy level interpreter), and — loaded lazily from :mod:`repro_torch.compile` —
``xla`` (the structurally cached jitted level loop, whose
``level_cost`` hook models its near-flat narrow-band step cost).

Because steps 1–4 depend on the statement graph but not the loop bounds (the
elimination window is derived from dependence distances), the expensive
elimination result is memoized per (statement graph, lower bounds, deps,
method, execution model): repeated ``plan`` requests with the same structure
— the serving path re-planning its decode loop each batch wave — skip
re-analysis entirely.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import importlib
import threading
import warnings
from typing import (
    Callable,
    Dict,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import obs_summary
from repro_torch.obs import trace as _trace
from repro_torch.core.dependence import Dependence, analyze, loop_carried
from repro_torch.core.elimination import (
    EliminationResult,
    eliminate_pattern,
    eliminate_transitive,
)
from repro_torch.core.executor import run_threaded
from repro_torch.core.fission import FissionResult, fission
from repro_torch.core.ir import LoopProgram
from repro_torch.core.policy import LevelCostFn, SccPolicyLike, resolve_policy
from repro_torch.core.scc import validate_retained
from repro_torch.core.sync import SyncProgram, insert_synchronization, strip_dependences
from repro_torch.core.wavefront import (
    WavefrontSchedule,
    run_wavefront,
    schedule_wavefronts,
)


# ---------------------------------------------------------------------- #
# Backend registry
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One execution backend and its capability contract.

    ``prepare(optimized_sync, retained, **options)`` runs at compile time
    and returns extra artifacts (e.g. the wavefront schedule, the compiled
    XLA handle); ``options`` carries the scheduling knobs the caller passed
    through :meth:`SyncPlan.compile`.

    ``accepts`` is the backend's *declared* capability contract: the option
    names ``compile``/``parallelize`` may forward to ``prepare``.  A
    requested option outside the contract raises ``ValueError`` naming the
    backend and its accepted options — never a silent drop.  ``None`` means
    "infer from the prepare signature" (the legacy-registrant default: a
    ``prepare(optimized, retained)`` from before the knobs existed simply
    accepts nothing, and passing it a knob is now an error rather than a
    no-op).

    ``level_cost(plan, ctx) -> float`` is the backend's per-SCC cost hook:
    the scheduling policy engine's default cost model scores each strategy
    offer through it, so the same :class:`SyncPlan` can pick ``chunk`` on a
    machine with width-proportional step cost (xla) where an interpreter
    with per-level dispatch cost (wavefront) picks ``skew``.

    ``differential(sync, *, store, stalls=None)`` executes an arbitrary
    SyncProgram and returns its final store — the hook ``tests/oracle.py``
    uses to bit-compare every backend against the sequential oracle.
    ``run(sync, artifacts, *, store, stalls=None)`` is the
    :class:`Executable` runner: like ``differential`` but handed the
    prepared artifacts so warm executions reuse the schedule / compiled
    handle instead of re-planning.
    """

    name: str
    prepare: Optional[Callable[..., Dict[str, object]]] = None
    differential: Optional[Callable[..., Mapping[str, dict]]] = None
    description: str = ""
    accepts: Optional[Tuple[str, ...]] = None
    level_cost: Optional[LevelCostFn] = None
    run: Optional[Callable[..., Mapping[str, dict]]] = None


_REGISTRY: Dict[str, BackendSpec] = {}

# Backends that register themselves on first use (import side effect), so
# e.g. requesting "torch" does not cost a torch import until someone asks
# for it.
_LAZY_BACKENDS: Dict[str, str] = {
    "torch": "repro_torch.compile",
    "torch_spmd": "repro_torch.compile.spmd",
}


def register_backend(spec: BackendSpec) -> None:
    """Register (or replace) an execution backend under ``spec.name``."""

    _REGISTRY[spec.name] = spec


def registered_backends() -> Tuple[str, ...]:
    """All backend names, including lazy ones not yet imported."""

    return tuple(_REGISTRY) + tuple(
        n for n in _LAZY_BACKENDS if n not in _REGISTRY
    )


def get_backend(name: str) -> BackendSpec:
    """Resolve a backend spec, importing lazy providers on demand."""

    spec = _REGISTRY.get(name)
    if spec is None and name in _LAZY_BACKENDS:
        importlib.import_module(_LAZY_BACKENDS[name])
        spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {registered_backends()}"
        )
    return spec


def execution_backends() -> Dict[str, BackendSpec]:
    """Name → spec for every backend with a differential runner (resolves
    lazy providers) — the iteration surface of ``tests/oracle.py``."""

    for name in registered_backends():
        get_backend(name)
    return {
        name: spec
        for name, spec in _REGISTRY.items()
        if spec.differential is not None
    }


def backend_accepted_options(spec: BackendSpec) -> Optional[Tuple[str, ...]]:
    """The backend's effective capability contract.

    The declared :attr:`BackendSpec.accepts` wins; specs without a
    declaration fall back to reflecting the ``prepare`` signature (a legacy
    registrant's ``prepare(optimized, retained)`` accepts nothing; a
    ``**kwargs`` prepare accepts everything, signalled as ``None``).
    """

    if spec.accepts is not None:
        return tuple(spec.accepts)
    if spec.prepare is None:
        return ()
    inferred = _accepted_option_names(spec.prepare)
    if inferred is None:
        return None  # **kwargs / un-inspectable: accepts everything
    return tuple(sorted(inferred))


@functools.lru_cache(maxsize=64)
def _accepted_option_names(
    prepare: Callable[..., Dict[str, object]]
) -> Optional[frozenset]:
    """Option names a ``prepare`` without a declared contract can receive.

    ``None`` = accepts everything (``**kwargs`` or un-inspectable).  The
    first two positional parameters are the pipeline artifacts (optimized
    sync, retained deps), not options, whatever the registrant named them.
    """

    import inspect

    try:
        params = list(inspect.signature(prepare).parameters.values())
    except (TypeError, ValueError):  # C callables etc.: assume modern
        return None
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return None
    names = []
    positional_seen = 0
    for p in params:
        if (
            p.kind
            in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
            )
            and positional_seen < 2
        ):
            positional_seen += 1
            continue
        if p.kind is inspect.Parameter.VAR_POSITIONAL:
            continue
        names.append(p.name)
    return frozenset(names)


def _check_backend_options(
    spec: BackendSpec, options: Mapping[str, object]
) -> None:
    """Enforce the capability contract: unknown options are an error.

    This replaces the old silent ``_accepted_options`` filter — e.g.
    ``chunk_limit`` on ``backend="threaded"`` used to do nothing without a
    word; now it raises naming the backend and its accepted options.
    """

    accepted = backend_accepted_options(spec)
    if accepted is None:
        return
    unknown = sorted(k for k in options if k not in accepted)
    if unknown:
        raise ValueError(
            f"backend {spec.name!r} does not accept option(s) "
            f"{', '.join(repr(k) for k in unknown)}; its capability "
            f"contract accepts {sorted(accepted) if accepted else 'no options'}"
            " — drop the option or compile for a backend that declares it"
        )


# ---------------------------------------------------------------------- #
# Option validation (shared by PlanOptions and SyncPlan.compile)
# ---------------------------------------------------------------------- #

ELIMINATION_METHODS = ("isd", "pattern", "both", "none")
EXECUTION_MODELS = ("doall", "dswp", "procmap")

# runtime dependence-resolution modes for non-affine (indirect) accesses:
# "inspect" schedules from the exact inspector instance graph; "speculate"
# runs doall-optimistic first and rolls back on a post-hoc validation failure
DEPS_MODES = ("inspect", "speculate")

# the scheduling knobs a PlanOptions forwards to ``prepare`` at compile time
SCHEDULING_OPTION_NAMES = (
    "chunk_limit",
    "scc_policy",
    "model",
    "processors",
    "deps",
)


def _validate_chunk_limit(chunk_limit: object) -> None:
    if chunk_limit is not None and (
        not isinstance(chunk_limit, int)
        or isinstance(chunk_limit, bool)
        or chunk_limit < 1
    ):
        raise ValueError(
            f"chunk_limit must be a positive integer or None, got "
            f"{chunk_limit!r} — a chunk of zero iterations cannot make "
            "progress (use chunk_limit=1 for fully sequential chunks)"
        )


def _validate_scheduling_options(options: Mapping[str, object]) -> None:
    """Value-validate the scheduling knobs (names are contract-checked
    separately, per backend)."""

    if "chunk_limit" in options:
        _validate_chunk_limit(options["chunk_limit"])
    if "scc_policy" in options:
        resolve_policy(options["scc_policy"])  # raises with allowed values
    if "model" in options and options["model"] not in EXECUTION_MODELS:
        raise ValueError(
            f"unknown execution model {options['model']!r}; expected one of "
            f"{EXECUTION_MODELS}"
        )
    if "deps" in options and options["deps"] not in DEPS_MODES:
        raise ValueError(
            f"unknown deps mode {options['deps']!r}; expected one of "
            f"{DEPS_MODES}"
        )


# ---------------------------------------------------------------------- #
# PlanOptions: the frozen, validated, hashable analysis configuration
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class PlanOptions:
    """Typed options of the analysis stage (:func:`plan`).

    Frozen and hashable so a plan request is a legitimate cache key;
    validated eagerly in ``__post_init__`` so a bad knob fails at
    construction with a clear message, not deep inside a scheduler.

    ``method``: ``"isd"`` (transitive reduction), ``"pattern"`` (Li &
    Abu-Sufah matching), ``"both"`` (pattern first — cheap — then ISD on the
    survivors), or ``"none"`` (naive synchronization only).
    ``deps``: explicit dependences; ``None`` runs the analyzer; the strings
    ``"inspect"``/``"speculate"`` also run the analyzer but additionally
    forward a runtime dependence-resolution mode for non-affine accesses to
    the backend — ``"inspect"`` schedules from the exact inspector instance
    graph (:mod:`repro_torch.core.inspector`), ``"speculate"`` runs the
    doall-optimistic schedule and rolls back to the conservative one when
    post-hoc validation against the inspector graph fails.  On programs
    without indirect accesses both modes degrade to the conservative plan.
    ``merge_sends``: merge compatible sends during optimized insertion.
    ``chunk_limit``/``scc_policy``: recurrence-SCC scheduling knobs,
    forwarded at compile time to backends whose capability contract accepts
    them.  ``model``/``processors``: the execution model the elimination
    (and later scheduling) assumes — ``"procmap"`` is how the Pallas K-loop
    plan expresses its explicit two-processor pipeline.
    """

    method: str = "isd"
    deps: Union[None, str, Tuple[Dependence, ...]] = None
    merge_sends: bool = False
    chunk_limit: Optional[int] = None
    scc_policy: SccPolicyLike = None
    model: str = "doall"
    processors: Optional[Tuple[Tuple[str, object], ...]] = None

    def __post_init__(self) -> None:
        if isinstance(self.deps, str):
            if self.deps not in DEPS_MODES:
                raise ValueError(
                    f"unknown deps mode {self.deps!r}; expected one of "
                    f"{DEPS_MODES} (or an explicit dependence sequence)"
                )
        elif self.deps is not None:
            object.__setattr__(self, "deps", tuple(self.deps))
        if isinstance(self.processors, Mapping):
            object.__setattr__(
                self, "processors", tuple(sorted(self.processors.items()))
            )
        elif self.processors is not None:
            object.__setattr__(self, "processors", tuple(self.processors))
        if self.method not in ELIMINATION_METHODS:
            raise ValueError(
                f"unknown elimination method {self.method!r}; expected one "
                f"of {ELIMINATION_METHODS}"
            )
        _validate_chunk_limit(self.chunk_limit)
        resolve_policy(self.scc_policy)  # raises with the allowed values
        if self.model not in EXECUTION_MODELS:
            raise ValueError(
                f"unknown execution model {self.model!r}; expected one of "
                f"{EXECUTION_MODELS}"
            )
        if self.model == "procmap" and not self.processors:
            raise ValueError(
                "model='procmap' requires a processors mapping "
                "(statement name -> processor id)"
            )
        if self.model == "doall" and self.processors:
            raise ValueError(
                "processors only make sense under model='procmap'"
            )
        if self.model != "doall" and self.method in ("pattern", "both"):
            raise ValueError(
                f"method={self.method!r} implements the doall pattern "
                "matcher only; use method='isd' for non-doall models"
            )

    # ------------------------------------------------------------------ #
    @property
    def processor_map(self) -> Optional[Dict[str, object]]:
        return dict(self.processors) if self.processors else None

    def scheduling_options(self) -> Dict[str, object]:
        """The non-default scheduling knobs to forward at compile time."""

        out: Dict[str, object] = {}
        if self.chunk_limit is not None:
            out["chunk_limit"] = self.chunk_limit
        if self.scc_policy is not None:
            out["scc_policy"] = self.scc_policy
        if self.model != "doall":
            out["model"] = self.model
        if self.processors:
            out["processors"] = self.processor_map
        if isinstance(self.deps, str):
            out["deps"] = self.deps
        return out


# ---------------------------------------------------------------------- #
# Bounds-free analysis memo
# ---------------------------------------------------------------------- #

# bounded like the compile caches: a long-running server with varying
# request structures must not accumulate elimination results forever (and
# locked like them — concurrent serving threads share this memo)
_ANALYSIS_MEMO: "collections.OrderedDict[Tuple, EliminationResult]" = (
    collections.OrderedDict()
)
_ANALYSIS_MEMO_MAX = 256
_ANALYSIS_LOCK = threading.Lock()
# registry-backed (repro_torch.obs.metrics): the unified registry owns the
# counters; this module keeps direct references for lock-free-looking
# increments and analysis_cache_stats() stays a thin view with the exact
# pre-registry return shape
_ANALYSIS_HITS = _metrics.counter("analysis_cache.hits")
_ANALYSIS_MISSES = _metrics.counter("analysis_cache.misses")


def analysis_cache_stats() -> Dict[str, int]:
    return {"hits": _ANALYSIS_HITS.value, "misses": _ANALYSIS_MISSES.value}


def clear_analysis_cache() -> None:
    with _ANALYSIS_LOCK:
        _ANALYSIS_MEMO.clear()
    _ANALYSIS_HITS.reset()
    _ANALYSIS_MISSES.reset()


def _eliminate(
    prog: LoopProgram,
    dep_list: Sequence[Dependence],
    method: str,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
) -> EliminationResult:
    # Non-affine proxies carry an unknown true distance: they can neither be
    # eliminated (a Δ=1 proxy does not prove the runtime distance is
    # covered) nor serve as covering edges for affine dependences (a
    # covering path through a proxy may not exist at runtime under
    # deps="inspect", where proxies are replaced by exact instance edges).
    # They bypass the algorithms and rejoin the retained set afterwards.
    nonaffine = tuple(d for d in dep_list if d.nonaffine)
    affine = [d for d in dep_list if not d.nonaffine]

    def _with_nonaffine(base: EliminationResult) -> EliminationResult:
        if not nonaffine:
            return base
        from repro_torch.core.elimination import synchronized_set

        extra = tuple(synchronized_set(nonaffine, model, processors))
        return EliminationResult(
            retained=base.retained + extra,
            eliminated=base.eliminated,
            witnesses=base.witnesses,
            method=base.method,
        )

    if method == "none":
        return _with_nonaffine(
            EliminationResult(
                retained=tuple(loop_carried(affine)),
                eliminated=(),
                witnesses={},
                method="none",
            )
        )
    if method == "isd":
        return _with_nonaffine(
            eliminate_transitive(prog, affine, model=model, processors=processors)
        )
    if method == "pattern":
        return _with_nonaffine(eliminate_pattern(prog, affine))
    if method == "both":
        first = eliminate_pattern(prog, affine)
        second = eliminate_transitive(prog, list(first.retained))
        return _with_nonaffine(
            EliminationResult(
                retained=second.retained,
                eliminated=first.eliminated + second.eliminated,
                witnesses=second.witnesses,
                method="pattern+isd",
            )
        )
    raise ValueError(f"unknown elimination method: {method!r}")


def _memoized_eliminate(
    prog: LoopProgram,
    dep_list: Sequence[Dependence],
    method: str,
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
) -> EliminationResult:
    """Elimination keyed by (statement graph, lower bounds, deps, method,
    execution model).

    The ISD window is derived from dependence distances and anchored at the
    loop *lower* bounds, so the result — including witness paths — is
    invariant under any change of the upper bounds (iteration count).
    """

    from repro_torch.compile.structure import program_fingerprint

    key = (
        program_fingerprint(prog),
        tuple(lo for lo, _hi in prog.bounds),
        method,
        tuple(dep_list),
        model,
        tuple(sorted(processors.items())) if processors else None,
    )
    with _ANALYSIS_LOCK:
        hit = _ANALYSIS_MEMO.get(key)
        if hit is not None:
            _ANALYSIS_MEMO.move_to_end(key)
    if hit is not None:
        _ANALYSIS_HITS.inc()
        return hit
    elim = _eliminate(prog, dep_list, method, model, processors)
    with _ANALYSIS_LOCK:
        _ANALYSIS_MEMO[key] = elim
        while len(_ANALYSIS_MEMO) > _ANALYSIS_MEMO_MAX:
            _ANALYSIS_MEMO.popitem(last=False)
    _ANALYSIS_MISSES.inc()
    return elim


# ---------------------------------------------------------------------- #
# Report
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ParallelizationReport:
    program: LoopProgram
    dependences: Tuple[Dependence, ...]
    fission: FissionResult
    naive_sync: SyncProgram
    elimination: EliminationResult
    optimized_sync: SyncProgram
    backend: str = "threaded"
    # level schedule of the optimized sync program (backend="wavefront" only)
    wavefront: Optional[WavefrontSchedule] = None
    # structural-cache artifact (backend="xla" only): repro_torch.compile handle
    compiled: Optional[object] = None
    # scheduling knobs this report was planned under (echoed into the
    # statement-level SCC summary for backends without a schedule)
    chunk_limit: Optional[int] = None
    scc_policy: SccPolicyLike = None
    # execution model the plan assumed (procmap nests carry the map too)
    model: str = "doall"
    processors: Optional[Dict[str, object]] = None

    @functools.cached_property
    def _statement_scc_summary(self) -> dict:
        """SCC partition + strategy records for backends without a schedule.

        Cached on the report: the cost model's exact-depth estimates make a
        fresh ``analyze_sccs`` of a recurrence-bearing program an
        O(instances) pass, too heavy to redo on every ``summary()`` call
        (cached_property writes to ``__dict__``, which a frozen dataclass
        permits — same pattern as WavefrontSchedule's cached stats).

        Strategy records reflect the report's *backend*: its ``level_cost``
        capability hook feeds the cost model, so an xla report shows the
        strategy the compiled artifact actually schedules.
        """

        from repro_torch.core.scc import analyze_sccs

        try:
            hook = get_backend(self.backend).level_cost
        except ValueError:  # backend since unregistered: interpreter model
            hook = None
        return analyze_sccs(
            self.program,
            self.elimination.retained,
            model=self.model,
            processors=self.processors,
            chunk_limit=self.chunk_limit,
            scc_policy=self.scc_policy,
            level_cost=hook,
        ).summary()

    def summary(self) -> dict:
        naive = self.naive_sync.sync_instruction_count()
        opt = self.optimized_sync.sync_instruction_count()
        out = {
            "dependences": len(self.dependences),
            "loop_carried": len(loop_carried(self.dependences)),
            "eliminated": len(self.elimination.eliminated),
            "naive_sync_instructions": naive["total"],
            "optimized_sync_instructions": opt["total"],
            "naive_runtime_sync_ops": self.naive_sync.runtime_sync_ops(),
            "optimized_runtime_sync_ops": self.optimized_sync.runtime_sync_ops(),
            "method": self.elimination.method,
            "backend": self.backend,
        }
        if self.wavefront is not None and self.wavefront.scc is not None:
            out["scc"] = self.wavefront.scc.summary()
        else:
            # deep copy: the cached dict must not be mutable through the
            # return value, or one caller's annotation would leak into
            # every later summary() of this report
            out["scc"] = copy.deepcopy(self._statement_scc_summary)
        if self.wavefront is not None:
            out["wavefront_depth"] = self.wavefront.depth
            out["wavefront_batched_ops"] = self.wavefront.batched_ops
        if self.compiled is not None:
            out["compile_key"] = self.compiled.key[:16]
            out["compile_cache"] = self.compiled.cache_stats()
        # observability pointers (repro_torch.obs): deliberately free of live
        # counter values so equal plans summarize identically regardless of
        # what else ran in between (shim/staged bit-identity)
        out["obs"] = obs_summary(self.backend)
        return out


# artifacts a backend's prepare() may contribute to the report; anything
# else it returns stays on Executable.artifacts (e.g. xla's compile_hit)
_REPORT_ARTIFACT_FIELDS = ("wavefront", "compiled")


# ---------------------------------------------------------------------- #
# The staged pipeline: plan -> SyncPlan -> compile -> Executable
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """The backend-independent analysis artifact of :func:`plan`.

    Holds everything steps 1–4 produced — computed exactly once, however
    many backends the plan is later compiled for.  ``compile`` never re-runs
    dependence analysis or elimination; it only schedules/lowers.
    """

    program: LoopProgram
    options: PlanOptions
    dependences: Tuple[Dependence, ...]
    fission: FissionResult
    naive_sync: SyncProgram
    elimination: EliminationResult
    optimized_sync: SyncProgram

    @property
    def retained(self) -> Tuple[Dependence, ...]:
        """The synchronized dependences the optimized program enforces."""

        return tuple(self.elimination.retained)

    def compile(self, backend: str = "threaded", **backend_options) -> "Executable":
        """Target one registered backend; returns an :class:`Executable`.

        The effective options are the plan's scheduling knobs
        (:meth:`PlanOptions.scheduling_options`) overlaid with
        ``backend_options`` (an explicit ``None`` override removes a plan
        knob).  Every effective option must be in the backend's capability
        contract (:func:`backend_accepted_options`) — unknown options raise
        ``ValueError`` naming the backend and its accepted options.
        """

        spec = get_backend(backend)
        options = self.options.scheduling_options()
        options.update(backend_options)
        # contract-check the NAMES first, None-valued overrides included —
        # a misspelled knob must error even when its value is None; only
        # then does an explicit None override remove a plan-level knob
        _check_backend_options(spec, options)
        options = {k: v for k, v in options.items() if v is not None}
        _validate_scheduling_options(options)
        artifacts: Dict[str, object] = {}
        if spec.prepare:
            with _trace.span("compile", backend=backend):
                artifacts = dict(
                    spec.prepare(
                        self.optimized_sync, self.elimination.retained, **options
                    )
                )
        return Executable(
            plan=self,
            backend=backend,
            options=tuple(sorted(options.items(), key=lambda kv: kv[0])),
            artifacts=artifacts,
        )

    def summary(self) -> dict:
        """Backend-independent plan summary (sync counts, elimination)."""

        naive = self.naive_sync.sync_instruction_count()
        opt = self.optimized_sync.sync_instruction_count()
        return {
            "dependences": len(self.dependences),
            "loop_carried": len(loop_carried(self.dependences)),
            "eliminated": len(self.elimination.eliminated),
            "retained": len(self.elimination.retained),
            "naive_sync_instructions": naive["total"],
            "optimized_sync_instructions": opt["total"],
            "method": self.elimination.method,
        }


@dataclasses.dataclass(frozen=True)
class Executable:
    """One backend's compiled form of a :class:`SyncPlan`.

    ``run(store=None, stalls=None)`` executes the optimized program and
    returns its final store — the same contract on every backend (``stalls``
    inject adversarial delays on the threaded machine; the deterministic
    backends accept and ignore them, exactly like the differential hooks
    always have).  ``report()`` yields the familiar
    :class:`ParallelizationReport`.
    """

    plan: SyncPlan
    backend: str
    options: Tuple[Tuple[str, object], ...]
    artifacts: Mapping[str, object]

    def run(
        self,
        store: Optional[Mapping[str, dict]] = None,
        stalls: Optional[Mapping] = None,
    ) -> dict:
        spec = get_backend(self.backend)
        _metrics.counter(f"backend.runs.{self.backend}").inc()
        with _trace.span("run", backend=self.backend):
            if spec.run is not None:
                return spec.run(
                    self.plan.optimized_sync,
                    dict(self.artifacts),
                    store=store,
                    stalls=stalls,
                )
            if spec.differential is not None:
                return spec.differential(
                    self.plan.optimized_sync, store=store, stalls=stalls
                )
        raise ValueError(
            f"backend {self.backend!r} registers neither a run nor a "
            "differential hook — it cannot execute programs"
        )

    def trace_json(self, indent: Optional[int] = None) -> str:
        """The buffered span events as Chrome-trace JSON (see
        :mod:`repro_torch.obs.trace`; empty unless tracing was enabled around the
        plan/compile/run calls)."""

        return _trace.trace_json(indent=indent)

    # convenience views over the prepared artifacts ---------------------- #
    @property
    def wavefront(self) -> Optional[WavefrontSchedule]:
        return self.artifacts.get("wavefront")

    @property
    def compiled(self) -> Optional[object]:
        return self.artifacts.get("compiled")

    @functools.cached_property
    def _report(self) -> ParallelizationReport:
        opts = dict(self.options)
        extra = {
            k: self.artifacts[k]
            for k in _REPORT_ARTIFACT_FIELDS
            if k in self.artifacts
        }
        return ParallelizationReport(
            program=self.plan.program,
            dependences=self.plan.dependences,
            fission=self.plan.fission,
            naive_sync=self.plan.naive_sync,
            elimination=self.plan.elimination,
            optimized_sync=self.plan.optimized_sync,
            backend=self.backend,
            chunk_limit=opts.get("chunk_limit"),
            scc_policy=opts.get("scc_policy"),
            model=opts.get("model", "doall"),
            processors=opts.get("processors"),
            **extra,
        )

    def report(self) -> ParallelizationReport:
        return self._report


def plan(
    prog: LoopProgram,
    options: Optional[PlanOptions] = None,
    **overrides,
) -> SyncPlan:
    """Run the backend-independent §5 analysis exactly once.

    ``options`` is a :class:`PlanOptions`; as a convenience, keyword
    arguments build one (``plan(prog, method="both")``) — but not both at
    once.  The pipeline: dependence analysis (or the caller's ``deps``),
    fission, naive synchronization insertion, memoized elimination,
    retained-set validation (unschedulable sets raise
    :class:`~repro_torch.core.wavefront.WavefrontError` here, with the offending
    SCC and a witness cycle — before any backend is involved), and the
    optimized sync program.
    """

    if options is None:
        options = PlanOptions(**overrides)
    elif overrides:
        raise TypeError(
            "pass either a PlanOptions or keyword options, not both "
            f"(got options={options!r} plus {sorted(overrides)})"
        )

    with _trace.span("plan", method=options.method, statements=len(prog.statements)):
        with _trace.span("plan.deps"):
            dep_list = (
                list(options.deps)
                if options.deps is not None and not isinstance(options.deps, str)
                else analyze(prog)
            )
        with _trace.span("plan.fission"):
            fiss = fission(prog, dep_list)
        with _trace.span("plan.naive_sync"):
            naive = insert_synchronization(prog, dep_list, merge=False)

        with _trace.span("plan.elimination"):
            elim = _memoized_eliminate(
                prog,
                dep_list,
                options.method,
                options.model,
                options.processor_map,
            )

        # Genuinely unschedulable retained sets (lexicographically negative /
        # backward-zero distances — a cyclic Δ-sign mix no machine can honor)
        # fail HERE, at plan time, for every backend: the threaded machine
        # would deadlock mid-execution and the schedulers would reject later
        # with less context.  repro_torch.core.scc raises with the offending SCC's
        # statements and a witness cycle (and bumps the
        # plan.wavefront_rejections counter).
        with _trace.span("plan.validate"):
            validate_retained(prog, elim.retained)

        with _trace.span("plan.optimize"):
            optimized = strip_dependences(naive, elim.eliminated)
            if options.merge_sends:
                optimized = insert_synchronization(
                    prog, list(elim.retained), merge=True
                )
    return SyncPlan(
        program=prog,
        options=options,
        dependences=tuple(dep_list),
        fission=fiss,
        naive_sync=naive,
        elimination=elim,
        optimized_sync=optimized,
    )


# ---------------------------------------------------------------------- #
# Built-in backends
# ---------------------------------------------------------------------- #

register_backend(
    BackendSpec(
        name="threaded",
        prepare=None,
        # the paper's machine takes no scheduling knobs; it accepts the
        # "deps" mode as a documented no-op — its conservative send/wait
        # execution enforces a superset of any inspector graph, so it is the
        # semantics every inspect/speculate schedule must reproduce
        accepts=("deps",),
        differential=lambda sync, *, store=None, stalls=None: run_threaded(
            sync, stalls=stalls, store=store, compare=False
        ).store,
        run=lambda sync, artifacts, *, store=None, stalls=None: run_threaded(
            sync, stalls=stalls, store=store, compare=False
        ).store,
        description="one thread per iteration, send/wait only (the paper's machine)",
    )
)


def _wavefront_prepare(
    optimized,
    retained,
    *,
    chunk_limit=None,
    scc_policy=None,
    model="doall",
    processors=None,
    deps=None,
):
    artifacts: Dict[str, object] = {
        "wavefront": schedule_wavefronts(
            optimized,
            list(retained),
            model=model,
            processors=processors,
            chunk_limit=chunk_limit,
            scc_policy=scc_policy,
        )
    }
    if deps is not None and optimized.program.has_indirect():
        from repro_torch.core.inspector import affine_retained

        # the exact instance graph is store-dependent — run() builds the
        # final schedule; prepare records the mode, the knobs and (for
        # speculation) the store-independent optimistic schedule
        artifacts["deps_mode"] = deps
        artifacts["retained"] = tuple(retained)
        artifacts["sched_options"] = {
            "chunk_limit": chunk_limit,
            "scc_policy": scc_policy,
            "model": model,
            "processors": processors,
        }
        if deps == "speculate":
            artifacts["speculative"] = schedule_wavefronts(
                optimized,
                list(affine_retained(retained)),
                model=model,
                processors=processors,
                chunk_limit=chunk_limit,
                scc_policy=scc_policy,
            )
    return artifacts


def _wavefront_run(sync, artifacts, *, store=None, stalls=None):
    mode = artifacts.get("deps_mode")
    if mode is None:
        return run_wavefront(
            sync, schedule=artifacts.get("wavefront"), store=store, compare=False
        ).store

    from repro_torch.core.inspector import (
        affine_retained,
        inspect_dependences,
        speculation_violations,
    )
    from repro_torch.core.wavefront import schedule_levels

    prog = sync.program
    init = {a: dict(c) for a, c in (store or prog.initial_store()).items()}
    inspection = inspect_dependences(prog, init)
    opts = artifacts.get("sched_options") or {}
    if mode == "speculate":
        speculative = artifacts["speculative"]
        out = run_wavefront(
            sync, schedule=speculative, store=init, compare=False
        )
        _metrics.counter("speculation.validations").inc()
        with _trace.span("speculate.validate", backend="wavefront"):
            ok = not speculation_violations(
                prog, inspection.edges, speculative.level_of()
            )
        if ok:
            return out.store
        # rollback: the speculative result is discarded; re-execute the
        # conservative hybrid schedule from the untouched initial image
        _metrics.counter("speculation.rollbacks").inc()
        with _trace.span("speculate.rollback", backend="wavefront"):
            return run_wavefront(
                sync, schedule=artifacts["wavefront"], store=init, compare=False
            ).store
    # mode == "inspect": exact per-store schedule — conservative proxies
    # replaced by the inspector's instance edges
    exact = schedule_levels(
        prog,
        list(affine_retained(artifacts["retained"])),
        model=opts.get("model", "doall"),
        processors=opts.get("processors"),
        chunk_limit=opts.get("chunk_limit"),
        scc_policy=opts.get("scc_policy"),
        instance_edges=inspection.edges,
    )
    return run_wavefront(sync, schedule=exact, store=init, compare=False).store


register_backend(
    BackendSpec(
        name="wavefront",
        prepare=_wavefront_prepare,
        accepts=("chunk_limit", "scc_policy", "model", "processors", "deps"),
        differential=lambda sync, *, store=None, stalls=None: run_wavefront(
            sync, store=store, compare=False
        ).store,
        run=_wavefront_run,
        description="NumPy dependence-level interpreter (O(depth) batched steps)",
    )
)


# ---------------------------------------------------------------------- #
# Compatibility shim
# ---------------------------------------------------------------------- #

def parallelize(
    prog: LoopProgram,
    *,
    method: str = "isd",
    deps: Optional[Sequence[Dependence]] = None,
    merge_sends: bool = False,
    backend: str = "threaded",
    chunk_limit: Optional[int] = None,
    scc_policy: SccPolicyLike = None,
) -> ParallelizationReport:
    """One-shot shim over ``plan(...).compile(backend).report()``.

    Kept for source compatibility: reports are bit-identical to the staged
    pipeline's (it *is* the staged pipeline) and structural compile-cache
    keys are unchanged, so a warm artifact is shared across both entry
    points.  New code should stage explicitly — the plan is computed once
    and can be compiled for several backends::

        p = plan(prog, PlanOptions(method="isd"))
        schedule = p.compile("wavefront").report().wavefront
        store    = p.compile("xla").run()

    Note the capability contract applies here too: a scheduling knob the
    target backend does not declare (e.g. ``chunk_limit`` with
    ``backend="threaded"``) raises ``ValueError`` instead of being silently
    dropped.
    """

    warnings.warn(
        "parallelize() is deprecated in favor of the staged API: "
        "plan(prog, PlanOptions(...)).compile(backend).report() "
        "(one analysis, any number of backends)",
        DeprecationWarning,
        stacklevel=2,
    )
    options = PlanOptions(
        method=method,
        deps=tuple(deps) if deps is not None else None,
        merge_sends=merge_sends,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
    )
    return plan(prog, options).compile(backend).report()
