"""PyTorch lowering of a wavefront schedule: the ``"torch"`` backend's level
loop on one device, captured as one CUDA graph per prepared case.

The reference package compiles the level loop into one jitted XLA
computation.  This module keeps that lowering's *host half* unchanged —
the padded, mask-guarded level tables, the segment skeleton (wave segments
and recurrence bands), the width-ladder cut points and the pow2 bucket —
so a prepared case here holds exactly the reference's tables.  The *device
half* is new:

  * every array of the memory image becomes one flat ``float64`` tensor on
    the device with a *trash cell* appended past the live data — masked-out
    lanes scatter there, so padding never corrupts the store (the only
    duplicate scatter indices are the trash cell's);
  * sparse stores carry ``bool`` coverage tensors; index tables are
    ``int64`` device tensors, moved once per prepared case;
  * levels are driven from the host.  The NumPy tables already say which
    statement groups are active at each level, so the host expands the
    segment skeleton once per case into a launch list of (statement, table
    row, lane cap) steps: wave segments walk their per-statement cursors,
    recurrence bands run their chunk loop with the width-ladder lane caps.
    Only active groups launch; there is no per-level ``cond``;
  * each step is a gather / compute / scatter of single PyTorch ops, so
    every IEEE op rounds on its own, as the sequential oracle does.  The
    out-of-box and uninitialized-read flags stay on the device and are read
    once, after the sweep, raising the reference's ``KeyError`` messages;
  * on CUDA a prepared case's first run is an eager sweep; its second
    records the whole launch list once as a ``torch.cuda.CUDAGraph`` over
    static store / coverage buffers, and every run from then on replays it
    by one host call — the port's counterpart of the reference's jit trace
    (:meth:`CompiledProgram.execute`).  Bounds that run once so pay nothing
    for the capture, which on an H100 took from a few ms (69 group steps)
    to about a second (Alg. 6 at 1025, 2049 group steps), up to several
    eager sweeps of the same case (PERF.md).  The graph is per case, not per
    bucket: the launch list depends on each bounds' level count and segment
    scalars.  On the CPU the sweep stays eager.

The device is a per-call choice, never part of the structural key: one
artifact serves every device, and the device joins the per-bounds case key
(:meth:`CompiledProgram._case_key_extra`) through :func:`device_scope`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.core.dependence import Dependence
from repro_torch.core.ir import LoopProgram, is_indirect
from repro_torch.core.policy import SccPolicyLike
from repro_torch.core.wavefront import (
    WavefrontSchedule,
    WavefrontStats,
    _DenseStore,
    schedule_levels,
)


class TorchLoweringError(ValueError):
    """The program cannot be lowered to the device loop (e.g. a compute fn
    that neither the lane proxy nor ``torch.func.vmap`` can evaluate)."""


# one rounding convention for table padding AND the cost model's padded-lane
# estimate (repro_torch.compile.torch_level_cost) — they must never drift
from repro_torch.compile import _next_pow2  # noqa: E402


# Width ladder for recurrence bands: a band's ramp-up and ramp-down levels
# run at sliced lane widths — halvings of the padded band width, at most
# WIDTH_LADDER_RUNGS of them, never narrower than WIDTH_LADDER_MIN lanes.
# Read late, so a benchmark can pin ``lowering.WIDTH_LADDER_RUNGS = 0``.
WIDTH_LADDER_RUNGS = 3
WIDTH_LADDER_MIN = 8


# ---------------------------------------------------------------------- #
# Devices.  An entry point names its device; the run wrappers install it
# for the duration of one call, so the verbatim executor and cache modules
# (which know nothing of devices) still route every prepare/execute — the
# speculate rollback included — to the caller's device.
# ---------------------------------------------------------------------- #

_DEVICE: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "repro_torch_device", default=None
)


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; ``"cuda"`` without a card raises —
    nothing falls back to the CPU unless the caller asks for it."""

    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"unsupported device {str(device)!r}; expected 'cuda' or 'cpu'"
        )
    return dev


@contextlib.contextmanager
def device_scope(device="cuda"):
    """Run the enclosed prepare/execute calls on ``device``."""

    token = _DEVICE.set(resolve_device(device))
    try:
        yield
    finally:
        _DEVICE.reset(token)


def current_device():
    """The device of the enclosing :func:`device_scope` (``"cuda"`` when
    none is open)."""

    dev = _DEVICE.get()
    return dev if dev is not None else resolve_device("cuda")


# ---------------------------------------------------------------------- #
# Strict lane arithmetic.  Eager PyTorch rounds every op on its own, so the
# reference's xor laundering (against XLA's FMA contraction) has no job
# here.  Three hazards remain, and the lane proxy handles them:
#
#  * A division-family op (/ // %) with a Python-number operand: CUDA's
#    true-division kernel turns a CPU-scalar divisor into a multiply by its
#    reciprocal, and ``number / tensor`` is ``reciprocal(t) * number`` —
#    neither is correctly rounded.  The number becomes a float64 tensor on
#    the lane's device, so the kernel performs a true IEEE division.
#  * ``**``: the oracle's ``float ** float`` is libm's ``pow``, and neither
#    PyTorch's CPU nor its CUDA ``pow`` gives the same last bit.  Every
#    ``**`` of a lane goes through :func:`host_pow`, which copies the
#    operands to the host and applies Python's ``**`` to each live lane (a
#    fixed rule for one operator, counted by ``torch.host_pow_lanes``).
#    The ``vmap`` fallback refuses ``**`` rather than reach ``torch.pow``.
#  * ``if lane:`` would take one branch for every lane: ``__bool__``
#    raises, which routes the compute to the ``torch.func.vmap`` fallback,
#    where a value branch fails loudly as well.
# ---------------------------------------------------------------------- #

# The live-lane mask of the statement step being computed (None: every
# lane is live); host_pow gives the other lanes a safe base.
_LIVE: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "repro_torch_live_lanes", default=None
)
# The warm-up sweep's mark (a one-element list, None outside a warm-up):
# _lane_pow sets it when a statement reaches host_pow.  Per sweep and per
# thread, unlike the process-wide torch.host_pow_lanes counter, which other
# worker threads move too.
_POW_MARK: "contextvars.ContextVar[Optional[List[bool]]]" = (
    contextvars.ContextVar("repro_torch_pow_mark", default=None)
)


class _LaneFailure(Exception):
    """A live lane's ``**`` failed; the compute re-raises ``error`` as the
    oracle would, instead of trying the ``vmap`` fallback."""

    def __init__(self, error: Exception) -> None:
        super().__init__(error)
        self.error = error


class _StrictLane:
    """Operator-intercepting wrapper around a lane vector."""

    __slots__ = ("x",)

    def __init__(self, x) -> None:
        self.x = x

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_StrictLane({self.x!r})"

    def __bool__(self) -> bool:
        raise TypeError(
            "compute fn branches on a lane vector's truth value; "
            "per-lane branching is not vectorizable — use arithmetic "
            "selects or run backend='wavefront'"
        )


def _unwrap(v):
    return v.x if isinstance(v, _StrictLane) else v


# Python-number divisors as device tensors, one per (bits, device), made
# once and never dropped: a captured graph reads them by address, so evicting
# one would leave the graph reading freed memory, and re-creating one under a
# later capture would be an illegal host-to-device copy.  The set is bounded
# by the divisors in the programs' compute fns.  The first tensor stored wins
# under the lock and is the one every caller gets, so two threads that miss
# together cannot leave a graph holding the loser's address.  The key is the
# value's bits (``float.hex``), so -0.0 is not 0.0 and NaN finds itself.
_SCALARS: Dict[Tuple[str, object], object] = {}
_SCALARS_LOCK = threading.Lock()


def _device_scalar(value: float, device):
    key = (float(value).hex(), device)
    t = _SCALARS.get(key)
    if t is None:
        import torch

        built = torch.tensor(value, dtype=torch.float64, device=device)
        with _SCALARS_LOCK:
            t = _SCALARS.setdefault(key, built)
    return t


def _arith(v):
    """An arithmetic operand: a comparison's bool lane counts as float64
    0.0 / 1.0, as Python's bool does (PyTorch would promote it to the
    default float32 against a Python float)."""

    import torch

    if isinstance(v, torch.Tensor) and v.dtype == torch.bool:
        return v.to(torch.float64)
    return v


def _strict_binop(op, swap: bool, device_operands: bool = False):
    def method(self, other):
        a, b = _arith(self.x), _arith(_unwrap(other))
        if device_operands and isinstance(b, (int, float)):
            b = _device_scalar(float(b), a.device)
        if swap:
            a, b = b, a
        return _StrictLane(op(a, b))

    return method


def _strict_unop(op):
    def method(self):
        return _StrictLane(op(_arith(self.x)))

    return method


def _install_strict_ops() -> None:
    import operator

    for name, op, device_operands in [
        ("add", operator.add, False),
        ("sub", operator.sub, False),
        ("mul", operator.mul, False),
        ("truediv", operator.truediv, True),
        ("floordiv", operator.floordiv, True),
        ("mod", operator.mod, True),
    ]:
        setattr(
            _StrictLane, f"__{name}__",
            _strict_binop(op, False, device_operands),
        )
        setattr(
            _StrictLane, f"__r{name}__",
            _strict_binop(op, True, device_operands),
        )
    _StrictLane.__pow__ = lambda self, other: _lane_pow(self, other)
    _StrictLane.__rpow__ = lambda self, other: _lane_pow(other, self)
    for name, op in [
        ("neg", operator.neg),
        ("pos", operator.pos),
        ("abs", operator.abs),
    ]:
        setattr(_StrictLane, f"__{name}__", _strict_unop(op))
    for name, op in [
        ("lt", operator.lt),
        ("le", operator.le),
        ("gt", operator.gt),
        ("ge", operator.ge),
        ("eq", operator.eq),  # value comparison, NOT python identity —
        ("ne", operator.ne),  # default object.__eq__ would be silently wrong
    ]:
        # a comparison stays a lane, so arithmetic on its result goes
        # through _arith and ``if lane > 0:`` raises like any lane
        setattr(
            _StrictLane,
            f"__{name}__",
            lambda self, other, op=op: _StrictLane(
                op(_unwrap(self), _unwrap(other))
            ),
        )


def host_pow(base, exp, live=None):
    """``base ** exp`` lane by lane, exactly as Python's ``float ** float``
    computes it (libm's ``pow``, as the sequential oracle does).

    ``base`` and ``exp`` are float64 tensors of one shape, or a tensor and a
    Python number; the result is a float64 tensor on the tensor's device.
    Lanes where the bool tensor ``live`` is False get base and exponent 1.0
    first, so padding and masked lanes can neither raise nor turn complex.
    A live lane raises what Python raises (``ZeroDivisionError`` for ``0.0
    ** -1``, ``OverflowError``); a complex result (a negative base to a
    fractional power) raises :class:`TorchLoweringError`, since the store
    holds float64.
    """

    import torch

    device = (base if isinstance(base, torch.Tensor) else exp).device
    b, e = torch.broadcast_tensors(
        torch.as_tensor(base, dtype=torch.float64, device=device),
        torch.as_tensor(exp, dtype=torch.float64, device=device),
    )
    n_live = b.numel()
    if live is not None:
        b = torch.where(live, b, 1.0)
        e = torch.where(live, e, 1.0)
        n_live = int(live.sum())
    _metrics.counter("torch.host_pow_lanes").inc(n_live)
    xs, ys = b.cpu().tolist(), e.cpu().tolist()
    if b.ndim == 0:
        xs, ys = [xs], [ys]
    out = [x ** y for x, y in zip(xs, ys)]
    for i, r in enumerate(out):
        if isinstance(r, complex):
            raise TorchLoweringError(
                f"lane {i}: {xs[i]!r} ** {ys[i]!r} is complex ({r!r}); the "
                "store holds float64"
            )
    return torch.tensor(out, dtype=torch.float64).reshape(b.shape).to(device)


def _lane_pow(base, exp):
    mark = _POW_MARK.get()
    if mark is not None:
        mark[0] = True
    a, b = _arith(_unwrap(base)), _arith(_unwrap(exp))
    try:
        return _StrictLane(host_pow(a, b, _LIVE.get()))
    except (ArithmeticError, TorchLoweringError) as e:
        raise _LaneFailure(e) from None


_POW_NAMES = frozenset(
    {"pow", "pow_", "__pow__", "__rpow__", "__ipow__", "float_power",
     "float_power_"}
)


@functools.lru_cache(maxsize=None)
def _no_pow_mode():
    """A ``TorchFunctionMode`` that refuses ``**`` inside the
    ``torch.func.vmap`` fallback: batched tensors cannot go to the host, and
    ``torch.pow`` would silently differ from the oracle."""

    from torch.overrides import TorchFunctionMode

    class NoPowMode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in _POW_NAMES:
                raise TorchLoweringError(
                    "'**' reached torch.pow in the vmap fallback; a compute "
                    "fn's '**' must act on its lane arguments (Python's ** "
                    "per lane) or run backend='wavefront'"
                )
            return func(*args, **(kwargs or {}))

    return NoPowMode


_install_strict_ops()


# ---------------------------------------------------------------------- #
# Case statics: everything (beyond table shapes) that changes the structure
# of the level sweep.  Kept field for field from the reference lowering so
# a prepared case's ``bucket`` compares equal to the reference's.
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class _StmtStatic:
    name: str
    write: str
    reads: Tuple[str, ...]
    guard: Optional[str]
    has_oob: bool                  # tables carry an "oob" lane mask to flag
    cov_reads: Tuple[bool, ...]    # per read: consult the coverage buffer
    cov_guard: bool
    cov_write: bool                # scatter updates the coverage buffer
    # narrow statements run every level with the active bit folded into the
    # lane mask (a handful of trash-redirected lanes) — cheaper than a
    # lax.cond, whose pass-through copies the write array at every level;
    # wide statements keep the cond so inactive levels don't pay their lanes
    use_cond: bool = True


@dataclasses.dataclass(frozen=True)
class _CaseStatic:
    stmts: Tuple[_StmtStatic, ...]
    # segmented level loop (hybrid schedules with recurrence SCCs only) as a
    # bounds-free *skeleton*:
    #   ("wave",)            — generic dispatcher segment
    #   ("rec", (k1, ...))   — nested fori_loop band running statements k1…
    # Every per-bounds scalar (segment extents, cursor bases, chunk counts,
    # band row bases) rides in ``PreparedCase.seg_dyn`` as a *traced* jit
    # argument instead, so two bounds whose skeleton and bucketed shapes
    # coincide share one trace — the "bucket" level of the cache hierarchy
    # (structure → bucket → trace → per-bounds tables).
    # None → the single traced-bound level loop (likewise shared across
    # bounds with equal bucketed shapes)
    segments: Optional[Tuple[Tuple, ...]] = None


@dataclasses.dataclass
class PreparedCase:
    """Per-(bounds, store layout) lowering artifacts: level tables + layout."""

    static: _CaseStatic
    n_levels: int
    tables: Tuple[Dict[str, np.ndarray], ...]   # per statement
    arrays: Tuple[str, ...]
    origin: Dict[str, Tuple[int, ...]]
    shapes: Dict[str, Tuple[int, ...]]
    flat_sizes: Dict[str, int]                  # live cells per array
    padded_sizes: Dict[str, int]                # flat buffer length (≥ live+1)
    sparse: Tuple[str, ...]                     # arrays carrying coverage
    schedule: WavefrontSchedule
    # per-segment dynamic scalars (see _CaseStatic.segments):
    #   wave → [lo, hi, cursors0…] ; rec → [n_chunks, row0…]
    seg_dyn: Tuple[np.ndarray, ...] = ()
    bucket: Tuple = ()                          # trace-identity key (host view)
    _device_tables: Optional[Tuple] = None      # device copies, moved once
    _steps: Optional[Tuple] = None              # host-expanded launch list
    # CUDA: None before the first run, _WARMED after it (the second run
    # captures), then the captured sweep, or the reason the case stays eager
    _sweep: Optional[object] = None
    # serializes the fill / replay / read-back of the static buffers, which
    # every run of this case shares
    _sweep_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )


@dataclasses.dataclass
class _CapturedSweep:
    """A case's level sweep recorded as one CUDA graph: the static store
    and coverage buffers it reads and writes, and its two device flags."""

    graph: object                   # torch.cuda.CUDAGraph
    store: Dict[str, object]
    coverage: Dict[str, object]
    bad: object                     # (out-of-box, hole) bool device tensor


# a case whose first (eager) run found nothing that a capture forbids
_WARMED = "warmed"

# one capture at a time in the process, on one stream per device that
# nothing else enqueues on (see _capture_stream)
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[object, object] = {}


def _capture_stream(device):
    """The device's capture stream (caller holds ``_CAPTURE_LOCK``).

    ``torch.cuda.Stream()`` hands out the pool's streams round robin, and
    torch.cuda.graph's default capture stream is one of them: another
    worker's warm-up side stream could be the capturing stream itself, and
    its work and waits there invalidate the capture.  The capture stream is
    therefore taken once from the high-priority pool, which the warm-ups
    (default priority) never draw from."""

    import torch

    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(
            device, priority=-1
        )
    return stream


_OOB_MSG = (
    "access outside the initialized store — widen the pad of initial_store()"
)
_HOLE_MSG = (
    "read of an uninitialized cell — the provided store does not cover "
    "this access"
)


class CompiledProgram:
    """One structural cache entry: a lowering plan plus its device runner.

    Built once per (statement graph, retained dependences, execution model);
    per-(bounds, layout, device) level tables are a nested LRU inside.
    ``plan(...).compile("torch")`` attaches the handle to the report.
    """

    # prepared-case LRU bound: a long-running server whose bounds vary per
    # request must not accumulate level tables without limit
    MAX_CASES = 32

    def __init__(
        self,
        key: str,
        program: LoopProgram,
        retained: Sequence[Dependence],
        model: str = "doall",
        processors: Optional[Dict[str, object]] = None,
        chunk_limit: Optional[int] = None,
        scc_policy: SccPolicyLike = None,
        deps: Optional[str] = None,
    ) -> None:
        import collections
        import threading

        self.key = key
        self.program = program
        self.retained = tuple(retained)
        self.model = model
        self.processors = dict(processors) if processors else None
        self.chunk_limit = chunk_limit
        self.scc_policy = scc_policy
        # non-affine dependence mode: None (conservative proxies),
        # "inspect" (exact per-bounds instance graph), or "speculate"
        # (optimistic schedule; validation + rollback live in the run
        # wrapper — repro_torch.compile.executor.execute_compiled)
        self.deps_mode = deps
        self.cache = None  # back-reference set by the owning CompileCache
        self._cases: "collections.OrderedDict[Tuple, PreparedCase]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self._batched = [
            self._make_batched(s) for s in program.statements
        ]
        # distinct (skeleton, bucketed shapes) identities served so far —
        # the reference's trace identity, kept so a later captured-graph
        # runner can key on it
        self._buckets: set = set()

    # ------------------------------------------------------------------ #
    @property
    def prepared_cases(self) -> int:
        return len(self._cases)

    @property
    def bucket_count(self) -> int:
        """Distinct (skeleton, bucketed shapes) identities served."""

        with self._lock:
            return len(self._buckets)

    def cache_stats(self) -> Dict[str, int]:
        if self.cache is None:  # pragma: no cover - standalone use
            return {}
        return self.cache.stats.as_dict()

    # ------------------------------------------------------------------ #
    # Hooks the verbatim host half calls.
    # ------------------------------------------------------------------ #

    def _level_cost_hook(self):
        """Per-level step-cost model handed to the scheduling policy."""

        from repro_torch.compile import torch_level_cost

        return torch_level_cost

    def _pad_lanes(self, wp: int) -> int:
        """Final lane padding (``wp`` is already a power of two)."""

        return wp

    def _use_cond(self, wp: int) -> bool:
        """The reference's wide/narrow split, kept so the case statics stay
        equal to the reference's; the eager sweep launches only active
        groups either way."""

        return wp > 32

    def _make_static(self, stmts, segments) -> _CaseStatic:
        return _CaseStatic(stmts=stmts, segments=segments)

    def _case_key_extra(self) -> Tuple:
        """The device joins the per-bounds case key: re-running a structure
        on another device rebuilds its device tables, never the artifact."""

        return (str(current_device()),)

    def _lane_values(self, k, ss, store, ridx, width, device, live):
        """Gather + vectorized compute of one table row's lanes (``live``:
        the lanes whose value is stored)."""

        reads = [store[a][ix] for a, ix in zip(ss.reads, ridx)]
        return self._batched[k](reads, width, device, live)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _make_batched(stmt):
        """Vectorized compute over whole lane vectors.

        Reads are wrapped in :class:`_StrictLane` (see the strict lane
        arithmetic above); compute functions that don't speak the proxy
        protocol (e.g. calling ``torch.*`` directly) fall back to
        ``torch.func.vmap``."""

        n_reads = len(stmt.reads)

        def batched(reads: List, width: int, device, live=None):
            import torch

            if n_reads == 0:
                return torch.full(
                    (width,), float(stmt.compute()), dtype=torch.float64,
                    device=device,
                )
            token = _LIVE.set(live)
            try:
                out = _unwrap(stmt.compute(*(_StrictLane(r) for r in reads)))
                if isinstance(out, (int, float)):
                    # a constant: a fill kernel, where as_tensor would copy
                    # from the host (illegal inside a graph capture)
                    return torch.full(
                        (width,), float(out), dtype=torch.float64,
                        device=device,
                    )
                out = torch.as_tensor(out, dtype=torch.float64, device=device)
                if out.shape == (width,):
                    return out
                if out.ndim == 0:
                    return out.expand(width)
            except _LaneFailure as f:
                raise f.error from None
            except Exception:
                pass
            finally:
                _LIVE.reset(token)
            try:
                with _no_pow_mode()():
                    return torch.as_tensor(
                        torch.func.vmap(stmt.compute)(*reads),
                        dtype=torch.float64,
                        device=device,
                    )
            except Exception as e:
                raise TorchLoweringError(
                    f"compute function of {stmt.name!r} cannot be evaluated "
                    f"on lane tensors ({e!r}); run this program with "
                    "backend='wavefront' or make the compute fn "
                    "torch-compatible"
                ) from e

        return batched

    # ------------------------------------------------------------------ #
    # Table construction (host side, NumPy)
    # ------------------------------------------------------------------ #

    @staticmethod
    def _layout_key(dense: _DenseStore) -> Tuple:
        return tuple(
            sorted(
                (a, dense.origin[a], dense.data[a].shape, a in dense.mask)
                for a in dense.data
            )
        )

    @staticmethod
    def _content_key(program: LoopProgram, dense: _DenseStore) -> Optional[str]:
        """Index-array content digest for indirect programs.

        The level tables of an indirect access are computed from the index
        array's *values* (and, under ``deps="inspect"``, so is the schedule
        itself), so the per-bounds case key must cover them — this is where
        store-dependent state lives, never in the bounds-free structural key.
        Affine programs return None and pay nothing.
        """

        if not program.has_indirect():
            return None
        h = hashlib.sha1()
        for arr in sorted(program.index_arrays()):
            h.update(arr.encode())
            h.update(repr(dense.origin[arr]).encode())
            h.update(dense.data[arr].tobytes())
            covered = dense.mask.get(arr)
            if covered is not None:
                h.update(covered.tobytes())
        return h.hexdigest()

    @staticmethod
    def _index_store(program: LoopProgram, dense: _DenseStore) -> dict:
        """Dict-form view of just the index arrays (inspector input)."""

        out: dict = {}
        for arr in program.index_arrays():
            d = dense.data[arr]
            lo = dense.origin[arr]
            covered = dense.mask.get(arr)
            cells = {}
            for idx in np.ndindex(d.shape):
                if covered is not None and not covered[idx]:
                    continue
                cells[tuple(int(x + l) for x, l in zip(idx, lo))] = float(
                    d[idx]
                )
            out[arr] = cells
        return out

    def prepare(
        self, program: LoopProgram, dense: _DenseStore
    ) -> Tuple[PreparedCase, bool]:
        """Level tables for these bounds + this store layout (memoized in a
        bounded LRU; thread-safe for concurrent serving)."""

        key = (
            program.bounds,
            self._layout_key(dense),
            self._content_key(program, dense),
            *self._case_key_extra(),
        )
        with self._lock:
            case = self._cases.get(key)
            if case is not None:
                self._cases.move_to_end(key)
                return case, True
        with _trace.span("compile.tables", bounds=str(program.bounds)):
            built = self._build_case(program, dense)
        with self._lock:
            case = self._cases.get(key)  # lost a build race: reuse theirs
            if case is None:
                self._cases[key] = case = built
                while len(self._cases) > self.MAX_CASES:
                    self._cases.popitem(last=False)
        return case, False

    def _build_case(
        self, program: LoopProgram, dense: _DenseStore
    ) -> PreparedCase:
        missing = [a for a in program.arrays() if a not in dense.data]
        if missing:
            raise KeyError(
                f"store is missing arrays {missing} referenced by the program"
            )
        # schedule under the compiled backend's own step-cost model: the
        # default scheduling policy scores strategies through the artifact's
        # level-cost hook (xla_level_cost here, the collective-aware
        # spmd_level_cost in the sharded subclass), so the same "auto" knob
        # can resolve to chunk here while the NumPy interpreter resolves it
        # to skew (forced strategies and explicit policy instances are
        # untouched by the hook)
        level_cost = self._level_cost_hook()

        retained = list(self.retained)
        instance_edges = None
        if self.deps_mode is not None and program.has_indirect():
            from repro_torch.core.inspector import (
                affine_retained,
                inspect_dependences,
            )

            # drop the conservative non-affine proxies; under "inspect" the
            # exact per-bounds instance graph replaces them, under
            # "speculate" nothing does (optimistic doall — the run wrapper
            # validates post-hoc and rolls back to the deps=None artifact)
            retained = list(affine_retained(retained))
            if self.deps_mode == "inspect":
                instance_edges = inspect_dependences(
                    program, self._index_store(program, dense)
                ).edges
        sched = schedule_levels(
            program,
            retained,
            model=self.model,
            processors=self.processors,
            chunk_limit=self.chunk_limit,
            scc_policy=self.scc_policy,
            level_cost=level_cost,
            instance_edges=instance_edges,
        )
        n_levels = sched.depth
        arrays = tuple(sorted(dense.data))
        origin = {a: dense.origin[a] for a in arrays}
        shapes = {a: dense.data[a].shape for a in arrays}
        flat_sizes = {a: int(np.prod(shapes[a])) for a in arrays}
        padded_sizes = {a: _next_pow2(flat_sizes[a] + 1) for a in arrays}
        sparse = tuple(a for a in arrays if a in dense.mask)

        per_stmt: Dict[str, List[Tuple[int, np.ndarray]]] = {}
        for lvl, groups in enumerate(sched.levels):
            for g in groups:
                per_stmt.setdefault(g.statement, []).append(
                    (lvl, np.asarray(g.iterations, dtype=np.int64))
                )

        stmt_statics: List[_StmtStatic] = []
        tables: List[Dict[str, np.ndarray]] = []
        # Actual (unpadded) lane count of every table row, in row order, and
        # each statement's padded width — the width ladder's raw material.
        row_widths: List[List[int]] = []
        wps: List[int] = []
        for s in program.statements:
            entries = per_stmt.get(s.name, [])
            G = len(entries)
            W = max((pts.shape[0] for _, pts in entries), default=1)
            Gp, Wp = _next_pow2(G + 1), self._pad_lanes(_next_pow2(W))
            row_widths.append([int(pts.shape[0]) for _, pts in entries])
            wps.append(Wp)

            glevel = np.full(Gp, n_levels, dtype=np.int32)  # sentinel rows
            lanemask = np.zeros((Gp, Wp), dtype=bool)
            accesses = (
                [("write", s.write)]
                + [(f"read{j}", r) for j, r in enumerate(s.reads)]
                + ([("guard", s.guard)] if s.guard is not None else [])
            )
            idx = {
                role: np.zeros((Gp, Wp), dtype=np.int32)
                for role, _ in accesses
            }
            oob = np.zeros((Gp, Wp), dtype=bool)
            guard_oob = np.zeros((Gp, Wp), dtype=bool)

            for gi, (lvl, pts) in enumerate(entries):
                glevel[gi] = lvl
                w = pts.shape[0]
                lanemask[gi, :w] = True
                if Wp > w:  # pad lanes repeat the first point (masked out)
                    pts = np.concatenate(
                        [pts, np.repeat(pts[:1], Wp - w, axis=0)]
                    )
                for role, ref in accesses:
                    a = ref.array
                    idx_inb = None
                    if is_indirect(ref):
                        # resolve the subscript against the index array's
                        # *contents* — the reason this table cache is keyed
                        # by _content_key on top of (bounds, layout)
                        iarr = ref.index.array
                        icoords = (
                            pts
                            + np.asarray(ref.index.offset_tuple(), np.int64)
                            - np.asarray(origin[iarr], np.int64)
                        )
                        ishp = np.asarray(shapes[iarr], np.int64)
                        idx_inb = np.all(
                            (icoords >= 0) & (icoords < ishp), axis=1
                        )
                        iflat = np.ravel_multi_index(
                            tuple(
                                np.clip(icoords[:, d], 0, shapes[iarr][d] - 1)
                                for d in range(icoords.shape[1])
                            ),
                            shapes[iarr],
                        )
                        ivals = dense.data[iarr].ravel()[iflat]
                        icov = dense.mask.get(iarr)
                        if icov is not None:
                            idx_inb &= icov.ravel()[iflat]
                        # astype truncates toward zero like the scalar
                        # executors' int()
                        coords = (ivals.astype(np.int64) + ref.offset)[
                            :, None
                        ] - np.asarray(origin[a], np.int64)
                    else:
                        coords = (
                            pts
                            + np.asarray(ref.offset_tuple(), np.int64)
                            - np.asarray(origin[a], np.int64)
                        )
                    shp = np.asarray(shapes[a], np.int64)
                    inb = np.all((coords >= 0) & (coords < shp), axis=1)
                    if idx_inb is not None:
                        inb &= idx_inb
                    flat = np.ravel_multi_index(
                        tuple(
                            np.clip(coords[:, d], 0, shapes[a][d] - 1)
                            for d in range(coords.shape[1])
                        ),
                        shapes[a],
                    )
                    # out-of-box lanes are redirected to the trash cell
                    flat = np.where(inb, flat, padded_sizes[a] - 1)
                    idx[role][gi] = flat.astype(np.int32)
                    bad = ~inb[:w]
                    if role == "guard":
                        guard_oob[gi, :w] |= bad
                    else:
                        oob[gi, :w] |= bad

            oob &= lanemask
            guard_oob &= lanemask
            # The guard access itself is evaluated unconditionally by the
            # sequential oracle, so a guard read outside the store is a
            # static error even for guarded statements.
            if guard_oob.any():
                raise KeyError(f"{s.name}: guard {_OOB_MSG}")
            if s.guard is None and oob.any():
                raise KeyError(f"{s.name}: {_OOB_MSG}")
            has_oob = bool(s.guard is not None and oob.any())

            cov_reads = tuple(r.array in dense.mask for r in s.reads)
            cov_guard = bool(
                s.guard is not None and s.guard.array in dense.mask
            )
            cov_write = s.write.array in dense.mask

            stmt_statics.append(
                _StmtStatic(
                    name=s.name,
                    write=s.write.array,
                    reads=tuple(r.array for r in s.reads),
                    guard=s.guard.array if s.guard is not None else None,
                    has_oob=has_oob,
                    cov_reads=cov_reads,
                    cov_guard=cov_guard,
                    cov_write=cov_write,
                    use_cond=self._use_cond(Wp),
                )
            )
            table = {
                "glevel": glevel,
                "lanemask": lanemask,
                "widx": idx["write"],
            }
            table["ridx"] = tuple(
                idx[f"read{j}"] for j in range(len(s.reads))
            )
            if s.guard is not None:
                table["gidx"] = idx["guard"]
            if has_oob:
                table["oob"] = oob
            tables.append(table)

        # Segment hybrid schedules AND inspect schedules: the band detector
        # only looks at per-level (statement, row) lockstep runs, which is
        # strategy-agnostic — an inspector-scheduled serialized chain lowers
        # to the same nested-fori recurrence band a chunked DOACROSS does,
        # instead of paying the generic per-level cursor dispatcher.
        segments, seg_dyn = None, ()
        if (
            sched.scc is not None and sched.scc.recurrences
        ) or instance_edges is not None:
            segments, seg_dyn = self._segment_levels(
                program, sched, n_levels, len(program.statements)
            )
            seg_dyn = self._split_band_widths(
                segments, seg_dyn, row_widths, wps
            )

        static = self._make_static(tuple(stmt_statics), segments)
        # The trace identity, computed host-side: everything jax's jit cache
        # keys a trace on — the statics plus the bucketed argument shapes
        # (level tables, padded store/coverage buffers, segment scalars).
        # Per-bounds *values* (n_levels, table contents, seg_dyn contents)
        # are traced arguments and deliberately absent.
        bucket = (
            static,
            tuple(
                tuple(
                    sorted(
                        (
                            role,
                            tuple(a.shape for a in arr)
                            if isinstance(arr, tuple)
                            else arr.shape,
                        )
                        for role, arr in t.items()
                    )
                )
                for t in tables
            ),
            tuple(sorted(padded_sizes.items())),
            sparse,
            tuple(d.shape for d in seg_dyn),
        )

        return PreparedCase(
            static=static,
            n_levels=n_levels,
            tables=tuple(tables),
            arrays=arrays,
            origin=origin,
            shapes=shapes,
            flat_sizes=flat_sizes,
            padded_sizes=padded_sizes,
            sparse=sparse,
            schedule=sched,
            seg_dyn=seg_dyn,
            bucket=bucket,
        )

    # Minimum run of uniform levels worth collapsing into a nested loop —
    # below this the generic dispatcher's per-level cost doesn't matter.
    REC_BAND_MIN = 4

    def _band_rungs(self, wpb: int) -> int:
        """Width-ladder depth for a recurrence band of padded width
        ``wpb``: the number of halvings (≤ ``WIDTH_LADDER_RUNGS``) whose
        narrowest rung still holds ``WIDTH_LADDER_MIN`` lanes.  The sharded
        artifact overrides this to 0 (its per-shard lane slicing needs the
        full padded width).  Reads the module knobs late so a bench can
        pin the ladder off for an unsplit control build."""

        rungs = 0
        while (
            rungs < WIDTH_LADDER_RUNGS
            and (wpb >> (rungs + 1)) >= WIDTH_LADDER_MIN
        ):
            rungs += 1
        return rungs

    def _split_band_widths(
        self,
        segments: Tuple[Tuple, ...],
        seg_dyn: Tuple[np.ndarray, ...],
        row_widths: List[List[int]],
        wps: List[int],
    ) -> Tuple[np.ndarray, ...]:
        """Append width-ladder cut points to each recurrence band's dynamic
        vector (ROADMAP 3b).

        A skewed diamond's band ramps up to its widest diagonal and back
        down, but every level pays for the *widest* statement row because
        the whole band shares one padded lane count.  For a ladder of
        ascending rung widths ``w_1 < … < w_L < wpb`` this computes, per
        rung, the maximal prefix ``P_i`` (and suffix start ``Q_i``) of band
        rows whose actual lane counts all fit ``w_i`` — monotone cuts
        ``0 ≤ P_1 ≤ … ≤ P_L ≤ Q_L ≤ … ≤ Q_1 ≤ n`` appended as ``[P_1…P_L,
        Q_L…Q_1]`` — so the executor can run the ramps at sliced lane
        widths and only the plateau at full width.  Lanes sliced away are
        pure padding (mask-false, repeat-first-point, trash-scattered), so
        bit-equality is structural, not numerical luck.

        The cut *values* ride in the traced ``seg_dyn`` vector; only the
        ladder depth L changes the vector's shape, and L is a function of
        the padded band width — already a bucket component — so the
        four-level cache and the zero-re-trace property are preserved.
        Uniform bands (every row as wide as the plateau) append nothing
        and keep today's trace byte-for-byte.
        """

        out = []
        for seg, dyn in zip(segments, seg_dyn):
            if seg[0] != "rec":
                out.append(dyn)
                continue
            stmt_ks = seg[1]
            n = int(dyn[0])
            row0 = [int(r) for r in dyn[1:]]
            wpb = max(wps[k] for k in stmt_ks)
            rungs = self._band_rungs(wpb)

            def fits(t: int, w: int) -> bool:
                return all(
                    row_widths[k][row0[j] + t] <= min(w, wps[k])
                    for j, k in enumerate(stmt_ks)
                )

            ws = [wpb >> (rungs - i) for i in range(rungs)]
            cuts_p = []
            for w in ws:
                p = cuts_p[-1] if cuts_p else 0  # prefixes are monotone
                while p < n and fits(p, w):
                    p += 1
                cuts_p.append(p)
            cuts_q = []
            for w in ws:
                q = cuts_q[-1] if cuts_q else n  # suffixes are monotone
                while q > cuts_p[-1] and fits(q - 1, w):
                    q -= 1
                cuts_q.append(q)
            if rungs == 0 or (cuts_p[-1] == 0 and cuts_q[-1] == n):
                # degenerate ladder (a uniform band): keep the un-split
                # vector so the trace — and the bucket — match today's
                out.append(dyn)
                continue
            extra = cuts_p + list(reversed(cuts_q))
            out.append(
                np.concatenate(
                    [dyn, np.asarray(extra, dtype=np.int32)]
                )
            )
        return tuple(out)

    @staticmethod
    def _segment_levels(
        program: LoopProgram, sched, n_levels: int, n_stmts: int
    ) -> Tuple[Tuple[Tuple, ...], Tuple[np.ndarray, ...]]:
        """Partition the level sequence into wave segments + recurrence bands.

        A band is a maximal run of ≥ :attr:`REC_BAND_MIN` levels whose
        active (statement, table-row) pairs advance in lockstep — exactly
        what a chunked recurrence (plus any acyclic groups pipelined against
        it) produces.  Sound regardless of which statements land in a band:
        same-level groups of different scheduling units are independent by
        construction, and the band executes them in lexical order like the
        generic dispatcher.

        Returns ``(skeleton, seg_dyn)``: the bounds-free segment skeleton
        that goes into :class:`_CaseStatic` plus one ``int32`` scalar vector
        per segment (``[lo, hi, cursors0…]`` for waves, ``[n_chunks,
        row0…]`` for bands) that rides as a traced jit argument — the
        static/dynamic split that lets every bounds in a bucket share one
        trace.
        """

        import bisect

        stmt_index = {s.name: k for k, s in enumerate(program.statements)}
        level_active: List[List[Tuple[int, int]]] = [
            [] for _ in range(n_levels)
        ]
        rows_seen = [0] * n_stmts
        stmt_levels: List[List[int]] = [[] for _ in range(n_stmts)]
        for lvl, groups in enumerate(sched.levels):
            for g in groups:
                k = stmt_index[g.statement]
                level_active[lvl].append((k, rows_seen[k]))
                stmt_levels[k].append(lvl)
                rows_seen[k] += 1
        for active in level_active:
            active.sort()  # lexical statement order (groups already are)

        def cursors_at(level: int) -> Tuple[int, ...]:
            return tuple(
                bisect.bisect_left(stmt_levels[k], level)
                for k in range(n_stmts)
            )

        skeleton: List[Tuple] = []
        seg_dyn: List[np.ndarray] = []

        def wave(lo: int, hi: int) -> None:
            skeleton.append(("wave",))
            seg_dyn.append(
                np.asarray([lo, hi, *cursors_at(lo)], dtype=np.int32)
            )

        wave_start = 0
        L = 0
        while L < n_levels:
            base = level_active[L]
            run = 1
            while L + run < n_levels and len(level_active[L + run]) == len(
                base
            ) and all(
                nk == bk and nr == br + run
                for (nk, nr), (bk, br) in zip(level_active[L + run], base)
            ):
                run += 1
            if base and run >= CompiledProgram.REC_BAND_MIN:
                if wave_start < L:
                    wave(wave_start, L)
                skeleton.append(("rec", tuple(k for k, _ in base)))
                seg_dyn.append(
                    np.asarray(
                        [run, *(r0 for _, r0 in base)], dtype=np.int32
                    )
                )
                wave_start = L + run
            L += run
        if wave_start < n_levels:
            wave(wave_start, n_levels)
        return tuple(skeleton), tuple(seg_dyn)

    # ------------------------------------------------------------------ #
    # The device half: host-driven eager sweep
    # ------------------------------------------------------------------ #

    @staticmethod
    def _level_steps(case: PreparedCase) -> Tuple[Tuple[int, int, Optional[int]], ...]:
        """Expand the case's segment skeleton into its launch list.

        Returns ``(statement k, table row, lane cap)`` in execution order.
        Wave segments walk per-statement cursors from their ``seg_dyn``
        bases and launch a statement at a level only when its next group
        belongs there; recurrence bands run ``n_chunks`` lockstep steps of
        their statements, at the width-ladder lane caps on the ramps.  The
        cap is ``None`` where it spans the statement's whole table row.
        """

        glevels = [t["glevel"] for t in case.tables]
        widths = [t["lanemask"].shape[1] for t in case.tables]
        steps: List[Tuple[int, int, Optional[int]]] = []

        def wave(lo: int, hi: int, cursors: List[int]) -> None:
            for level in range(lo, hi):
                for k, glevel in enumerate(glevels):
                    c = cursors[k]
                    if glevel[c] == level:
                        steps.append((k, c, None))
                        cursors[k] = c + 1

        if case.static.segments is None:
            wave(0, case.n_levels, [0] * len(glevels))
            return tuple(steps)
        for seg, dyn in zip(case.static.segments, case.seg_dyn):
            dyn = [int(x) for x in dyn]
            if seg[0] == "wave":
                wave(dyn[0], dyn[1], dyn[2:])
                continue
            stmt_ks = seg[1]
            J = len(stmt_ks)
            # ladder depth from the vector's length: [run, J row bases,
            # 2·L cut points] (see _split_band_widths)
            L = (len(dyn) - 1 - J) // 2
            wpb = max(widths[k] for k in stmt_ks)
            ws = [wpb >> (L - i) for i in range(L)]
            caps = ws + [wpb] + list(reversed(ws))
            edges = [0] + dyn[1 + J: 1 + J + 2 * L] + [dyn[0]]
            for lo, hi, cap in zip(edges, edges[1:], caps):
                for t in range(lo, hi):
                    for j, k in enumerate(stmt_ks):  # lexical stmt order
                        steps.append(
                            (k, dyn[1 + j] + t, None if cap >= widths[k] else cap)
                        )
        return tuple(steps)

    @staticmethod
    def _to_device(case: PreparedCase, device) -> Tuple[Dict[str, object], ...]:
        """Index tables as int64 device tensors and lane masks as bool.  An
        unguarded statement's scatter targets do not depend on the store,
        so they are resolved here once (``wtgt``: masked lanes → trash)."""

        import torch

        def dev(x: np.ndarray):
            if x.dtype != np.bool_:
                x = x.astype(np.int64)
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        out = []
        for t, ss in zip(case.tables, case.static.stmts):
            d: Dict[str, object] = {
                "lanemask": dev(t["lanemask"]),
                "widx": dev(t["widx"]),
                "ridx": tuple(dev(ix) for ix in t["ridx"]),
            }
            if "gidx" in t:
                d["gidx"] = dev(t["gidx"])
            if "oob" in t:
                d["oob"] = dev(t["oob"])
            if ss.guard is None:
                trash = case.padded_sizes[ss.write] - 1
                d["wtgt"] = dev(np.where(t["lanemask"], t["widx"], trash))
            out.append(d)
        return tuple(out)

    def _group_step(self, k, ss, t, c, cap, store, coverage, flags, device):
        """Gather / compute / scatter of statement ``k``'s table row ``c``
        (its leading ``cap`` lanes when capped — the sliced-away lanes are
        mask-false padding).  Flag terms are appended to ``flags`` as
        device scalars; nothing here waits for the device."""

        import torch

        def row(m):
            r = m[c]
            return r if cap is None else r[:cap]

        lanes = row(t["lanemask"])
        ridx = [row(ix) for ix in t["ridx"]]
        mask = lanes
        if ss.guard is not None:
            gix = row(t["gidx"])
            if ss.cov_guard:
                flags[1].append(torch.any(lanes & ~coverage[ss.guard][gix]))
            mask = mask & (store[ss.guard][gix] > 0.0)
        for j, (a, ix) in enumerate(zip(ss.reads, ridx)):
            if ss.cov_reads[j]:
                flags[1].append(torch.any(mask & ~coverage[a][ix]))
        if ss.has_oob:
            oob_row = row(t["oob"])
            flags[0].append(torch.any(mask & oob_row))
            mask = mask & ~oob_row
        vals = self._lane_values(
            k, ss, store, ridx, lanes.shape[0], device, mask
        )
        if ss.guard is None:
            tgt = row(t["wtgt"])
        else:
            # masked_fill takes the trash index as a kernel argument, where
            # torch.where would copy a Python scalar to the device
            trash = store[ss.write].shape[0] - 1
            tgt = row(t["widx"]).masked_fill(~mask, trash)
        store[ss.write][tgt] = vals
        if ss.cov_write:
            coverage[ss.write][tgt] = True

    def _sweep_steps(self, case: PreparedCase, store, coverage, device):
        """Enqueue the case's whole launch list on ``store`` / ``coverage``
        (flat device tensors, updated in place) and return its flags as one
        (out-of-box, hole) bool device tensor; nothing here waits for the
        device, so a graph capture records it as it stands."""

        import torch

        flags: Tuple[List, List] = ([], [])
        tables = case._device_tables
        stmts = case.static.stmts
        for k, c, cap in case._steps:
            self._group_step(
                k, stmts[k], tables[k], c, cap, store, coverage, flags, device,
            )
        return torch.stack(
            [
                torch.stack(f).any() if f else torch.zeros(
                    (), dtype=torch.bool, device=device
                )
                for f in flags
            ]
        )

    @staticmethod
    def _host_buffers(case: PreparedCase, dense: _DenseStore):
        """The flat host images of the store and coverage (trash cell and
        pow2 padding included) that the device buffers are loaded from."""

        store = {}
        for a in case.arrays:
            flat = np.zeros(case.padded_sizes[a], dtype=np.float64)
            flat[: case.flat_sizes[a]] = dense.data[a].ravel()
            store[a] = flat
        coverage = {}
        for a in case.sparse:
            cov = np.zeros(case.padded_sizes[a], dtype=bool)
            cov[: case.flat_sizes[a]] = dense.mask[a].ravel()
            coverage[a] = cov
        return store, coverage

    def _device_buffers(self, case: PreparedCase, dense: _DenseStore, device):
        import torch

        store, coverage = self._host_buffers(case, dense)
        return (
            {a: torch.from_numpy(x).to(device) for a, x in store.items()},
            {a: torch.from_numpy(x).to(device) for a, x in coverage.items()},
        )

    @staticmethod
    def _read_back(case: PreparedCase, store, coverage, bad):
        """The store and coverage on the host, after the flags (``bad``,
        already read to the host) raise the reference's ``KeyError``."""

        if bad[0]:
            raise KeyError(_OOB_MSG)
        if bad[1]:
            raise KeyError(_HOLE_MSG)
        with _trace.span("torch.to_host"):
            out_np = {
                a: store[a][: case.flat_sizes[a]].cpu().numpy().reshape(
                    case.shapes[a]
                )
                for a in case.arrays
            }
            cov_np = {
                a: coverage[a][: case.flat_sizes[a]].cpu().numpy().reshape(
                    case.shapes[a]
                )
                for a in case.sparse
            }
        return out_np, cov_np

    # Private switches, set only by chip_smoke.py: ``_capture = False`` runs
    # the CUDA sweep eagerly (to time it beside the replay); ``_refill =
    # False`` replays without loading this run's store (a planted fault).
    _capture = True
    _refill = True

    def _eager(self, case: PreparedCase, dense: _DenseStore, device):
        with _trace.span("torch.to_device"):
            store, coverage = self._device_buffers(case, dense, device)
        with _trace.span("torch.execute", levels=case.n_levels):
            # the one host read of the flags, after the whole sweep
            bad = self._sweep_steps(case, store, coverage, device).cpu()
        return self._read_back(case, store, coverage, bad)

    def _warm_up(self, case: PreparedCase, dense: _DenseStore, device):
        """First run of ``case`` on CUDA: an eager sweep whose result is this
        run's, and which decides whether the case can be captured (on its
        second run).  Caller holds ``case._sweep_lock``."""

        import torch

        store, coverage = self._device_buffers(case, dense, device)
        # Hazard: warm before capturing.  _device_scalar creates its tensors
        # lazily with a host-to-device copy, which is illegal under capture;
        # this sweep creates every one the launch list needs, on a side
        # stream as torch.cuda.graph's documentation prescribes.
        mark = [False]
        token = _POW_MARK.set(mark)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side), _trace.span(
                "torch.execute", levels=case.n_levels, warm_up=True
            ):
                bad = self._sweep_steps(case, store, coverage, device)
        finally:
            _POW_MARK.reset(token)
        torch.cuda.current_stream(device).wait_stream(side)
        if mark[0]:
            # Hazard: ``**`` cannot be captured — host_pow copies lanes to
            # the host mid-sweep.  Decided from the warm-up's mark, never by
            # catching a failed capture.
            reason = "host_pow: a statement's ** runs Python's pow on the host"
            with _trace.span("torch.capture", eager=reason):
                pass
        else:
            reason = _WARMED
        case._sweep = reason
        _metrics.counter("torch.eager_sweeps").inc()
        return self._read_back(case, store, coverage, bad.cpu())

    def _record(self, case: PreparedCase, dense: _DenseStore, device):
        """Second run of ``case`` on CUDA: record its launch list as one
        graph over static buffers (the caller then replays it).  Caller
        holds ``case._sweep_lock``."""

        import torch

        store, coverage = self._device_buffers(case, dense, device)
        # Hazard: capture from worker threads.  thread_local confines the
        # capture's ban on unsafe CUDA calls to this thread, so other
        # workers' sweeps and replays go on; _CAPTURE_LOCK keeps captures
        # one at a time.  Any capture error raises.
        with _CAPTURE_LOCK, _trace.span(
            "torch.capture", steps=len(case._steps)
        ), torch.cuda.device(device):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(
                graph,
                stream=_capture_stream(device),
                capture_error_mode="thread_local",
            ):
                bad = self._sweep_steps(case, store, coverage, device)
        _metrics.counter("torch.graph_captures").inc()
        case._sweep = _CapturedSweep(graph, store, coverage, bad)

    def _replayed(self, case: PreparedCase, dense: _DenseStore, device):
        """Run ``case`` on CUDA: eagerly on its first run, through its graph
        from the second (captured then), eagerly for good when the first
        run found it cannot be captured."""

        import torch

        # Hazard: the static buffers are shared by every run of the case,
        # so fill, replay and read-back hold its lock; other cases replay
        # concurrently.
        with case._sweep_lock:
            if case._sweep is None:
                return self._warm_up(case, dense, device)
            if case._sweep is _WARMED:
                self._record(case, dense, device)
            sweep = case._sweep
            if isinstance(sweep, _CapturedSweep):
                with _trace.span("torch.to_device"):
                    if self._refill:
                        # Hazard: stale inputs.  The replay reads this run's
                        # store only because it is loaded here, outside the
                        # graph, before every replay.
                        store, coverage = self._host_buffers(case, dense)
                        for a, x in store.items():
                            sweep.store[a].copy_(torch.from_numpy(x))
                        for a, x in coverage.items():
                            sweep.coverage[a].copy_(torch.from_numpy(x))
                with _trace.span(
                    "torch.execute", levels=case.n_levels, replay=True
                ):
                    sweep.graph.replay()
                    bad = sweep.bad.cpu()
                _metrics.counter("torch.graph_replays").inc()
                return self._read_back(
                    case, sweep.store, sweep.coverage, bad
                )
        _metrics.counter("torch.eager_sweeps").inc()
        return self._eager(case, dense, device)

    def execute(self, case: PreparedCase, dense: _DenseStore) -> WavefrontStats:
        """Run the artifact on ``dense`` (mutated in place with the result)
        on the device of the enclosing :func:`device_scope`: on CUDA eagerly
        on a case's first run and by replaying its captured graph from the
        second, on the CPU eagerly."""

        device = current_device()
        with self._lock:
            new_bucket = case.bucket not in self._buckets
            if new_bucket:
                self._buckets.add(case.bucket)
        _metrics.counter(
            "torch.bucket_misses" if new_bucket else "torch.bucket_hits"
        ).inc()

        if case._device_tables is None:
            with _trace.span("torch.to_device", tables=True):
                # conversion is idempotent, so a concurrent duplicate would
                # cost only a wasted copy; the lock keeps assignment clean
                steps = self._level_steps(case)
                tables = self._to_device(case, device)
                with self._lock:
                    if case._device_tables is None:
                        case._steps = steps
                        case._device_tables = tables
        if device.type != "cuda":
            out_np, cov_np = self._eager(case, dense, device)
        elif self._capture:
            out_np, cov_np = self._replayed(case, dense, device)
        else:
            _metrics.counter("torch.eager_sweeps").inc()
            out_np, cov_np = self._eager(case, dense, device)
        dense.data.update(out_np)
        dense.mask.update(cov_np)
        sched = case.schedule
        return WavefrontStats(
            levels=sched.depth,
            batched_ops=sched.batched_ops,
            instances=sched.instances,
            max_width=sched.max_width,
        )
