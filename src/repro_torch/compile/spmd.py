"""``repro_torch.compile.spmd`` — the SPMD level loop across the processes
of a ``torch.distributed`` group, backend ``"torch_spmd"``.

The port's counterpart of the reference's ``"xla_spmd"``.  A wavefront
level is embarrassingly parallel across lanes — exactly the parallelism
the paper's optimized send/wait sets expose — so this backend splits each
statement's padded lane row across the ranks of the default process group
(a process group stands where the reference's jax mesh stood; the caller,
or ``torchrun`` / ``mp.spawn``, creates and owns it):

  * every rank holds the whole store and the whole level tables
    (replicated); for each group step of a statement that reads, each rank
    slices its contiguous block of the row's lanes (and of the live-lane
    mask), gathers and computes only those lanes with the same strict ops
    as ``"torch"``, and one all-gather reassembles the full lane vector in
    rank order before the masked scatter, which runs full-width on every
    rank;
  * recurrence bands keep the store replicated, with one all-gather per
    read-bearing statement per level, so hybrid schedules shard without
    any cross-rank scatter;
  * everything outside the sharded gather/compute runs full-width on
    replicated data, identically on every rank — so the store on every
    rank stays bit-equal to the sequential oracle.

The cost model: :func:`spmd_level_cost` divides the padded lane work by
the device count but charges a flat cost plus a per-lane cost for the
gather — so ``CostModelPolicy`` picks a wide skewed wavefront when the
lane savings beat the collective tax and narrow chunking when they don't,
per SCC, with both scored offers recorded in ``summary()["scc"]``.

Cache discipline: the backend owns :data:`SPMD_CACHE`, a separate
:class:`~repro_torch.compile.cache.CompileCache` whose factory builds
:class:`SpmdCompiledProgram` — structural keys carry no backend tag, so
the isolation (``"torch"`` and ``"torch_spmd"`` artifacts never alias)
lives in the cache instance.  The shard count is part of the case static
(and so of the bucket) and of the per-bounds case key, never the
structural key.

Rules of execution:

* **One device** (no group, a group of one, or a forced count of 1): the
  code path is exactly ``"torch"``'s — capture on CUDA included — with no
  collective.
* **More than one device on CUDA**: the sweep stays eager, by rule
  (counted in ``torch.eager_sweeps``, the reason in ``case._sweep``): this
  backend captures no NCCL collective.
* **Ranks must agree.**  Two ranks whose auctions differ (say, priced by
  different calibration profiles) would issue different collectives and
  hang, and two ranks that hold different stores would mix their lanes;
  before a sharded run's first collective the ranks exchange the case's
  structural key, strategy records and level count and a digest of the
  store, and a disagreement raises naming it.  Every rank must run the
  same program on the same store: ``LoopProgram.initial_store()`` draws
  its values from Python's ``hash``, which differs between processes
  unless ``PYTHONHASHSEED`` is fixed, so build the store once and send it
  to every rank.
* **The group's backend must reach the device**: a gloo group with a CUDA
  device (or an NCCL group with the CPU) raises ``ValueError`` at
  ``compile()``.
* One thread per rank drives a group's collectives: the ranks' runs must
  come in the same order.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Optional, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.compile import _next_pow2
from repro_torch.compile.cache import CompileCache
from repro_torch.compile.lowering import (
    _POW_MARK,
    CompiledProgram,
    TorchLoweringError,
    _CaseStatic,
    device_scope,
    resolve_device,
)

__all__ = [
    "SPMD_CACHE",
    "SPMD_COLLECTIVE_LANE_UNITS",
    "SPMD_COLLECTIVE_UNITS",
    "SpmdCompiledProgram",
    "device_count",
    "force_device_count",
    "reset_spmd_caches",
    "shard_count",
    "spmd_level_cost",
]


# ---------------------------------------------------------------------- #
# Device plumbing.  Two views on purpose:
#   * device_count()  — what the COST MODEL assumes (forcible, so policy
#     tests can score an 8-device group from a single-process pytest run);
#   * shard_count()   — what EXECUTION actually shards over, never more
#     than the group's real size (a forced count degrades safely to an
#     unsharded run, still bit-equal).
# Both are power-of-two floors: lane tables pad to powers of two, so a
# pow2 shard count always divides the padded width.  The group is read on
# every call, never cached: a caller may create and destroy it in-process.
# ---------------------------------------------------------------------- #

_FORCED: Optional[int] = None


def _pow2_floor(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n).bit_length() - 1)


def force_device_count(n: Optional[int]) -> None:
    """Testing seam: pin the cost model's device count (None restores the
    process group's real size)."""

    global _FORCED
    _FORCED = None if n is None else int(n)


def _group() -> Tuple[int, int]:
    """The default process group's (rank, world size); (0, 1) without
    one."""

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _actual_devices() -> int:
    return _pow2_floor(_group()[1])


def device_count() -> int:
    """The device count the collective-aware cost model charges against."""

    if _FORCED is not None:
        return _pow2_floor(_FORCED)
    return _actual_devices()


def shard_count() -> int:
    """The device count execution actually shards over (≤ the group's)."""

    return min(device_count(), _actual_devices())


def reset_spmd_caches() -> None:
    """Drop the forced device count plus the backend's structural cache
    (the ``obs.reset_all()`` hook), so tests that vary device counts stay
    order-independent."""

    global _FORCED
    _FORCED = None
    SPMD_CACHE.clear()


def _check_group(device) -> None:
    """Raise when the default group's backend cannot gather tensors of
    ``device``: gloo gathers CPU tensors, NCCL CUDA ones."""

    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    backend = str(dist.get_backend()).lower()
    reaches = {"cuda": ("nccl",), "cpu": ("gloo", "mpi")}[device.type]
    if not any(b in backend for b in reaches):
        raise ValueError(
            f"torch_spmd: the default process group's backend {backend!r} "
            f"cannot gather tensors on {device}; use an NCCL group for "
            "'cuda' and a gloo group for 'cpu'"
        )


# ---------------------------------------------------------------------- #
# The collective-aware cost hook.  Same units as torch_level_cost (per-step
# padded-lane work): the lane term is divided across devices, and sharded
# steps add a flat collective cost plus a per-lane gather term.  At
# device_count()==1 this is exactly torch_level_cost — one device must not
# perturb single-device strategy selection.
# ---------------------------------------------------------------------- #

# Hand-set defaults for the collective terms, in lane units — the
# profile-less fallback: spmd_level_cost resolves all four unit costs late
# through repro_torch.calibrate.units(), so a warmed profile (or a
# monkeypatched constant) takes effect on the next auction.

# flat per-step cost of issuing the lane-gather collective, in lane units
SPMD_COLLECTIVE_UNITS = 4.0
# per-lane cost of moving one gathered lane between devices
SPMD_COLLECTIVE_LANE_UNITS = 0.125


def spmd_level_cost(plan, ctx) -> float:
    """Per-SCC cost of a strategy offer on the sharded level loop.

    ``depth × statements × (flat + lanes/devices [+ collective(lanes)])``:
    a wide skewed wavefront amortizes its padded lanes across the group
    but pays the all-gather per step, so it wins only when ``lanes/n``
    savings beat the collective tax — narrow chunked schedules (lanes ≤
    devices) keep losing to plain chunking.
    """

    from repro_torch.calibrate import units as _units

    u = _units()
    n = device_count()
    width = plan.max_width if plan.max_width else max(1, round(plan.width))
    # sharded tables pad lanes up to the device count (see _pad_lanes)
    lanes = max(_next_pow2(max(1, int(width))), n if n > 1 else 1)
    per_step = u["xla_step"] + u["xla_lane"] * lanes / n
    if n > 1:
        per_step += (
            u["spmd_collective"] + u["spmd_collective_lane"] * lanes
        )
    return float(plan.depth) * len(ctx.statements) * per_step


# ---------------------------------------------------------------------- #
# The sharded artifact
# ---------------------------------------------------------------------- #

# set while a sharded case sweeps: (this rank's lane block, shard count,
# world size).  _lane_values consults it, so the same group-step code
# shards here and stays full-width on one device.
_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_spmd_shard", default=None
)

# case._sweep of a sharded case: on CUDA the base executor then sweeps it
# eagerly, counted in torch.eager_sweeps
_SHARDED = (
    "torch_spmd: a sweep sharded across processes stays eager; no NCCL "
    "collective is captured"
)


@dataclasses.dataclass(frozen=True)
class _SpmdCaseStatic(_CaseStatic):
    """Case static plus the shard count: the device count changes the
    sweep (slice + all-gather per read-bearing statement), so it belongs
    in the static — and therefore the bucket — never in the structural
    key."""

    n_shards: int = 1


def _gather(vals, n: int, world: int):
    """The full lane vector from every rank's block, in rank order.  A
    rank at or past ``n`` (a world that is not a power of two) computes
    block ``rank % n`` again; its copy is dropped."""

    import torch
    import torch.distributed as dist

    vals = vals.contiguous()
    parts = [torch.empty_like(vals) for _ in range(world)]
    dist.all_gather(parts, vals)
    _metrics.counter("spmd.collectives").inc()
    return torch.cat(parts[:n])


def _check_failures(failure, world: int, device) -> None:
    """After a step whose compute reached ``**`` on the host: exchange
    which ranks failed, and raise on every rank when one did, so that no
    rank waits in a gather the failing rank never reaches."""

    import torch
    import torch.distributed as dist

    mine = torch.tensor([failure is not None], dtype=torch.int32, device=device)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    ranks = [r for r, f in enumerate(every) if int(f)]
    if failure is not None:
        raise failure
    if ranks:
        raise TorchLoweringError(
            f"torch_spmd: a live lane's ** failed on rank(s) {ranks}"
        )


class SpmdCompiledProgram(CompiledProgram):
    """A :class:`CompiledProgram` whose lane gather/compute is split across
    the ranks of the default process group (see the module docstring)."""

    def _level_cost_hook(self):
        return spmd_level_cost

    def _pad_lanes(self, wp: int) -> int:
        # lane rows must divide into the shards; both are powers of two,
        # so padding up to the shard count suffices
        return max(wp, shard_count())

    def _use_cond(self, wp: int) -> bool:
        # the reference never wraps sharded group steps in lax.cond; kept
        # so the case statics stay equal to its own
        return False

    def _band_rungs(self, wpb: int) -> int:
        # no width ladder when sharded: the per-shard lane slice needs
        # every statement at its full padded width
        return 0

    def _make_static(self, stmts, segments) -> _SpmdCaseStatic:
        return _SpmdCaseStatic(
            stmts=stmts, segments=segments, n_shards=shard_count()
        )

    def _case_key_extra(self) -> Tuple:
        # the device, as "torch"'s, and the shard count: re-sharding
        # rebuilds tables (lane padding depends on it) without touching
        # the structural level
        return (*super()._case_key_extra(), shard_count())

    def _lane_values(self, k, ss, store, ridx, width, device, live):
        shard_of = _SHARD.get()
        if shard_of is None or not ss.reads:
            # one device, or a zero-read broadcast statement (cheaper
            # replicated than gathered)
            return super()._lane_values(k, ss, store, ridx, width, device, live)
        block, n, world = shard_of
        shard = width // n
        lo = block * shard
        ridx_loc = [ix[lo: lo + shard] for ix in ridx]
        live_loc = None if live is None else live[lo: lo + shard]
        mark = [False]
        token = _POW_MARK.set(mark)
        failure = None
        try:
            vals = super()._lane_values(
                k, ss, store, ridx_loc, shard, device, live_loc
            )
        except (ArithmeticError, TorchLoweringError) as e:
            if not mark[0]:
                raise  # not value-dependent: every rank raises alike
            failure = e
        finally:
            _POW_MARK.reset(token)
        if mark[0]:
            # a ** ran on the host (it already waited for the device), and
            # its lanes may fail on one rank only
            _check_failures(failure, world, device)
        return _gather(vals, n, world)

    def _sweep_steps(self, case, store, coverage, device):
        n = getattr(case.static, "n_shards", 1)
        if n <= 1:
            return super()._sweep_steps(case, store, coverage, device)
        rank, world = _group()
        token = _SHARD.set((rank % n, n, world))
        try:
            return super()._sweep_steps(case, store, coverage, device)
        finally:
            _SHARD.reset(token)

    def _agree(self, case, dense) -> None:
        """Before a sharded run's first collective: every rank must hold
        the same structural key, strategy records, level count and shard
        count — or the ranks' collectives would differ and hang — and the
        same store, or the gathered lanes would mix them.  One exchange a
        run; raises naming the disagreement."""

        import hashlib

        import torch.distributed as dist

        scc = case.schedule.scc
        store = hashlib.sha1()
        for a in sorted(dense.data):
            store.update(a.encode())
            store.update(dense.data[a].tobytes())
            if a in dense.mask:
                store.update(dense.mask[a].tobytes())
        mine = {
            "structural key": self.key,
            "strategies": tuple(
                (s.statements, s.strategy, s.chunk, s.skew)
                for s in (scc.recurrences if scc is not None else ())
            ),
            "levels": case.n_levels,
            "shards": case.static.n_shards,
            "store": store.hexdigest(),
        }
        every = [None] * _group()[1]
        dist.all_gather_object(every, mine)
        for field, value in mine.items():
            seen = [e[field] for e in every]
            if any(v != value for v in seen):
                raise ValueError(
                    f"torch_spmd: the ranks disagree on the run's {field}: "
                    + "; ".join(f"rank {r}: {v!r}" for r, v in enumerate(seen))
                    + " — every rank must run the same program on the same "
                    "store and price it with the same calibration profile"
                )

    def execute(self, case, dense):
        n = getattr(case.static, "n_shards", 1)
        _metrics.gauge("spmd.devices").set(n)
        if n > 1:
            self._agree(case, dense)
            case._sweep = _SHARDED
            hist = _metrics.histogram("spmd.shard_width")
            for ss, t in zip(case.static.stmts, case.tables):
                if ss.reads:
                    hist.observe(t["lanemask"].shape[1] // n)
        return super().execute(case, dense)


# the backend-owned structural cache: same hierarchy, separate namespace
# (metrics under spmd_compile_cache.*), sharded artifact factory
SPMD_CACHE = CompileCache(
    metrics_prefix="spmd_compile_cache", factory=SpmdCompiledProgram
)


# ---------------------------------------------------------------------- #
# Backend registration: plan(...).compile("torch_spmd", device=...).
# Mirrors the "torch" registration, routed through SPMD_CACHE.
# ---------------------------------------------------------------------- #

def _spmd_prepare(
    optimized,
    retained,
    *,
    chunk_limit=None,
    scc_policy=None,
    model="doall",
    processors=None,
    deps=None,
    device="cuda",
):
    dev = resolve_device(device)  # raises on "cuda" without a card
    _check_group(dev)
    compiled, hit = SPMD_CACHE.get_or_compile(
        optimized.program,
        tuple(retained),
        model=model,
        processors=processors,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
        deps=deps,
    )
    return {"compiled": compiled, "compile_hit": hit, "device": dev}


def _spmd_differential(sync, *, store=None, stalls=None, device="cuda"):
    from repro_torch.compile.executor import run_xla

    _check_group(resolve_device(device))
    with device_scope(device):
        return run_xla(sync, store=store, compare=False, cache=SPMD_CACHE).store


def _spmd_run(sync, artifacts, *, store=None, stalls=None):
    from repro_torch.compile.executor import execute_compiled

    with device_scope(artifacts["device"]):
        return execute_compiled(artifacts["compiled"], sync, store=store)


def _register() -> None:
    from repro_torch.core.parallelizer import BackendSpec, register_backend

    register_backend(
        BackendSpec(
            name="torch_spmd",
            prepare=_spmd_prepare,
            accepts=(
                "chunk_limit",
                "scc_policy",
                "model",
                "processors",
                "deps",
                "device",
            ),
            level_cost=spmd_level_cost,
            differential=_spmd_differential,
            run=_spmd_run,
            description=(
                "SPMD level loop: lanes split across the ranks of a "
                "torch.distributed group, one all-gather per read-bearing "
                "statement step, collective-aware strategy costing "
                "(repro_torch.compile.spmd)"
            ),
        )
    )


_register()
