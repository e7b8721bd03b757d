"""``repro_torch.calibrate`` — measured per-device cost profiles for the
strategy auction.

The backend cost hooks (:func:`repro_torch.compile.torch_level_cost`,
:func:`repro_torch.compile.spmd.spmd_level_cost`) and the interpreters'
default depth × statement-groups model price strategy offers with hand-set
constants.  This package replaces those constants with *measured* ones: at
first use (:func:`warm`) it runs a small suite of synthetic microbenchmarks
through the real level loop (:mod:`repro_torch.calibrate.microbench`) on
the device the caller names — the card by default — and persists the
resulting :class:`CostProfile` as a schema-versioned JSON file keyed by a
fingerprint of that device (its name, the SPMD device count, torch and
CUDA versions, machine and system), so serving restarts reuse it with zero
re-measurement.

The unit names keep the reference schema: ``xla_step`` / ``xla_lane``
price one step of the compiled level loop and one padded lane of it — in
this package that loop is the ``"torch"`` backend.

Design contract:

* **Nothing measures implicitly.**  The cost hooks read the active profile
  through :func:`units`, which never triggers a microbenchmark — with no
  profile warmed, they resolve the hand-set module constants *late*
  (``repro_torch.compile.TORCH_STEP_UNITS`` and friends), so monkeypatched
  values take effect everywhere and test runs stay deterministic.
* **Calibration never enters structural cache keys.**  Like the
  ``level_cost`` hook it feeds (see
  :func:`repro_torch.core.policy.resolve_policy`), the profile re-prices
  offers but is invisible to ``structural_key`` — two processes with
  different profiles share artifacts; only the auction outcome may differ.
* **The profile names its device.**  :func:`measure` and :func:`warm` take
  ``device`` (``"cuda"`` by default, which raises without a card, as
  :func:`repro_torch.compile.lowering.resolve_device` does); the CPU is
  measured only when the caller asks for it, and a CPU profile never
  prices the card's auction (its fingerprint differs).
* **Corrupt / stale files fall back to defaults.**  A profile that fails
  schema, fingerprint, or unit validation is ignored
  (``calibrate.fallbacks`` counter) and the hand-set constants apply.
* **One profile per process**, and under a ``torch.distributed`` process
  group one per group: rank 0 measures (or loads) and broadcasts, so every
  rank prices the ``"torch_spmd"`` auction alike.
* ``REPRO_CALIBRATE=off`` (or ``0`` / ``false``) pins the hand-set
  defaults regardless of any warmed or persisted profile;
  ``REPRO_CALIBRATE_DIR`` overrides the cache directory.

Metrics (unified ``repro_torch.obs.metrics`` registry):
``calibrate.measurements`` (one per timed microbenchmark sample — flat
across a restart that reuses a persisted profile), ``calibrate.loads``,
``calibrate.fallbacks`` counters and the ``calibrate.generation`` gauge.
:func:`reset` (installed in ``obs.reset_all()``) restores the in-memory
default state without touching persisted files.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform as _platform
import sys
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

from repro_torch.obs import metrics as _metrics

__all__ = [
    "SCHEMA_VERSION",
    "UNIT_NAMES",
    "CostProfile",
    "active_profile",
    "cache_dir",
    "default_profile",
    "dispatch_units",
    "enabled",
    "host_fingerprint",
    "host_info",
    "load_profile",
    "measure",
    "profile_generation",
    "profile_path",
    "reset",
    "save_profile",
    "set_profile",
    "summary_pointer",
    "unit",
    "units",
    "warm",
]

SCHEMA_VERSION = 1

# The five calibrated unit costs.  All are relative weights inside one
# backend's auction, so hand-set defaults (abstract units) and measured
# values (microseconds) are both legitimate — they are never mixed within
# one profile.
#   xla_step             flat per-level cost of the compiled level loop's step
#   xla_lane             per padded lane on top of it
#   spmd_collective      flat per-level collective cost across processes
#   spmd_collective_lane per gathered lane of that collective
#   dispatch             per batched group dispatch of the interpreters
UNIT_NAMES = (
    "xla_step",
    "xla_lane",
    "spmd_collective",
    "spmd_collective_lane",
    "dispatch",
)


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """One device's measured (or default) cost units.

    ``source`` is ``"default"`` (hand-set constants, generation 0),
    ``"measured"`` (fresh microbenchmarks this process) or ``"persisted"``
    (reloaded from the cache dir with zero re-measurement).
    """

    units: Dict[str, float]
    fingerprint: str
    generation: int = 0
    source: str = "default"
    schema: int = SCHEMA_VERSION
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "schema": self.schema,
            "fingerprint": self.fingerprint,
            "generation": self.generation,
            "units": {k: float(self.units[k]) for k in UNIT_NAMES},
            "meta": dict(self.meta),
        }


_LOCK = threading.Lock()
_ACTIVE: Optional[CostProfile] = None


# ---------------------------------------------------------------------- #
# Environment / device identity
# ---------------------------------------------------------------------- #

def enabled() -> bool:
    """False when ``REPRO_CALIBRATE`` is ``off``/``0``/``false`` — the
    hand-set defaults then apply regardless of warmed/persisted state."""

    return os.environ.get("REPRO_CALIBRATE", "").strip().lower() not in (
        "off",
        "0",
        "false",
    )


def host_info(device="cuda") -> Dict[str, str]:
    """The identity a profile is keyed by: the device its units are
    measured on (``"cpu"``, or the CUDA device's name), the device count
    the SPMD backend shards over (the process group's), torch and CUDA
    versions, machine and system.  ``"cuda"`` without a card raises."""

    import torch

    from repro_torch.compile.lowering import resolve_device
    from repro_torch.compile.spmd import _actual_devices

    dev = resolve_device(device)
    return {
        "machine": _platform.machine(),
        "system": _platform.system(),
        "device": (
            "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
        ),
        "devices": str(_actual_devices()),
        "torch": str(torch.__version__),
        "cuda": torch.version.cuda or "none",
    }


_IDENTITY = ("machine", "system", "device", "devices", "torch", "cuda")


def host_fingerprint(
    info: Optional[Dict[str, str]] = None, *, device="cuda"
) -> str:
    info = info if info is not None else host_info(device)
    raw = "|".join(f"{k}={info[k]}" for k in _IDENTITY)
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def cache_dir() -> Path:
    """Profile directory: ``REPRO_CALIBRATE_DIR`` when set, else the
    XDG-style user cache (``~/.cache/repro-torch-calibrate``)."""

    override = os.environ.get("REPRO_CALIBRATE_DIR")
    if override:
        return Path(override)
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg) if xdg else Path.home() / ".cache"
    return base / "repro-torch-calibrate"


def profile_path(fingerprint: Optional[str] = None, *, device="cuda") -> Path:
    fp = fingerprint if fingerprint is not None else host_fingerprint(
        device=device
    )
    return cache_dir() / f"cost_profile-{fp}.json"


# ---------------------------------------------------------------------- #
# Default (hand-set) units, resolved LATE
# ---------------------------------------------------------------------- #

def _hand_set_units() -> Dict[str, float]:
    """Today's module constants, read at call time — monkeypatching
    ``repro_torch.compile.TORCH_STEP_UNITS`` (or the spmd/policy constants)
    changes every consumer."""

    import repro_torch.compile as _compile

    spmd = sys.modules.get("repro_torch.compile.spmd")
    policy = sys.modules.get("repro_torch.core.policy")
    return {
        "xla_step": float(_compile.TORCH_STEP_UNITS),
        "xla_lane": float(_compile.TORCH_LANE_UNITS),
        "spmd_collective": float(
            getattr(spmd, "SPMD_COLLECTIVE_UNITS", 4.0)
        ),
        "spmd_collective_lane": float(
            getattr(spmd, "SPMD_COLLECTIVE_LANE_UNITS", 0.125)
        ),
        "dispatch": float(getattr(policy, "DISPATCH_UNITS", 1.0)),
    }


def default_profile() -> CostProfile:
    # the fingerprint is not computed here: it would import torch and query
    # CUDA for the device name on every plan() of the auction
    return CostProfile(
        units=_hand_set_units(),
        fingerprint="default",
        generation=0,
        source="default",
    )


# ---------------------------------------------------------------------- #
# Active-profile state
# ---------------------------------------------------------------------- #

def active_profile() -> CostProfile:
    """The installed profile, or a fresh default snapshot when none (or
    when calibration is disabled via the env switch)."""

    with _LOCK:
        prof = _ACTIVE
    if prof is None or not enabled():
        return default_profile()
    return prof


def set_profile(profile: Optional[CostProfile]) -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = profile
    _metrics.gauge("calibrate.generation").set(
        0 if profile is None else profile.generation
    )


def reset() -> None:
    """Back to hand-set defaults in-memory (``obs.reset_all()`` hook).
    Persisted profile files are left on disk — restarts reuse them."""

    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def units() -> Dict[str, float]:
    """The unit costs every cost hook prices with *right now*."""

    prof = active_profile()
    if prof.source == "default":
        # a default snapshot may be stale vs a just-monkeypatched constant;
        # re-resolve late
        return _hand_set_units()
    return dict(prof.units)


def unit(name: str) -> float:
    if name not in UNIT_NAMES:
        raise KeyError(
            f"unknown calibration unit {name!r}; expected one of {UNIT_NAMES}"
        )
    return units()[name]


def dispatch_units() -> float:
    """Per-group dispatch weight of the interpreters' default cost model."""

    return units()["dispatch"]


def profile_generation() -> int:
    """Generation of the profile pricing the auction (0 = hand-set)."""

    prof = active_profile()
    return prof.generation if prof.source != "default" else 0


def summary_pointer() -> dict:
    """Deterministic pointer for ``report.summary()["obs"]`` — state flags
    plus where the full profile lives, never measured values."""

    prof = active_profile()
    return {
        "enabled": enabled(),
        "source": prof.source,
        "generation": prof.generation,
        "profile_export": (
            "repro_torch.calibrate.active_profile() / profile_path()"
        ),
    }


# ---------------------------------------------------------------------- #
# Persistence
# ---------------------------------------------------------------------- #

def _valid_units(raw: object) -> Optional[Dict[str, float]]:
    if not isinstance(raw, dict):
        return None
    out: Dict[str, float] = {}
    for name in UNIT_NAMES:
        v = raw.get(name)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        v = float(v)
        if not (v > 0.0) or v != v or v == float("inf"):
            return None
        out[name] = v
    return out


def load_profile(
    path: Optional[Path] = None, *, device="cuda"
) -> Optional[CostProfile]:
    """Read + validate a persisted profile of ``device``; ``None`` (and a
    ``calibrate.fallbacks`` tick) on a missing, corrupt, schema-mismatched
    or foreign-device file — the caller falls back to defaults or
    re-measures."""

    fingerprint = host_fingerprint(device=device)
    path = Path(path) if path is not None else profile_path(fingerprint)
    try:
        raw = json.loads(path.read_text())
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        _metrics.counter("calibrate.fallbacks").inc()
        return None
    units_d = _valid_units(raw.get("units")) if isinstance(raw, dict) else None
    if (
        units_d is None
        or raw.get("schema") != SCHEMA_VERSION
        or raw.get("fingerprint") != fingerprint
        or isinstance(raw.get("generation"), bool)
        or not isinstance(raw.get("generation"), int)
        or raw["generation"] < 0
    ):
        _metrics.counter("calibrate.fallbacks").inc()
        return None
    meta = raw.get("meta")
    return CostProfile(
        units=units_d,
        fingerprint=raw["fingerprint"],
        generation=raw["generation"],
        source="persisted",
        meta=dict(meta) if isinstance(meta, dict) else {},
    )


def save_profile(
    profile: CostProfile, path: Optional[Path] = None
) -> Path:
    """Atomic write (tempfile in the target dir + ``os.replace``), so a
    concurrent reader never sees a partial profile."""

    path = Path(path) if path is not None else profile_path(
        profile.fingerprint
    )
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=str(path.parent), prefix=path.name, suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(profile.as_dict(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


# ---------------------------------------------------------------------- #
# Process groups: one profile per group, rank 0's
# ---------------------------------------------------------------------- #

def _rank() -> int:
    from repro_torch.compile.spmd import _group

    return _group()[0]


def _from_rank0(obj):
    """``obj`` as rank 0 holds it, on every rank of the default process
    group (``obj`` itself without a group of two or more)."""

    from repro_torch.compile.spmd import _group

    if _group()[1] == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ---------------------------------------------------------------------- #
# Measurement entry points
# ---------------------------------------------------------------------- #

def measure(persist: bool = True, *, device="cuda", **bench_kwargs) -> CostProfile:
    """Run the microbenchmark suite on ``device`` and install (and by
    default persist) the resulting profile.  A no-op returning the
    defaults when the env switch disables calibration.  ``bench_kwargs``
    forward to :func:`repro_torch.calibrate.microbench.measure_units`
    (tests shrink the problem sizes through them).

    Under a process group every rank must call it: rank 0 times the level
    loop, every rank takes part in the SPMD timings (their collectives
    need the whole group), and rank 0 persists the profile and broadcasts
    it, so every rank installs the same one."""

    if not enabled():
        return default_profile()
    from repro_torch.calibrate import microbench as _mb

    units_d, meta = _mb.measure_units(device=device, **bench_kwargs)
    prof = None
    if _rank() == 0:
        prev = load_profile(device=device)
        info = host_info(device)
        meta = dict(meta)
        meta.update(info)
        prof = CostProfile(
            units=units_d,
            fingerprint=host_fingerprint(info),
            generation=(prev.generation if prev is not None else 0) + 1,
            source="measured",
            meta=meta,
        )
        if persist:
            save_profile(prof)
    prof = _from_rank0(prof)
    set_profile(prof)
    return prof


def warm(*, device="cuda", **bench_kwargs) -> CostProfile:
    """The documented "first use": reuse an already-installed or persisted
    profile (zero re-measurement — ``calibrate.measurements`` stays flat),
    else measure and persist one on ``device``.  ``PlanService`` calls this
    at startup when ``ServiceOptions(warm_profile=True)``, for the
    options' device.  Under a process group rank 0's file decides for
    every rank."""

    if not enabled():
        return default_profile()
    with _LOCK:
        prof = _ACTIVE
    if prof is not None and prof.source != "default":
        return prof
    prof = _from_rank0(
        load_profile(device=device) if _rank() == 0 else None
    )
    if prof is not None:
        set_profile(prof)
        _metrics.counter("calibrate.loads").inc()
        return prof
    return measure(device=device, **bench_kwargs)
