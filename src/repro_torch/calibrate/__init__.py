"""``repro_torch.calibrate`` — the cost-profile surface the strategy auction
reads.

This is the port's counterpart of ``repro.calibrate``, cut to what the
planning path consults: the profile schema, the hand-set default units and
the late-resolving readers (:func:`units`, :func:`dispatch_units`,
:func:`profile_generation`, :func:`summary_pointer`).  The scheduling policy
(:mod:`repro_torch.core.policy`) and the backend cost hook
(:func:`repro_torch.compile.torch_level_cost`) price offers through
:func:`units`, which never measures anything.

The unit names keep the reference schema: ``xla_step`` / ``xla_lane`` price
one step of the compiled level loop and one padded lane of it — in this
package that loop is the ``"torch"`` backend.  Measuring the units on the
card (the reference's microbench) is not ported yet: :func:`measure` raises.

``REPRO_CALIBRATE=off`` (or ``0`` / ``false``) pins the hand-set defaults,
as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import platform as _platform
import sys
import threading
from typing import Dict, Optional

from repro_torch.obs import metrics as _metrics

__all__ = [
    "SCHEMA_VERSION",
    "UNIT_NAMES",
    "CostProfile",
    "active_profile",
    "default_profile",
    "dispatch_units",
    "enabled",
    "host_fingerprint",
    "host_info",
    "measure",
    "profile_generation",
    "reset",
    "set_profile",
    "summary_pointer",
    "unit",
    "units",
]

SCHEMA_VERSION = 1

# The five unit costs (relative weights inside one backend's auction):
#   xla_step             flat per-level cost of the compiled level loop's step
#   xla_lane             per padded lane on top of it
#   spmd_collective      flat per-level collective cost on a device mesh
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
    """One host's cost units; ``source`` is ``"default"`` (hand-set,
    generation 0) or whatever installed it through :func:`set_profile`."""

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


def enabled() -> bool:
    """False when ``REPRO_CALIBRATE`` is ``off``/``0``/``false``."""

    return os.environ.get("REPRO_CALIBRATE", "").strip().lower() not in (
        "off",
        "0",
        "false",
    )


def host_info() -> Dict[str, str]:
    """The identity a profile is keyed by: platform, torch version, CUDA
    version and the first CUDA device's name (``none`` without a card)."""

    import torch

    cuda = torch.version.cuda or "none"
    device = (
        torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none"
    )
    return {
        "machine": _platform.machine(),
        "system": _platform.system(),
        "torch": str(torch.__version__),
        "cuda": cuda,
        "device": device,
    }


def host_fingerprint(info: Optional[Dict[str, str]] = None) -> str:
    info = info if info is not None else host_info()
    raw = "|".join(
        f"{k}={info[k]}"
        for k in ("machine", "system", "torch", "cuda", "device")
    )
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def _hand_set_units() -> Dict[str, float]:
    """The module constants, read at call time so a monkeypatched value
    takes effect in every consumer."""

    import repro_torch.compile as _compile

    policy = sys.modules.get("repro_torch.core.policy")
    return {
        "xla_step": float(_compile.TORCH_STEP_UNITS),
        "xla_lane": float(_compile.TORCH_LANE_UNITS),
        "spmd_collective": 4.0,
        "spmd_collective_lane": 0.125,
        "dispatch": float(getattr(policy, "DISPATCH_UNITS", 1.0)),
    }


def default_profile() -> CostProfile:
    # the fingerprint is not computed here: it would import torch and query
    # CUDA for the device name on every plan() of the auction
    return CostProfile(
        units=_hand_set_units(), fingerprint="default", source="default"
    )


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
    """Back to hand-set defaults (``obs.reset_all()`` hook)."""

    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def units() -> Dict[str, float]:
    """The unit costs every cost hook prices with *right now*."""

    prof = active_profile()
    if prof.source == "default":
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
    """Deterministic pointer for ``report.summary()["obs"]`` — state flags,
    never measured values."""

    prof = active_profile()
    return {
        "enabled": enabled(),
        "source": prof.source,
        "generation": prof.generation,
        "profile_export": "repro_torch.calibrate.active_profile()",
    }


def measure(**_bench_kwargs) -> CostProfile:
    """Measuring the units on the card is not ported yet."""

    raise NotImplementedError(
        "repro_torch.calibrate.measure: the calibration microbench is not "
        "ported yet (ROADMAP Queue 1 item 5); the hand-set units apply"
    )
