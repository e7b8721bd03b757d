"""``repro_torch.compile`` — the ``"torch"`` backend: optimized SyncPrograms
run as an eager PyTorch level loop on one device.

Where the wavefront backend (:mod:`repro_torch.core.wavefront`) interprets
the dependence-level schedule in NumPy, this package runs it on a device:
the host builds the same padded, mask-guarded level tables as the
reference's XLA lowering (:mod:`repro_torch.compile.lowering`), moves them
to the device once per prepared case, and launches each level's active
statement groups as float64 gather / compute / scatter steps.  Artifacts
are cached structurally — by a canonical hash of (statement graph, retained
dependences, execution model), never loop bounds or the device
(:mod:`repro_torch.compile.structure`, :mod:`repro_torch.compile.cache`).

``plan(...).compile("torch", device=...)`` takes the device; it defaults
to ``"cuda"`` and raises when no card is present.  Nothing falls back to
the CPU unless the caller asks for ``device="cpu"``.

Import is lazy: pulling this package costs no torch import until an
artifact is built or run.
"""

from __future__ import annotations

import importlib
from typing import TYPE_CHECKING

from repro_torch.compile.structure import (
    compute_fingerprint,
    program_fingerprint,
    structural_key,
)

_LAZY = {
    "CompileCache": "repro_torch.compile.cache",
    "GLOBAL_CACHE": "repro_torch.compile.cache",
    "clear_compile_cache": "repro_torch.compile.cache",
    "compile_cache_stats": "repro_torch.compile.cache",
    "get_or_compile": "repro_torch.compile.cache",
    "CompiledProgram": "repro_torch.compile.lowering",
    "TorchLoweringError": "repro_torch.compile.lowering",
    "device_scope": "repro_torch.compile.lowering",
    "resolve_device": "repro_torch.compile.lowering",
    "execute_compiled": "repro_torch.compile.executor",
}

if TYPE_CHECKING:  # pragma: no cover - typing aid only
    from repro_torch.compile.cache import (  # noqa: F401
        CompileCache,
        GLOBAL_CACHE,
        clear_compile_cache,
        compile_cache_stats,
        get_or_compile,
    )
    from repro_torch.compile.executor import execute_compiled  # noqa: F401
    from repro_torch.compile.lowering import (  # noqa: F401
        CompiledProgram,
        TorchLoweringError,
        device_scope,
        resolve_device,
    )


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


# ---------------------------------------------------------------------- #
# Backend capability: the cost hook.  Import-light on purpose (no torch, no
# numpy) — the core report path consults it through BackendSpec.level_cost.
# ---------------------------------------------------------------------- #

# Hand-set default cost units, in padded-lane units: a flat per-step share
# worth about one lane, plus one unit per padded lane.  The calibration
# surface (repro_torch.calibrate.units) resolves them late, so
# monkeypatching them here takes effect everywhere.
TORCH_STEP_UNITS = 1.0   # flat per-step overhead of one level-loop step
TORCH_LANE_UNITS = 1.0   # cost of one padded lane on top of it


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def torch_level_cost(plan, ctx) -> float:
    """Per-SCC cost of a strategy offer *on the device level loop*.

    The formula of the reference's ``xla_level_cost``: each level pays a
    near-flat step cost plus work proportional to the *padded* lane width of
    each statement's table row, so a skewed wavefront whose widest diagonal
    pads to 64 lanes can lose its depth advantage to narrow sequential
    chunks.  Cost: ``depth × statements × (step + lane ×
    next_pow2(width))``, with the units resolved through
    :func:`repro_torch.calibrate.units`.
    """

    from repro_torch.calibrate import units as _units

    u = _units()
    width = plan.max_width if plan.max_width else max(1, round(plan.width))
    lanes = _next_pow2(max(1, int(width)))
    return float(plan.depth) * len(ctx.statements) * (
        u["xla_step"] + u["xla_lane"] * lanes
    )


__all__ = sorted(
    [
        "TORCH_LANE_UNITS",
        "TORCH_STEP_UNITS",
        "compute_fingerprint",
        "program_fingerprint",
        "structural_key",
        "torch_level_cost",
        *_LAZY,
    ]
)


# ---------------------------------------------------------------------- #
# Backend registration: plan(...).compile("torch", device=...).  The
# callables defer torch-heavy imports until the backend is exercised.
# ---------------------------------------------------------------------- #

def _torch_prepare(
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
    from repro_torch.compile.cache import get_or_compile
    from repro_torch.compile.lowering import resolve_device

    dev = resolve_device(device)  # raises on "cuda" without a card
    compiled, hit = get_or_compile(
        optimized.program,
        tuple(retained),
        model=model,
        processors=processors,
        chunk_limit=chunk_limit,
        scc_policy=scc_policy,
        deps=deps,
    )
    return {"compiled": compiled, "compile_hit": hit, "device": dev}


def _torch_differential(sync, *, store=None, stalls=None, device="cuda"):
    from repro_torch.compile.executor import run_xla
    from repro_torch.compile.lowering import device_scope

    with device_scope(device):
        return run_xla(sync, store=store, compare=False).store


def _torch_run(sync, artifacts, *, store=None, stalls=None):
    from repro_torch.compile.executor import execute_compiled
    from repro_torch.compile.lowering import device_scope

    with device_scope(artifacts["device"]):
        return execute_compiled(artifacts["compiled"], sync, store=store)


def _register() -> None:
    from repro_torch.core.parallelizer import BackendSpec, register_backend

    register_backend(
        BackendSpec(
            name="torch",
            prepare=_torch_prepare,
            accepts=(
                "chunk_limit",
                "scc_policy",
                "model",
                "processors",
                "deps",
                "device",
            ),
            level_cost=torch_level_cost,
            differential=_torch_differential,
            run=_torch_run,
            description=(
                "structurally cached eager PyTorch level loop on one device "
                "(repro_torch.compile; one artifact per dependence structure)"
            ),
        )
    )


_register()
