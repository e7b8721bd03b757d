"""``ServiceOptions`` — the frozen, validated configuration of a
:class:`~repro_torch.serve.service.PlanService`.

Mirrors the contract of :class:`repro_torch.core.parallelizer.PlanOptions`: frozen
and hashable so a service configuration is a legitimate cache-key component,
and validated *eagerly* so a bad knob fails at construction with a message
naming the accepted set — including unknown knob *names*, which
``PlanOptions`` leaves to the dataclass ``TypeError`` but a service (whose
callers typically forward a config dict) must reject with the same
ValueError-naming-the-accepted-set shape the backend capability contracts
use (:func:`repro_torch.core.parallelizer._check_backend_options`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, init=False)
class ServiceOptions:
    """Typed knobs of a :class:`~repro_torch.serve.service.PlanService`.

    ``backend``: the execution backend every submitted request compiles for
    (checked against the parallelizer's backend registry, lazy providers
    included).
    ``workers``: worker-pool width — how many requests resolve concurrently
    (per-structure admission still serializes same-structure requests, so
    one cold structure never plans twice).
    ``plan_cache_capacity``: per-tenant bound of the plan/artifact LRU
    (evictions surface as ``plan_cache.evictions`` in ``obs.metrics``).
    ``plan_cache_bytes``: byte budget over ALL tenants' cached entries —
    each entry carries an estimated footprint of its plan plus compiled
    artifact, the total rides the ``plan_cache.bytes`` gauge, and the LRU
    evicts past-budget entries oldest-first (count bound still applies).
    ``max_queue_depth``: admission bound — ``submit()`` beyond this many
    outstanding requests is rejected instead of queueing without limit.
    ``default_tenant``: tenant used when ``submit()``/``resolve()`` are not
    given one.
    ``device``: the device the ``"torch"`` backend runs every request on —
    ``"cuda"``, ``"cuda:N"`` or ``"cpu"``; an unavailable device fails here,
    never by falling back to the CPU.  The other backends run on the host:
    they are not passed it, and it is not checked for them.
    ``warm_profile``: warming the host's cost-calibration profile at
    construction needs ``repro_torch.calibrate.warm``, which the port does
    not have yet (ROADMAP Queue 1 item 5): ``True`` is refused.
    """

    backend: str = "torch"
    device: str = "cuda"
    workers: int = 2
    plan_cache_capacity: int = 16
    plan_cache_bytes: int = 64 * 1024 * 1024
    max_queue_depth: int = 64
    default_tenant: str = "default"
    warm_profile: bool = False

    def __init__(self, **knobs: object) -> None:
        accepted = tuple(f.name for f in dataclasses.fields(self))
        unknown = sorted(k for k in knobs if k not in accepted)
        if unknown:
            raise ValueError(
                f"ServiceOptions does not accept knob(s) "
                f"{', '.join(repr(k) for k in unknown)}; the accepted set is "
                f"{sorted(accepted)} — drop the knob or check its spelling"
            )
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, knobs.get(f.name, f.default))
        self._validate()

    def _validate(self) -> None:
        from repro_torch.core.parallelizer import get_backend

        if not isinstance(self.backend, str) or not self.backend:
            raise ValueError(
                f"backend must be a non-empty backend name, got "
                f"{self.backend!r}"
            )
        get_backend(self.backend)  # raises naming the registered set
        for knob in (
            "workers",
            "plan_cache_capacity",
            "plan_cache_bytes",
            "max_queue_depth",
        ):
            v = getattr(self, knob)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"{knob} must be a positive integer, got {v!r} — a "
                    "service with zero capacity cannot admit requests"
                )
        if not isinstance(self.default_tenant, str) or not self.default_tenant:
            raise ValueError(
                f"default_tenant must be a non-empty string, got "
                f"{self.default_tenant!r}"
            )
        if not isinstance(self.warm_profile, bool):
            raise ValueError(
                f"warm_profile must be a bool, got {self.warm_profile!r}"
            )
        if self.warm_profile:
            raise ValueError(
                "warm_profile=True needs repro_torch.calibrate.warm, which "
                "the port does not have yet (ROADMAP Queue 1 item 5); "
                "construct the service with warm_profile=False"
            )
        if self.backend == "torch":  # the one backend with a device knob
            self._validate_device()

    def _validate_device(self) -> None:
        from repro_torch.compile.lowering import resolve_device

        accepted = "'cuda', 'cuda:N' or 'cpu'"
        if not isinstance(self.device, str):
            raise ValueError(
                f"device must be one of {accepted}, got {self.device!r}"
            )
        try:
            dev = resolve_device(self.device)
            if dev.type == "cuda":
                import torch

                if dev.index >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"{torch.cuda.device_count()} CUDA device(s) present"
                    )
        except (RuntimeError, ValueError) as e:
            raise ValueError(
                f"device {self.device!r} is not usable ({e}); the accepted "
                f"set is {accepted}, on a machine that has the device"
            ) from None
