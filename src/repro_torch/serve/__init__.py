"""repro_torch.serve — the multi-tenant plan service.

Public surface of the serving layer (ROADMAP "Serving layer" item): a
:class:`PlanService` admits requests for many program structures
concurrently and resolves each through the full cache hierarchy — per-tenant
plan LRU → structural compile cache → trace bucket → per-bounds tables — so
steady-state traffic never re-analyzes *or re-traces*.

    from repro_torch.serve import PlanService, ServiceOptions

    svc = PlanService(ServiceOptions(workers=4, plan_cache_capacity=8))
    fut = svc.submit(prog, PlanOptions(method="isd"), tenant="decode",
                     run=True)
    result = fut.result()          # ServiceResult: plan, executable, store
    svc.drain()                    # block until the queue is empty
    snap = svc.stats()             # the SERVE_sync artifact snapshot
    svc.close()

The wave helpers the demo client (``repro_torch.launch.serve``) uses —
``plan_wave_sync`` / ``plan_scan_sync`` / ``plan_route_sync`` /
``plan_rescore_sync`` / ``plan_wave`` / ``run_nonaffine_wave`` — live here
too, riding the process-default service instance (:func:`default_service`).
"""

from repro_torch.serve.options import ServiceOptions
from repro_torch.serve.service import (
    PlanService,
    ServiceResult,
    default_service,
    reset_default_service,
)
from repro_torch.serve.waves import (
    decode_program,
    plan_rescore_sync,
    plan_route_sync,
    plan_scan_sync,
    plan_wave,
    plan_wave_sync,
    run_nonaffine_wave,
    scan_program,
)

__all__ = [
    "PlanService",
    "ServiceOptions",
    "ServiceResult",
    "default_service",
    "reset_default_service",
    "decode_program",
    "scan_program",
    "plan_wave_sync",
    "plan_scan_sync",
    "plan_route_sync",
    "plan_rescore_sync",
    "run_nonaffine_wave",
    "plan_wave",
]
