"""Production serving loop: continuous batching over decode slots, the
counterpart of the reference's ``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x7b \
        --requests 12 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

A minimal continuous-batching scheduler over the port's prefill/decode
steps: a fixed pool of decode slots; finished sequences (EOS or length
budget) are evicted and replaced by newly prefillable requests each
iteration, so the decode batch stays full.  Uses the int8 KV cache when
``--kv-quant`` is set.  :func:`serve_requests` is the loop, which
``chip_smoke.py`` drives at full size; :func:`main` runs the smoke-size
configuration of ``--arch`` on ``--device`` (``cuda`` unless the caller
asks for ``cpu``).

This module is a thin demo *client* of the plan service: the wave workloads
and their caching live in :mod:`repro_torch.serve`.  Each batch wave
resolves its synchronization through the staged pipeline — ``plan()`` once
per program *structure* (tenant plan LRU), then ``SyncPlan.compile`` on the
default service's backend and device per wave — resolved *concurrently*
(planner threads per wave), all riding the structural compile cache
(:mod:`repro_torch.compile`):

  * the acyclic decode chain (DECODE extends the KV cache with Δ=1, SAMPLE
    reads it at Δ=0),
  * a recurrence-bearing cross-slot rescoring scan whose mixed-sign carried
    dependence makes the plan a *hybrid* artifact, and
  * the two non-affine wave workloads (inspector-routed histogram,
    speculative sparse rescore), run on the wave's sampled tokens.

The dependence structures are identical from wave to wave, so every wave
after the first is a plan-LRU hit AND a structural-cache hit for every
compile.  The hit/miss counters are printed with the throughput summary.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.compile.lowering import resolve_device
from repro_torch.configs import ARCHITECTURES, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import serve_lm
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model_zoo as zoo
from repro_torch.obs import metrics
from repro_torch.serve import service as _service

# the wave workloads' public home is repro_torch.serve; re-exported here so
# the demo client's surface (serve.plan_wave etc.) is the reference's
from repro_torch.serve import (  # noqa: F401  (re-exported helper surface)
    PlanService,
    ServiceOptions,
    default_service,
    plan_rescore_sync,
    plan_route_sync,
    plan_scan_sync,
    plan_wave,
    plan_wave_sync,
    run_nonaffine_wave,
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: "object"
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeRun:
    """What one :func:`serve_requests` call served, and the last wave's
    plans."""

    done: List[Request]
    decoded_tokens: int
    seconds: float
    waves: int
    kv_quant: bool
    sync_plan: object = None
    scan_plan: object = None
    route_exe: object = None
    rescore_exe: object = None


def _plan_service_on(device: torch.device) -> None:
    """Make the process-default plan service run its level loops on
    ``device``, the model's: the waves' plans run where the decode does."""

    with _service._DEFAULT_LOCK:
        svc = _service._DEFAULT
        if svc is not None and resolve_device(svc.options.device) == device:
            return
        _service._DEFAULT = PlanService(ServiceOptions(device=str(device)))
    if svc is not None:
        svc.close()


def serve_requests(
    params: dict,
    cfg: ModelConfig,
    requests: List[Request],
    *,
    slots: int,
    max_new: int,
    device="cuda",
) -> ServeRun:
    """Serve ``requests`` (each prompt a 1-D int tensor, all of one length)
    in waves of ``slots``: each wave's four sync plans resolved on two
    planner threads, a fresh cache, the prefill, ``max_new - 1`` greedy
    decode steps and the wave's non-affine workloads on its sampled
    tokens.  Each request's ``generated`` receives its ``max_new`` tokens.
    The frontend stubs (frame or patch embeddings) are
    :func:`serve_lm.make_batch`'s for seed 0, the same every wave, as the
    reference draws them from one key."""

    dev = resolve_device(device)
    _plan_service_on(dev)
    queue = list(requests)
    prompt_len = int(queue[0].prompt.shape[0])
    npfx = serve_lm.prefix_len(cfg)
    max_len = npfx + prompt_len + max_new
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    frontend = {
        k: v for k, v in serve_lm.make_batch(cfg, slots, prompt_len, device=dev).items()
        if k != "tokens"
    }
    done: List[Request] = []

    # one cache per slot (slot-batched prefill keeps the demo simple; a real
    # server prefills in a second batch dimension and swaps pages)
    B = slots
    t0 = time.perf_counter()
    decoded_tokens = 0
    waves = 0
    sync_plan = scan_plan = None
    route_exe = rescore_exe = None
    with concurrent.futures.ThreadPoolExecutor(
        max_workers=2, thread_name_prefix="sync-planner"
    ) as planner:
        while queue:
            active = queue[:B]
            queue = queue[B:]
            # re-plan this wave's sync concurrently (acyclic decode chain +
            # the recurrence-bearing rescoring scan): structural-cache hits
            # on every wave after the first (same dependence structures)
            sync_plan, scan_plan, route_exe, rescore_exe = plan_wave(
                max_new, B, pool=planner
            )
            waves += 1
            t_run = time.perf_counter()
            while len(active) < B:  # pad the batch with a dummy copy
                active.append(Request(rid=-1, prompt=active[0].prompt, done=True))
            batch = {
                "tokens": torch.stack([r.prompt for r in active]).to(dev, torch.int32),
                **frontend,
            }
            cache = zoo.init_cache(cfg, B, max_len, device=dev)
            logits, cache = prefill(params, batch, cache)
            cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
            cache_len = npfx + prompt_len
            for r, t in zip(active, cur[:, 0].tolist()):
                if r.rid >= 0:
                    r.generated.append(int(t))
            for _ in range(max_new - 1):
                cur, cache = serve(params, cur, cache, cache_len)
                cache_len += 1
                for r, t in zip(active, cur[:, 0].tolist()):
                    if r.rid >= 0 and not r.done:
                        r.generated.append(int(t))
                        decoded_tokens += 1
            # non-affine wave workloads: route this wave's sampled tokens
            # through the inspector-planned histogram and the speculative
            # sparse rescore, index contents = actual runtime values
            run_nonaffine_wave(route_exe, rescore_exe, cur[:, 0].tolist(), bins=B)
            metrics.histogram("serve.run_ms").observe((time.perf_counter() - t_run) * 1e3)
            done.extend(r for r in active if r.rid >= 0)
    return ServeRun(
        done=done,
        decoded_tokens=decoded_tokens,
        seconds=time.perf_counter() - t0,
        waves=waves,
        kv_quant=cfg.kv_quant,
        sync_plan=sync_plan,
        scan_plan=scan_plan,
        route_exe=route_exe,
        rescore_exe=rescore_exe,
    )


def _pct(name: str) -> str:
    h = metrics.histogram(name)
    p50, p99 = h.percentile(50), h.percentile(99)
    if p50 is None:
        return f"{name.split('.')[-1]}: n=0"
    return f"{name.split('.')[-1]}: n={h.count} p50={p50:.2f}ms p99={p99:.2f}ms"


def print_summary(run: ServeRun) -> None:
    """The reference server's summary lines: throughput, per-wave latency
    distributions (plan/compile per planner call, 4 a wave; run per wave),
    rollbacks and the plans' cache traffic."""

    from repro_torch.core import inspector_cache_stats

    dt, waves = run.seconds, run.waves
    print(
        f"served {len(run.done)} requests, {run.decoded_tokens} decode tokens in "
        f"{dt:.2f}s ({run.decoded_tokens/max(dt,1e-9):.0f} tok/s batched, "
        f"kv_quant={run.kv_quant})"
    )
    rollbacks = metrics.counter("speculation.rollbacks").value
    reinspections = inspector_cache_stats()["misses"]
    print(
        f"per-wave latency ({waves} waves): {_pct('serve.plan_ms')} | "
        f"{_pct('serve.compile_ms')} | {_pct('serve.run_ms')}"
    )
    print(
        f"speculation rollbacks: {rollbacks}, inspector re-inspections "
        f"(memo misses): {reinspections}"
    )
    sync_plan, scan_plan = run.sync_plan, run.scan_plan
    if sync_plan is not None and sync_plan.compiled is not None:
        cc = sync_plan.compiled.cache_stats()
        print(
            f"decode sync plan: {waves} waves -> compile cache "
            f"{cc.get('hits', 0)} hits / {cc.get('misses', 0)} misses "
            f"(key {sync_plan.compiled.key[:12]}, retained="
            f"{[d.pretty() for d in sync_plan.elimination.retained]})"
        )
    if scan_plan is not None and scan_plan.compiled is not None:
        (rec,) = scan_plan.summary()["scc"]["recurrences"]
        print(
            f"cyclic scan plan: {waves} waves -> hybrid artifact "
            f"(key {scan_plan.compiled.key[:12]}, strategy={rec['strategy']}, "
            f"statements={rec['statements']})"
        )
    if run.route_exe is not None and run.rescore_exe is not None:
        print(
            f"non-affine wave workloads: routing histogram "
            f"(deps='inspect', key {run.route_exe.compiled.key[:12]}) + sparse "
            f"rescore (deps='speculate', key {run.rescore_exe.compiled.key[:12]})"
            f", inspector memo {inspector_cache_stats()}"
        )
    print("sample:", run.done[0].rid, run.done[0].generated[:10])


def main(argv: Optional[List[str]] = None) -> ServeRun:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi_6b", choices=ARCHITECTURES)
    ap.add_argument("--slots", type=int, default=4, help="decode batch size")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if args.kv_quant:
        cfg = cfg.scaled(kv_quant=True)
    dev = resolve_device(args.device)
    params = zoo.init(cfg, device=dev, seed=0)
    # request queue (synthetic prompts)
    gen = torch.Generator(device=dev).manual_seed(0)
    queue = [
        Request(
            rid=i,
            prompt=torch.randint(
                0, cfg.vocab_size, (args.prompt_len,), generator=gen, device=dev,
                dtype=torch.int32,
            ),
        )
        for i in range(args.requests)
    ]
    run = serve_requests(
        params, cfg, queue, slots=args.slots, max_new=args.max_new, device=dev
    )
    print_summary(run)
    return run


if __name__ == "__main__":
    main()
