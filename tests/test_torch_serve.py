"""The port's plan service (:mod:`repro_torch.serve`) on the ``"torch"``
backend, on the CPU, mirroring ``tests/test_serve.py``.

Every request runs ``plan → compile("torch", device="cpu") → run`` and is
held against ``run_sequential``; the same submissions through the
reference's ``PlanService`` on its NumPy ``"wavefront"`` backend give the
same stores, the same structural misses and the same per-tenant LRU
traffic.  On the CPU the level loop stays eager, so the CUDA-graph
counters (``captures`` / ``replays`` / ``eager_sweeps``) do not move; the
capture itself is tested on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import pytest
import torch

import repro.core as ref_core
import repro.obs as ref_obs
import repro.serve as ref_serve

import repro_torch.core as tcore
import repro_torch.obs as obs
import repro_torch.serve as tserve
from repro_torch.compile import compile_cache_stats
from repro_torch.compile.structure import program_fingerprint
from repro_torch.core import (
    LoopProgram,
    analysis_cache_stats,
    indexed_store,
    inspect_dependences,
    inspector_cache_stats,
    run_sequential,
)
from repro_torch.obs import metrics
from repro_torch.serve import (
    PlanService,
    ServiceOptions,
    decode_program,
    plan_rescore_sync,
    scan_program,
)
from repro_torch.serve import service as service_mod

CPU = {"device": "cpu"}


def _doall_program(n: int, core=tcore) -> LoopProgram:
    """A dependence-free two-statement chain — the third soak structure
    (``tests/test_serve.py``'s helper), built from either package."""

    return core.LoopProgram(
        statements=(
            core.Statement("A", core.ArrayRef("a", 0), (core.ArrayRef("b", 0),)),
            core.Statement("B", core.ArrayRef("c", 0), (core.ArrayRef("a", 0),)),
        ),
        bounds=((0, n),),
    )


def _fresh_initial(prog) -> dict:
    return {a: dict(c) for a, c in prog.initial_store().items()}


def _graph_counters(stats: dict) -> tuple:
    return stats["captures"], stats["replays"], stats["eager_sweeps"]


# ---------------------------------------------------------------------- #
# ServiceOptions
# ---------------------------------------------------------------------- #

def test_service_options_rejects_unknown_knob_naming_accepted_set():
    with pytest.raises(ValueError) as exc:
        ServiceOptions(worker=4, **CPU)  # typo for "workers"
    msg = str(exc.value)
    assert "'worker'" in msg
    for name in (
        "backend",
        "device",
        "workers",
        "plan_cache_capacity",
        "max_queue_depth",
        "default_tenant",
    ):
        assert name in msg


@pytest.mark.parametrize(
    "bad",
    [
        {"backend": "no-such-backend"},
        {"backend": "xla"},  # the reference's default; the port has none
        {"workers": 0},
        {"plan_cache_capacity": 0},
        {"max_queue_depth": -1},
        {"workers": True},
        {"default_tenant": ""},
        {"warm_profile": 1},
    ],
    ids=lambda b: "-".join(f"{k}={v!r}" for k, v in b.items()),
)
def test_service_options_validates_values(bad):
    with pytest.raises(ValueError) as exc:
        ServiceOptions(**{**CPU, **bad})
    if "backend" in bad:
        assert bad["backend"] in str(exc.value)
        assert "torch" in str(exc.value)  # the registered set is named


@pytest.mark.parametrize("device", ["tpu", "cuda:99", 0, ""])
def test_service_options_rejects_unknown_or_unavailable_device(device):
    with pytest.raises(ValueError) as exc:
        ServiceOptions(device=device)
    msg = str(exc.value)
    assert repr(device) in msg
    assert "'cuda'" in msg and "'cpu'" in msg  # the accepted set


def test_service_options_refuses_warm_profile_naming_the_roadmap_item():
    with pytest.raises(ValueError) as exc:
        ServiceOptions(warm_profile=True, **CPU)
    assert "item 5" in str(exc.value)
    assert ServiceOptions(warm_profile=False, **CPU).warm_profile is False


def test_service_options_defaults_are_torch_on_cuda():
    defaults = {f.name: f.default for f in dataclasses.fields(ServiceOptions)}
    assert defaults["backend"] == "torch"
    assert defaults["device"] == "cuda"
    assert defaults["warm_profile"] is False
    if torch.cuda.is_available():
        assert ServiceOptions().device == "cuda"
    else:
        # nothing falls back to the CPU by itself
        with pytest.raises(ValueError, match="'cuda'"):
            ServiceOptions()


def test_service_options_frozen_and_hashable():
    opts = ServiceOptions(workers=3, **CPU)
    assert opts.workers == 3
    assert opts.backend == "torch"  # defaults survive the custom __init__
    assert opts.device == "cpu"
    with pytest.raises(Exception):
        opts.workers = 5  # type: ignore[misc]
    assert hash(opts) == hash(ServiceOptions(workers=3, **CPU))
    assert opts != ServiceOptions(workers=4, **CPU)
    # a host backend is neither checked for the device nor given it: the
    # default "cuda" is accepted without a card, and requests still run
    host = ServiceOptions(backend="wavefront")
    assert host.device == "cuda"
    with PlanService(host) as svc:
        prog = decode_program(8)
        res = svc.submit(prog, run=True).result()
        assert res.executable.backend == "wavefront"
        assert res.store == run_sequential(prog, _fresh_initial(prog))


# ---------------------------------------------------------------------- #
# Basic request surface
# ---------------------------------------------------------------------- #

def test_submit_runs_and_matches_oracle():
    obs.reset_all()
    with PlanService(ServiceOptions(workers=2, **CPU)) as svc:
        prog = decode_program(8)
        res = svc.submit(prog, tenant="t0", run=True).result()
        assert res.tenant == "t0"
        assert res.plan_cached is False
        assert res.store == run_sequential(prog, _fresh_initial(prog))
        assert res.executable.backend == "torch"
        # same structure+bounds again: plan-LRU hit
        res2 = svc.submit(prog, tenant="t0", run=True).result()
        assert res2.plan_cached is True
        assert res2.store == res.store
        # a caller's store is copied, not mutated
        init = _fresh_initial(prog)
        init["kv"] = {c: v + 0.5 for c, v in init["kv"].items()}
        before = {a: dict(c) for a, c in init.items()}
        res3 = svc.submit(prog, tenant="t0", store=init).result()
        assert init == before
        assert res3.store == run_sequential(prog, before)
        assert res3.store != res.store
        stats = svc.drain()
        t0_stats = dict(stats["tenants"]["t0"])
        assert t0_stats.pop("bytes") > 0  # artifact entries are byte-accounted
        assert t0_stats == {
            "size": 1, "hits": 2, "misses": 1, "evictions": 0,
        }
        assert stats["submitted"] == stats["completed"] == 3
        assert stats["backend"] == "torch" and stats["device"] == "cpu"
        # the later requests reused the cached compiled artifact
        assert metrics.counter("plan_cache.artifact_hits").value == 2
        assert _graph_counters(stats) == (0, 0, 0)  # eager on the CPU
        assert "traces" not in stats  # captures takes its place


def test_admission_bound_and_close_reject():
    obs.reset_all()
    svc = PlanService(ServiceOptions(workers=1, max_queue_depth=1, **CPU))
    prog = _doall_program(8)
    # hold the structure's admission lock so the first request parks in
    # resolve() — the admission bound is then observable deterministically
    gate = svc._structure_lock(program_fingerprint(prog))
    gate.acquire()
    try:
        first = svc.submit(prog, tenant="t")
        with pytest.raises(RuntimeError) as exc:
            svc.submit(prog, tenant="t")
        assert "max_queue_depth" in str(exc.value)
    finally:
        gate.release()
    assert first.result().plan is not None
    svc.close()
    with pytest.raises(RuntimeError) as exc:
        svc.submit(prog, tenant="t")
    assert "closed" in str(exc.value)
    svc.close()  # idempotent


def test_deadline_drops_expired_queued_request():
    obs.reset_all()
    svc = PlanService(ServiceOptions(workers=1, max_queue_depth=4, **CPU))
    prog = _doall_program(8)
    gate = svc._structure_lock(program_fingerprint(prog))
    gate.acquire()
    try:
        first = svc.submit(prog, tenant="t")
        doomed = svc.submit(prog, tenant="t", deadline_ms=1.0)
        # hold the gate until the deadline has certainly expired
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.02:
            time.sleep(0.005)
    finally:
        gate.release()
    assert first.result().plan is not None
    with pytest.raises(RuntimeError) as exc:
        doomed.result()
    assert "deadline" in str(exc.value)
    stats = svc.drain()
    assert stats["deadline_drops"] == 1
    assert metrics.counter("serve.deadline_drops").value == 1
    # a request that starts before its deadline is NOT preempted
    ok = svc.submit(prog, tenant="t", deadline_ms=60_000.0, run=True).result()
    assert ok.store == run_sequential(prog, _fresh_initial(prog))
    svc.close()


@pytest.mark.parametrize("bad", [0, -1, -0.5, True, "5"])
def test_deadline_ms_validation(bad):
    with PlanService(ServiceOptions(workers=1, **CPU)) as svc:
        with pytest.raises(ValueError):
            svc.submit(_doall_program(8), deadline_ms=bad)


# ---------------------------------------------------------------------- #
# The soak: bucket hits + evictions + mid-soak oracle samples
# ---------------------------------------------------------------------- #

# (tenant, program factory, two bounds variants in the same or adjacent
# power-of-two buckets) — tests/test_serve.py's soak mix
SOAK = [
    ("decode", decode_program, (12, 13)),
    ("scan", lambda h: scan_program(3, h), (4, 5)),
    ("doall", _doall_program, (16, 17)),
]


def test_soak_bucket_hits_and_tenant_isolation():
    obs.reset_all()
    waves = 20
    with PlanService(
        ServiceOptions(workers=2, plan_cache_capacity=2, **CPU)
    ) as svc:
        # warmup wave: every (structure, bounds) pair runs once
        scan_exe = None
        for tenant, make, bounds in SOAK:
            for b in bounds:
                res = svc.submit(make(b), tenant=tenant, run=True).result()
                if tenant == "scan":
                    scan_exe = res.executable
        warm = svc.drain()
        assert warm["bucket_misses"] > 0

        # the two scan bounds (horizon 4 and 5) pad into the SAME bucket
        assert scan_exe is not None
        assert scan_exe.compiled.bucket_count == 1

        for wave in range(waves):
            results = []
            for tenant, make, bounds in SOAK:
                prog = make(bounds[wave % 2])
                sample = wave in (5, 10, 15)
                results.append(
                    (prog, svc.submit(prog, tenant=tenant, run=sample))
                )
                svc.submit(prog, tenant="mixed")
            for prog, fut in results:
                res = fut.result()
                if res.store is not None:  # sampled wave: oracle check
                    assert res.store == run_sequential(
                        prog, _fresh_initial(prog)
                    ), f"soak diverged from oracle at wave {wave}"
        stats = svc.drain()

    # no new bucket after the warmup wave, and the sampled runs hit
    assert stats["bucket_misses"] == warm["bucket_misses"]
    assert metrics.counter("torch.bucket_hits").value > 0
    assert _graph_counters(stats) == (0, 0, 0)  # the CPU sweep is eager
    # the chatty tenant churned its tight LRU...
    assert stats["tenants"]["mixed"]["evictions"] > 0
    assert stats["plan_cache"]["evictions"] > 0
    assert metrics.counter("plan_cache.evictions").value > 0
    # ...while the per-structure tenants stayed hot and untouched
    for tenant in ("decode", "scan", "doall"):
        assert stats["tenants"][tenant]["evictions"] == 0
        assert stats["tenants"][tenant]["hits"] >= waves
        assert stats["tenants"][tenant]["misses"] == 2  # the two bounds
    assert stats["plan_cache"]["size"] <= 4 * 2  # per-tenant bound held
    json.dumps(stats)  # the snapshot is JSON-able


# ---------------------------------------------------------------------- #
# Concurrency: structural misses == distinct structures under racing
# submitters
# ---------------------------------------------------------------------- #

def test_six_submitters_keep_structural_misses_at_distinct_structures():
    obs.reset_all()
    programs = [decode_program(9), scan_program(3, 6), _doall_program(11)]
    n_threads, per_thread = 6, 8
    with PlanService(ServiceOptions(workers=4, **CPU)) as svc:
        barrier = threading.Barrier(n_threads)
        futures, errs = [], []
        lock = threading.Lock()

        def submitter(tid: int) -> None:
            barrier.wait(timeout=60)  # maximize the race on cold structures
            try:
                batch = [
                    svc.submit(
                        programs[(tid + k) % len(programs)],
                        tenant=f"t{tid}",
                        run=k % 4 == 0,
                    )
                    for k in range(per_thread)
                ]
                with lock:
                    futures.extend(batch)
            except Exception as e:  # pragma: no cover - failure reporting
                with lock:
                    errs.append(e)

        threads = [
            threading.Thread(target=submitter, args=(i,))
            for i in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errs
        for fut in futures:
            res = fut.result(timeout=120)
            assert res.executable is not None
            if res.store is not None:
                prog = res.plan.program
                assert res.store == run_sequential(prog, _fresh_initial(prog))
        stats = svc.drain(timeout=120)

    cc = compile_cache_stats()
    assert cc["misses"] == len(programs), cc
    art = metrics.counter("plan_cache.artifact_hits").value
    assert cc["hits"] + art == n_threads * per_thread - len(programs), (cc, art)
    assert stats["completed"] == n_threads * per_thread


# ---------------------------------------------------------------------- #
# Inspector memo across serve waves, through the waves helpers
# ---------------------------------------------------------------------- #

@pytest.fixture
def cpu_default_service(monkeypatch):
    """The waves helpers ride the process-default service, which defaults
    to CUDA; install a CPU one for the test."""

    obs.reset_all()
    svc = PlanService(ServiceOptions(**CPU))
    monkeypatch.setattr(service_mod, "_DEFAULT", svc)
    yield svc
    svc.close()


def test_inspector_memo_hits_across_waves_with_changed_nonindex_data(
    cpu_default_service,
):
    exe = plan_rescore_sync(8)  # deps="speculate" sparse matvec
    assert exe.backend == "torch"
    prog = exe.plan.program
    rows = [3, 1, 0, 2, 7, 5, 4, 6]  # a permutation: no conflicts
    cols = list(range(8))

    store1 = indexed_store(prog, {"row": rows, "col": cols})
    init1 = {a: dict(c) for a, c in store1.items()}
    out1 = exe.run(store={a: dict(c) for a, c in store1.items()})
    assert out1 == run_sequential(prog, init1)
    s1 = inspector_cache_stats()
    assert s1["misses"] >= 1

    store2 = indexed_store(prog, {"row": rows, "col": cols})
    for arr in ("v", "x"):
        for cell in store2[arr]:
            store2[arr][cell] = store2[arr][cell] + 7.25
    init2 = {a: dict(c) for a, c in store2.items()}
    out2 = exe.run(store={a: dict(c) for a, c in store2.items()})
    assert out2 == run_sequential(prog, init2)
    assert out2 != out1
    s2 = inspector_cache_stats()
    assert s2["misses"] == s1["misses"], "non-index change re-inspected"
    assert s2["hits"] == s1["hits"] + 1
    assert metrics.counter("speculation.rollbacks").value == 0

    store_f = indexed_store(prog, {"row": rows, "col": cols})
    for arr in ("row", "col"):
        for cell in store_f[arr]:
            store_f[arr][cell] = float(store_f[arr][cell])
    inspect_dependences(prog, store_f)
    s3 = inspector_cache_stats()
    assert s3["misses"] == s2["misses"]
    assert s3["hits"] == s2["hits"] + 1


def test_plan_wave_resolves_four_tenants_on_the_default_service(
    cpu_default_service,
):
    from repro_torch.serve import plan_wave, run_nonaffine_wave

    _, _, route, rescore = plan_wave(6, 3)
    assert route.backend == rescore.backend == "torch"
    routed, rescored = run_nonaffine_wave(route, rescore, [5, 2, 7, 1], 4)
    assert routed and rescored  # each asserted bit-equal to the oracle
    stats = cpu_default_service.stats()
    assert sorted(stats["tenants"]) == ["decode", "rescore", "route", "scan"]
    plan_wave(6, 3)
    cache = cpu_default_service.stats()["plan_cache"]
    assert (cache["hits"], cache["misses"]) == (4, 4)  # the LRUs hit


# ---------------------------------------------------------------------- #
# Byte-accounted artifact LRU
# ---------------------------------------------------------------------- #

def test_byte_budget_evicts_and_gauge_tracks():
    obs.reset_all()
    prog = decode_program(8)
    with PlanService(
        ServiceOptions(workers=1, plan_cache_bytes=1, **CPU)
    ) as svc:
        for _ in range(3):
            res = svc.submit(prog, tenant="t", run=True).result()
            assert res.store == run_sequential(prog, _fresh_initial(prog))
        stats = svc.drain()
    assert stats["plan_cache"]["size"] == 0
    assert stats["plan_cache"]["bytes"] == 0
    assert stats["plan_cache"]["bytes_budget"] == 1
    assert stats["plan_cache"]["evictions"] == 3
    assert stats["tenants"]["t"]["misses"] == 3
    assert metrics.gauge("plan_cache.bytes").value == 0
    assert metrics.counter("plan_cache.evictions").value == 3

    obs.reset_all()
    with PlanService(ServiceOptions(workers=1, **CPU)) as svc:
        svc.submit(prog, tenant="t", run=True).result()
        res2 = svc.submit(prog, tenant="t", run=True).result()
        assert res2.plan_cached is True
        stats = svc.drain()
    assert stats["plan_cache"]["evictions"] == 0
    assert stats["plan_cache"]["bytes"] > 0
    assert stats["tenants"]["t"]["bytes"] == stats["plan_cache"]["bytes"]
    assert (
        metrics.gauge("plan_cache.bytes").value
        == stats["plan_cache"]["bytes"]
    )
    assert metrics.counter("plan_cache.artifact_hits").value == 1


# ---------------------------------------------------------------------- #
# Held against the reference's service on its NumPy wavefront backend
# ---------------------------------------------------------------------- #

def _mix(pkg_serve, pkg_core, waves: int):
    """The soak mix as one submission list: (tenant, program, run) per
    request — a warm-up wave with every pair run, then ``waves`` waves
    each running one bounds per structure and replaying it through a
    capacity-2 "mixed" tenant."""

    structures = [
        ("decode", pkg_serve.decode_program, (12, 13)),
        ("scan", lambda h: pkg_serve.scan_program(3, h), (4, 5)),
        ("doall", lambda n: _doall_program(n, pkg_core), (16, 17)),
    ]
    out = []
    for tenant, make, bounds in structures:
        for b in bounds:
            out.append((tenant, make(b), True))
    for wave in range(waves):
        for tenant, make, bounds in structures:
            prog = make(bounds[wave % 2])
            out.append((tenant, prog, True))
            out.append(("mixed", prog, wave % 3 == 0))
    return out


def _serve_all(svc, submissions):
    stores = []
    for tenant, prog, run in submissions:
        stores.append(svc.submit(prog, tenant=tenant, run=run).result().store)
    return stores, svc.drain()


@pytest.mark.parametrize("waves", [3, 8])
def test_port_service_matches_reference_service_on_wavefront(waves):
    ref_obs.reset_all()
    obs.reset_all()
    # one worker on both sides: the per-tenant LRU traffic is then a pure
    # function of the submission order
    with ref_serve.PlanService(
        ref_serve.ServiceOptions(
            backend="wavefront", workers=1, plan_cache_capacity=2
        )
    ) as rsvc:
        ref_stores, ref_stats = _serve_all(
            rsvc, _mix(ref_serve, ref_core, waves)
        )
    ref_structural = ref_core.analysis_cache_stats()["misses"]

    with PlanService(
        ServiceOptions(workers=1, plan_cache_capacity=2, **CPU)
    ) as svc:
        mix = _mix(tserve, tcore, waves)
        stores, stats = _serve_all(svc, mix)

    assert stores == ref_stores
    for (_, prog, run), store in zip(mix, stores):
        if run:
            assert store == run_sequential(prog, _fresh_initial(prog))
    assert analysis_cache_stats()["misses"] == ref_structural
    assert compile_cache_stats()["misses"] == 3  # one artifact a structure
    for tenant in ("decode", "scan", "doall", "mixed"):
        for key in ("hits", "misses", "evictions", "size"):
            assert stats["tenants"][tenant][key] == (
                ref_stats["tenants"][tenant][key]
            ), (tenant, key)
    assert stats["tenants"]["mixed"]["evictions"] > 0
    assert stats["submitted"] == ref_stats["submitted"] == len(mix)
