"""The SPMD level loop on ``torch.distributed`` (:mod:`repro_torch.compile.spmd`,
backend ``"torch_spmd"``), mirroring ``tests/test_spmd.py`` on the CPU.

Contracts under test:

* **Collective-aware policy divergence** — the wide ``{(0,1),(1,-1)}``
  recurrence chunks on one device but skews at a forced eight, a narrow
  blocked recurrence keeps chunking at eight; and at forced counts 1, 2
  and 8 the port's offers and strategies equal the reference
  ``"xla_spmd"`` ones under equal units (its ``report()`` builds host
  tables only, so it runs on this tree).
* **One device** — no process group (or a group of one) takes ``"torch"``'s
  exact path: ``n_shards == 1``, zero ``spmd.collectives``, bit-equal.
* **Reset discipline** — ``obs.reset_all()`` clears the forced device
  count and the backend's structural cache.
* **Real sharding** — 2 and 4 spawned gloo processes (``file://`` store in
  ``tmp_path``): the corpus bit-equal on every rank to the reference's
  ``run_sequential``, one all-gather per read-bearing group step; ranks
  whose auctions differ raise naming the disagreement instead of hanging;
  a measurement under the group gives every rank rank 0's profile.  Every
  spawn has its own timeout and kills its children on it.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import traceback

import pytest
import torch

import repro.calibrate as ref_calibrate
import repro.core as ref_core
import repro.obs as ref_obs
from programs import ALL_PROGRAMS
from repro.compile import spmd as ref_spmd

import repro_torch.calibrate as calibrate
import repro_torch.core as tcore
import repro_torch.obs as obs
from repro_torch.compile import device_scope, spmd
from repro_torch.compile.spmd import SPMD_CACHE
from repro_torch.convert import program_from_reference, store_from_reference
from repro_torch.core.wavefront import _DenseStore
from repro_torch.core import (
    ArrayRef,
    LoopProgram,
    PlanOptions,
    Statement,
    histogram,
    indexed_store,
    paper_alg6,
    plan,
    registered_backends,
    run_sequential,
)
from repro_torch.obs import metrics

CPU = {"device": "cpu"}
SPAWN_TIMEOUT_S = 240


def _fresh(prog: LoopProgram, store=None) -> dict:
    src = store if store is not None else prog.initial_store()
    return {a: dict(c) for a, c in src.items()}


def wide_recurrence(ni: int, nj: int, core=tcore) -> LoopProgram:
    """{(0,1), (1,-1)}: chunking is fully serial (unit chunks) while a
    unimodular skew runs an ``nj``-wide diagonal wavefront."""

    return core.LoopProgram(
        statements=(
            core.Statement(
                "S1",
                core.ArrayRef("a", (0, 0)),
                (core.ArrayRef("a", (0, -1)), core.ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, ni), (0, nj)),
    )


def narrow_blocked_recurrence(n: int, core=tcore) -> LoopProgram:
    """{(0,-32), (-1,1)}: 32-iteration DOACROSS chunks are cheap, so
    sharding should lose."""

    return core.LoopProgram(
        statements=(
            core.Statement(
                "S1",
                core.ArrayRef("a", (0, 0)),
                (core.ArrayRef("a", (0, -32)), core.ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, n), (0, n)),
    )


def skew_recurrence(ni: int, nj: int, core=tcore) -> LoopProgram:
    """{(1,-1)}: chip_smoke.py's 64×16 recurrence cell."""

    return core.LoopProgram(
        statements=(
            core.Statement("S1", core.ArrayRef("a", (0, 0)), (core.ArrayRef("a", (-1, 1)),)),
        ),
        bounds=((0, ni), (0, nj)),
    )


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIBRATE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("REPRO_CALIBRATE", raising=False)
    obs.reset_all()
    ref_obs.reset_all()
    yield
    obs.reset_all()
    ref_obs.reset_all()


# ---------------------------------------------------------------------- #
# Registration
# ---------------------------------------------------------------------- #

def test_backend_registered():
    assert "torch_spmd" in registered_backends()


def test_unknown_option_rejected_naming_accepted_set():
    prog = wide_recurrence(4, 4)
    with pytest.raises(ValueError) as exc:
        plan(prog, method="isd").compile("torch_spmd", bogus_knob=1, **CPU)
    assert "bogus_knob" in str(exc.value)
    assert "device" in str(exc.value)


# ---------------------------------------------------------------------- #
# Collective-aware policy divergence (cost model only — execution stays on
# one device inside a single pytest process)
# ---------------------------------------------------------------------- #

def test_wide_recurrence_diverges_shard_vs_chunk():
    spmd.force_device_count(8)
    prog = wide_recurrence(40, 96)
    p = plan(prog, method="isd")
    exe_torch = p.compile("torch", **CPU)
    exe_spmd = p.compile("torch_spmd", **CPU)
    (rec_t,) = exe_torch.report().summary()["scc"]["recurrences"]
    (rec_s,) = exe_spmd.report().summary()["scc"]["recurrences"]
    assert rec_t["strategy"] == "chunk"
    assert rec_s["strategy"] == "skew"
    assert rec_t["offers"]["chunk"] < rec_t["offers"]["skew"]
    assert rec_s["offers"]["skew"] < rec_s["offers"]["chunk"]
    oracle = run_sequential(prog, _fresh(prog))
    assert exe_torch.run(store=_fresh(prog)) == oracle
    assert exe_spmd.run(store=_fresh(prog)) == oracle


def test_narrow_recurrence_keeps_chunking_on_wide_group():
    spmd.force_device_count(8)
    prog = narrow_blocked_recurrence(32)
    exe = plan(prog, method="isd").compile("torch_spmd", **CPU)
    (rec,) = exe.report().summary()["scc"]["recurrences"]
    assert rec["strategy"] == "chunk"
    assert rec["offers"]["chunk"] < rec["offers"]["skew"]
    init = _fresh(prog, prog.initial_store(pad=33))
    assert exe.run(store=_fresh(prog, init)) == run_sequential(prog, init)


def test_degenerate_cost_model_matches_torch():
    """At device_count()==1 the spmd cost hook equals torch_level_cost."""

    prog = wide_recurrence(40, 96)
    p = plan(prog, method="isd")
    (rec_t,) = p.compile("torch", **CPU).report().summary()["scc"]["recurrences"]
    (rec_s,) = p.compile("torch_spmd", **CPU).report().summary()["scc"]["recurrences"]
    assert rec_s["strategy"] == rec_t["strategy"]
    assert rec_s["offers"] == rec_t["offers"]


EQUAL_UNITS = {
    "xla_step": 3.0,
    "xla_lane": 0.5,
    "spmd_collective": 6.0,
    "spmd_collective_lane": 0.25,
    "dispatch": 2.0,
}

_CORPUS = dict(ALL_PROGRAMS)
OFFER_PROGRAMS = [
    ("wide_40x96", wide_recurrence(40, 96, ref_core)),
    ("wide_96x192", wide_recurrence(96, 192, ref_core)),
    ("narrow_32", narrow_blocked_recurrence(32, ref_core)),
    ("skew_recurrence_64x16", skew_recurrence(64, 16, ref_core)),
    *[
        (name, _CORPUS[name])
        for name in ("mixed_cycle_pm1", "skew_pipeline", "double_skew",
                     "guarded_recurrence", "producer_into_cycle")
    ],
]


def _recurrence_records(summary):
    return [
        (r["statements"], r["strategy"], r["chunk"], r["skew"], r["offers"])
        for r in summary["scc"]["recurrences"]
    ]


@pytest.mark.parametrize("units", ["hand-set", "profile"])
@pytest.mark.parametrize("count", [1, 2, 8])
@pytest.mark.parametrize("name,ref_prog", OFFER_PROGRAMS, ids=[n for n, _ in OFFER_PROGRAMS])
def test_offers_equal_reference_xla_spmd(name, ref_prog, count, units):
    """Same program, same forced device count, same units: the port's
    ``torch_spmd`` auction scores and picks exactly as ``xla_spmd``."""

    if units == "profile":
        for pkg in (calibrate, ref_calibrate):
            pkg.set_profile(pkg.CostProfile(
                units=dict(EQUAL_UNITS), fingerprint="equal", generation=1,
                source="measured",
            ))
    spmd.force_device_count(count)
    ref_spmd.force_device_count(count)
    ref = ref_core.plan(ref_prog, method="isd").compile("xla_spmd").report()
    port = plan(program_from_reference(ref_prog), method="isd").compile(
        "torch_spmd", **CPU
    ).report()
    ref_recs = _recurrence_records(ref.summary())
    assert ref_recs, "the auction ran no recurrence"
    assert _recurrence_records(port.summary()) == ref_recs


# ---------------------------------------------------------------------- #
# One device: "torch"'s path, no collective
# ---------------------------------------------------------------------- #

def test_single_device_collapses_to_torch_path():
    prog = paper_alg6(16)
    exe = plan(prog, method="isd").compile("torch_spmd", **CPU)
    assert exe.run(store=_fresh(prog)) == run_sequential(prog, _fresh(prog))
    assert metrics.counter("spmd.collectives").value == 0
    assert metrics.gauge("spmd.devices").value == 1
    for case in exe.compiled._cases.values():
        assert case.static.n_shards == 1
        assert case._sweep is None  # never marked as a sharded sweep
    # the same launch list and tables as "torch"
    base = plan(prog, method="isd").compile("torch", **CPU)
    base.run(store=_fresh(prog))
    (c_s,) = exe.compiled._cases.values()
    (c_t,) = base.compiled._cases.values()
    assert c_s._steps == c_t._steps
    assert c_s.n_levels == c_t.n_levels


def test_group_of_one_collapses_to_torch_path(tmp_path):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1
    )
    try:
        assert spmd.device_count() == 1 and spmd.shard_count() == 1
        prog = wide_recurrence(12, 24)
        exe = plan(prog, method="isd").compile("torch_spmd", **CPU)
        assert exe.run(store=_fresh(prog)) == run_sequential(prog, _fresh(prog))
        assert metrics.counter("spmd.collectives").value == 0
        (case,) = exe.compiled._cases.values()
        assert case.static.n_shards == 1
    finally:
        dist.destroy_process_group()


def test_a_group_that_cannot_reach_the_device_raises_at_compile(tmp_path, monkeypatch):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1
    )
    try:
        prog = wide_recurrence(4, 4)
        p = plan(prog, method="isd")
        p.compile("torch_spmd", **CPU)  # gloo reaches the CPU
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(ValueError, match="cannot gather tensors on cpu"):
            p.compile("torch_spmd", **CPU)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_spmd_artifacts_never_alias_torch_artifacts():
    prog = paper_alg6(12)
    p = plan(prog, method="isd")
    exe_t = p.compile("torch", **CPU)
    exe_s = p.compile("torch_spmd", **CPU)
    assert exe_t.compiled is not exe_s.compiled
    assert type(exe_s.compiled) is spmd.SpmdCompiledProgram
    assert type(exe_t.compiled) is not spmd.SpmdCompiledProgram


# ---------------------------------------------------------------------- #
# Reset discipline
# ---------------------------------------------------------------------- #

def test_reset_all_clears_forced_count_and_cache():
    spmd.force_device_count(8)
    assert spmd.device_count() == 8
    assert spmd.shard_count() == 1  # never more than the real group
    prog = paper_alg6(8)
    plan(prog, method="isd").compile("torch_spmd", **CPU)
    assert len(SPMD_CACHE) == 1
    obs.reset_all()
    assert spmd._FORCED is None
    assert len(SPMD_CACHE) == 0
    assert spmd.device_count() == spmd._actual_devices() == 1
    assert spmd.shard_count() == 1


# ---------------------------------------------------------------------- #
# Inspect-scheduled programs lower through the recurrence-band path
# ---------------------------------------------------------------------- #

def test_inspect_schedule_takes_recurrence_band_path():
    prog = histogram(8)
    store = indexed_store(prog, {"bin": [3] * 8})
    init = _fresh(prog, store)
    oracle = run_sequential(prog, init)
    for backend in ("torch", "torch_spmd"):
        exe = plan(prog, PlanOptions(deps="inspect")).compile(backend, **CPU)
        assert exe.run(store=init) == oracle
        (case,) = exe.compiled._cases.values()
        assert case.static.segments is not None
        assert any(seg[0] == "rec" for seg in case.static.segments), backend


def test_inspect_parallel_rows_stay_bit_equal():
    prog = histogram(8)
    store = indexed_store(prog, {"bin": list(range(8))})
    init = _fresh(prog, store)
    exe = plan(prog, PlanOptions(deps="inspect")).compile("torch_spmd", **CPU)
    assert exe.run(store=init) == run_sequential(prog, init)


# ---------------------------------------------------------------------- #
# Real sharding: spawned gloo processes
# ---------------------------------------------------------------------- #

METHODS = ("none", "isd", "pattern", "both")


def _corpus_runs():
    """(label, reference program, PlanOptions knobs, compile knobs) of the
    multi-process corpus: every program under every method, the
    non-affine ones under inspect and speculate too, and the wide and 64×16
    recurrences under each strategy."""

    runs = []
    for name, prog in ALL_PROGRAMS:
        for deps in (None, "inspect", "speculate") if prog.has_indirect() else (None,):
            for method in METHODS:
                runs.append((f"{name}/{method}/{deps}", prog, {"method": method, "deps": deps}, {}))
    for policy in (None, "chunk", "skew"):
        knobs = {} if policy is None else {"scc_policy": policy}
        runs.append((f"wide_24x40/{policy}", wide_recurrence(24, 40, ref_core), {"method": "isd"}, knobs))
        runs.append((f"skew_64x16/{policy}", skew_recurrence(64, 16, ref_core), {"method": "isd"}, knobs))
    return runs


def _job_corpus(inits):
    out = []
    for (label, ref_prog, plan_knobs, knobs), init in zip(_corpus_runs(), inits):
        prog = program_from_reference(ref_prog)
        before = metrics.counter("spmd.collectives").value
        exe = tcore.plan(prog, **plan_knobs).compile("torch_spmd", **knobs, **CPU)
        store = exe.run(store=init)
        issued = metrics.counter("spmd.collectives").value - before
        with device_scope("cpu"):
            case, _ = exe.compiled.prepare(prog, _DenseStore(init))
        stmts = case.static.stmts
        expected = sum(1 for k, _, _ in case._steps if stmts[k].reads)
        out.append({
            "label": label,
            "store": store,
            "shards": case.static.n_shards,
            "levels": case.n_levels,
            "single_statement": len(stmts) == 1,
            "issued": issued,
            "expected": expected if plan_knobs.get("deps") != "speculate" else None,
        })
    return out


def _reciprocal_program():
    """b[i] = a[i] ** -1.0 over eight lanes: a zero in ``a`` fails one
    lane's ``**`` (Python raises ZeroDivisionError, as the oracle does)."""

    return LoopProgram(
        statements=(
            Statement("S1", ArrayRef("b", 0), (ArrayRef("a", 0),),
                      compute=lambda x: x ** -1.0),
        ),
        bounds=((0, 8),),
    )


def _reciprocal_store():
    return {"a": {(i,): float(i - 5) for i in range(-8, 16)},
            "b": {(i,): 0.0 for i in range(-8, 16)}}


def _job_disagree(init):
    """Three runs whose ranks must not go on: rank 1 prices with a profile
    whose lanes are dear, so its auction chunks the wide recurrence (one
    lane a level) where rank 0's skews; rank 1 holds another store; and a
    ``**`` fails on a lane of rank 1's block only."""

    rank = spmd._group()[0]
    out = {}
    prog = wide_recurrence(40, 96, tcore)
    p = tcore.plan(prog, method="isd")
    if rank == 1:
        calibrate.set_profile(calibrate.CostProfile(
            units={**EQUAL_UNITS, "xla_lane": 1e6}, fingerprint="other",
            generation=1, source="measured",
        ))
    for case, store in (
        ("profile", _fresh(prog, init)),
        ("store", {"a": {c: v + rank for c, v in init["a"].items()}}),
    ):
        try:
            p.compile("torch_spmd", **CPU).run(store=store)
            out[case] = None
        except ValueError as e:
            out[case] = str(e)
        obs.reset_all()  # both ranks' hand-set units, and no cached case
    recip = _reciprocal_program()
    try:
        tcore.plan(recip, method="isd").compile("torch_spmd", **CPU).run(
            store=_reciprocal_store()
        )
        out["pow"] = None
    except (ArithmeticError, ValueError) as e:
        out["pow"] = f"{type(e).__name__}: {e}"
    return out


def _job_measure(_):
    prof = calibrate.measure(device="cpu", n=256, widths=(4, 16), repeats=1)
    first = dict(prof.units)
    calibrate.reset()
    metrics.counter("calibrate.measurements").reset()
    again = calibrate.warm(device="cpu")
    return {
        "units": first,
        "meta": {k: prof.meta[k] for k in ("spmd_devices", "spmd_delta_us", "device")},
        "fingerprint": prof.fingerprint,
        "warm_source": again.source,
        "warm_units": dict(again.units),
        "measurements_after_warm": metrics.counter("calibrate.measurements").value,
        "loads": metrics.counter("calibrate.loads").value,
        "files": sorted(p.name for p in calibrate.cache_dir().glob("*.json")),
    }


_JOBS = {"corpus": _job_corpus, "disagree": _job_disagree, "measure": _job_measure}


def _worker(rank, world, init_file, job, payload, profile_dir, results):
    try:
        os.environ["REPRO_CALIBRATE_DIR"] = profile_dir
        torch.set_num_threads(1)
        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world
        )
        try:
            results.put((rank, "ok", _JOBS[job](payload)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def _spawn(world, job, tmp_path, payload=None, timeout=SPAWN_TIMEOUT_S):
    """Run ``job(payload)`` on ``world`` spawned gloo ranks; each rank's
    result by rank.  Stores travel in ``payload``: every rank must hold the
    same one, and ``initial_store()`` hashes differently in each process.  Every wait is bounded: on the timeout the children are killed
    and the test fails, so a hung collective never hangs the suite."""

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = str(tmp_path / f"store_{job}_{world}")
    profile_dir = str(tmp_path / f"profiles_{job}_{world}")
    procs = [
        ctx.Process(
            target=_worker,
            args=(r, world, init_file, job, payload, profile_dir, results),
            daemon=True,
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    got = {}
    try:
        import time

        deadline = time.monotonic() + timeout
        while len(got) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                rank, status, payload = results.get(timeout=min(remaining, 5.0))
            except queue_mod.Empty:
                if all(not p.is_alive() for p in procs) and results.empty():
                    break
                continue
            got[rank] = (status, payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: v for r, (s, v) in got.items() if s == "error"}
    assert not errors, "\n".join(f"rank {r}:\n{tb}" for r, tb in errors.items())
    assert sorted(got) == list(range(world)), (
        f"ranks {sorted(set(range(world)) - set(got))} gave no result within "
        f"{timeout} s (killed)"
    )
    assert all(not p.is_alive() for p in procs)
    return {r: payload for r, (_, payload) in got.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_processes_bit_equal_on_every_rank(world, tmp_path):
    runs = _corpus_runs()
    inits = [store_from_reference(p.initial_store()) for _, p, _, _ in runs]
    per_rank = _spawn(world, "corpus", tmp_path, inits)
    for r, rows in per_rank.items():
        assert [row["label"] for row in rows] == [label for label, *_ in runs]
        for row, (label, ref_prog, _, _), init in zip(rows, runs, inits):
            assert row["store"] == ref_core.run_sequential(ref_prog, init), (
                f"rank {r}: {label} diverged from run_sequential"
            )
            assert row["shards"] == world, label
            if row["expected"] is not None:
                # one all-gather per group step of a read-bearing statement
                assert row["issued"] == row["expected"], label
            if row["single_statement"] and row["expected"] is not None:
                # one statement, one group a level: the reference's count,
                # one per read-bearing statement per level
                assert row["issued"] == row["levels"], label
    # every rank issued the same collectives
    issued = [[row["issued"] for row in per_rank[r]] for r in range(world)]
    assert all(i == issued[0] for i in issued)
    assert sum(issued[0]) > 0


def test_gloo_ranks_that_disagree_raise_instead_of_hanging(tmp_path):
    prog = wide_recurrence(40, 96)
    per_rank = _spawn(2, "disagree", tmp_path, _fresh(prog), timeout=120)
    for r in (0, 1):
        got = per_rank[r]
        assert got["profile"] is not None, f"rank {r} ran a case its peer scheduled differently"
        assert "disagree on the run's strategies" in got["profile"]
        assert "'skew'" in got["profile"] and "'chunk'" in got["profile"]
        assert got["store"] is not None, f"rank {r} ran on another store than its peer"
        assert "disagree on the run's store" in got["store"]
    # the lane a[5] == 0.0 lies in rank 1's block of eight: rank 1 raises
    # what Python raises, rank 0 learns of it instead of waiting to gather
    assert per_rank[1]["pow"].startswith("ZeroDivisionError")
    assert "failed on rank(s) [1]" in per_rank[0]["pow"]
    recip = _reciprocal_program()
    with pytest.raises(ZeroDivisionError):
        run_sequential(recip, _reciprocal_store())


def test_measure_under_a_gloo_group_gives_every_rank_rank0s_profile(tmp_path):
    per_rank = _spawn(2, "measure", tmp_path, timeout=180)
    r0, r1 = per_rank[0], per_rank[1]
    assert r0["units"] == r1["units"]
    assert r0["fingerprint"] == r1["fingerprint"]
    # the collective units were measured across the two ranks
    assert r0["meta"]["spmd_devices"] == 2
    assert isinstance(r0["meta"]["spmd_delta_us"], dict)
    assert r0["meta"]["device"] == "cpu"
    for r in (r0, r1):
        # rank 0's persisted file reloads on every rank, nothing re-measured
        assert r["warm_source"] == "persisted"
        assert r["warm_units"] == r0["units"]
        assert r["measurements_after_warm"] == 0
        assert r["loads"] == 1
        assert r["files"] == [f"cost_profile-{r0['fingerprint']}.json"]
