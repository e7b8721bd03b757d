"""The port's cost-profile subsystem (:mod:`repro_torch.calibrate`),
mirroring ``tests/test_calibrate.py`` on the CPU, and held against the
reference's framework-free pieces.

Contracts under test:

* **Persistence round-trip** — ``measure()`` installs and persists a
  schema-versioned profile; a fresh process state reloads it via
  ``warm()`` with *zero re-measurement* (``calibrate.measurements`` flat).
* **Corrupt / stale / foreign fallback** — truncated JSON, wrong schema,
  wrong fingerprint, a profile of another device, or invalid unit values
  are each ignored with a ``calibrate.fallbacks`` tick; the hand-set
  defaults keep pricing.
* **The device** — ``measure`` / ``warm`` default to ``"cuda"`` and raise
  without a card; the profile's identity names the device it was measured
  on.
* **Env switch** — ``REPRO_CALIBRATE=off`` pins the defaults.
* **Invariance pins** — calibration never enters structural keys, and only
  offer *prices* (never the offer set) respond to a profile.
* **Against the reference** — the same line fit, the same file keys and
  schema, the same corrupt inputs rejected.
"""

from __future__ import annotations

import json
import random

import pytest
import torch

import repro.calibrate as ref_calibrate
from repro.calibrate import microbench as ref_microbench

import repro_torch.calibrate as calibrate
import repro_torch.compile as compile_pkg
import repro_torch.obs as obs
from repro_torch.calibrate import microbench
from repro_torch.core import (
    ArrayRef,
    LoopProgram,
    Statement,
    clear_analysis_cache,
    plan,
)
from repro_torch.obs import metrics

CPU = {"device": "cpu"}

FAST_UNITS = {
    "xla_step": 0.5,
    "xla_lane": 0.25,
    "spmd_collective": 2.0,
    "spmd_collective_lane": 0.0625,
    "dispatch": 40.0,
}


@pytest.fixture(autouse=True)
def _isolated_calibration(tmp_path, monkeypatch):
    """Every test gets its own cache dir, the env switch unset, and a
    clean in-memory state on both sides."""

    monkeypatch.setenv("REPRO_CALIBRATE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_CALIBRATE", raising=False)
    obs.reset_all()
    yield
    obs.reset_all()


def _fake_measure(monkeypatch, units=None):
    """Patch the microbenchmark suite with a deterministic stub that still
    ticks the measurement counter (so reuse-vs-remeasure is observable)."""

    def fake_measure_units(**kwargs):
        assert kwargs["device"] == "cpu"
        metrics.counter("calibrate.measurements").inc()
        return dict(units or FAST_UNITS), {"stub": True}

    monkeypatch.setattr(microbench, "measure_units", fake_measure_units)


def _recurrence(ni=6, nj=24):
    return LoopProgram(
        statements=(
            Statement(
                "S1",
                ArrayRef("a", (0, 0)),
                (ArrayRef("a", (0, -1)), ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, ni), (0, nj)),
    )


# ---------------------------------------------------------------------- #
# Defaults / env switch
# ---------------------------------------------------------------------- #

def test_default_units_resolve_hand_set_constants_late(monkeypatch):
    assert calibrate.units()["xla_step"] == compile_pkg.TORCH_STEP_UNITS
    monkeypatch.setattr(compile_pkg, "TORCH_STEP_UNITS", 7.25)
    assert calibrate.units()["xla_step"] == 7.25
    from repro_torch.compile import spmd

    assert calibrate.units()["xla_step"] == 7.25
    # the collective units are read late from the spmd module as well
    assert calibrate.units()["spmd_collective"] == spmd.SPMD_COLLECTIVE_UNITS
    monkeypatch.setattr(spmd, "SPMD_COLLECTIVE_UNITS", 9.5)
    monkeypatch.setattr(spmd, "SPMD_COLLECTIVE_LANE_UNITS", 0.75)
    assert calibrate.units()["spmd_collective"] == 9.5
    assert calibrate.units()["spmd_collective_lane"] == 0.75


def test_env_switch_pins_defaults(monkeypatch):
    _fake_measure(monkeypatch)
    calibrate.measure(**CPU)
    assert calibrate.active_profile().source == "measured"
    monkeypatch.setenv("REPRO_CALIBRATE", "off")
    assert not calibrate.enabled()
    assert calibrate.active_profile().source == "default"
    assert calibrate.profile_generation() == 0
    assert calibrate.units() == calibrate.default_profile().units
    assert calibrate.measure(**CPU).source == "default"
    assert calibrate.warm(**CPU).source == "default"


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (calibrate.measure, calibrate.warm, calibrate.host_info,
                 calibrate.load_profile):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert calibrate.active_profile().source == "default"


# ---------------------------------------------------------------------- #
# Persistence round-trip + restart reuse
# ---------------------------------------------------------------------- #

def test_measure_persists_and_roundtrips(monkeypatch, tmp_path):
    _fake_measure(monkeypatch)
    prof = calibrate.measure(**CPU)
    assert prof.source == "measured"
    assert prof.generation == 1
    assert prof.units == FAST_UNITS
    path = calibrate.profile_path(**CPU)
    assert path.parent == tmp_path
    on_disk = json.loads(path.read_text())
    assert on_disk["schema"] == calibrate.SCHEMA_VERSION
    assert on_disk["fingerprint"] == calibrate.host_fingerprint(**CPU)
    assert on_disk["meta"]["device"] == "cpu"
    loaded = calibrate.load_profile(**CPU)
    assert loaded is not None
    assert loaded.source == "persisted"
    assert loaded.units == prof.units
    assert loaded.generation == 1
    assert calibrate.measure(**CPU).generation == 2


def test_warm_reuses_persisted_profile_with_zero_remeasurement(monkeypatch):
    _fake_measure(monkeypatch)
    calibrate.warm(**CPU)  # cold: measures and persists
    assert metrics.counter("calibrate.measurements").value == 1
    obs.reset_all()  # "restart": in-memory state gone, file survives
    assert calibrate.active_profile().source == "default"
    prof = calibrate.warm(**CPU)
    assert prof.source == "persisted"
    assert prof.generation == 1
    assert metrics.counter("calibrate.measurements").value == 0  # flat
    assert metrics.counter("calibrate.loads").value == 1
    assert calibrate.warm(**CPU) is prof
    assert metrics.counter("calibrate.loads").value == 1


def test_plan_service_warm_profile_knob(monkeypatch):
    _fake_measure(monkeypatch)
    from repro_torch.serve import PlanService, ServiceOptions

    with pytest.raises(ValueError):
        ServiceOptions(warm_profile="yes", **CPU)
    with PlanService(ServiceOptions(warm_profile=True, **CPU)):
        assert calibrate.active_profile().source == "measured"
    obs.reset_all()
    with PlanService(ServiceOptions(warm_profile=True, **CPU)) as svc:
        assert calibrate.active_profile().source == "persisted"
        assert metrics.counter("calibrate.measurements").value == 0
        prog = _recurrence()
        res = svc.submit(prog, run=True).result()
        assert res.store is not None
    # without the knob nothing is warmed
    obs.reset_all()
    with PlanService(ServiceOptions(**CPU)):
        assert calibrate.active_profile().source == "default"


# ---------------------------------------------------------------------- #
# Corrupt / stale / foreign fallback
# ---------------------------------------------------------------------- #

def _corruptions():
    return [
        lambda raw: raw.update(schema=99),
        lambda raw: raw.update(fingerprint="feedfacedeadbeef"),
        lambda raw: raw.update(generation=-1),
        lambda raw: raw.update(generation=True),
        lambda raw: raw["units"].update(xla_step=0.0),
        lambda raw: raw["units"].update(xla_lane=float("nan")),
        lambda raw: raw["units"].update(dispatch=float("inf")),
        lambda raw: raw["units"].update(xla_step=True),
        lambda raw: raw["units"].update(xla_step="1.0"),
        lambda raw: raw["units"].pop("dispatch"),
        lambda raw: raw.update(units=[1.0] * 5),
    ]


def test_corrupt_and_stale_profiles_fall_back(monkeypatch):
    path = calibrate.profile_path(**CPU)
    path.parent.mkdir(parents=True, exist_ok=True)

    # missing file: None, but NOT a fallback (nothing was corrupt)
    assert calibrate.load_profile(**CPU) is None
    assert metrics.counter("calibrate.fallbacks").value == 0

    good = calibrate.CostProfile(
        units=dict(FAST_UNITS),
        fingerprint=calibrate.host_fingerprint(**CPU),
        generation=3,
        source="measured",
    )

    def dump(mutate):
        raw = good.as_dict()
        mutate(raw)
        path.write_text(json.dumps(raw))

    for i, mutate in enumerate(_corruptions(), start=1):
        dump(mutate)
        assert calibrate.load_profile(**CPU) is None
        assert metrics.counter("calibrate.fallbacks").value == i

    # truncated JSON (a torn write without the atomic replace)
    path.write_text(json.dumps(good.as_dict())[:25])
    assert calibrate.load_profile(**CPU) is None
    assert metrics.counter("calibrate.fallbacks").value == len(_corruptions()) + 1

    # warm() on a corrupt file re-measures instead of trusting it
    _fake_measure(monkeypatch)
    prof = calibrate.warm(**CPU)
    assert prof.source == "measured"
    assert metrics.counter("calibrate.measurements").value == 1
    assert calibrate.load_profile(**CPU).units == FAST_UNITS


def test_foreign_host_profile_triggers_remeasure(monkeypatch):
    _fake_measure(monkeypatch)
    calibrate.measure(**CPU)
    old_path = calibrate.profile_path(**CPU)
    obs.reset_all()
    monkeypatch.setattr(
        calibrate,
        "host_fingerprint",
        lambda info=None, *, device="cuda": "0123456789abcdef",
    )
    assert calibrate.load_profile(old_path, **CPU) is None
    assert metrics.counter("calibrate.fallbacks").value == 1
    prof = calibrate.warm(**CPU)
    assert prof.source == "measured"
    assert prof.fingerprint == "0123456789abcdef"
    assert metrics.counter("calibrate.measurements").value == 1


def test_profile_identity_names_the_measured_device(monkeypatch):
    """A CPU measurement on a card's host must never price the card's
    auction: the device is part of the identity."""

    _fake_measure(monkeypatch)
    cpu_prof = calibrate.measure(**CPU)
    info = calibrate.host_info("cpu")
    assert info["device"] == "cpu"
    assert set(info) == {"machine", "system", "device", "devices", "torch", "cuda"}
    assert cpu_prof.meta["device"] == "cpu"
    card = {**info, "device": "NVIDIA H100 80GB HBM3"}
    assert calibrate.host_fingerprint(card) != calibrate.host_fingerprint(info)
    for key in ("torch", "cuda", "machine", "system", "devices"):
        assert calibrate.host_fingerprint({**info, key: "other"}) != (
            calibrate.host_fingerprint(info)
        )
    # the card's loader, on the same host, ignores the CPU's file
    cpu_path = calibrate.profile_path(**CPU)
    monkeypatch.setattr(calibrate, "host_info", lambda device="cuda": card)
    assert calibrate.profile_path() != cpu_path
    assert calibrate.load_profile() is None  # no card profile yet
    assert calibrate.load_profile(cpu_path) is None  # foreign: fallback
    assert metrics.counter("calibrate.fallbacks").value == 1


def test_default_cache_dir_lies_outside_the_repo(monkeypatch, tmp_path):
    from pathlib import Path

    monkeypatch.delenv("REPRO_CALIBRATE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert calibrate.cache_dir() == tmp_path / "xdg" / "repro-torch-calibrate"
    monkeypatch.delenv("XDG_CACHE_HOME")
    repo = Path(__file__).resolve().parents[1]
    assert repo not in calibrate.cache_dir().parents


def test_save_profile_is_atomic_and_leaves_no_tempfile(tmp_path):
    prof = calibrate.CostProfile(
        units=dict(FAST_UNITS), fingerprint="abc", generation=1,
        source="measured",
    )
    path = calibrate.save_profile(prof)
    assert path == tmp_path / "cost_profile-abc.json"
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
    assert json.loads(path.read_text()) == prof.as_dict()


# ---------------------------------------------------------------------- #
# Invariance pins: structural keys and offers vs calibration state
# ---------------------------------------------------------------------- #

def test_structural_key_invariant_to_calibration(monkeypatch):
    from repro_torch.compile import structural_key

    prog = _recurrence()
    retained = tuple(plan(prog).elimination.retained)
    before = structural_key(prog, retained, model="doall")
    _fake_measure(
        monkeypatch,
        units={**FAST_UNITS, "xla_step": 1e6, "dispatch": 1e-6},
    )
    calibrate.measure(**CPU)
    assert structural_key(prog, retained, model="doall") == before


def test_offers_and_schedule_structure_invariant_to_calibration(monkeypatch):
    prog = _recurrence()
    rec0 = (
        plan(prog).compile("wavefront").report().wavefront.scc.recurrences[0]
    )
    assert rec0.profile_generation == 0
    assert rec0.offers

    _fake_measure(monkeypatch, units={**FAST_UNITS, "dispatch": 123.0})
    calibrate.measure(**CPU)
    clear_analysis_cache()
    rec1 = (
        plan(prog).compile("wavefront").report().wavefront.scc.recurrences[0]
    )
    assert rec1.strategy == rec0.strategy
    assert rec1.chunk == rec0.chunk
    assert rec1.offers == rec0.offers
    assert rec1.profile_generation == 1


def test_measured_units_reprice_the_torch_auction_but_not_its_offer_set(monkeypatch):
    """The torch backend's auction reads the profile: a flat step cost that
    dwarfs the lane cost (a level-bound device) flips the wide recurrence
    from chunk to skew; the offer set and the structural key stay put."""

    from repro_torch.compile import clear_compile_cache

    prog = _recurrence(40, 96)
    p = plan(prog, method="isd")
    (rec0,) = p.compile("torch", **CPU).report().summary()["scc"]["recurrences"]
    key0 = p.compile("torch", **CPU).compiled.key
    assert rec0["strategy"] == "chunk"
    _fake_measure(
        monkeypatch, units={**FAST_UNITS, "xla_step": 8.0, "xla_lane": 1e-4}
    )
    calibrate.measure(**CPU)
    clear_compile_cache()  # a fresh case, auctioned under the profile
    exe = plan(prog, method="isd").compile("torch", **CPU)
    (rec1,) = exe.report().summary()["scc"]["recurrences"]
    assert rec1["strategy"] == "skew"
    assert set(rec1["offers"]) == set(rec0["offers"])
    assert rec1["offers"] != rec0["offers"]
    assert rec1["profile_generation"] == 1
    assert exe.compiled.key == key0


def test_obs_summary_carries_calibration_pointer(monkeypatch):
    assert obs.obs_summary("torch")["calibration"] == {
        "enabled": True,
        "source": "default",
        "generation": 0,
        "profile_export": (
            "repro_torch.calibrate.active_profile() / profile_path()"
        ),
    }
    _fake_measure(monkeypatch)
    calibrate.measure(**CPU)
    ptr = obs.obs_summary("torch")["calibration"]
    assert ptr["source"] == "measured"
    assert ptr["generation"] == 1


# ---------------------------------------------------------------------- #
# One real (tiny) measurement through the level loop
# ---------------------------------------------------------------------- #

def test_real_microbenchmark_smoke():
    prof = calibrate.measure(device="cpu", n=256, widths=(4, 16), repeats=1)
    assert prof.source == "measured"
    for name in calibrate.UNIT_NAMES:
        assert prof.units[name] > 0.0
    assert metrics.counter("calibrate.measurements").value > 0
    assert calibrate.units() == prof.units
    assert prof.meta["device"] == "cpu"
    assert prof.meta["timed"] == "eager sweep on the host clock"
    assert set(prof.meta["xla_per_level_us"]) == {"4", "16"}
    assert prof.meta["spmd_delta_us"] == "skipped (single-device group)"
    # without a group the collective units keep the hand-set ratios
    assert prof.units["spmd_collective"] == pytest.approx(4.0 * prof.units["xla_lane"])
    # the measurement used local caches only
    from repro_torch.compile import compile_cache_stats

    assert compile_cache_stats()["misses"] == 0


def test_microbench_rejects_degenerate_parameters():
    with pytest.raises(ValueError):
        microbench.measure_units(n=256, widths=(8,), **CPU)
    with pytest.raises(ValueError):
        microbench.measure_units(n=64, widths=(4, 32), **CPU)


# ---------------------------------------------------------------------- #
# Against the reference's framework-free pieces
# ---------------------------------------------------------------------- #

def test_schema_and_unit_names_match_the_reference():
    assert calibrate.SCHEMA_VERSION == ref_calibrate.SCHEMA_VERSION
    assert calibrate.UNIT_NAMES == ref_calibrate.UNIT_NAMES
    assert microbench._MIN_UNIT_US == ref_microbench._MIN_UNIT_US


def test_profile_file_carries_the_reference_keys(monkeypatch):
    _fake_measure(monkeypatch)
    calibrate.measure(**CPU)
    port_raw = json.loads(calibrate.profile_path(**CPU).read_text())
    ref = ref_calibrate.CostProfile(
        units=dict(FAST_UNITS), fingerprint="f", generation=1,
        source="measured",
    )
    assert set(port_raw) == set(ref.as_dict())
    assert set(port_raw["units"]) == set(ref.as_dict()["units"])
    # and a file the reference's writer produced parses as the port's
    path = ref_calibrate.save_profile(ref, calibrate.cache_dir() / "ref.json")
    monkeypatch.setattr(calibrate, "host_fingerprint", lambda info=None, *, device="cuda": "f")
    loaded = calibrate.load_profile(path, **CPU)
    assert loaded.units == FAST_UNITS and loaded.generation == 1


@pytest.mark.parametrize("seed", range(5))
def test_fit_line_equals_the_reference(seed):
    rng = random.Random(seed)
    points = [(2 ** k, rng.uniform(-5, 50)) for k in range(rng.randint(2, 6))]
    assert microbench._fit_line(points) == ref_microbench._fit_line(points)
    flat = [(8, 3.0), (8, 5.0)]  # zero variance: slope 0
    assert microbench._fit_line(flat) == ref_microbench._fit_line(flat)


def test_per_level_difference_equals_the_reference():
    samples = {64: (0.004, 30), 128: (0.007, 62), 4: (0.001, 1), 8: (0.001, 1)}
    for n, dist in ((128, 4), (8, 2)):
        got = microbench._per_level_us(lambda s: samples[s], n, dist, 1)
        want = ref_microbench._per_level_us(lambda s: samples[s], n, dist, 1)
        assert got == want


def test_corrupt_inputs_rejected_as_the_reference_rejects_them(monkeypatch, tmp_path):
    good = {"schema": 1, "fingerprint": "f", "generation": 3,
            "units": dict(FAST_UNITS), "meta": {}}
    monkeypatch.setattr(calibrate, "host_fingerprint", lambda info=None, *, device="cuda": "f")
    monkeypatch.setattr(ref_calibrate, "host_fingerprint", lambda info=None: "f")
    cases = [lambda raw: None, *_corruptions()]
    for i, mutate in enumerate(cases):
        raw = json.loads(json.dumps(good))
        mutate(raw)
        path = tmp_path / f"case{i}.json"
        path.write_text(json.dumps(raw))
        port = calibrate.load_profile(path, **CPU)
        ref = ref_calibrate.load_profile(path)
        assert (port is None) == (ref is None), i
        if ref is not None:
            assert port.units == ref.units and port.generation == ref.generation
        assert calibrate._valid_units(raw.get("units")) == ref_calibrate._valid_units(
            raw.get("units")
        )
    torn = tmp_path / "torn.json"
    torn.write_text(json.dumps(good)[:25])
    assert calibrate.load_profile(torn, **CPU) is None
    assert ref_calibrate.load_profile(torn) is None
