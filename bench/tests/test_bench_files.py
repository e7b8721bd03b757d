"""Every cell's files are found by name, and ``BENCHMARK.json`` keeps to the
shape the benchmark's contract gives it."""

import json
import re

import pytest
from conftest import BENCH

ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_limits():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    n = 24  # a full check with every cell the benchmark may come to hold
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_are_unique_and_pairs_once():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_metrics_keys_bounds_and_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for w in m["workloads"]:  # every cell that reports it reports what it moves
            assert w in CELLS and w in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    import harness

    c = harness.load_cell(cell)
    assert (BENCH / "kinds" / f"{c.mix['kind']}.py").is_file()
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert c.limits and all(isinstance(v["limit"], float) for v in c.limits.values())


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    readers = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in METRICS}


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    """A file of its own under paths; the keys it changes from the source
    are those ``reduced`` lists, and none is a width; its family reads it."""

    import harness

    raw = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("bench/configs/")
    assert sorted(raw["published"]) == sorted(conf["reduced"])
    assert all(raw[k] != v for k, v in raw["published"].items())
    widths = re.compile(r"(hidden|intermediate|head|_dim|_rank|size$|expert)")
    assert not any(widths.search(k) for k in conf["reduced"])
    harness.family_of(raw["model_type"]).dims(conf["name"], raw)


@pytest.mark.parametrize("name,arch,published", [
    ("granite-3-2b", "granite_3_2b", {"norm_eps": 1e-5, "tie_embeddings": True}),
    ("yi-6b", "yi_6b", {"norm_eps": 1e-5}),
])
def test_config_is_the_ports_own(name, arch, published):
    """The file's sizes give the configuration the port ships for the model,
    with the published RMSNorm epsilon and head tying where the shipped
    configuration keeps the port's defaults."""

    import dataclasses

    import harness
    from repro_torch.configs import get_config

    cell = harness.load_cell(next(w["name"] for w in SPEC["workloads"] if w["config"] == name))
    ours = cell.family.port_config(cell.dims)
    shipped = get_config(arch)
    assert dataclasses.replace(ours, name=shipped.name) == dataclasses.replace(shipped, **published)
