"""One run of one cell: set-up, the measured window, the traced slice, the
metric readers, the check against the plain reference, and the result.

Everything about a cell is found by name: ``BENCHMARK.json`` names its
configuration and traffic mix; ``bench/configs/<config>.json`` holds the
sizes, and its ``model_type`` names the family in
``bench/families/<model_type>.py`` (sizes, the port's configuration,
weights, plain reference and arithmetic); ``bench/traffic/<traffic>.json``
holds the mix, whose ``kind`` names the driver in
``bench/kinds/<kind>.py``; ``bench/limits/<workload>.json`` holds the limit
of each number that the check compares; and each metric is read by
``bench/metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

import devtrace as trace_lib
import weights

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    family: ModuleType  # families/<model_type>.py
    dims: object  # the family's sizes
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the spec at ``spec_path``: its configuration file
    as the spec names it from the spec's directory, its traffic mix and
    limits under the spec's first ``paths`` entry."""

    spec_path = Path(spec_path)
    spec = json.loads(spec_path.read_text())
    root = spec_path.parent
    bench = root / spec["paths"][0]
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {spec_path.name}: {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    raw = json.loads((root / conf["file"]).read_text())
    family = family_of(raw["model_type"])

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(
        name=name,
        family=family,
        dims=sized(family, family.dims(w["config"], raw)),
        mix=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)],
    )


def family_of(model_type: str) -> ModuleType:
    """``bench/families/<model_type>.py``; a model type with no module
    stops the run."""

    name = f"families.{model_type}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise SystemExit(f"model_type {model_type!r} has no family module: no module "
                         f"{name} (bench/families/{model_type}.py)") from None


def reader(metric: str) -> Callable:
    """``bench/metrics/<metric>.py``'s ``read(run)``."""

    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sized(family: ModuleType, d):
    """``d`` with the embedding table's row count as the port pads it."""

    return dataclasses.replace(d, padded_vocab=family.port_config(d).padded_vocab_size)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters() -> Dict[str, int]:
    """The program's counters that the readers use."""

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.obs import metrics

    out = {f"flash_attention.{k}": v for k, v in ops.flash_attention.routes.items()}
    out["attention.train_plain_calls"] = metrics.counter("attention.train_plain_calls").value
    return out


def p95(values: List[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18] if len(values) > 1 else values[0]


class Driver:
    """A kind of traffic: ``setup`` builds the program's objects and warms
    every shape, ``call(i)`` is one timed call and returns its record,
    ``release`` frees the program's state, ``check`` runs the reference
    and returns the numbers it compares."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.family, self.dims, self.mix = cell, cell.family, cell.dims, cell.mix
        self.seed, self.device = seed, device
        self.cfg = self.family.port_config(cell.dims,
                                           **{k: self.mix[k] for k in ("remat",) if k in self.mix})
        self.reading_s = 0.0  # set-up time spent on the check's readings

    def flat_weights(self) -> Dict[tuple, torch.Tensor]:
        """The cell's weights from the seed, by path: the family's leaves."""

        return weights.make_flat(self.family.leaf_specs(self.dims), self.seed, self.device)

    def setup(self) -> None:
        raise NotImplementedError

    def call(self, i: int) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def check(self, iters: List[dict]) -> Dict[str, float]:
        raise NotImplementedError

    def traced_ranges(self):
        """A context in which the traced slice runs: a driver may open named
        ranges (``bench.<part>``) around parts of the program there."""

        return contextlib.nullcontext()


@dataclasses.dataclass
class Run:
    cell: Cell
    driver: Driver
    seed: int
    setup_s: float
    iters: List[dict]  # every call of the window, in order; "traced" marks the slice's
    trace: Optional[trace_lib.Trace]
    counters: Dict[str, int]  # the program's counters over the traced slice

    @property
    def timed(self) -> List[dict]:
        """The window's calls outside the traced slice."""

        return [r for r in self.iters if not r["traced"]]

    @property
    def traced(self) -> List[dict]:
        return [r for r in self.iters if r["traced"]]


def driver_for(cell: Cell, seed: int, device: torch.device) -> Driver:
    mod = importlib.import_module(f"kinds.{cell.mix['kind']}")
    return mod.Driver(cell, seed, device)


def window(drv: Driver, seconds: float, trace: bool):
    """The measured window: with ``trace``, its first ``trace_calls`` calls
    under the profiler; then calls until ``seconds`` have passed since the
    first began.  Returns (records, trace, counter deltas over the slice)."""

    iters: List[dict] = []
    tr, deltas = None, {}
    t_start = time.perf_counter()
    if trace:
        before = counters()

        def one(i):
            return lambda: iters.append(dict(drv.call(i), traced=True))

        with drv.traced_ranges():
            tr = trace_lib.profile([one(i) for i in range(drv.mix["trace_calls"])],
                                   lambda: sync(drv.device))
        after = counters()
        deltas = {k: after[k] - before[k] for k in after}
    while time.perf_counter() - t_start < seconds:
        iters.append(dict(drv.call(len(iters)), traced=False))
    return iters, tr, deltas


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float) -> dict:
    """One run; returns the result line's object (without ``checks``'
    printing, which :func:`report` does)."""

    drv = driver_for(cell, seed, device)
    if device.type == "cuda":
        torch.empty(1, device=device)  # the allocator's statistics exist once it holds memory
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup()
    sync(device)
    setup_s = time.perf_counter() - t_process - drv.reading_s
    iters, tr, deltas = window(drv, seconds, trace)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    r = Run(cell, drv, seed, setup_s, iters, tr, deltas)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    numbers = drv.check(iters)

    checks = {}
    for name, value in numbers.items():
        limit = cell.limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(checks)
    out = {
        "correct": correct,
        "attempted": sum(x["requests"] for x in iters),
        "failed": 0,
        "metrics": metrics,
        "device": device_info(device, peak),
    }
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": trace_lib.device_ops(tr),
                            "idle_gaps": trace_lib.idle_gaps(tr)}
    out["checks"] = checks
    return out


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def jax_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""

    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def report(out: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""

    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
