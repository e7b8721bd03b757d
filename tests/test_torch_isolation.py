"""The port stands alone: ``repro_torch`` imports no jax and nothing of the
reference package ``repro``, and its verbatim copies of the reference's
framework-free modules stay in lockstep with them."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# Copies of reference modules, equal to them once ``repro.`` reads
# ``repro_torch.``.
VERBATIM = [
    "obs/__init__.py",
    "obs/trace.py",
    "obs/metrics.py",
    *sorted(
        str(p.relative_to(REF)) for p in (REF / "core").glob("*.py")
    ),
    "compile/structure.py",
    "compile/cache.py",
    "compile/executor.py",
    "kernels/pipelined_matmul/schedule.py",
    *sorted(
        str(p.relative_to(REF)) for p in (REF / "configs").glob("*.py")
    ),
    "serve/__init__.py",
    "serve/options.py",
    "serve/service.py",
    "serve/waves.py",
    "data/__init__.py",
    "data/pipeline.py",
    "optim/__init__.py",
    "checkpoint/__init__.py",
    "runtime/__init__.py",
    "runtime/fault_tolerance.py",
    "runtime/pipeline.py",
    "runtime/pp_lowering.py",
    "calibrate/__init__.py",
    "launch/analytic.py",
    "launch/mesh.py",
    "launch/sharding.py",
    "launch/input_specs.py",
    "launch/hlo_analysis.py",
    "launch/dryrun.py",
    "launch/steps.py",
]

# The copies that differ beyond the rename, and why.
DIFFERING = {
    "obs/__init__.py": (
        "no profile module (the predicted-vs-measured rows had no caller in "
        "the port); the docstring names trace.merge_chrome_trace and "
        "repro_torch.spans"
    ),
    "obs/trace.py": (
        "the LM path's spans: call (a step span with a call id that the "
        "spans under it share, and an optional device timer), module (a "
        "span with a layer index and no keyword dict), epoch_ns on every "
        "event (the anchor pair retaken when tracing turns on), dur_device "
        "read from the timer's marks in events(), merge_chrome_trace, and "
        "the shared null context public as NULL"
    ),
    "core/parallelizer.py": (
        "the lazily registered backends are the port's own: "
        '{"torch": "repro_torch.compile", "torch_spmd": '
        '"repro_torch.compile.spmd"} instead of xla / xla_spmd'
    ),
    "kernels/pipelined_matmul/schedule.py": (
        'compile_kloop compiles "torch" and takes the device'
    ),
    "serve/options.py": (
        'the default backend is "torch" (the port registers no "xla"); a '
        'device knob, default "cuda", validated at construction for the '
        '"torch" backend, the one that takes it; '
        "warm_profile warms the profile of the options' device"
    ),
    "serve/service.py": (
        "requests compile with the options' device on the torch backend; "
        "warm_profile=True calls warm(device=options.device) at "
        "construction; stats() reads the port's torch.bucket_hits|misses "
        "and reports captures / replays / eager_sweeps from "
        "torch.graph_captures|replays / torch.eager_sweeps, captures in "
        "the place of the reference's traces (xla.traces has no "
        "counterpart)"
    ),
    "serve/waves.py": (
        "_timed_compile compiles for the default service's backend and "
        'device instead of "xla"'
    ),
    "data/pipeline.py": (
        "the unused jax / jax.numpy imports dropped (the stream is NumPy)"
    ),
    "calibrate/__init__.py": (
        "units price the torch level loop (TORCH_STEP_UNITS / "
        "TORCH_LANE_UNITS) and the collective units are read late from "
        "repro_torch.compile.spmd; measure / warm / load_profile / "
        "profile_path / host_info take the device (default 'cuda', which "
        "raises without a card) and the identity names it (its name, the "
        "process group's device count, torch, CUDA, machine, system); the "
        "default profile's fingerprint is 'default' (no CUDA query per "
        "plan); under a process group rank 0 measures or loads and "
        "broadcasts; the cache dir is repro-torch-calibrate"
    ),
    "runtime/pp_lowering.py": (
        "the stages are ranks of a torch.distributed group (the default one "
        "or a mesh dimension's), one batch_isend_irecv pair a microbatch step "
        "counted in pp.handoffs, in place of shard_map and a ppermute; main "
        "runs on a fake group of 512 ranks and reads the hand-offs where the "
        "reference counts collective-permutes in the HLO"
    ),
    "launch/mesh.py": (
        "DeviceMesh in place of jax.make_mesh (init_device_mesh, or the "
        "default group's first ranks), the device type a knob (default "
        "'cuda'), and fake_world for the device-free dry run"
    ),
    "launch/sharding.py": (
        "specs are the port's P objects; the rules run on the reference's "
        "leaf (reference_leaf maps the port's per-block leaves to the "
        "reference's stacked ones) and drop the stack entry; placements / "
        "NamedSharding / distribute turn specs into DTensor placements"
    ),
    "launch/input_specs.py": (
        "meta tensors in place of ShapeDtypeStructs and NamedSharding trees "
        "of the port's P; argument_bytes sums a rank's local shards"
    ),
    "launch/hlo_analysis.py": (
        "collectives read from CommDebugMode (CollectiveMode, "
        "collective_stats) in place of HLO text; H100 SXM constants in place "
        "of v5e's; no f32 / tpu_adjusted correction (the dtypes are real)"
    ),
    "launch/dryrun.py": (
        "a fake process group and FakeTensorMode in place of XLA_FLAGS host "
        "devices and an AOT compile: memory from local shard sizes and a "
        "live-tensor peak, cost from flop formulas and unfused op bytes over "
        "the local ops, train cells lowered once at the deployment "
        "microbatch count"
    ),
    "launch/steps.py": (
        "eager steps (autograd.grad, a Python loop over microbatches); under "
        "a mesh the microbatch split is an all-to-all, gradients stay "
        "Partial across microbatches and are reduced once (to grad_shardings "
        "when given), and updated state returns to its input placements; "
        "each call opens one step span (train.step, serve.prefill, "
        "serve.decode with its argmax as lm.sample) through "
        "repro_torch.spans.step, which turns tracing on for the call while "
        "a torch.profiler records (one check of its flag a call)"
    ),
}


def _renamed(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_in_lockstep(rel):
    ref = _renamed((REF / rel).read_text())
    port = (PORT / rel).read_text()
    if rel in DIFFERING:
        assert port != ref, f"{rel} is listed as differing but is verbatim"
    else:
        assert port == ref, (
            f"{rel} drifted from src/repro/{rel}; re-copy it or list it in "
            "DIFFERING with the reason"
        )


def test_core_copy_covers_every_reference_module():
    ref = {p.name for p in (REF / "core").glob("*.py")}
    port = {p.name for p in (PORT / "core").glob("*.py")}
    assert ref == port and len(ref) == 15


def test_configs_copy_covers_every_reference_config():
    ref = {p.name for p in (REF / "configs").glob("*.py")}
    port = {p.name for p in (PORT / "configs").glob("*.py")}
    assert ref == port and len(ref) == 12


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


PORT_SOURCES = sorted(
    str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
) + ["../../chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_source_imports_no_jax_and_nothing_of_repro(rel):
    path = (PORT / rel).resolve()
    bad = [
        m for m in _imports(path)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, f"{rel} imports {bad}"
    text = path.read_text()
    assert not re.search(r"import_module\(\s*['\"](jax|repro)\b", text)
    assert not re.search(r"['\"]repro\.[a-z]", text), (
        f"{rel} names a module path of the reference package"
    )


MAIN_PATH = """
import sys
import torch
from repro_torch.core import plan, paper_alg6, gather_scatter, run_sequential
from repro_torch.kernels.pipelined_matmul.ops import matmul
from repro_torch.kernels.pipelined_matmul.schedule import compile_kloop
import repro_torch.convert  # noqa: F401

for prog, deps in ((paper_alg6(16), None), (gather_scatter(8), "speculate")):
    init = prog.initial_store()
    out = plan(prog, method="isd", deps=deps).compile(
        "torch", device="cpu"
    ).run(store=init)
    assert out == run_sequential(prog, init)
compile_kloop(2, 16, device="cpu")

# the SPMD backend (no process group: one device) and a calibration
import repro_torch.calibrate as calibrate

prog = paper_alg6(16)
init = prog.initial_store()
out = plan(prog, method="isd").compile("torch_spmd", device="cpu").run(store=init)
assert out == run_sequential(prog, init)
calibrate.measure(device="cpu", n=256, widths=(4, 16), repeats=1, persist=False)

# the plan service on the "torch" backend
from repro_torch.serve import PlanService, ServiceOptions, decode_program

with PlanService(ServiceOptions(device="cpu")) as svc:
    prog = decode_program(6)
    res = svc.submit(prog, run=True).result()
    assert res.store == run_sequential(prog, prog.initial_store())
a = torch.ones(5, 3)
assert torch.equal(matmul(a, torch.ones(3, 2)), torch.full((5, 2), 3.0))

# the LM serving path: a prefill and a decode step on the CPU
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve_lm import generate, make_batch
from repro_torch.models import model_zoo

cfg = get_smoke_config("gemma3_27b")
params = model_zoo.init(cfg, device="cpu")
res = generate(params, cfg, make_batch(cfg, 2, 8, device="cpu"), 2)
assert res.tokens.shape == (2, 2) and len(res.decode_ms) == 1
# one MoE, one Mamba and one encoder-decoder smoke forward
for arch in ("deepseek_moe_16b", "mamba2_2_7b", "whisper_medium"):
    cfg = get_smoke_config(arch)
    batch = make_batch(cfg, 2, 8, device="cpu")
    logits, aux = model_zoo.forward_logits(model_zoo.init(cfg, device="cpu"), batch, cfg)
    assert logits.shape == (2, 8, cfg.padded_vocab_size) and bool(torch.isfinite(aux))
# the training path: a CPU train loop of a smoke config, checkpointed
import tempfile
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.trainer import train_loop

with tempfile.TemporaryDirectory() as d:
    res = train_loop(
        get_smoke_config("granite_3_2b"), DataConfig(global_batch=2, seq_len=8),
        total_steps=2, ckpt=CheckpointManager(d, async_writes=False),
        ckpt_every=1, device="cpu",
    )
assert res.final_step == 2
# the continuous-batching server, the pipeline runner and the pipeline step's module
from repro_torch.launch import serve
from repro_torch.runtime import pp_lowering  # noqa: F401
from repro_torch.runtime.pipeline import PipelineRunner

run = serve.main(["--requests", "2", "--slots", "2", "--max-new", "2", "--device", "cpu"])
assert run.waves == 1 and len(run.done[0].generated) == 2
runner = PipelineRunner([lambda x: x + 1.0] * 3, num_microbatches=2)
outs, stats = runner.run([torch.zeros(2), torch.ones(2)])
assert stats.handoffs == 4 and all(torch.equal(a, b) for a, b in zip(outs, runner.run_reference([torch.zeros(2), torch.ones(2)])))
# a dry-run cell on the production mesh (a fake group of 512 ranks)
from repro_torch.launch import dryrun

with tempfile.TemporaryDirectory() as d:
    rec = dryrun.run_cell("mamba2_2_7b", "decode_32k", False, __import__("pathlib").Path(d))
assert rec["chips"] == 256 and rec["memory"]["argument_bytes"] > 0
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "repro")
)
print("LEAKED", leaked)
"""


def test_main_path_subprocess_loads_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run(
        [sys.executable, "-c", MAIN_PATH],
        env=env,
        cwd=str(ROOT),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout
