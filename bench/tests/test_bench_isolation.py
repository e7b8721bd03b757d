"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names: the port's own name begins with the JAX package's),
the plain reference imports nothing of the program, and nothing reads the
JAX package's benchmark folder."""

import ast
import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = FORBIDDEN | {"repro_torch"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_every_module_the_benchmark_loads_is_free_of_jax():
    code = f"""
import sys, json
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent / 'src')!r}]
import torch, harness, control
from kinds import train, prefill_closed, decode_pool
from reference import decoder
from pathlib import Path
for p in sorted(Path({str(BENCH / 'metrics')!r}).glob('*.py')):
    harness.reader(p.name[:-3])
import repro_torch.launch.steps, repro_torch.models.model_zoo, repro_torch.optim.optimizer
import repro_torch.kernels.flash_attention.ops
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names and not names & FORBIDDEN


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    import harness
    import repro_torch  # noqa: F401  (its name begins with the JAX package's)

    assert "repro_torch" not in harness.jax_modules()
    monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
    assert "repro" in harness.jax_modules()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & PROGRAM, tops


RUN = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", RUN, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_reads_the_jax_benchmarks(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops
    assert "benchmarks" not in path.read_text()
