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
    "obs/profile.py",
    *sorted(
        str(p.relative_to(REF)) for p in (REF / "core").glob("*.py")
    ),
    "compile/structure.py",
    "compile/cache.py",
    "compile/executor.py",
    "kernels/pipelined_matmul/schedule.py",
]

# The copies that differ beyond the rename, and why.
DIFFERING = {
    "core/parallelizer.py": (
        "the lazily registered backends are the port's own: "
        '{"torch": "repro_torch.compile"} instead of xla / xla_spmd'
    ),
    "kernels/pipelined_matmul/schedule.py": (
        'compile_kloop compiles "torch" and takes the device'
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
a = torch.ones(5, 3)
assert torch.equal(matmul(a, torch.ones(3, 2)), torch.full((5, 2), 3.0))
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
