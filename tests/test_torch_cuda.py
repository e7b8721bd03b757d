"""The port on the card: every test here needs a CUDA device and skips
without one.  On the machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only PyTorch is installed; its
oracles are the reference's framework-free ``run_sequential`` and the
port's plain PyTorch versions.
"""

import numpy as np
import pytest
import torch

import repro.core as ref_core
from programs import ALL_PROGRAMS

import repro_torch.core as tc
from repro_torch.convert import program_from_reference, store_from_reference
from repro_torch.kernels.pipelined_matmul import ops, schedule
from repro_torch.kernels.pipelined_matmul.ref import matmul_ref

pytestmark = pytest.mark.cuda

METHODS = ("none", "isd", "pattern", "both")
DEPS_MODES = (None, "inspect", "speculate")
SHAPES = [(128, 128, 128), (256, 512, 128), (300, 257, 130), (64, 8, 24)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("method", METHODS)
def test_corpus_bit_equal_on_cuda(cuda, method):
    for deps in DEPS_MODES:
        for name, ref_prog in ALL_PROGRAMS:
            init = store_from_reference(ref_prog.initial_store())
            expect = ref_core.run_sequential(ref_prog, init)
            p = tc.plan(program_from_reference(ref_prog), method=method, deps=deps)
            out = p.compile("torch", device=cuda).run(store=init)
            naive = tc.get_backend("torch").differential(
                p.naive_sync, store=init, device=cuda
            )
            assert out == expect, f"{name}/{method}/deps={deps} diverged"
            assert naive == expect, f"{name}/{method}/deps={deps} naive diverged"


@pytest.mark.parametrize(
    "compute",
    [
        lambda x: x / 7,
        lambda x: 7.0 / (x + 100.0),
        lambda x: x // 3 + x % 3,
        lambda x: (x > 0.5) * 0.1 - x / 3,
    ],
    ids=["div", "rdiv", "floordiv_mod", "bool_select"],
)
def test_division_family_bit_equal_on_cuda(cuda, compute):
    prog = tc.LoopProgram(
        statements=(
            tc.Statement(
                "S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", 0),),
                compute=compute,
            ),
        ),
        bounds=((0, 2048),),
    )
    init = prog.initial_store()
    out = tc.plan(prog).compile("torch", device=cuda).run(store=init)
    assert out == tc.run_sequential(prog, init)


def test_out_of_store_flag_raises_on_cuda(cuda):
    prog = tc.LoopProgram(
        statements=(
            tc.Statement("S1", tc.ArrayRef("a", 6), (), guard=tc.ArrayRef("p", 0)),
        ),
        bounds=((0, 4),),
    )
    store = {
        "a": {(i,): 0.0 for i in range(8)},
        "p": {(i,): 1.0 for i in range(4)},
    }
    with pytest.raises(KeyError, match="initialized store"):
        tc.plan(prog).compile("torch", device=cuda).run(store=store)


@pytest.mark.parametrize("depth", [1, 2])
def test_kloop_compiles_and_runs_on_cuda(cuda, depth):
    first, _ = schedule.compile_kloop(depth, 16, device=cuda)
    again, hit = schedule.compile_kloop(depth, 64, device=cuda)
    assert hit and again is first
    p = schedule._kloop_plan(depth, 64)
    init = p.program.initial_store()
    out = p.compile("torch", device=cuda).run(store=init)
    assert out == tc.run_sequential(p.program, init)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernel_matches_plain_version_on_cuda(cuda, M, K, N, dtype, depth):
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
    a, b = a.to(cuda, dtype), b.to(cuda, dtype)
    before = ops.matmul.launches
    out = ops.matmul(a, b, depth=depth)
    torch.cuda.synchronize()
    assert ops.matmul.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(
        out.float(), matmul_ref(a, b).float(), atol=tol * K**0.5, rtol=tol
    )


def test_kernel_takes_offset_views_through_the_element_path(cuda):
    """A view whose base is not 16-byte aligned takes the element-granular
    copy path and still agrees."""

    base = torch.randn(65, 64, device=cuda)
    a = base[1:]  # contiguous, 256 bytes past the allocation: aligned
    b = torch.randn(64 * 33 + 1, device=cuda)[1:].view(64, 33)  # 4-byte offset
    out = ops.matmul(a, b)
    torch.testing.assert_close(
        out, matmul_ref(a, b), atol=2e-5 * 64**0.5, rtol=2e-5
    )


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.randn(32, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul(a, torch.randn(32, 16, device=cuda).t())
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.matmul(a, torch.randn(16, 8))
