"""The port on the card: every test here needs a CUDA device and skips
without one.  On the machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only PyTorch is installed; its
oracles are the reference's framework-free ``run_sequential`` and the
port's plain PyTorch versions (for the LM path, the same model run on the
CPU).
"""

import numpy as np
import pytest
import torch

import repro.core as ref_core
from programs import ALL_PROGRAMS

import repro_torch.core as tc
from repro_torch.configs import get_smoke_config
from repro_torch.convert import program_from_reference, store_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref
from repro_torch.kernels.pipelined_matmul import ops, schedule
from repro_torch.kernels.pipelined_matmul.ref import matmul_ref
from repro_torch.launch import serve_lm
from repro_torch.models import attention, model_zoo

pytestmark = pytest.mark.cuda

METHODS = ("none", "isd", "pattern", "both")
DEPS_MODES = (None, "inspect", "speculate")
# (M, K, N); in bf16 all but (300, 257, 130) take the TMA kernel, and
# (300, 264, 136) has a ragged M, N below one 256-wide tile and K not a
# multiple of the 64-deep K-step
SHAPES = [(128, 128, 128), (256, 512, 128), (300, 257, 130), (64, 8, 24), (300, 264, 136)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# flash attention: the largest relative L2 error of one output row against
# the plain version in f32 (a row's norm shrinks with its live keys, so an
# absolute limit would be loose on long rows); the limits of chip_smoke.py
ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


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
        lambda x: x ** 2,
        lambda x: abs(x) ** 0.5,
        lambda x: 1.3 ** x,
    ],
    ids=["div", "rdiv", "floordiv_mod", "bool_select", "x**2", "abs(x)**0.5", "1.3**x"],
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


def _expected_route(dtype, K, N):
    if dtype == torch.float32:
        return "ffma"
    return "tma_wgmma" if K % 8 == 0 and N % 8 == 0 else "cp_async_mma"


def _launch_counted(a, b, **kw):
    """``ops.matmul`` and the route its one launch took."""

    before, routes = ops.matmul.launches, dict(ops.matmul.routes)
    out = ops.matmul(a, b, **kw)
    torch.cuda.synchronize()
    assert ops.matmul.launches == before + 1
    took = [r for r, n in ops.matmul.routes.items() if n != routes[r]]
    assert len(took) == 1 and ops.matmul.routes[took[0]] == routes[took[0]] + 1
    return out, took[0]


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernel_matches_plain_version_on_cuda(cuda, M, K, N, dtype, depth):
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
    a, b = a.to(cuda, dtype), b.to(cuda, dtype)
    out, took = _launch_counted(a, b, depth=depth)
    assert took == _expected_route(dtype, K, N)
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


@pytest.mark.parametrize("M,K,N", [(200, 200, 264), (256, 256, 512)])
def test_tma_kernel_identity_a_returns_b_exactly(cuda, M, K, N):
    """A = I: every output element is one bf16 value of B times 1 plus
    zeros, exact in f32 and back in bf16; a B-descriptor, swizzle or
    epilogue mistake shows position by position."""

    b = torch.randn(K, N, device=cuda).bfloat16()
    out, took = _launch_counted(torch.eye(M, device=cuda).bfloat16(), b)
    assert took == "tma_wgmma"
    assert torch.equal(out, b)


@pytest.mark.parametrize("M,K,N", [(300, 264, 264), (128, 256, 256)])
def test_tma_kernel_identity_b_returns_a_exactly(cuda, M, K, N):
    a = torch.randn(M, K, device=cuda).bfloat16()
    out, took = _launch_counted(a, torch.eye(K, device=cuda).bfloat16())
    assert took == "tma_wgmma"
    assert torch.equal(out, a)


def test_bf16_route_follows_the_base_address_on_cuda(cuda):
    """A view 16 bytes into its allocation takes the TMA kernel; one 2 bytes
    in takes the cp.async kernel; both agree with the plain version."""

    base = torch.randn(128 * 64 + 8, device=cuda).bfloat16()
    b = torch.randn(64, 256, device=cuda).bfloat16()
    for offset, expect in ((8, "tma_wgmma"), (1, "cp_async_mma")):
        a = base[offset:offset + 128 * 64].view(128, 64)
        out, took = _launch_counted(a, b)
        assert took == expect
        torch.testing.assert_close(
            out.float(), matmul_ref(a, b).float(), atol=3e-2 * 8, rtol=3e-2
        )


def test_tma_route_failure_raises_and_launches_nothing_else(cuda, monkeypatch):
    """An eligible operand whose TMA launch fails raises; it is never
    retried on the cp.async kernel."""

    real = ops._entry_point

    def failing(src, name):
        if src == ops.TMA_SOURCE:
            return lambda *args: 1  # cudaErrorInvalidValue
        return real(src, name)

    monkeypatch.setattr(ops, "_entry_point", failing)
    a = torch.randn(128, 64, device=cuda).bfloat16()
    b = torch.randn(64, 256, device=cuda).bfloat16()
    before, routes = ops.matmul.launches, dict(ops.matmul.routes)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        ops.matmul(a, b)
    assert ops.matmul.launches == before and ops.matmul.routes == routes


def test_tma_kernel_refuses_a_schedule_without_both_waits(cuda):
    a = torch.randn(128, 64, device=cuda).bfloat16()
    b = torch.randn(64, 256, device=cuda).bfloat16()
    out = torch.empty(128, 256, device=cuda).bfloat16()
    fn = ops._entry_point(ops.TMA_SOURCE, "pm_matmul_bf16_tma")
    stream = torch.cuda.current_stream().cuda_stream
    for full, empty in ((1, 0), (0, 1)):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 128, 256, 64, 4,
                full, empty, stream)
        assert rc == 1  # cudaErrorInvalidValue


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.randn(32, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul(a, torch.randn(32, 16, device=cuda).t())
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.matmul(a, torch.randn(16, 8))


# ---------------------------------------------------------------------- #
# Flash attention: the kernel against its plain version
# ---------------------------------------------------------------------- #

FLASH_CASES = [
    # B, Sq, Sk, H, KV, hd, causal, window
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, None),
    (2, 192, 192, 4, 2, 64, True, None),
    (1, 256, 256, 2, 2, 32, True, 32),
    (1, 256, 256, 2, 2, 32, True, 100),
    (1, 256, 256, 2, 2, 32, True, 1000),
    (1, 193, 201, 4, 4, 32, False, None),
    (1, 201, 193, 4, 1, 16, True, None),
    (2, 300, 300, 8, 2, 128, True, 64),
    (1, 77, 77, 2, 1, 128, False, 16),
]


def _flash_inputs(cuda, B, Sq, Sk, H, KV, hd, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, device=cuda, generator=gen).to(dtype)
    k = torch.randn(B, Sk, KV, hd, device=cuda, generator=gen).to(dtype)
    v = torch.randn(B, Sk, KV, hd, device=cuda, generator=gen).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_kernel_matches_plain_version_on_cuda(cuda, case, dtype):
    B, Sq, Sk, H, KV, hd, causal, window = case
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, KV, hd, dtype)
    before = flash_ops.flash_attention.launches
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    ref = flash_attention_bshd_ref(
        q.float(), k.float(), v.float(), causal=causal, window=window
    )
    assert out.shape == ref.shape and out.dtype == dtype
    row_err = (out.float() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    assert row_err.max().item() <= ROW_TOL[dtype]


def test_flash_kernel_reads_strided_views(cuda):
    """q, k and v as head slices of one fused projection: strided, not
    contiguous, read in place."""

    qkv = torch.randn(2, 96, 4 + 2 + 2, 64, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    out = flash_ops.flash_attention(q, k, v, causal=True)
    ref = flash_attention_bshd_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_chunked_attention_on_cuda_is_the_kernel(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 4, 2, 32, torch.bfloat16)
    before = flash_ops.flash_attention.launches
    out = attention.chunked_attention(q, k, v, causal=True, window=16)
    assert flash_ops.flash_attention.launches == before + 1
    ref = attention.chunked_attention_plain(q, k, v, causal=True, window=16)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=3e-2)
    with pytest.raises(NotImplementedError, match="q_offset"):
        attention.chunked_attention(q, k, v, q_offset=8)
    q8, k8, v8 = _flash_inputs(cuda, 1, 16, 16, 2, 2, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="hd=8"):
        attention.chunked_attention(q8, k8, v8)
    assert flash_ops.flash_attention.launches == before + 1


@pytest.mark.parametrize("arch", ["yi_6b", "gemma3_27b"])
def test_smoke_size_serving_on_cuda_goes_through_the_kernel(cuda, arch):
    """The smoke configuration served on the card agrees with the same
    weights served on the CPU (logits within 1e-4 in f32: the two devices
    sum in other orders), with one kernel launch per attention layer per
    prefill."""

    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = model_zoo.init(cfg, device="cpu", seed=0)
    batch = serve_lm.make_batch(cfg, 2, 24, device="cpu", seed=1)
    on_cpu = serve_lm.generate(params, cfg, batch, 6)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    before = flash_ops.flash_attention.launches
    on_cuda = serve_lm.generate(to(params), cfg, to(batch), 6)
    assert flash_ops.flash_attention.launches - before == cfg.num_layers
    torch.testing.assert_close(
        on_cuda.prefill_logits.cpu(), on_cpu.prefill_logits, atol=1e-4, rtol=1e-4
    )
    assert on_cuda.tokens.shape == on_cpu.tokens.shape
