"""The port on the card: every test here needs a CUDA device and skips
without one.  On the machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only PyTorch is installed; its
oracles are the reference's framework-free ``run_sequential`` and the
port's plain PyTorch versions (for the LM path, the same model run on the
CPU).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro.core as ref_core
from programs import ALL_PROGRAMS

import repro_torch.core as tc
from repro_torch.configs import get_smoke_config
from repro_torch.convert import program_from_reference, store_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.probe import one_hot_probe, split_edge_picks
from repro_torch.kernels.flash_attention.ref import (
    combine_splits_ref,
    decode_partials_ref,
    flash_attention_bshd_ref,
    flash_attention_tf32x3_ref,
    split_kv_tf32_ref,
)
from repro_torch.kernels.pipelined_matmul import ops, schedule
from repro_torch.kernels.pipelined_matmul.ref import matmul_ref, split_tf32_ref, stage_ref
from repro_torch.launch import serve_lm
from repro_torch.models import attention, model_zoo

pytestmark = pytest.mark.cuda

METHODS = ("none", "isd", "pattern", "both")
DEPS_MODES = (None, "inspect", "speculate")
# (M, K, N); every shape takes its dtype's TMA route, (300, 257, 130) after
# the bf16 stage of both operands, and (300, 264, 136) has a ragged M, N
# below one 256-wide tile and K not a multiple of the 64-deep K-step
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
    """The route rule written out: the TMA route of the dtype, whatever K
    and N are."""

    return "tma_wgmma_tf32x3" if dtype == torch.float32 else "tma_wgmma"


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
    if _expected_route(dtype, K, N) == "tma_wgmma_tf32x3" and depth > ops.TF32X3_STAGES:
        with pytest.raises(NotImplementedError, match="ring depth"):
            ops.matmul(a, b, depth=depth)  # 4 x 64 KB does not fit
        return
    out, took = _launch_counted(a, b, depth=depth)
    assert took == _expected_route(dtype, K, N)
    tol = TOL[dtype]
    torch.testing.assert_close(
        out.float(), matmul_ref(a, b).float(), atol=tol * K**0.5, rtol=tol
    )


def test_kernel_takes_offset_views_on_cuda(cuda):
    """A view whose base is not 16-byte aligned is read by the split, which
    writes it anew at a 16-byte stride, and still agrees."""

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
    """A view 16 bytes into its allocation goes straight to the TMA kernel;
    one 2 bytes in is restaged first (one stage launch); both agree with
    the plain version."""

    base = torch.randn(128 * 64 + 8, device=cuda).bfloat16()
    b = torch.randn(64, 256, device=cuda).bfloat16()
    for offset, stages in ((8, 0), (1, 1)):
        a = base[offset:offset + 128 * 64].view(128, 64)
        before = ops.stage_bf16.launches
        out, took = _launch_counted(a, b)
        assert took == "tma_wgmma" and ops.stage_bf16.launches == before + stages
        torch.testing.assert_close(
            out.float(), matmul_ref(a, b).float(), atol=3e-2 * 8, rtol=3e-2
        )


def test_tma_route_failure_raises_and_launches_nothing_else(cuda, monkeypatch):
    """An operand whose TMA launch fails raises; nothing else is tried."""

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
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 128, 256, 64, 64, 256, 4,
                full, empty, stream)
        assert rc == 1  # cudaErrorInvalidValue
    for lda, ldb in ((60, 256), (64, 252), (72 + 4, 256)):  # below K / N, or not % 8
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 128, 256, 64, lda, ldb, 4,
                1, 1, stream)
        assert rc == 1


# ---------------------------------------------------------------------- #
# The 3xTF32 route: split pre-pass and tensor-core product
# ---------------------------------------------------------------------- #

# (M, K, N): whole tiles; a ragged M and N below one tile; K not a multiple
# of the 256 promotion run (1000, 264) or of the 32-deep K-step (20); K
# below one K-step (4); several runs with a ragged last one (4100)
TF32X3_SHAPES = [(128, 128, 128), (300, 264, 136), (256, 1000, 256),
                 (64, 20, 24), (130, 4, 44), (192, 4100, 136)]


def _limit_ratio(out, ref, K):
    """The largest error as a share of the f32 limit 2e-5 sqrt(K) + 2e-5
    |ref|."""

    err = (out.double() - ref.double()).abs()
    return (err / (2e-5 * K**0.5 + 2e-5 * ref.double().abs())).max().item()


def _bits21(x):
    """x with 21 significant bits, so that hi + lo == x exactly."""

    return (x.view(torch.int32) & ~0x7).view(torch.float32)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("M,K,N", TF32X3_SHAPES)
def test_tf32x3_kernel_within_the_limit_of_plain_and_f64_on_cuda(cuda, M, K, N, depth):
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(cuda)
    splits = ops.split_tf32.launches
    out, took = _launch_counted(a, b, depth=depth)
    assert took == "tma_wgmma_tf32x3" and out.shape == (M, N)
    assert ops.split_tf32.launches == splits + 2
    assert _limit_ratio(out, matmul_ref(a, b), K) <= 1
    assert _limit_ratio(out, a.double() @ b.double(), K) <= 1


@pytest.mark.parametrize("transpose", [False, True], ids=["rows", "transposed"])
@pytest.mark.parametrize("shape", [(64, 64), (300, 264), (36, 4), (4, 1028), (2048, 4096),
                                   (300, 257), (257, 130), (7, 5), (33, 1), (1, 49155)])
def test_split_kernel_is_bit_equal_to_its_plain_version_on_cuda(cuda, shape, transpose):
    rng = np.random.default_rng(shape[0] + shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.float32(2.0) ** rng.integers(-30, 30, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:8] = [0.0, -0.0, 1 + 2.0**-11, -(1 + 2.0**-11), 1e-38, -3e-39, 3e38, -1e-45]
    x = torch.from_numpy(x).to(cuda)
    before = ops.split_tf32.launches
    hi, lo = ops.split_tf32(x, transpose)
    torch.cuda.synchronize()
    assert ops.split_tf32.launches == before + 1
    width = shape[0] if transpose else shape[1]
    rh, rl = split_tf32_ref(x, transpose, ld=(width + 3) // 4 * 4)
    assert torch.equal(hi.view(torch.int32), rh.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), rl.view(torch.int32))


@pytest.mark.parametrize("transpose", [False, True], ids=["rows", "transposed"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_split_kernel_reads_views_at_any_base_on_cuda(cuda, offset, transpose):
    """Views 4, 8 and 12 bytes into their allocation, with rows of 37
    floats: every row starts at another alignment."""

    x = torch.randn(50 * 37 + offset, device=cuda)[offset:].view(50, 37)
    hi, lo = ops.split_tf32(x, transpose)
    rh, rl = split_tf32_ref(x, transpose, ld=(50 if transpose else 37) + 3 & ~3)
    torch.cuda.synchronize()
    assert torch.equal(hi.view(torch.int32), rh.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), rl.view(torch.int32))


def test_split_kernel_refuses_what_it_cannot_read_on_cuda(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        ops.split_tf32(torch.randn(8, 6, device=cuda).t())
    with pytest.raises(TypeError):
        ops.split_tf32(torch.randn(2, 6, 8, device=cuda), transpose=True)
    with pytest.raises(TypeError):
        ops.split_tf32(torch.randn(8, 8, device=cuda).double())


def test_tf32x3_identity_a_returns_b_exactly_at_yi6b_widths(cuda):
    """A = I and B of 21 significant bits: every output is b_lo + b_hi of
    one element of B plus zeros, exact if the split, the descriptors, the
    promotion and the epilogue are."""

    b = _bits21(torch.randn(4096, 11008, device=cuda))
    out, took = _launch_counted(torch.eye(4096, device=cuda), b)
    assert took == "tma_wgmma_tf32x3"
    assert torch.equal(out, b)


def test_tf32x3_identity_b_returns_a_exactly_at_yi6b_widths(cuda):
    a = _bits21(torch.randn(2048, 4096, device=cuda))
    out, took = _launch_counted(a, torch.eye(4096, device=cuda))
    assert took == "tma_wgmma_tf32x3"
    assert torch.equal(out, a)


def test_tf32x3_route_failure_raises_and_launches_nothing_else(cuda, monkeypatch):
    """A failing product launch raises naming the route; no other kernel is
    tried."""

    real = ops._entry_point

    def failing(src, name):
        if name == "pm_matmul_f32_tf32x3":
            return lambda *args: 1  # cudaErrorInvalidValue
        return real(src, name)

    monkeypatch.setattr(ops, "_entry_point", failing)
    a, b = torch.randn(128, 64, device=cuda), torch.randn(64, 128, device=cuda)
    before, routes = ops.matmul.launches, dict(ops.matmul.routes)
    with pytest.raises(RuntimeError, match="tma_wgmma_tf32x3: cudaError 1"):
        ops.matmul(a, b)
    assert ops.matmul.launches == before and ops.matmul.routes == routes


def test_tf32x3_kernel_refuses_a_schedule_without_both_waits(cuda):
    a_hi, a_lo = ops.split_tf32(torch.randn(128, 64, device=cuda))
    b_hi, b_lo = ops.split_tf32(torch.randn(64, 128, device=cuda), transpose=True)
    out = torch.empty(128, 128, device=cuda)
    fn = ops._entry_point(ops.TF32X3_SOURCE, "pm_matmul_f32_tf32x3")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (a_hi, a_lo, b_hi, b_lo, out)]
    for stages, full, empty in ((3, 1, 0), (3, 0, 1), (4, 1, 1)):
        assert fn(*ptrs, 128, 128, 64, 64, stages, full, empty, stream) == 1
    for ld in (60, 66):  # below K, or not a multiple of 4
        assert fn(*ptrs, 128, 128, 64, ld, 3, 1, 1, stream) == 1


# ---------------------------------------------------------------------- #
# Operands TMA cannot describe as they lie: the bf16 stage, the padded split
# ---------------------------------------------------------------------- #

# (M, K, N): odd N, odd K, both, M = 1, K and N below one 16-byte row
UNALIGNED_SHAPES = [(300, 257, 130), (256, 264, 257), (200, 131, 264), (1, 257, 129),
                    (1, 8, 3), (64, 9, 25), (130, 5, 7)]


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", UNALIGNED_SHAPES)
def test_unaligned_operands_take_the_tma_routes_on_cuda(cuda, M, K, N, dtype, depth):
    """Both routes at every depth on strides TMA cannot describe: within
    the limit of the plain version, and in f32 of an f64 product; the bf16
    stage launched once a call where K or N is not a multiple of 8, the
    split twice."""

    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(cuda, dtype)
    if dtype == torch.float32 and depth > ops.TF32X3_STAGES:
        with pytest.raises(NotImplementedError, match="ring depth"):
            ops.matmul(a, b, depth=depth)
        return
    stages, splits = ops.stage_bf16.launches, ops.split_tf32.launches
    out, took = _launch_counted(a, b, depth=depth)
    assert took == _expected_route(dtype, K, N) and out.shape == (M, N)
    if dtype == torch.float32:
        assert ops.split_tf32.launches == splits + 2 and ops.stage_bf16.launches == stages
        assert _limit_ratio(out, matmul_ref(a, b), K) <= 1
        assert _limit_ratio(out, a.double() @ b.double(), K) <= 1
    else:
        want = int(K % 8 != 0 or N % 8 != 0)
        assert ops.stage_bf16.launches == stages + want and ops.split_tf32.launches == splits
        torch.testing.assert_close(out.float(), matmul_ref(a, b).float(),
                                   atol=3e-2 * K**0.5, rtol=3e-2)


@pytest.mark.parametrize("offset", [1, 2, 4])  # 2, 4 and 8 bytes in
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_views_off_sixteen_bytes_take_the_tma_routes_on_cuda(cuda, dtype, offset):
    """A and B as views 2, 4 and 8 bytes (bf16) or 4, 8 and 16 bytes (f32)
    into their allocations, with aligned row lengths: the bf16 stage copies
    both, at their own widths."""

    M, K, N = 96, 64, 136
    base_a = torch.randn(M * K + offset, device=cuda).to(dtype)
    base_b = torch.randn(K * N + offset, device=cuda).to(dtype)
    a = base_a[offset:].view(M, K)
    b = base_b[offset:].view(K, N)
    st = ops.staging(dtype, M, K, N, a.data_ptr(), b.data_ptr())
    out, took = _launch_counted(a, b)
    assert took == _expected_route(dtype, K, N)
    if dtype == torch.bfloat16:
        assert (st.a, st.b, st.lda, st.ldb) == (True, True, K, N)
        torch.testing.assert_close(out.float(), matmul_ref(a, b).float(),
                                   atol=3e-2 * K**0.5, rtol=3e-2)
    else:
        assert _limit_ratio(out, a.double() @ b.double(), K) <= 1


@pytest.mark.parametrize("offset", [0, 1, 3, 7])
@pytest.mark.parametrize("rows,cols", [(300, 257), (257, 130), (33, 7), (2048, 49155), (5, 1)])
def test_stage_is_bit_equal_to_its_plain_version_on_cuda(cuda, rows, cols, offset):
    """The stage of one operand (B) and of both, at bases 0, 2, 6 and 14
    bytes into an allocation: the whole (rows, ld) buffer, padding included,
    bit-equal to ``stage_ref``; one launch a call."""

    x = torch.randn(rows * cols + offset, device=cuda).bfloat16()[offset:].view(rows, cols)
    y = torch.randn(rows, cols + 3, device=cuda).bfloat16()
    ld = (cols + 7) // 8 * 8
    for st, want in ((ops.Staging(a=False, b=True, lda=cols, ldb=ld), (y, stage_ref(x, ld))),
                     (ops.Staging(a=True, b=True, lda=(cols + 10) // 8 * 8, ldb=ld),
                      (stage_ref(y, (cols + 10) // 8 * 8), stage_ref(x, ld)))):
        before = ops.stage_bf16.launches
        got = ops.stage_bf16(y, x, st)
        torch.cuda.synchronize()
        assert ops.stage_bf16.launches == before + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g.view(torch.int16), w.view(torch.int16))


def test_failing_stage_raises_and_launches_no_product(cuda, monkeypatch):
    """A stage launch that fails raises naming the route; the product is
    not launched and nothing is counted."""

    real = ops._entry_point
    products = []

    def failing(src, name):
        if name == "pm_stage_bf16":
            return lambda *args: 1  # cudaErrorInvalidValue
        fn = real(src, name)
        return lambda *args: products.append(name) or fn(*args)

    monkeypatch.setattr(ops, "_entry_point", failing)
    a = torch.randn(128, 63, device=cuda).bfloat16()
    b = torch.randn(63, 256, device=cuda).bfloat16()
    before, routes, stages = ops.matmul.launches, dict(ops.matmul.routes), ops.stage_bf16.launches
    with pytest.raises(RuntimeError, match="stage launch failed on route tma_wgmma"):
        ops.matmul(a, b)
    assert products == []
    assert ops.matmul.launches == before and ops.matmul.routes == routes
    assert ops.stage_bf16.launches == stages


def test_failing_split_raises_and_launches_no_product(cuda, monkeypatch):
    real = ops._entry_point
    products = []

    def failing(src, name):
        if name == "pm_split_tf32":
            return lambda *args: 1
        fn = real(src, name)
        return lambda *args: products.append(name) or fn(*args)

    monkeypatch.setattr(ops, "_entry_point", failing)
    a, b = torch.randn(128, 63, device=cuda), torch.randn(63, 130, device=cuda)
    with pytest.raises(RuntimeError, match="split_tf32 launch failed on route tma_wgmma_tf32x3"):
        ops.matmul(a, b)
    assert products == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_identity_probes_at_the_lm_head_on_cuda(cuda, dtype):
    """granite-3-2b's LM head, (2048, 2048, 49155): I @ B == B and A @ I
    == A beside zero columns (the (K, N) identity), exactly; B is restaged
    in bf16 and N is odd, so the stage, the padded stride and the single
    stores of the odd-N epilogue are read position by position."""

    K, N = 2048, 49155
    b = _bits21(torch.randn(K, N, device=cuda)).to(dtype)
    a = _bits21(torch.randn(K, K, device=cuda)).to(dtype)
    out, took = _launch_counted(torch.eye(K, device=cuda, dtype=dtype), b)
    assert took == _expected_route(dtype, K, N) and torch.equal(out, b)
    out, took = _launch_counted(a, torch.eye(K, N, device=cuda, dtype=dtype))
    assert torch.equal(out[:, :K], a) and not out[:, K:].any()


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.randn(32, 16, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.matmul(a, torch.randn(16, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_takes_transposed_operands(cuda, dtype):
    """Transposed (column-major) operands reach the kernel, copied
    row-major, and agree with the plain version."""

    a = torch.randn(264, 192, device=cuda).to(dtype).t()  # (192, 264)
    b = torch.randn(136, 264, device=cuda).to(dtype).t()  # (264, 136)
    assert not (a.is_contiguous() or b.is_contiguous())
    before = ops.matmul.launches
    out = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert ops.matmul.launches == before + 1
    ref = matmul_ref(a.contiguous(), b.contiguous())
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype] * 16, rtol=TOL[dtype])


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
    (1, 193, 201, 4, 2, 128, True, None),
    (1, 193, 201, 4, 2, 128, False, None),
    (2, 333, 290, 4, 4, 64, False, 100),
]


def _flash_route(dtype, hd, sq=None, group=1):
    if dtype == torch.float32:
        return "tma_wgmma_tf32x3"
    if hd in (64, 128) and sq is not None and sq <= 16 and sq * group <= 64:
        return "flash_decode"
    return "tma_wgmma"


def _flash_counted(q, k, v, **kw):
    """``flash_ops.flash_attention`` and the route its one launch took."""

    before, routes = flash_ops.flash_attention.launches, dict(flash_ops.flash_attention.routes)
    out = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    took = [r for r, n in flash_ops.flash_attention.routes.items() if n != routes[r]]
    assert len(took) == 1
    return out, took[0]


def _row_err(out, ref):
    ref = ref.float()
    return ((out.float() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


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
    out, took = _flash_counted(q, k, v, causal=causal, window=window)
    assert took == _flash_route(dtype, hd)
    ref = flash_attention_bshd_ref(
        q.float(), k.float(), v.float(), causal=causal, window=window
    )
    assert out.shape == ref.shape and out.dtype == dtype
    assert _row_err(out, ref) <= ROW_TOL[dtype]


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_tma_kernel_at_every_depth_on_cuda(cuda, hd):
    """Every ring depth that fits (1 .. default_depth) on the TMA route,
    causal over several tiles and with a window."""

    q, k, v = _flash_inputs(cuda, 2, 520, 520, 4, 2, hd, torch.bfloat16, seed=hd)
    for window in (None, 200):
        ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), causal=True, window=window)
        for depth in range(1, flash_ops.default_depth(hd) + 1):
            out, took = _flash_counted(q, k, v, causal=True, window=window, depth=depth)
            assert took == "tma_wgmma"
            assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16], (depth, window)


@pytest.mark.parametrize(
    "shape,kw",
    [
        ((2, 520, 520, 4, 2), dict(causal=True)),
        ((1, 193, 201, 4, 2), dict(causal=False)),
        ((1, 300, 300, 4, 1), dict(causal=True, window=130)),
        ((2, 520, 520, 4, 2), dict(causal=True, identity_v=True)),
        ((1, 193, 201, 4, 4), dict(causal=False, identity_v=True)),
    ],
    ids=["causal", "ragged", "window", "causal_identity_v", "ragged_identity_v"],
)
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_tma_one_hot_probes_are_exact_on_cuda(cuda, hd, shape, kw):
    """Each row's one live key of margin >= 128 returns its v row (or, with
    V = I, the one-hot P) bit for bit: a wrong P fragment, V transpose or
    descriptor stride shows position by position."""

    B, Sq, Sk, H, KV = shape
    q, k, v, expected = one_hot_probe(B, Sq, Sk, H, KV, hd, seed=hd, **kw)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (q, k, v))
    kw = {n: x for n, x in kw.items() if n != "identity_v"}
    out, took = _flash_counted(q, k, v, **kw)
    assert took == "tma_wgmma"
    assert torch.equal(out.float().cpu(), torch.from_numpy(expected))


def test_flash_tma_reads_kv_cache_slices_and_head_views_on_cuda(cuda):
    """k and v as the first Sk positions of a longer cache, q as a head
    slice of a fused projection: strided, read in place through the 4-D
    tensor maps, a ragged Sk zero-filled inside its own batch."""

    gen = torch.Generator(device=cuda).manual_seed(3)
    cache_k = torch.randn(2, 640, 2, 128, device=cuda, generator=gen).bfloat16()
    cache_v = torch.randn(2, 640, 2, 128, device=cuda, generator=gen).bfloat16()
    qkv = torch.randn(2, 201, 8, 128, device=cuda, generator=gen).bfloat16()
    q = qkv[:, :, :4]
    k, v = cache_k[:, :201], cache_v[:, :201]
    assert not (q.is_contiguous() or k.is_contiguous())
    out, took = _flash_counted(q, k, v, causal=True)
    assert took == "tma_wgmma"
    ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), causal=True)
    assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16]


def test_flash_tma_failure_raises_and_launches_nothing_else(cuda, monkeypatch):
    """An operand on the TMA route whose launch fails raises, naming the
    route and the shape; it is never retried on another kernel."""

    monkeypatch.setattr(flash_ops, "_tma_entry_point", lambda: (lambda *args: 1))
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 2, 2, 128, torch.bfloat16)
    before, routes = flash_ops.flash_attention.launches, dict(flash_ops.flash_attention.routes)
    with pytest.raises(RuntimeError, match=r"tma_wgmma.*cudaError 1.*hd=128"):
        flash_ops.flash_attention(q, k, v)
    assert flash_ops.flash_attention.launches == before
    assert flash_ops.flash_attention.routes == routes


def test_flash_tma_kernel_refuses_a_schedule_without_both_waits(cuda):
    import ctypes

    q, k, v = _flash_inputs(cuda, 1, 128, 128, 2, 2, 64, torch.bfloat16)
    o = torch.empty_like(q)
    fn = flash_ops._tma_entry_point()
    dims = (ctypes.c_longlong * 6)(1, 2, 2, 128, 128, 64)
    maps = (ctypes.c_longlong * 33)(
        *(x for t in (q, k, v) for x in flash_ops.tensor_map(t.shape, t.stride(), 128).flat())
    )
    o_strides = (ctypes.c_longlong * 3)(*o.stride()[:3])
    stream = torch.cuda.current_stream().cuda_stream
    for full, empty in ((1, 0), (0, 1)):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dims, maps,
                o_strides, 1, 0, 0, 0.18, 2, full, empty, stream)
        assert rc == 1  # cudaErrorInvalidValue


# ---------------------------------------------------------------------- #
# Flash attention in f32 on the tensor cores: the 3xTF32 route
# ---------------------------------------------------------------------- #

def _row_share_f64(out, q, k, v, **kw):
    """The largest relative L2 error of one output row against an f64
    plain version, as a share of the f32 row limit."""

    ref = flash_attention_bshd_ref(q.double(), k.double(), v.double(), **kw)
    d = (out.double() - ref).norm(dim=-1)
    return (d / ref.norm(dim=-1).clamp_min(1e-300)).max().item() / ROW_TOL[torch.float32]


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_tf32x3_kernel_at_every_depth_on_cuda(cuda, hd):
    """Every ring depth that fits, causal over several tiles and with a
    window; within the f32 limit of the plain version and of f64."""

    q, k, v = _flash_inputs(cuda, 2, 520, 520, 4, 2, hd, torch.float32, seed=hd)
    for window in (None, 200):
        kw = dict(causal=True, window=window)
        ref = flash_attention_bshd_ref(q, k, v, **kw)
        for depth in range(1, flash_ops.tf32x3_default_depth(hd) + 1):
            splits = flash_ops.split_kv_tf32.launches
            out, took = _flash_counted(q, k, v, depth=depth, **kw)
            assert took == "tma_wgmma_tf32x3"
            assert flash_ops.split_kv_tf32.launches == splits + 1
            assert _row_err(out, ref) <= ROW_TOL[torch.float32], (depth, window)
            assert _row_share_f64(out, q, k, v, **kw) <= 0.25, (depth, window)


def test_flash_tf32x3_error_against_f64_and_a_one_tf32_emulation_on_cuda(cuda):
    """At a yi-6b head shape the route reads at most a quarter of the f32
    limit against f64; one TF32 product of each pair reads above it."""

    q, k, v = _flash_inputs(cuda, 1, 1024, 1024, 8, 2, 128, torch.float32, seed=5)
    out, took = _flash_counted(q, k, v, causal=True)
    assert took == "tma_wgmma_tf32x3"
    assert _row_share_f64(out, q, k, v, causal=True) <= 0.25
    one = flash_attention_tf32x3_ref(q, k, v, causal=True, terms=1)
    assert _row_share_f64(one, q, k, v, causal=True) > 1


@pytest.mark.parametrize(
    "shape,kw",
    [
        ((2, 520, 520, 4, 2), dict(causal=True)),
        ((1, 193, 201, 4, 2), dict(causal=False)),
        ((1, 300, 300, 4, 1), dict(causal=True, window=130)),
        ((2, 520, 520, 4, 2), dict(causal=True, identity_v=True)),
        ((1, 193, 201, 4, 4), dict(causal=False, identity_v=True)),
    ],
    ids=["causal", "ragged", "window", "causal_identity_v", "ragged_identity_v"],
)
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_tf32x3_one_hot_probes_are_exact_on_cuda(cuda, hd, shape, kw):
    """The probes' values are exact in TF32 (lo = 0), so each row returns
    its v row (with V = I the one-hot P) bit for bit: a wrong key order in
    Vᵀ, A fragment or descriptor moves the one 1 of a row."""

    B, Sq, Sk, H, KV = shape
    q, k, v, expected = one_hot_probe(B, Sq, Sk, H, KV, hd, seed=hd, **kw)
    q, k, v = (torch.from_numpy(a).to(cuda) for a in (q, k, v))
    kw = {n: x for n, x in kw.items() if n != "identity_v"}
    out, took = _flash_counted(q, k, v, **kw)
    assert took == "tma_wgmma_tf32x3"
    assert torch.equal(out.cpu(), torch.from_numpy(expected))


@pytest.mark.parametrize(
    "B,Sk,KV,hd,view",
    [(4, 2048, 4, 128, False), (2, 201, 2, 128, True), (1, 5, 3, 64, False), (2, 333, 2, 64, True),
     (4, 2048, 8, 16, False), (2, 201, 2, 16, True), (64, 512, 12, 32, False), (2, 333, 2, 32, True)],
    ids=["yi6b", "cache_slice_ragged", "short", "cache_slice_hd64", "hd16_prefill",
         "cache_slice_hd16", "minilm_hd32", "cache_slice_hd32"],
)
def test_split_kv_kernel_is_bit_equal_to_its_plain_version_on_cuda(cuda, B, Sk, KV, hd, view):
    gen = torch.Generator(device=cuda).manual_seed(Sk)
    if view:  # the first Sk positions of a cache holding k and v side by side
        cache = torch.randn(B, 640, 2 * KV, hd, device=cuda, generator=gen)
        k, v = cache[:, :Sk, :KV], cache[:, :Sk, KV:]
    else:
        k = torch.randn(B, Sk, KV, hd, device=cuda, generator=gen)
        v = torch.randn(B, Sk, KV, hd, device=cuda, generator=gen)
        # a tie, a negative zero, the top of the range and a subnormal
        k.view(-1)[:4] = torch.tensor([1 + 2.0**-11, -0.0, 3e38, 1e-38], device=cuda)
    before = flash_ops.split_kv_tf32.launches
    got = flash_ops.split_kv_tf32(k, v)
    torch.cuda.synchronize()
    assert flash_ops.split_kv_tf32.launches == before + 1
    for g, w in zip(got, split_kv_tf32_ref(k, v)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_flash_tf32x3_reads_kv_cache_slices_and_head_views_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    cache_k = torch.randn(2, 640, 2, 128, device=cuda, generator=gen)
    cache_v = torch.randn(2, 640, 2, 128, device=cuda, generator=gen)
    qkv = torch.randn(2, 201, 8, 128, device=cuda, generator=gen)
    q, k, v = qkv[:, :, :4], cache_k[:, :201], cache_v[:, :201]
    assert not (q.is_contiguous() or k.is_contiguous())
    out, took = _flash_counted(q, k, v, causal=True)
    assert took == "tma_wgmma_tf32x3"
    ref = flash_attention_bshd_ref(q, k, v, causal=True)
    assert _row_err(out, ref) <= ROW_TOL[torch.float32]


def test_flash_tf32x3_failure_raises_and_launches_nothing_else(cuda, monkeypatch):
    """A failing product launch raises, naming the route and the shape; no
    other kernel is tried."""

    real = flash_ops._tf32x3_entry_point

    def failing(name):
        if name == "fa_forward_tf32x3":
            return lambda *args: 1  # cudaErrorInvalidValue
        return real(name)

    monkeypatch.setattr(flash_ops, "_tf32x3_entry_point", failing)
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 2, 2, 128, torch.float32)
    before, routes = flash_ops.flash_attention.launches, dict(flash_ops.flash_attention.routes)
    with pytest.raises(RuntimeError, match=r"tma_wgmma_tf32x3.*cudaError 1.*Sk=64, H=2, KV=2, hd=128"):
        flash_ops.flash_attention(q, k, v)
    assert flash_ops.flash_attention.launches == before
    assert flash_ops.flash_attention.routes == routes


def test_flash_tf32x3_kernel_refuses_a_schedule_without_both_waits(cuda):
    """The host entry refuses a plan without both waits, or a ring it has
    no instantiation for, before either of its launches."""

    import ctypes

    q, k, v = _flash_inputs(cuda, 1, 128, 128, 2, 2, 64, torch.float32)
    ws, parts = flash_ops._split_workspace(k)
    ws.fill_(7.0)
    o = torch.empty_like(q)
    fn = flash_ops._tf32x3_entry_point("fa_forward_tf32x3")
    dims = (ctypes.c_longlong * 6)(1, 2, 2, 128, 128, 64)
    qmap = (ctypes.c_longlong * 11)(*flash_ops.tensor_map(q.shape, q.stride(), 128, 4).flat())
    o_strides = (ctypes.c_longlong * 3)(*o.stride()[:3])
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, ws, o)]
    for stages, full, empty in ((2, 1, 0), (2, 0, 1), (5, 1, 1), (0, 1, 1)):
        rc = fn(*ptrs, dims, qmap, flash_ops._kv_strides(k, v), o_strides, 1, 0, 0, 0.18,
                stages, full, empty, stream)
        assert rc == 1  # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert bool((ws == 7.0).all())  # the pre-pass did not run either


@pytest.mark.parametrize(
    "dtype,hd",
    [(torch.bfloat16, 128), (torch.bfloat16, 32), (torch.bfloat16, 16), (torch.float32, 128),
     (torch.float32, 32), (torch.float32, 16)],
    ids=["tma_wgmma", "tma_wgmma_hd32", "tma_wgmma_hd16", "tma_wgmma_tf32x3",
         "tma_wgmma_tf32x3_hd32", "tma_wgmma_tf32x3_hd16"],
)
@pytest.mark.parametrize("window", [None, 100])
def test_flash_q_offset_matches_plain_version_on_every_route_on_cuda(cuda, dtype, hd, window):
    """Query i at position q_offset + i: the last 200 rows of 700 positions
    against the plain version with the same offset; the offset off by one
    reads above the limit."""

    q, k, v = _flash_inputs(cuda, 2, 200, 700, 4, 2, hd, dtype, seed=hd)
    out, took = _flash_counted(q, k, v, causal=True, window=window, q_offset=500)
    assert took == _flash_route(dtype, hd)
    kw = dict(causal=True, window=window)
    ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), q_offset=500, **kw)
    assert _row_err(out, ref) <= ROW_TOL[dtype]
    fault = flash_attention_bshd_ref(q.float(), k.float(), v.float(), q_offset=501, **kw)
    assert _row_err(out, fault) > ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_broadcast_batch_takes_a_tma_route_on_cuda(cuda, hd, dtype):
    """k and v broadcast over the batch (a zero batch stride, as
    ``expand`` gives) and q broadcast over the heads, read in place by the
    TMA routes: the tensor maps take a zero stride."""

    q, k, v = _flash_inputs(cuda, 2, 300, 333, 4, 2, hd, dtype, seed=hd + 1)
    kb, vb = k[:1].expand(2, -1, -1, -1), v[:1].expand(2, -1, -1, -1)
    qb = q[:, :, :1].expand(-1, -1, 4, -1)
    assert kb.stride(0) == 0 and qb.stride(2) == 0
    for qq, kk, vv in ((q, kb, vb), (qb, k, v), (qb, kb, vb)):
        for kw in (dict(causal=True), dict(causal=False, window=100), dict(causal=True, q_offset=33)):
            out, took = _flash_counted(qq, kk, vv, **kw)
            assert took == _flash_route(dtype, hd, 300, 2)
            ref = flash_attention_bshd_ref(qq.float(), kk.float(), vv.float(), **kw)
            assert _row_err(out, ref) <= ROW_TOL[dtype], kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_broadcast_few_rows_on_cuda(cuda, dtype):
    """A broadcast batch with few query rows: bf16 on flash_decode, f32 on
    its TMA route, each reading the zero stride in place."""

    q, k, v = _flash_inputs(cuda, 4, 4, 1500, 16, 16, 64, dtype, seed=9)
    kb, vb = k[:1].expand(4, -1, -1, -1), v[:1].expand(4, -1, -1, -1)
    out, took = _flash_counted(q, kb, vb, causal=False)
    assert took == _flash_route(dtype, 64, 4, 1)
    ref = flash_attention_bshd_ref(q.float(), kb.float(), vb.float(), causal=False)
    assert _row_err(out, ref) <= ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,to", [(8, 16), (24, 32), (48, 64)])
def test_flash_head_dim_zero_padded_on_cuda(cuda, hd, to, dtype):
    """A head dim no kernel is built for runs on the next one, zero-padded
    at its own scale: one launch, on the TMA route of the dtype."""

    q, k, v = _flash_inputs(cuda, 2, 200, 230, 4, 2, hd, dtype, seed=hd)
    assert flash_ops.padded_head_dim(hd) == to
    for kw in (dict(causal=True), dict(causal=False, window=50)):
        out, took = _flash_counted(q, k, v, **kw)
        assert took == _flash_route(dtype, to) and out.shape == q.shape
        ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), **kw)
        assert _row_err(out, ref) <= ROW_TOL[dtype], kw


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.float32, 128), (torch.float32, 32),
                                     (torch.bfloat16, 16)],
                         ids=["tma_wgmma", "tma_wgmma_tf32x3", "tma_wgmma_tf32x3_hd32",
                              "tma_wgmma_hd16"])
def test_flash_row_without_keys_raises_before_any_launch_on_cuda(cuda, dtype, hd):
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 2, 2, hd, dtype)
    before, splits = flash_ops.flash_attention.launches, flash_ops.split_kv_tf32.launches
    with pytest.raises(NotImplementedError, match="no key"):
        flash_ops.flash_attention(q, k, v, causal=True, q_offset=-1)
    with pytest.raises(NotImplementedError, match="no key"):
        flash_ops.flash_attention(q, k, v, causal=False, window=8, q_offset=72)
    assert (flash_ops.flash_attention.launches, flash_ops.split_kv_tf32.launches) == (before, splits)


def test_flash_kernel_reads_strided_views(cuda):
    """q, k and v as head slices of one fused projection: strided, not
    contiguous, read in place."""

    qkv = torch.randn(2, 96, 4 + 2 + 2, 64, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    out = flash_ops.flash_attention(q, k, v, causal=True)
    ref = flash_attention_bshd_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def _encode_tiled(strides):
    """cuTensorMapEncodeTiled (the CUDA driver's, through ctypes) on a 4-D
    bf16 map of dims (64, 2, 128, 2) innermost first, byte ``strides`` of
    the three outer dims and a (64, 1, 64, 1) box with the 128-byte swizzle:
    its CUresult."""

    import ctypes

    drv = ctypes.CDLL("libcuda.so.1")
    fn = drv.cuTensorMapEncodeTiled
    fn.restype = ctypes.c_int
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    raw = (ctypes.c_ubyte * 192)()
    tmap = ctypes.addressof(raw) + (-ctypes.addressof(raw)) % 64  # 64-byte aligned
    base = torch.zeros(1 << 16, dtype=torch.bfloat16, device="cuda")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, u32, ctypes.c_void_p,
                   ctypes.POINTER(u64), ctypes.POINTER(u64), ctypes.POINTER(u32),
                   ctypes.POINTER(u32), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    bf16, swizzle_128b, l2_256b = 9, 3, 3
    return fn(tmap, bf16, 4, base.data_ptr(), (u64 * 4)(64, 2, 128, 2), (u64 * 3)(*strides),
              (u32 * 4)(64, 1, 64, 1), (u32 * 4)(1, 1, 1, 1), 0, swizzle_128b, l2_256b, 0)


def test_tensor_map_encoder_takes_a_zero_stride_on_cuda(cuda):
    """The driver's encoder takes a zero stride (a broadcast dimension)
    beside strides that are multiples of 16 bytes, in any of the outer
    dimensions, so the flash routes read broadcast operands in place; a
    stride off 16 bytes is refused."""

    assert _encode_tiled((128, 256, 128 * 256)) == 0
    assert _encode_tiled((128, 256, 0)) == 0
    assert _encode_tiled((0, 256, 128 * 256)) == 0
    assert _encode_tiled((128, 0, 0)) == 0
    assert _encode_tiled((136, 256, 128 * 256)) != 0


def test_chunked_attention_on_cuda_is_the_kernel(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 4, 2, 32, torch.bfloat16)
    before = flash_ops.flash_attention.launches
    out = attention.chunked_attention(q, k, v, causal=True, window=16)
    assert flash_ops.flash_attention.launches == before + 1
    ref = attention.chunked_attention_plain(q, k, v, causal=True, window=16)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=3e-2)
    # a prefill continuation: 48 queries after 16 positions of cache
    qc = q[:, 16:]
    out = attention.chunked_attention(qc, k, v, causal=True, window=16, q_offset=16)
    assert flash_ops.flash_attention.launches == before + 2
    ref = attention.chunked_attention_plain(qc, k, v, causal=True, window=16, q_offset=16)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=3e-2)
    # hd 8 runs on the hd-16 kernel, zero-padded, at hd 8's scale
    q8, k8, v8 = _flash_inputs(cuda, 1, 16, 16, 2, 2, 8, torch.float32)
    out = attention.chunked_attention(q8, k8, v8)
    assert flash_ops.flash_attention.launches == before + 3
    assert out.shape == q8.shape
    ref = attention.chunked_attention_plain(q8, k8, v8)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["yi_6b", "gemma3_27b", "internlm2_20b"])
def test_smoke_size_serving_on_cuda_goes_through_the_kernel(cuda, arch):
    """The smoke configuration served on the card agrees with the same
    weights served on the CPU (logits within 1e-4 in f32: the two devices
    sum in other orders), with one kernel launch per attention layer per
    prefill (internlm2's hd 8 on the zero-padded hd-16 kernel)."""

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


# ---------------------------------------------------------------------- #
# The training path
# ---------------------------------------------------------------------- #

def test_attention_with_grad_takes_the_plain_version_and_no_grad_the_kernel(cuda):
    """Training (inputs that require grad, grad enabled) takes the plain
    version under autograd, counted; the same call under no_grad launches
    the kernel; the kernel's own entry still refuses a grad input."""

    from repro_torch.obs import metrics

    plain_calls = metrics.counter("attention.train_plain_calls")
    q, k, v = (
        t.requires_grad_(True)
        for t in _flash_inputs(cuda, 1, 64, 64, 4, 2, 64, torch.bfloat16)
    )
    launches, calls = flash_ops.flash_attention.launches, plain_calls.value
    with torch.no_grad():
        out = attention.chunked_attention(q, k, v, causal=True)
    assert flash_ops.flash_attention.launches == launches + 1
    assert plain_calls.value == calls
    trained = attention.chunked_attention(q, k, v, causal=True)
    assert flash_ops.flash_attention.launches == launches + 1
    assert plain_calls.value == calls + 1
    trained.float().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()
    torch.testing.assert_close(out.float(), trained.detach().float(), atol=3e-2, rtol=3e-2)
    with pytest.raises(NotImplementedError, match="requires grad"):
        flash_ops.flash_attention(q, k, v, causal=True)
    assert flash_ops.flash_attention.launches == launches + 1


def test_smoke_train_step_on_cuda_matches_the_cpu(cuda):
    """One train step of the smoke configuration (f32, remat "full") on the
    card against the same step on the CPU: loss and grad norm within 1e-5
    relative, ``mu`` and ``nu`` within 1e-4 of each leaf's norm, params
    within 1e-3 of the learning rate where the gradient is at least 1e-6
    (100 eps) and within 2 lr elsewhere.  A first Adam step moves an element
    by lr g / (|g| + eps): ill-conditioned where |g| is near eps (1e-8), so
    there the devices' rounding of g may move it by up to 2 lr, and the
    moments, linear in g, hold those elements instead."""

    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, DataState, make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizer import AdamW

    cfg = get_smoke_config("granite_3_2b").scaled(dtype="float32", remat="full")
    lr = 1e-3
    opt = AdamW(learning_rate=lr, warmup_steps=0, total_steps=10)
    step = make_train_step(cfg, opt)
    params = model_zoo.init(cfg, device="cpu", seed=0)
    batch = {
        k: torch.from_numpy(v)
        for k, v in make_batch(DataConfig(4, 32), cfg, DataState(0, 0)).items()
    }
    cp, cs, cm = step(params, opt.init(params), batch)
    launches = flash_ops.flash_attention.launches
    gp, gs, gm = step(
        tree_lib.tree_map(lambda t: t.to(cuda), params),
        opt.init(tree_lib.tree_map(lambda t: t.to(cuda), params)),
        {k: v.to(cuda) for k, v in batch.items()},
    )
    assert flash_ops.flash_attention.launches == launches  # training: plain attention
    for key in ("loss", "grad_norm", "lr"):
        assert abs(gm[key].item() - cm[key].item()) <= 1e-5 * abs(cm[key].item()), key
    for moment in ("mu", "nu"):
        for a, b in zip(tree_lib.leaves(getattr(gs, moment)), tree_lib.leaves(getattr(cs, moment))):
            assert (a.cpu() - b).abs().max().item() <= 1e-4 * b.norm().item(), moment
    for a, b, m in zip(tree_lib.leaves(gp), tree_lib.leaves(cp), tree_lib.leaves(cs.mu)):
        assert a.device.type == "cuda"
        err = (a.cpu() - b).abs()
        clear = m.abs() / (1 - opt.b1) >= 1e-6  # mu = (1 - b1) g after one step
        assert err.max().item() <= 2 * lr
        assert err[clear].max().item() <= 1e-3 * lr if clear.any() else True


def test_checkpoint_roundtrip_of_cuda_bf16_tensors(cuda, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager, Snapshot
    from repro_torch.optim.optimizer import AdamW

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {
        "blocks": [{"w": torch.randn(33, 7, generator=gen, device=cuda).to(torch.bfloat16)}
                   for _ in range(2)],
        "scale": torch.ones(7, device=cuda),
    }
    state = AdamW().init(params)
    mgr = CheckpointManager(tmp_path)  # the async writer
    try:
        mgr.save(Snapshot(step=3, tree={"params": params, "opt": state}))
        mgr.wait()
        snap = mgr.restore(target={"params": params, "opt": state})
    finally:
        mgr.close()
    got = snap.tree["params"]["blocks"][1]["w"]
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), params["blocks"][1]["w"].view(torch.int16))
    assert snap.tree["opt"].step.device.type == "cuda"
    assert snap.tree["opt"].mu["scale"].dtype == torch.float32


# ---------------------------------------------------------------------- #
# The level loop captured as one CUDA graph per prepared case
# ---------------------------------------------------------------------- #

def _counts():
    from repro_torch.obs import metrics

    return tuple(
        metrics.counter(f"torch.{name}").value
        for name in ("graph_captures", "graph_replays", "eager_sweeps")
    )


def _eager_run(exe, store):
    """The same artifact with its sweep run eagerly on the card."""

    exe.compiled._capture = False
    try:
        return exe.run(store=store)
    finally:
        del exe.compiled._capture


def _wide_recurrence():
    return tc.LoopProgram(
        statements=(
            tc.Statement(
                "S1",
                tc.ArrayRef("a", (0, 0)),
                (tc.ArrayRef("a", (0, -1)), tc.ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, 96), (0, 192)),
    )


def _skew_recurrence(ni, nj):
    return tc.LoopProgram(
        statements=(
            tc.Statement("S1", tc.ArrayRef("a", (0, 0)), (tc.ArrayRef("a", (-1, 1)),)),
        ),
        bounds=((0, ni), (0, nj)),
    )


@pytest.mark.parametrize("method", METHODS)
def test_captured_sweep_bit_equal_to_eager_and_oracle_over_corpus(cuda, method):
    for deps in DEPS_MODES:
        for name, ref_prog in ALL_PROGRAMS:
            init = store_from_reference(ref_prog.initial_store())
            expect = ref_core.run_sequential(ref_prog, init)
            exe = tc.plan(
                program_from_reference(ref_prog), method=method, deps=deps
            ).compile("torch", device=cuda)
            before = _counts()
            first = exe.run(store=init)
            again = exe.run(store=init)
            after = _counts()
            eager = _eager_run(exe, init)
            label = f"{name}/{method}/deps={deps}"
            assert first == again == eager == expect, label
            # the first run is an eager sweep, the second a replay after its
            # capture (or, for a case that cannot be captured, eager again)
            assert after[1] - before[1] + after[2] - before[2] >= 2, label


@pytest.mark.parametrize(
    "name,make,knobs",
    [
        ("paper_alg6_1025", lambda: tc.paper_alg6(1025), {}),
        ("skew_recurrence_64x16_chunk", lambda: _skew_recurrence(64, 16),
         {"scc_policy": "chunk"}),
        ("wide_skew_96x192_skew", _wide_recurrence, {"scc_policy": "skew"}),
    ],
)
def test_captured_sweep_at_the_benchmark_sizes(cuda, name, make, knobs):
    prog = make()
    init = prog.initial_store()
    expect = tc.run_sequential(prog, init)
    exe = tc.plan(prog, method="isd").compile("torch", device=cuda, **knobs)
    before = _counts()
    assert exe.run(store=init) == expect
    # bounds that run once pay no capture: the first run is eager
    assert _counts() == (before[0], before[1], before[2] + 1)
    assert exe.run(store=init) == expect  # captured, then replayed
    assert exe.run(store=init) == expect
    assert _counts() == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert _eager_run(exe, init) == expect


def test_each_initial_store_of_one_case_matches_its_own_oracle(cuda):
    prog = tc.paper_alg6(64)
    exe = tc.plan(prog, method="isd").compile("torch", device=cuda)
    first = prog.initial_store()
    second = {
        a: {c: v * 1.5 - 0.25 for c, v in cells.items()}
        for a, cells in first.items()
    }
    before, cases = _counts(), exe.compiled.prepared_cases
    for store in (first, second, first, second):
        assert exe.run(store=store) == tc.run_sequential(prog, store)
    # one case, one graph: an eager first run, then three replays, the
    # first of them right after the capture
    assert exe.compiled.prepared_cases == min(cases + 1, exe.compiled.MAX_CASES)
    assert _counts() == (before[0] + 1, before[1] + 3, before[2] + 1)


def test_soak_on_cuda_with_four_workers_captures_nothing_after_warmup(cuda):
    from repro_torch import obs
    from repro_torch.serve import (
        PlanService,
        ServiceOptions,
        decode_program,
        scan_program,
    )

    def doall(n):
        return tc.LoopProgram(
            statements=(
                tc.Statement("A", tc.ArrayRef("a", 0), (tc.ArrayRef("b", 0),)),
                tc.Statement("B", tc.ArrayRef("c", 0), (tc.ArrayRef("a", 0),)),
            ),
            bounds=((0, n),),
        )

    mix = [
        (tenant, make(b))
        for tenant, make, bounds in (
            ("decode", decode_program, (12, 13)),
            ("scan", lambda h: scan_program(3, h), (4, 5)),
            ("doall", doall, (16, 17)),
        )
        for b in bounds
    ]
    obs.reset_all()
    with PlanService(ServiceOptions(workers=4, device="cuda")) as svc:
        # warm-up: each case's first run is eager, its second captures
        for _ in range(2):
            for tenant, prog in mix:
                svc.submit(prog, tenant=tenant, run=True)
        warm = svc.drain(timeout=300)
        assert warm["captures"] == len(mix)
        assert warm["eager_sweeps"] == len(mix)
        futures = [
            (prog, svc.submit(prog, tenant=tenant, run=True))
            for _ in range(10)
            for tenant, prog in mix
        ]
        for prog, fut in futures:
            assert fut.result(timeout=300).store == tc.run_sequential(
                prog, prog.initial_store()
            )
        stats = svc.drain(timeout=300)
    assert stats["captures"] == warm["captures"]
    assert stats["replays"] - warm["replays"] == len(futures)
    assert stats["eager_sweeps"] == warm["eager_sweeps"]


def test_concurrent_first_runs_capture_cleanly_from_many_workers(cuda):
    """More cold cases than the stream pool has streams, each run three
    times by eight workers at once: each capture (a case's second run)
    runs beside other workers' warm-up sweeps, replays and host copies, and
    none may disturb it (with torch.cuda.graph's default capture stream, a
    warm-up on the same pool stream invalidated the capture)."""

    import sys

    from repro_torch import obs
    from repro_torch.serve import (
        PlanService,
        ServiceOptions,
        decode_program,
        scan_program,
    )

    # 41 cases, none evicted (at most MAX_CASES = 32 of one structure);
    # the three large ones hold the capture lock for a few hundred ms each
    # while the other workers warm up
    progs = (
        [tc.paper_alg6(n) for n in (1025, 1000, 900)]
        + [decode_program(n) for n in range(6, 36)]
        + [scan_program(3, h) for h in range(4, 12)]
    )
    obs.reset_all()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with PlanService(
            ServiceOptions(workers=8, max_queue_depth=128, device="cuda")
        ) as svc:
            futures = [
                (prog, svc.submit(prog, tenant=f"t{i % 3}", run=True))
                for i, prog in enumerate(progs * 3)
            ]
            for prog, fut in futures:
                assert fut.result(timeout=300).store == tc.run_sequential(
                    prog, prog.initial_store()
                )
            stats = svc.drain(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert stats["captures"] == len(progs)  # one graph per case
    assert stats["replays"] == 2 * len(progs)
    assert stats["eager_sweeps"] == len(progs)  # the first runs


def test_capture_stream_is_never_a_warm_up_stream(cuda):
    from repro_torch.compile.lowering import _CAPTURE_LOCK, _capture_stream

    device = torch.device("cuda", torch.cuda.current_device())
    with _CAPTURE_LOCK:
        capture = _capture_stream(device)
        assert _capture_stream(device) is capture  # one a device
    # twice round the default-priority pool the warm-ups draw from
    pool = {torch.cuda.Stream(device).cuda_stream for _ in range(64)}
    assert capture.cuda_stream not in pool


def test_pow_program_runs_eager_by_rule_and_is_not_captured(cuda):
    from repro_torch.obs import trace

    prog = tc.LoopProgram(
        statements=(
            tc.Statement(
                "S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", 0),),
                compute=lambda x: abs(x) ** 0.5 + 1.0,
            ),
        ),
        bounds=((0, 300),),
    )
    init = prog.initial_store()
    exe = tc.plan(prog).compile("torch", device=cuda)
    before = _counts()
    trace.clear()
    trace.enable()
    try:
        assert exe.run(store=init) == tc.run_sequential(prog, init)
    finally:
        trace.disable()
    assert _counts() == (before[0], before[1], before[2] + 1)
    spans = [e for e in trace.events() if e["name"] == "torch.capture"]
    assert len(spans) == 1 and "host_pow" in spans[0]["args"]["eager"]
    assert exe.run(store=init) == tc.run_sequential(prog, init)
    assert _counts() == (before[0], before[1], before[2] + 2)


def test_replay_raises_out_of_box_and_hole_flags(cuda):
    # a guarded write past the store's box: the flag is the guard's
    oob = tc.LoopProgram(
        statements=(
            tc.Statement("S1", tc.ArrayRef("a", 6), (), guard=tc.ArrayRef("p", 0)),
        ),
        bounds=((0, 4),),
    )
    exe = tc.plan(oob).compile("torch", device=cuda)
    a = {(i,): 0.0 for i in range(8)}
    quiet = {"a": dict(a), "p": {(i,): 0.0 for i in range(4)}}
    for _ in range(2):  # eager, then captured
        assert exe.run(store=quiet) == tc.run_sequential(oob, quiet)
    replays = _counts()[1]
    with pytest.raises(KeyError, match="initialized store"):
        exe.run(store={"a": dict(a), "p": {(i,): 1.0 for i in range(4)}})
    assert _counts()[1] == replays + 1  # raised from the replay

    # a guarded read of a cell the store does not hold
    hole = tc.LoopProgram(
        statements=(
            tc.Statement(
                "S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", 0),),
                guard=tc.ArrayRef("p", 0),
            ),
        ),
        bounds=((0, 6),),
    )
    exe = tc.plan(hole).compile("torch", device=cuda)
    b = {(i,): float(i) for i in range(6) if i != 4}
    a = {(i,): 0.0 for i in range(6)}
    quiet = {"a": dict(a), "b": dict(b),
             "p": {(i,): float(i != 4) for i in range(6)}}
    for _ in range(2):
        assert exe.run(store=quiet) == tc.run_sequential(hole, quiet)
    replays = _counts()[1]
    with pytest.raises(KeyError, match="uninitialized cell"):
        exe.run(store={"a": dict(a), "b": dict(b),
                       "p": {(i,): 1.0 for i in range(6)}})
    assert _counts()[1] == replays + 1


def test_threads_first_touching_one_constant_beside_captures(cuda):
    """Eight cases divide by one constant no other test uses: their first
    runs touch it at once, and their captures follow while other workers
    still run.  Every graph must read the one tensor the scalar cache keeps,
    so replays after the allocator has handed memory out again still match
    the oracle."""

    from repro_torch.compile import lowering

    d = 3.0517578125
    progs = [
        tc.LoopProgram(
            statements=(
                tc.Statement(
                    "S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", 0),),
                    compute=lambda x: x / d,
                ),
            ),
            bounds=((0, n),),
        )
        for n in range(40, 48)
    ]
    exes = [tc.plan(p).compile("torch", device=cuda) for p in progs]
    barrier = threading.Barrier(len(progs))
    before = _counts()

    def runs(i):
        init = progs[i].initial_store()
        expect = tc.run_sequential(progs[i], init)
        barrier.wait(timeout=60)
        for _ in range(3):  # eager, captured, replayed
            assert exes[i].run(store=init) == expect

    with ThreadPoolExecutor(len(progs)) as pool:
        list(pool.map(runs, range(len(progs))))
    assert _counts()[0] == before[0] + len(progs)
    device = torch.device("cuda", torch.cuda.current_device())
    kept = lowering._device_scalar(d, device)
    assert kept is lowering._device_scalar(d, device)
    churn = [torch.full((1 << 18,), 7.0, device=cuda) for _ in range(16)]
    del churn
    for prog, exe in zip(progs, exes):
        init = prog.initial_store()
        assert exe.run(store=init) == tc.run_sequential(prog, init)


# ---------------------------------------------------------------------- #
# Calibration on the card, and "torch_spmd" in a world-size-1 NCCL group
# ---------------------------------------------------------------------- #

def test_tiny_measure_on_the_card_persists_a_profile_of_the_card(cuda, tmp_path, monkeypatch):
    import repro_torch.calibrate as calibrate
    from repro_torch import obs
    from repro_torch.obs import metrics

    monkeypatch.setenv("REPRO_CALIBRATE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_CALIBRATE", raising=False)
    obs.reset_all()
    try:
        prof = calibrate.measure(device=cuda, n=4096, widths=(8, 64), repeats=2)
        for name in calibrate.UNIT_NAMES:
            assert prof.units[name] > 0.0
        assert prof.meta["timed"] == "captured graph replay between CUDA events"
        assert prof.meta["device"] == torch.cuda.get_device_name(0)
        assert set(prof.meta["xla_per_level_us"]) == {"8", "64"}
        assert metrics.counter("calibrate.measurements").value > 0
        assert calibrate.profile_path().exists()
        assert not calibrate.profile_path(device="cpu").exists()
        obs.reset_all()
        again = calibrate.warm()
        assert again.source == "persisted" and again.units == prof.units
        assert metrics.counter("calibrate.measurements").value == 0
        assert metrics.counter("calibrate.loads").value == 1
    finally:
        obs.reset_all()


def test_profile_identity_is_keyed_by_the_cards_name(cuda):
    import repro_torch.calibrate as calibrate

    info = calibrate.host_info("cuda")
    assert info["device"] == torch.cuda.get_device_name(0)
    assert info["cuda"] == torch.version.cuda
    assert calibrate.host_info("cpu")["device"] == "cpu"
    assert calibrate.host_fingerprint(device="cuda") != calibrate.host_fingerprint(device="cpu")


def test_torch_spmd_in_a_world_of_one_nccl_group_is_the_torch_path(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.compile import spmd
    from repro_torch.obs import metrics

    obs.reset_all()
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1
    )
    try:
        for prog in (tc.paper_alg6(64), _wide_recurrence()):
            init = prog.initial_store()
            expect = tc.run_sequential(prog, init)
            exes = {
                b: tc.plan(prog, method="isd").compile(b, device=cuda)
                for b in ("torch", "torch_spmd")
            }
            deltas = {}
            for backend, exe in exes.items():
                before = _counts()
                for _ in range(3):  # eager, captured, replayed
                    assert exe.run(store=init) == expect, backend
                deltas[backend] = tuple(a - b for a, b in zip(_counts(), before))
            assert deltas["torch_spmd"] == deltas["torch"] == (1, 2, 1)
            (c_s,) = exes["torch_spmd"].compiled._cases.values()
            (c_t,) = exes["torch"].compiled._cases.values()
            assert c_s.static.n_shards == 1
            assert c_s._steps == c_t._steps
        assert metrics.counter("spmd.collectives").value == 0
        assert spmd.shard_count() == 1
    finally:
        dist.destroy_process_group()
        obs.reset_all()


def test_torch_spmd_refuses_a_gloo_group_with_the_card(cuda, tmp_path):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1
    )
    try:
        p = tc.plan(tc.paper_alg6(8), method="isd")
        with pytest.raises(ValueError, match="cannot gather tensors on cuda"):
            p.compile("torch_spmd", device=cuda)
        p.compile("torch_spmd", device="cpu")  # gloo reaches the CPU
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# The MoE, Mamba-2 and encoder-decoder families
# ---------------------------------------------------------------------- #

def _rel_l2(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_moe_layer_matches_dense_oracle_on_cuda(cuda, dtype, limit):
    """One deepseek-moe-16b MoE layer at full width (64 experts, top 6, 2
    shared) on 512 tokens, capacity raised so nothing drops: the grouped
    dispatch against ``moe_reference`` on the card, relative L2 within
    1e-5 in f32 (TF32 off) and 1e-2 in bf16 (the two sum the experts in
    other orders and round the combine weights to bf16)."""

    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("deepseek_moe_16b").scaled(dtype=dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.moe_init(gen, cfg)
    x = torch.randn(2, 256, cfg.d_model, device=cuda, generator=gen).to(getattr(torch, dtype))
    with torch.inference_mode():
        y, aux = moe.moe_apply(params, x, cfg)
        ref = moe.moe_reference(params, x, cfg)
    assert bool(torch.isfinite(aux)) and y.dtype == x.dtype
    assert _rel_l2(y, ref) <= limit


def test_ssd_chunked_matches_sequential_on_cuda(cuda):
    """``ssd_chunked`` against ``ssd_reference`` at one mamba2-2.7b layer's
    heads and state (H 80, P 64, N 128), S 512 in two chunks of 256, f32
    (TF32 off), within 1e-4 as the reference's own test holds them."""

    from repro_torch.models import mamba

    gen = torch.Generator(device=cuda).manual_seed(0)
    B, S, H, P, N = 1, 512, 80, 64, 128
    x = torch.randn(B, S, H, P, device=cuda, generator=gen)
    dt = mamba.softplus(torch.randn(B, S, H, device=cuda, generator=gen) - 4.0)
    A = -torch.exp(torch.randn(H, device=cuda, generator=gen) * 0.3)
    Bm = torch.randn(B, S, N, device=cuda, generator=gen)
    Cm = torch.randn(B, S, N, device=cuda, generator=gen)
    with torch.inference_mode():
        y, h = mamba.ssd_chunked(x, dt, A, Bm, Cm, 256)
        y_ref, h_ref = mamba.ssd_reference(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)


# whisper-medium (16 heads, hd 64, 1500 encoder frames): the encoder's
# 1500 x 1500, the prefill cross-attention's 4 x 1500 and the decode
# step's 1 x 1500, all non-causal
WHISPER_SHAPES = [(4, 1500, 1500), (4, 4, 1500), (4, 1, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk", WHISPER_SHAPES, ids=lambda v: str(v))
def test_flash_kernel_at_whisper_shapes_on_cuda(cuda, B, Sq, Sk, dtype):
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, 16, 16, 64, dtype)
    out, took = _flash_counted(q, k, v, causal=False)
    assert took == _flash_route(dtype, 64, Sq)
    ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), causal=False)
    assert _row_err(out, ref) <= ROW_TOL[dtype]


@pytest.mark.parametrize(
    "arch,per_prefill,per_step",
    [
        ("deepseek_moe_16b", 1, 0),
        ("mamba2_2_7b", 0, 0),
        ("jamba_v01_52b", 1, 0),
        ("whisper_medium", 3, 1),  # encoder, self, cross; the cross at decode
    ],
)
def test_new_families_serve_on_cuda_through_the_kernel(cuda, arch, per_prefill, per_step):
    """The smoke configuration served on the card agrees with the same
    weights served on the CPU (f32 logits within 1e-4: the devices sum in
    other orders), with the stated flash launches per attention layer."""

    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = model_zoo.init(cfg, device="cpu", seed=0)
    # 2 x 16 prompt tokens: one MoE group of 32
    batch = serve_lm.make_batch(cfg, 2, 16, device="cpu", seed=1)
    on_cpu = serve_lm.generate(params, cfg, batch, 6)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    attn_layers = sum(p.mixer != "mamba" for p in cfg.block) * cfg.num_blocks
    before = flash_ops.flash_attention.launches
    on_cuda = serve_lm.generate(to(params), cfg, to(batch), 6)
    assert flash_ops.flash_attention.launches - before == attn_layers * (per_prefill + 5 * per_step)
    torch.testing.assert_close(
        on_cuda.prefill_logits.cpu(), on_cpu.prefill_logits, atol=1e-4, rtol=1e-4
    )
    assert torch.equal(on_cuda.tokens.cpu(), on_cpu.tokens)


# ---------------------------------------------------------------------- #
# The continuous-batching server, the pipeline runner and the pipeline step
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("identity_v", [False, True])
@pytest.mark.parametrize("Sq", [1, 4])
def test_flash_tma_probes_hold_whisper_last_ragged_tile_on_cuda(cuda, Sq, identity_v, monkeypatch):
    """The one-hot probes at whisper's cross shapes (Sk 1500, non-causal,
    hd 64: the last tile holds 28 keys), their first rows on those keys
    and the one before: exact on the TMA route, which these shapes take
    with flash_decode's rule switched off (flash_decode's own probes:
    ``test_flash_decode_probes_hold_the_last_range_on_cuda``)."""

    B, Sk, H, KV, hd = 4, 1500, 16, 16, 64
    q, k, v, expected = one_hot_probe(
        B, Sq, Sk, H, KV, hd, causal=False, identity_v=identity_v, seed=Sq,
        first_picks=Sk - 1 - np.arange(29),
    )
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (q, k, v))
    monkeypatch.setattr(flash_ops, "_decode_route", False)
    out, took = _flash_counted(q, k, v, causal=False)
    assert took == "tma_wgmma"
    assert torch.equal(out.float().cpu(), torch.from_numpy(expected))


def test_continuous_batching_on_cuda_is_generate_through_the_kernel(cuda, monkeypatch):
    """``launch.serve.serve_requests`` at smoke size on the card: each
    request's tokens are ``generate``'s on the same batch, one flash launch
    a layer a wave, the wave plans on a service of the card."""

    from repro_torch import obs
    from repro_torch.launch import serve

    obs.reset_all()
    try:
        cfg = get_smoke_config("yi_6b")
        params = model_zoo.init(cfg, device=cuda, seed=0)
        gen = torch.Generator(device=cuda).manual_seed(1)
        prompts = [torch.randint(0, cfg.vocab_size, (24,), generator=gen, device=cuda,
                                 dtype=torch.int32) for _ in range(6)]
        before = flash_ops.flash_attention.launches
        run = serve.serve_requests(
            params, cfg, [serve.Request(rid=i, prompt=p) for i, p in enumerate(prompts)],
            slots=4, max_new=5, device=cuda,
        )
        assert flash_ops.flash_attention.launches - before == cfg.num_layers * run.waves == 4
        assert serve.default_service().options.device.startswith("cuda")
        padded = prompts + [prompts[4]] * 2  # the short wave's pads
        for w in range(2):
            batch = {"tokens": torch.stack(padded[4 * w: 4 * w + 4])}
            want = serve_lm.generate(params, cfg, batch, 5).tokens.tolist()
            for r, tokens in zip(run.done[4 * w: 4 * w + 4], want):
                assert r.generated == tokens, r.rid
    finally:
        obs.reset_all()


def test_pipeline_runner_on_cuda_is_bit_equal_to_its_reference(cuda):
    from repro_torch.runtime.pipeline import PipelineRunner

    gen = torch.Generator(device=cuda).manual_seed(0)
    ws = [torch.randn((256, 256), generator=gen, device=cuda) / 16 for _ in range(4)]

    def stage(w):
        def fn(x):
            if isinstance(x, tuple):
                x, *skips = x
                x = x + sum(skips)
            return torch.tanh(x @ w)

        return fn

    inputs = [torch.randn((64, 256), generator=gen, device=cuda) for _ in range(5)]
    for skips in ((), ((0, 2), (0, 3), (1, 3))):
        runner = PipelineRunner([stage(w) for w in ws], skips=skips, num_microbatches=5)
        out, stats = runner.run(inputs)
        for a, b in zip(out, runner.run_reference(inputs)):
            assert torch.equal(a, b)
        assert stats.handoffs == 3 * 5


def test_pipeline_step_refuses_a_gloo_group_with_the_card(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch.runtime.pp_lowering import build_pipeline_step

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1
    )
    try:
        with pytest.raises(ValueError, match="cannot move tensors on cuda"):
            build_pipeline_step(2, 8, device=cuda)
        step, _ = build_pipeline_step(2, 8, device="cpu")  # gloo moves CPU tensors
        w, xs = torch.eye(8), torch.ones((2, 3, 8))
        assert torch.equal(step(w, xs), torch.tanh(xs))  # one stage, nothing moved
    finally:
        dist.destroy_process_group()


def test_sharded_attention_reaches_the_kernel_through_local_map(cuda, tmp_path):
    """DTensor q, k, v on a one-rank NCCL mesh reach the flash kernel as
    their local shards (``models/sharded.attention``), one launch, equal
    to the plain tensors' call bit for bit."""

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding

    q, k, v = _flash_inputs(cuda, 2, 128, 128, 8, 2, 64, torch.bfloat16)
    want = attention.chunked_attention(q, k, v, causal=True)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_debug_mesh(device_type="cuda")
        sh = sharding.NamedSharding(mesh, sharding.P("data", None, "model", None))
        dq, dk, dv = (sharding.distribute(t, sh) for t in (q, k, v))
        before = flash_ops.flash_attention.launches
        got = attention.chunked_attention(dq, dk, dv, causal=True)
        assert flash_ops.flash_attention.launches == before + 1
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# The flash_decode route: few query rows, the keys split across the blocks
# of a cluster, one launch a call
# ---------------------------------------------------------------------- #

# B, Sq, Sk, H, KV, hd, causal, window, q_offset: whisper's three small
# calls (decode cross, prompt cross, prompt self), yi-6b's decode position
# (GQA 4, hd 128) at 1, 4 and 8 rows, with a window, granite's hd 64 GQA
DECODE_CASES = [
    (4, 1, 1500, 16, 16, 64, False, None, 0),
    (4, 4, 1500, 16, 16, 64, False, None, 0),
    (4, 4, 4, 16, 16, 64, True, None, 0),
    (4, 1, 2048, 32, 4, 128, True, None, 2047),
    (2, 4, 2048, 32, 4, 128, True, None, 2044),
    (2, 8, 2048, 32, 4, 128, True, None, 2040),
    (2, 4, 2048, 32, 4, 128, True, 300, 2044),
    (2, 16, 999, 32, 8, 64, True, 64, 983),
    (3, 7, 333, 6, 2, 128, False, None, 0),
]


def _decode_ref(q, k, v, splits, **kw):
    """The route's plain version at the kernel's key ranges, f32 out (P
    rounded to bf16 as the kernel rounds it), and its partial states."""

    m, l, acc = decode_partials_ref(q, k, v, splits=splits, **kw)
    return combine_splits_ref(m, l, acc, torch.float32), (m, l, acc)


def _splits(q, k, causal, window, q_offset):
    from repro_torch.kernels.flash_attention.ref import live_span

    lo, hi = live_span(q.shape[1], k.shape[1], causal, window, q_offset)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return flash_ops.decode_splits(q.shape[0], k.shape[2], hi - lo, sms), hi


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_matches_its_plain_version_on_cuda(cuda, case):
    """The kernel against ``flash_decode_ref``'s steps within the bf16 row
    limit, with both planted faults above it:
    a peer's state left out of the merge, the last live key dropped."""

    B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, KV, hd, torch.bfloat16, seed=Sq + Sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, took = _flash_counted(q, k, v, **kw)
    assert took == "flash_decode" == _flash_route(torch.bfloat16, hd, Sq, H // KV)
    splits, hi = _splits(q, k, causal, window, q_offset)
    ref, (m, l, acc) = _decode_ref(q, k, v, splits, **kw)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16]
    if splits > 1:
        m[splits // 2], l[splits // 2] = -float("inf"), 0.0
        assert _row_err(out, combine_splits_ref(m, l, acc, torch.float32)) > ROW_TOL[torch.bfloat16]
    dropped, _ = _decode_ref(q, k[:, :hi - 1], v[:, :hi - 1], splits, **kw)
    assert _row_err(out, dropped) > ROW_TOL[torch.bfloat16]


@pytest.mark.parametrize("identity_v", [False, True])
@pytest.mark.parametrize("Sq", [1, 4])
def test_flash_decode_probes_hold_the_last_range_on_cuda(cuda, Sq, identity_v):
    """The one-hot probes at whisper's cross shapes on flash_decode, their
    first rows on the key before the last range, its first key and its
    last tile's keys: exact."""

    B, Sk, H, KV, hd = 4, 1500, 16, 16, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = flash_ops.decode_splits(B, KV, Sk, sms)
    q, k, v, expected = one_hot_probe(
        B, Sq, Sk, H, KV, hd, causal=False, identity_v=identity_v, seed=Sq,
        first_picks=split_edge_picks(Sk, splits, B * H * Sq),
    )
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (q, k, v))
    out, took = _flash_counted(q, k, v, causal=False)
    assert took == "flash_decode"
    assert torch.equal(out.float().cpu(), torch.from_numpy(expected))


@pytest.mark.parametrize("ranges", range(1, flash_ops.DECODE_MAX_CLUSTER + 1))
def test_flash_decode_every_range_count_on_cuda(cuda, ranges):
    """hd 128 with GQA (4 query rows, 4 heads a KV head: 16 rows) over
    ``64 * ranges - 5`` keys on 2 KV heads: the split rule gives one range a
    64-key tile, so every cluster size from 1 to the cap runs; each against
    its plain version at those ranges."""

    Sk = 64 * ranges - 5
    q, k, v = _flash_inputs(cuda, 1, 4, Sk, 8, 2, 128, torch.bfloat16, seed=ranges)
    splits, _ = _splits(q, k, False, None, 0)
    assert splits == ranges
    out, took = _flash_counted(q, k, v, causal=False)
    assert took == "flash_decode"
    ref, _ = _decode_ref(q, k, v, splits, causal=False, window=None, q_offset=0)
    assert torch.isfinite(out.float()).all()
    assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16]


def test_flash_decode_with_an_empty_range_on_cuda(cuda):
    """64 query rows at a decode position with a 3-key window (forced
    beyond the rule): the live span of 66 keys is two ranges, and all
    but the two rows at their edge keep keys in one of them only, so they
    merge a range that holds no live key for them: finite, the plain
    version's."""

    Sk, Sq = 130, 64
    q, k, v = _flash_inputs(cuda, 1, Sq, Sk, 1, 1, 64, torch.bfloat16, seed=9)
    kw = dict(causal=True, window=3, q_offset=Sk - Sq)
    splits, _ = _splits(q, k, **kw)
    assert splits == 2
    m, _, _ = decode_partials_ref(q, k, v, splits=splits, **kw)
    assert torch.isinf(m).any(dim=0).sum().item() == Sq - 2
    out = flash_ops._flash_decode(q, k, v, **kw)
    ref, _ = _decode_ref(q, k, v, splits, **kw)
    assert torch.isfinite(out.float()).all()
    assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16]


def test_flash_decode_is_one_launch_on_cuda(cuda):
    """Whisper's decode cross call is one kernel on the device, with no
    allocation beyond its output and no second kernel."""

    from torch.profiler import ProfilerActivity, profile

    q, k, v = _flash_inputs(cuda, 4, 1, 1500, 16, 16, 64, torch.bfloat16, seed=4)
    flash_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "flash_decode_kernel" in kernels[0], kernels


@pytest.mark.parametrize("case", [(4, 1, 1500, 16, 16, 64, True, None, 700),
                                  (2, 4, 2048, 32, 4, 128, True, 300, 1000),
                                  (4, 1, 1500, 16, 16, 64, False, None, 0)],
                         ids=["cache_tail", "gqa_window", "view_of_a_longer_buffer"])
def test_flash_decode_reads_nothing_outside_the_live_span_on_cuda(cuda, case):
    """NaN in K and V outside the live span (a cache's unwritten tail, the
    keys a window drops, a longer buffer's rows past a view) leaves the
    output finite and equal to the plain version's on clean K and V: the
    tensor maps end at the span's end and no range starts before it."""

    from repro_torch.kernels.flash_attention.ref import live_span

    B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, KV, hd, torch.bfloat16, seed=11)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    lo, hi = live_span(Sq, Sk, causal, window, q_offset)
    if causal:
        kn, vn = k.clone(), v.clone()
        for t in (kn, vn):
            t[:, :lo] = float("nan")
            t[:, hi:] = float("nan")
    else:
        kn, vn = (torch.cat([t, torch.full_like(t[:, :37], float("nan"))], dim=1)[:, :Sk]
                  for t in (k, v))
    assert 0 < lo or hi < Sk or kn.stride(0) != k.stride(0)
    out, took = _flash_counted(q, kn, vn, **kw)
    assert took == "flash_decode"
    assert torch.isfinite(out.float()).all()
    splits, _ = _splits(q, k, **kw)
    ref, _ = _decode_ref(q, k, v, splits, **kw)
    assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16]


def test_flash_decode_forced_beyond_the_rule_and_the_combine_alone_on_cuda(cuda):
    """``_flash_decode`` at 64 rows (uncounted) against its plain version
    on its own ranges, and the ranges' merge alone: the same plain merge
    with a peer's state left out misses it."""

    q, k, v = _flash_inputs(cuda, 4, 64, 1500, 16, 16, 64, torch.bfloat16, seed=3)
    before = dict(flash_ops.flash_attention.routes)
    out = flash_ops._flash_decode(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.routes == before
    splits, _ = _splits(q, k, False, None, 0)
    ref, (m, l, acc) = _decode_ref(q, k, v, splits, causal=False, window=None, q_offset=0)
    assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16]
    assert splits > 1
    m[0], l[0] = -float("inf"), 0.0
    assert _row_err(out, combine_splits_ref(m, l, acc, torch.float32)) > ROW_TOL[torch.bfloat16]
    with pytest.raises(NotImplementedError, match="flash_decode"):
        flash_ops._flash_decode(q.float(), k.float(), v.float(), causal=False)


def test_whisper_cross_attention_runs_on_flash_decode_on_cuda(cuda, monkeypatch):
    """``models/encdec.py``'s cross attention on the card through the
    kernel: whisper's smoke config in bf16, served for 4 steps; the
    decoder's calls (its prompt's self and cross attention, each decode
    step's self and cross attention) take flash_decode when their head dim
    is one the route takes, and their launches are counted by route."""

    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("whisper_medium"), head_dim=64)
    params = model_zoo.init(cfg, device=cuda, seed=0)
    batch = serve_lm.make_batch(cfg, 2, 4, device=cuda, seed=1)
    calls = []
    real = attention.chunked_attention

    def tally(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], flash_ops._route_of(q, k, v)))
        return real(q, k, v, **kw)

    self_decode = []
    real_decode = attention.decode_attention

    def tally_decode(q, k, v, cache_len, **kw):
        self_decode.append(attention.decode_takes_kernel(
            q.device.type, q, k, v, cache_len, False))
        return real_decode(q, k, v, cache_len, **kw)

    before = dict(flash_ops.flash_attention.routes)
    plain = attention.DECODE_PLAIN_CALLS.value
    monkeypatch.setattr(attention, "chunked_attention", tally)
    monkeypatch.setattr(attention, "decode_attention", tally_decode)
    run = serve_lm.generate(params, cfg, batch, 4)
    took = {r: n - before[r] for r, n in flash_ops.flash_attention.routes.items() if n != before[r]}
    F = cfg.encoder.num_frames
    decoder = [c for c in calls if c[0] != F]
    assert decoder and all(r == "flash_decode" for *_, r in decoder)
    assert len(self_decode) == 3 * cfg.num_layers and all(self_decode)
    assert took.get("flash_decode") == len(decoder) + len(self_decode)
    assert sum(took.values()) == len(calls) + len(self_decode)
    assert attention.DECODE_PLAIN_CALLS.value == plain
    assert torch.isfinite(run.prefill_logits.float()).all()


# decode attention on the kernel: (B, Smax, KV, G, hd, window, cache_len),
# yi-6b's decode shape at a small batch and granite's with a window
DECODE_ATTENTION_CASES = [
    (8, 3072, 4, 8, 128, None, 1),
    (8, 3072, 4, 8, 128, None, 2049),
    (8, 3072, 4, 8, 128, None, 3072),
    (8, 3072, 8, 4, 64, 1024, 1),
    (8, 3072, 8, 4, 64, 1024, 2049),
    (8, 3072, 8, 4, 64, 1024, 3072),
]


@pytest.mark.parametrize("case", DECODE_ATTENTION_CASES, ids=lambda c: "x".join(map(str, c)))
def test_decode_attention_reads_the_live_cache_on_flash_decode_on_cuda(cuda, case):
    """``decode_attention`` on bf16 operands is one flash_decode launch
    over the whole cache, against the plain version in f32 on the same
    values within the bf16 row limit.  The slots outside the live keys
    (past ``cache_len``, before the window) hold NaN: the kernel reads none
    of them into its output.  The plain version on the card in f32 counts
    one plain call."""

    B, Smax, KV, G, hd, window, cache_len = case
    q, k, v = _flash_inputs(cuda, B, 1, Smax, KV * G, KV, hd, torch.bfloat16, seed=cache_len)
    lo = 0 if window is None else max(0, cache_len - window)
    kn, vn = k.clone(), v.clone()
    for t in (kn, vn):
        t[:, cache_len:] = float("nan")
        t[:, :lo] = float("nan")
    routes, plain = dict(flash_ops.flash_attention.routes), attention.DECODE_PLAIN_CALLS.value
    out = attention.decode_attention(q, kn, vn, cache_len, window=window)
    torch.cuda.synchronize()
    took = {r: n - routes[r] for r, n in flash_ops.flash_attention.routes.items() if n != routes[r]}
    assert took == {"flash_decode": 1}
    assert attention.DECODE_PLAIN_CALLS.value == plain
    ref = attention.decode_attention(q.float(), k.float(), v.float(), cache_len, window=window)
    assert attention.DECODE_PLAIN_CALLS.value == plain + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert _row_err(out, ref) <= ROW_TOL[torch.bfloat16]
    if cache_len > 1:  # the last live key dropped: the check sees it
        dropped = attention.decode_attention(q.float(), k.float(), v.float(), cache_len - 1,
                                             window=window)
        assert _row_err(out, dropped) > ROW_TOL[torch.bfloat16]


def _tiny_bf16_decoder(cuda):
    """yi-6b's smoke decoder at hd 64, bf16: a decode step's attention is
    one the kernel takes."""

    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("yi_6b"), head_dim=64)
    return cfg, model_zoo.init(cfg, device=cuda, seed=0)


def test_decode_step_takes_flash_decode_in_every_layer_on_cuda(cuda, monkeypatch):
    """A bf16 decoder's decode step raises ``flash_attention.routes
    ["flash_decode"]`` by its layer count and counts no plain decode call;
    its logits agree with the same step on the plain decode attention."""

    from repro_torch import tree as tree_lib

    cfg, params = _tiny_bf16_decoder(cuda)
    cache = model_zoo.init_cache(cfg, 2, 64, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for c in tree_lib.leaves(cache):  # a filled prefix of 40 positions in every layer
        c[:, :40] = torch.randn(c[:, :40].shape, device=cuda, generator=gen).to(c.dtype)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1), device=cuda, generator=gen)
    routes, plain = dict(flash_ops.flash_attention.routes), attention.DECODE_PLAIN_CALLS.value
    with torch.inference_mode():
        logits, _ = model_zoo.decode_step(params, tokens, cfg, cache, 40)
    torch.cuda.synchronize()
    took = {r: n - routes[r] for r, n in flash_ops.flash_attention.routes.items() if n != routes[r]}
    assert took == {"flash_decode": cfg.num_layers}
    assert attention.DECODE_PLAIN_CALLS.value == plain
    monkeypatch.setattr(attention, "decode_takes_kernel", lambda *a: False)
    with torch.inference_mode():
        plain_logits, _ = model_zoo.decode_step(params, tokens, cfg, cache, 40)
    assert attention.DECODE_PLAIN_CALLS.value == plain + cfg.num_layers
    rel = ((logits.float() - plain_logits.float()).norm() / plain_logits.float().norm()).item()
    assert rel <= 3e-2, rel


def test_decode_step_at_the_next_cache_len_encodes_no_tensor_map_on_cuda(cuda, monkeypatch):
    """Two decode steps of a bf16 decoder at ``cache_len`` and ``cache_len +
    1``: the first encodes each layer's K / V tensor maps and queries the
    card's cluster count once; the second encodes no map and queries
    nothing (the live span rides in the launch's ``dims``)."""

    import collections

    from repro_torch.launch.steps import make_serve_step

    cfg, params = _tiny_bf16_decoder(cuda)
    cache = model_zoo.init_cache(cfg, 2, 1024, device=cuda)
    calls = collections.Counter()
    real = flash_ops._decode_entry_point

    def counted(name):
        fn = real(name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(flash_ops, "_decode_entry_point", counted)
    monkeypatch.setattr(flash_ops, "_DECODE_MAPS", type(flash_ops._DECODE_MAPS)())
    flash_ops._decode_clusters.cache_clear()
    serve = make_serve_step(cfg)
    tokens = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    tokens, cache = serve(params, tokens, cache, 600)
    torch.cuda.synchronize()
    assert calls["fa_decode"] == cfg.num_layers
    assert calls["fa_decode_maps"] == cfg.num_layers and calls["fa_decode_clusters"] == 1
    first = dict(calls)
    tokens, cache = serve(params, tokens, cache, 601)
    torch.cuda.synchronize()
    assert calls["fa_decode"] == first["fa_decode"] + cfg.num_layers
    assert calls["fa_decode_maps"] == first["fa_decode_maps"]
    assert calls["fa_decode_clusters"] == first["fa_decode_clusters"]


def test_lm_spans_carry_device_time_on_cuda_and_none_on_the_cpu(cuda):
    """The timed spans of a prefill, a decode step and a train step (remat
    full: its recompute runs on autograd's device thread) read a positive
    ``dur_device`` on the card, in the call of their step; on the CPU none."""

    import dataclasses

    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.obs import trace
    from repro_torch.optim.optimizer import AdamW

    timed = {"lm.norm", "lm.qkv", "lm.rope", "lm.cache_write", "lm.attention", "lm.out_proj",
             "lm.mlp", "lm.unembed", "serve.prefill", "serve.decode", "train.step",
             "optim.update"}
    cfg = dataclasses.replace(get_smoke_config("granite_3_2b"), remat="full")
    opt = AdamW()
    for device in (cuda, torch.device("cpu")):
        params = model_zoo.init(cfg, device=device, seed=0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 8), device=device)
        cache = model_zoo.init_cache(cfg, 2, 16, device=device)
        trace.clear()
        with trace.tracing():
            _, cache = make_prefill_step(cfg)(params, {"tokens": tokens}, cache)
            make_serve_step(cfg)(params, tokens[:, -1:], cache, 8)
            make_train_step(cfg, opt)(params, opt.init(params),
                                      {"tokens": tokens, "labels": tokens})
        torch.cuda.synchronize()
        ev = trace.events()
        steps = {e["name"]: e["args"]["call"] for e in ev if e["args"]["depth"] == 1}
        assert set(steps) == {"serve.prefill", "serve.decode", "train.step"}
        assert sum(e["name"] == "lm.attention" and e["args"]["call"] == steps["train.step"]
                   for e in ev) == 2 * cfg.num_layers
        assert {e["name"] for e in ev} >= timed | {"lm.embed", "lm.sample"}
        for e in ev:
            if device.type == "cuda" and e["name"] in timed:
                assert e["args"]["dur_device"] > 0, e
            else:
                assert "dur_device" not in e["args"], e
    trace.clear()
