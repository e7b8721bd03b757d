"""The port's pipelined matmul against the reference Pallas kernel (run in
interpret mode, as the reference's own tests run it on the CPU), the wiring
from the K-loop plans to the Hopper kernels' ring depths and waits, the rule
that picks a kernel for CUDA operands, and the build's digest.

Inputs are made with numpy from a seed and handed to both sides.  The
tolerances are the reference's (``tests/test_kernels.py``): 2e-5 in f32
and 3e-2 in bf16, the absolute one scaled by sqrt(K).
"""

import dataclasses
import re
import shutil
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pipelined_matmul.ops import matmul as ref_matmul

from repro_torch.core.dependence import FLOW, Dependence
from repro_torch.core.parallelizer import PlanOptions, plan
from repro_torch.kernels import _build
from repro_torch.kernels.pipelined_matmul import ops, schedule
from repro_torch.kernels.pipelined_matmul.ref import matmul_ref, split_tf32_ref
from repro_torch.kernels.pipelined_matmul.ref import rna_tf32_ref as ref_rna_tf32

SHAPES = [(128, 128, 128, 128), (256, 512, 128, 128), (300, 257, 130, 64)]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K), dtype=np.float32)
    b = rng.standard_normal((K, N), dtype=np.float32)
    return a, b


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,K,N,blk", SHAPES)
def test_matmul_matches_reference_kernel(M, K, N, blk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _operands(M, K, N)
    ref = ref_matmul(
        jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
        blk_m=blk, blk_n=blk, blk_k=blk,
    )
    out = ops.matmul(
        torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
        blk_m=blk, blk_n=blk, blk_k=blk,
    )
    assert out.dtype == tdt and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(
        out.to(torch.float32).numpy(),
        np.asarray(ref.astype(jnp.float32)),
        atol=tol * K**0.5,
        rtol=tol,
    )


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    a, b = _operands(40, 24, 16, seed=1)
    before, routes = ops.matmul.launches, dict(ops.matmul.routes)
    out = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), depth=1)
    bf = ops.matmul(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    assert ops.matmul.launches == before and ops.matmul.routes == routes
    assert torch.equal(out, matmul_ref(torch.from_numpy(a), torch.from_numpy(b)))
    assert torch.equal(
        bf, matmul_ref(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    )


# ---------------------------------------------------------------------- #
# depth -> plan -> kernel
# ---------------------------------------------------------------------- #

def test_default_depth_is_min_buffers():
    assert ops.default_depth() == 2


def test_depth_one_takes_the_credit_wait_variant():
    s = ops.kernel_schedule(1)
    assert s.depth == 1 and s.credit
    assert sorted(s.waits) == ["arrival", "credit"]
    assert s.barriers_per_step == 2


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_depth_two_and_up_take_one_barrier(depth):
    s = ops.kernel_schedule(depth)
    assert s.depth == depth and not s.credit
    assert sorted(s.waits) == ["arrival", "issue"]
    assert s.barriers_per_step == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_waits_are_the_plans(depth):
    plan = ops.plan_pipeline(depth)
    s = ops.kernel_schedule(depth)
    assert len(s.waits) == plan.waits_per_step
    assert s.credit == plan.credit_wait_needed


def test_depth_outside_the_ring_raises():
    with pytest.raises(NotImplementedError, match="ring depth"):
        ops.kernel_schedule(5)
    with pytest.raises(NotImplementedError, match="ring depth"):
        ops.matmul(torch.zeros(2, 2), torch.zeros(2, 2), depth=0)


def test_plan_with_a_wait_the_kernel_lacks_raises(monkeypatch):
    real = ops.plan_pipeline(2)
    odd = dataclasses.replace(
        real,
        retained=real.retained
        + (Dependence(FLOW, "COMPUTE", "LOAD", "buf", (3,)),),
        waits_per_step=real.waits_per_step + 1,
    )
    monkeypatch.setattr(ops, "plan_pipeline", lambda depth: odd)
    ops.kernel_schedule.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="no wait for"):
            ops.kernel_schedule(2)
    finally:
        ops.kernel_schedule.cache_clear()


def test_plan_without_the_arrival_wait_raises(monkeypatch):
    real = ops.plan_pipeline(2)
    odd = dataclasses.replace(
        real,
        retained=tuple(d for d in real.retained if d.sink != "COMPUTE"),
        waits_per_step=real.waits_per_step - 1,
    )
    monkeypatch.setattr(ops, "plan_pipeline", lambda depth: odd)
    ops.kernel_schedule.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="arrival"):
            ops.kernel_schedule(2)
    finally:
        ops.kernel_schedule.cache_clear()


@pytest.mark.parametrize(
    "a,b,err",
    [
        (torch.zeros(3, 4), torch.zeros(5, 2), ValueError),
        (torch.zeros(3, 4), torch.zeros(4, 2, dtype=torch.float64), TypeError),
        (torch.zeros(3, 4, dtype=torch.float16), torch.zeros(4, 2, dtype=torch.float16), TypeError),
        (torch.zeros(2, 3, 4), torch.zeros(4, 2), ValueError),
    ],
    ids=["inner_dim", "mixed_dtype", "fp16", "rank3"],
)
def test_bad_operands_raise(a, b, err):
    with pytest.raises(err):
        ops.matmul(a, b)


# ---------------------------------------------------------------------- #
# depth -> Hopper plan -> the TMA kernel's mbarriers
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_hopper_schedule_is_what_plan_retains(depth):
    """Under the warp-specialised processor map ``plan()`` keeps the
    arrival flow and the slot-reuse anti dependence at every depth: the
    full / empty mbarrier pair."""

    res = plan(
        schedule.make_kloop_program(16),
        PlanOptions(
            method="isd",
            deps=tuple(schedule.kloop_dependences(depth)),
            model="procmap",
            processors={"ISSUE": "producer", "LOAD": "producer", "COMPUTE": "consumer"},
        ),
    ).elimination
    assert sorted(d.pretty() for d in res.retained) == sorted([
        "LOAD δf(buf, Δ=0) COMPUTE",
        f"COMPUTE δa(buf, Δ={depth}) LOAD",
    ])
    s = ops.hopper_schedule(depth)
    assert s.depth == depth and list(s.waits) == ["full", "empty"]
    assert s.full and s.empty


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_the_shared_processor_map_keeps_the_credit_only_at_depth_one(depth):
    """The contrast: with ISSUE and COMPUTE on one processor the anti
    dependence is covered by program order from D = 2 on; with a producer
    warpgroup of its own nothing covers it."""

    assert ops.kernel_schedule(depth).credit == (depth == 1)
    assert ops.hopper_schedule(depth).empty


def test_hopper_stages_is_the_deepest_ring_that_fits():
    assert ops.HOPPER_STAGES == 4 <= ops.MAX_STAGES
    ring = ops.HOPPER_STAGES * ops.HOPPER_STAGE_BYTES + 1024 + 64
    assert ring <= ops.SMEM_PER_BLOCK < ring + ops.HOPPER_STAGE_BYTES
    assert ops.HOPPER_STAGES != ops.default_depth()


def test_kernel_constants_agree_with_the_wrapper():
    src = ops.TMA_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("MAX_STAGES") == ops.MAX_STAGES
    assert (const("BM") * const("BK") + const("BK") * const("BN")) * 2 == ops.HOPPER_STAGE_BYTES
    assert "int MAX_STAGES = 4;" in ops.SOURCE.read_text()


def _with_retained(retained):
    return types.SimpleNamespace(retained=tuple(retained), eliminated=())


def test_hopper_plan_with_a_wait_the_kernel_lacks_raises(monkeypatch):
    real = ops.hopper_plan(2)
    odd = _with_retained(
        real.retained + (Dependence(FLOW, "COMPUTE", "LOAD", "buf", (3,)),)
    )
    monkeypatch.setattr(ops, "hopper_plan", lambda depth: odd)
    ops.hopper_schedule.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="no mbarrier for"):
            ops.hopper_schedule(2)
    finally:
        ops.hopper_schedule.cache_clear()


@pytest.mark.parametrize("drop", ["COMPUTE", "LOAD"], ids=["no_full", "no_empty"])
def test_hopper_plan_without_both_waits_raises(monkeypatch, drop):
    real = ops.hopper_plan(2)
    odd = _with_retained(d for d in real.retained if d.sink != drop)
    monkeypatch.setattr(ops, "hopper_plan", lambda depth: odd)
    ops.hopper_schedule.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="full and the empty"):
            ops.hopper_schedule(2)
    finally:
        ops.hopper_schedule.cache_clear()


def test_hopper_depth_outside_the_ring_raises():
    with pytest.raises(NotImplementedError, match="ring depth"):
        ops.hopper_schedule(5)
    with pytest.raises(NotImplementedError, match="ring depth"):
        ops.matmul(torch.zeros(8, 8, dtype=torch.bfloat16),
                   torch.zeros(8, 8, dtype=torch.bfloat16), depth=0)


# ---------------------------------------------------------------------- #
# which kernel a CUDA call takes
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize(
    "dtype,K,N,a_addr,b_addr,expect",
    [
        (torch.bfloat16, 4096, 11008, 0, 0, "tma_wgmma"),     # yi-6b up
        (torch.bfloat16, 11008, 4096, 1 << 20, 4096, "tma_wgmma"),  # down
        (torch.bfloat16, 264, 136, 0, 0, "tma_wgmma"),        # ragged, aligned
        (torch.bfloat16, 8, 24, 0, 0, "tma_wgmma"),           # one K box
        (torch.bfloat16, 257, 130, 0, 0, "cp_async_mma"),     # odd strides
        (torch.bfloat16, 264, 130, 0, 0, "cp_async_mma"),     # N % 8 != 0
        (torch.bfloat16, 260, 136, 0, 0, "cp_async_mma"),     # K % 8 != 0
        (torch.bfloat16, 264, 136, 2, 0, "cp_async_mma"),     # A offset
        (torch.bfloat16, 264, 136, 0, 8, "cp_async_mma"),     # B offset
        (torch.float32, 4096, 11008, 0, 0, "tma_wgmma_tf32x3"),  # yi-6b up
        (torch.float32, 257, 130, 4, 0, "ffma"),
        (torch.float32, 11008, 4096, 1 << 20, 4096, "tma_wgmma_tf32x3"),  # down
        (torch.float32, 264, 136, 0, 0, "tma_wgmma_tf32x3"),  # ragged, aligned
        (torch.float32, 4, 4, 0, 0, "tma_wgmma_tf32x3"),      # K below a step
        (torch.float32, 260, 132, 0, 0, "tma_wgmma_tf32x3"),  # not % 8: f32 is % 4
        (torch.float32, 258, 136, 0, 0, "ffma"),              # K % 4 != 0
        (torch.float32, 264, 130, 0, 0, "ffma"),              # N % 4 != 0
        (torch.float32, 264, 136, 4, 0, "ffma"),              # A 4 bytes in
        (torch.float32, 264, 136, 0, 8, "ffma"),              # B 8 bytes in
    ],
)
def test_route_rule(dtype, K, N, a_addr, b_addr, expect):
    assert ops.route(dtype, K, N, a_addr, b_addr) == expect


def test_route_of_views_follows_their_base_address():
    base = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    b = torch.zeros(64, 32, dtype=torch.bfloat16)
    aligned = base[8:].view(64, 64)  # 16 bytes in
    offset = base[1:64 * 64 + 1].view(64, 64)  # 2 bytes in
    assert base.data_ptr() % 16 == 0
    assert ops.route(aligned.dtype, 64, 32, aligned.data_ptr(), b.data_ptr()) == "tma_wgmma"
    assert ops.route(offset.dtype, 64, 32, offset.data_ptr(), b.data_ptr()) == "cp_async_mma"


def test_f32_route_of_views_follows_their_base_address():
    base = torch.zeros(64 * 64 + 4, dtype=torch.float32)
    b = torch.zeros(64, 32, dtype=torch.float32)
    aligned = base[4:].view(64, 64)  # 16 bytes in
    offset = base[1:64 * 64 + 1].view(64, 64)  # 4 bytes in
    assert base.data_ptr() % 16 == 0
    assert ops.route(aligned.dtype, 64, 32, aligned.data_ptr(), b.data_ptr()) == "tma_wgmma_tf32x3"
    assert ops.route(offset.dtype, 64, 32, offset.data_ptr(), b.data_ptr()) == "ffma"
    assert ops.route(b.dtype, 64, 32, b.data_ptr(), offset.data_ptr()) == "ffma"


def test_routes_count_every_route():
    assert set(ops.matmul.routes) == {
        "tma_wgmma", "cp_async_mma", "tma_wgmma_tf32x3", "ffma"
    }


# ---------------------------------------------------------------------- #
# the 3xTF32 route: split, depth rule, accuracy of the scheme
# ---------------------------------------------------------------------- #

def _bits(t):
    return t.contiguous().view(torch.int32)


def _rna_numpy(x):
    """Round to 11 significant bits, to nearest, ties away from zero, by
    frexp (independent of the bit trick; normal f32 values)."""

    m, e = np.frexp(np.asarray(x, np.float64))
    r = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def _normal_f32(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.float32(2.0) ** rng.integers(-20, 20, shape).astype(np.float32)
    return x


def test_split_hi_keeps_eleven_significant_bits_rounded_to_nearest():
    x = _normal_f32((64, 48), seed=3)
    hi, lo = split_tf32_ref(torch.from_numpy(x))
    assert int((_bits(hi) & 0x1FFF).abs().sum()) == 0  # 13 low bits clear
    assert int((_bits(lo) & 0x1FFF).abs().sum()) == 0
    np.testing.assert_array_equal(hi.numpy(), _rna_numpy(x))
    # ties go away from zero: 1 + 2^-11 and its negative
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23])
    hi_t, _ = split_tf32_ref(tie)
    assert hi_t.tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 1.0]


def test_split_lo_is_the_rounded_remainder():
    x = torch.from_numpy(_normal_f32((64, 48), seed=4))
    hi, lo = split_tf32_ref(x)
    rest = x - hi  # exact in f32
    assert torch.equal(lo, ref_rna_tf32(rest))
    np.testing.assert_array_equal(lo.numpy(), _rna_numpy(rest.numpy()))
    # hi + lo carries 22 significant bits: within 2^-22 of |x|
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= x.double().abs() * 2.0**-22).all())


def test_split_is_exact_on_twenty_one_bit_inputs():
    x = _bits(torch.from_numpy(_normal_f32((96, 40), seed=5)))
    x = (x & ~0x7).view(torch.float32)  # 21 significant bits
    hi, lo = split_tf32_ref(x)
    assert torch.equal(hi + lo, x)
    hi_t, lo_t = split_tf32_ref(x, transpose=True)
    assert torch.equal(hi_t, hi.t().contiguous()) and hi_t.is_contiguous()
    assert torch.equal(lo_t, lo.t().contiguous()) and tuple(lo_t.shape) == (40, 96)


def test_split_wrapper_on_the_cpu_is_the_plain_version_and_launches_nothing():
    x = torch.from_numpy(_normal_f32((12, 8), seed=6))
    before = ops.split_tf32.launches
    for transpose in (False, True):
        got = ops.split_tf32(x, transpose)
        want = split_tf32_ref(x, transpose)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.split_tf32.launches == before
    with pytest.raises(TypeError):
        ops.split_tf32(x.double())


def _three_tf32(a, b):
    """3xTF32 in plain arithmetic: the split, then the three products of
    TF32 values (exact in f64) summed in f64."""

    ah, al = (t.numpy().astype(np.float64) for t in split_tf32_ref(torch.from_numpy(a)))
    bh, bl = (t.numpy().astype(np.float64) for t in split_tf32_ref(torch.from_numpy(b)))
    return al @ bh + ah @ bl + ah @ bh


def _one_tf32(a, b):
    ah, _ = split_tf32_ref(torch.from_numpy(a))
    bh, _ = split_tf32_ref(torch.from_numpy(b))
    return ah.numpy().astype(np.float64) @ bh.numpy().astype(np.float64)


def _pallas_f32(a, b, blk):
    return np.asarray(ref_matmul(jnp.asarray(a), jnp.asarray(b),
                                 blk_m=blk, blk_n=blk, blk_k=blk))


@pytest.mark.parametrize("M,K,N,blk", SHAPES)
def test_three_tf32_is_within_the_f32_limit_of_the_reference_kernel(M, K, N, blk):
    a, b = _operands(M, K, N)
    np.testing.assert_allclose(
        _three_tf32(a, b), _pallas_f32(a, b, blk), atol=2e-5 * K**0.5, rtol=2e-5
    )


def test_one_tf32_product_misses_the_limit_at_k_4096():
    """The limit tells one TF32 product (a dropped cross term looks like
    this) from three: the check the card runs can see it."""

    M, K, N = 128, 4096, 128
    a, b = _operands(M, K, N, seed=7)
    ref = _pallas_f32(a, b, 128)
    limit = 2e-5 * K**0.5 + 2e-5 * np.abs(ref)
    assert (np.abs(_three_tf32(a, b) - ref) / limit).max() < 0.25
    assert (np.abs(_one_tf32(a, b) - ref) / limit).max() > 10


def _rz_f32(x):
    """f64 values to f32, rounded toward zero."""

    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _truncating_tensor_core(a, b, run_k):
    """3xTF32 on a tensor core whose f32 accumulator rounds toward zero once
    a k8 slice, restarted every ``run_k`` of K (None: never) and added into
    an f32 sum: the kernel's promotion, emulated."""

    ah, al = (t.numpy().astype(np.float64) for t in split_tf32_ref(torch.from_numpy(a)))
    bh, bl = (t.numpy().astype(np.float64) for t in split_tf32_ref(torch.from_numpy(b)))
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        part = al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s]
        acc = _rz_f32(acc.astype(np.float64) + part)
        if run_k and (k0 + 8) % run_k == 0:
            total, acc = total + acc, np.zeros_like(acc)
    return total + acc


def test_promotion_run_keeps_a_truncating_accumulator_inside_the_limit():
    """Why the kernel promotes every TF32X3_RUN_K of K: carried over all of
    K = 11008, a truncating accumulator misses the limit; restarted every
    run and summed by round-to-nearest adds it stays far inside."""

    M, K, N = 32, 11008, 32
    a, b = _operands(M, K, N, seed=8)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    limit = 2e-5 * K**0.5 + 2e-5 * np.abs(ref)
    promoted = _truncating_tensor_core(a, b, ops.TF32X3_RUN_K)
    carried = _truncating_tensor_core(a, b, None)
    assert (np.abs(promoted - ref) / limit).max() < 0.25
    assert (np.abs(carried - ref) / limit).max() > 1


def test_tf32x3_depth_rule():
    assert ops.TF32X3_STAGES == 3
    assert ops.tf32x3_schedule().depth == ops.TF32X3_STAGES
    for depth in (1, 2, 3):
        s = ops.tf32x3_schedule(depth)
        assert s.depth == depth and s.full and s.empty
    for depth in (0, 4, 5):
        with pytest.raises(NotImplementedError, match="ring depth"):
            ops.tf32x3_schedule(depth)
    a, b = torch.zeros(8, 8), torch.zeros(8, 4)
    with pytest.raises(NotImplementedError, match="tma_wgmma_tf32x3"):
        ops.matmul(a, b, depth=4)
    # f32 the FFMA kernel takes keeps its 1..4
    assert ops.matmul(torch.zeros(8, 7), torch.zeros(7, 5), depth=4).shape == (8, 5)


def test_tf32x3_stages_is_the_deepest_ring_that_fits():
    ring = ops.TF32X3_STAGES * ops.TF32X3_STAGE_BYTES + 1024 + 64
    assert ring <= ops.SMEM_PER_BLOCK < ring + ops.TF32X3_STAGE_BYTES
    assert ops.TF32X3_STAGE_BYTES == 64 * 1024


def test_tf32x3_kernel_constants_agree_with_the_wrapper():
    src = ops.TF32X3_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BM"), const("BN"), const("BK")) == (
        ops.TF32X3_BM, ops.TF32X3_BN, ops.TF32X3_BK
    )
    assert const("RUN_K") == ops.TF32X3_RUN_K <= 256
    assert ops.TF32X3_RUN_K % ops.TF32X3_BK == 0
    assert const("MAX_STAGES") == ops.TF32X3_STAGES
    assert (2 * (const("BM") + const("BN")) * const("BK") * 4
            == ops.TF32X3_STAGE_BYTES)
    assert "cvt.rna.tf32.f32" in _build.INCLUDE_DIRS[0].joinpath("hopper.cuh").read_text()


def test_every_entry_point_has_its_ctypes_signature():
    """Each ``extern "C"`` launcher of the matmul's sources is bound with
    as many pointers and ints as it declares."""

    for src in (ops.SOURCE, ops.TMA_SOURCE, ops.TF32X3_SOURCE):
        for name, args in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()
        ):
            params = [p.strip() for p in args.split(",")]
            ptrs = sum("void*" in p for p in params[:-1])
            assert params[-1] == "void* stream"
            assert ops._SIGNATURES[name] == (ptrs, len(params) - 1 - ptrs), name


# ---------------------------------------------------------------------- #
# the build: an edited header rebuilds the library
# ---------------------------------------------------------------------- #

def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.INCLUDE_DIRS[0], csrc)
    src = tmp_path / "kernel" / ops.TMA_SOURCE.name
    src.parent.mkdir()
    shutil.copy(ops.TMA_SOURCE, src)
    monkeypatch.setattr(_build, "INCLUDE_DIRS", (csrc,))
    assert _build.headers(src) == [(csrc / "hopper.cuh").resolve()]
    before = _build.library_path(src)
    assert before == _build.library_path(src)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(src)
    assert after != before and after.name.startswith("libtma_wgmma_matmul-")


def test_library_path_follows_nested_includes_beside_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "INCLUDE_DIRS", ())
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    assert [p.name for p in _build.headers(tmp_path / "k.cu")] == ["a.cuh", "b.cuh"]
    before = _build.library_path(tmp_path / "k.cu")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.library_path(tmp_path / "k.cu") != before


def test_tf32x3_library_path_covers_hopper_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.INCLUDE_DIRS[0], csrc)
    src = tmp_path / "kernel" / ops.TF32X3_SOURCE.name
    src.parent.mkdir()
    shutil.copy(ops.TF32X3_SOURCE, src)
    monkeypatch.setattr(_build, "INCLUDE_DIRS", (csrc,))
    assert _build.headers(src) == [(csrc / "hopper.cuh").resolve()]
    before = _build.library_path(src)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(src)
    assert after != before and after.name.startswith("libtma_wgmma_tf32x3-")
