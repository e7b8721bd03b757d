"""The port's pipelined matmul against the reference Pallas kernel (run in
interpret mode, as the reference's own tests run it on the CPU), the wiring
from the K-loop plans to the Hopper kernels' ring depths and waits, the rule
that picks a kernel for CUDA operands and the staging it writes first (the
bf16 stage, the padded 3xTF32 split, each route emulated through its padded
stride), and the build's digest.

Inputs are made with numpy from a seed and handed to both sides.  The
tolerances are the reference's (``tests/test_kernels.py``): 2e-5 in f32
and 3e-2 in bf16, the absolute one scaled by sqrt(K).
"""

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
from repro_torch.kernels.pipelined_matmul.ref import matmul_ref, split_tf32_ref, stage_ref
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

def test_depth_outside_the_ring_raises():
    with pytest.raises(NotImplementedError, match="ring depth"):
        ops.matmul(torch.zeros(2, 2), torch.zeros(2, 2), depth=0)


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

    assert schedule.plan_pipeline(depth).credit_wait_needed == (depth == 1)
    assert ops.hopper_schedule(depth).empty


def test_hopper_stages_is_the_deepest_ring_that_fits():
    assert ops.HOPPER_STAGES == 4 <= ops.MAX_STAGES
    ring = ops.HOPPER_STAGES * ops.HOPPER_STAGE_BYTES + 1024 + 64
    assert ring <= ops.SMEM_PER_BLOCK < ring + ops.HOPPER_STAGE_BYTES
    assert ops.HOPPER_STAGES != schedule.min_buffers()


def test_kernel_constants_agree_with_the_wrapper():
    src = ops.TMA_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("MAX_STAGES") == ops.MAX_STAGES
    assert (const("BM") * const("BK") + const("BK") * const("BN")) * 2 == ops.HOPPER_STAGE_BYTES
    # the stage refuses any leading dimension but the one staging() gives
    assert "ld != (cols + 7) / 8 * 8" in src
    assert ops.staging(torch.bfloat16, 1, 9, 17, 0, 0).lda == (9 + 7) // 8 * 8


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

# every bf16 call takes the TMA / wgmma product and every f32 call the
# 3xTF32 one; what TMA cannot describe is restaged first (:func:`staging`)
@pytest.mark.parametrize(
    "dtype,K,N,a_addr,b_addr,expect",
    [
        (torch.bfloat16, 4096, 11008, 0, 0, "tma_wgmma"),     # yi-6b up
        (torch.bfloat16, 11008, 4096, 1 << 20, 4096, "tma_wgmma"),  # down
        (torch.bfloat16, 264, 136, 0, 0, "tma_wgmma"),        # ragged, aligned
        (torch.bfloat16, 8, 24, 0, 0, "tma_wgmma"),           # one K box
        (torch.bfloat16, 257, 130, 0, 0, "tma_wgmma"),        # odd strides
        (torch.bfloat16, 264, 130, 0, 0, "tma_wgmma"),        # N % 8 != 0
        (torch.bfloat16, 260, 136, 0, 0, "tma_wgmma"),        # K % 8 != 0
        (torch.bfloat16, 264, 136, 2, 0, "tma_wgmma"),        # A offset
        (torch.bfloat16, 264, 136, 0, 8, "tma_wgmma"),        # B offset
        (torch.float32, 4096, 11008, 0, 0, "tma_wgmma_tf32x3"),  # yi-6b up
        (torch.float32, 257, 130, 4, 0, "tma_wgmma_tf32x3"),
        (torch.float32, 11008, 4096, 1 << 20, 4096, "tma_wgmma_tf32x3"),  # down
        (torch.float32, 264, 136, 0, 0, "tma_wgmma_tf32x3"),  # ragged, aligned
        (torch.float32, 4, 4, 0, 0, "tma_wgmma_tf32x3"),      # K below a step
        (torch.float32, 260, 132, 0, 0, "tma_wgmma_tf32x3"),  # not % 8: f32 is % 4
        (torch.float32, 258, 136, 0, 0, "tma_wgmma_tf32x3"),  # K % 4 != 0
        (torch.float32, 264, 130, 0, 0, "tma_wgmma_tf32x3"),  # N % 4 != 0
        (torch.float32, 264, 136, 4, 0, "tma_wgmma_tf32x3"),  # A 4 bytes in
        (torch.float32, 264, 136, 0, 8, "tma_wgmma_tf32x3"),  # B 8 bytes in
    ],
)
def test_route_rule(dtype, K, N, a_addr, b_addr, expect):
    assert ops.route(dtype, K, N, a_addr, b_addr) == expect


def test_route_of_views_follows_their_base_address():
    """Both views take the TMA route; the one 2 bytes in is restaged."""

    base = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    b = torch.zeros(64, 32, dtype=torch.bfloat16)
    aligned = base[8:].view(64, 64)  # 16 bytes in
    offset = base[1:64 * 64 + 1].view(64, 64)  # 2 bytes in
    assert base.data_ptr() % 16 == 0
    for a, restaged in ((aligned, False), (offset, True)):
        assert ops.route(a.dtype, 64, 32, a.data_ptr(), b.data_ptr()) == "tma_wgmma"
        st = ops.staging(a.dtype, 64, 64, 32, a.data_ptr(), b.data_ptr())
        assert (st.a, st.b, st.lda, st.ldb, st.launches) == (restaged, False, 64, 32, int(restaged))


def test_f32_route_of_views_follows_their_base_address():
    """Every f32 view takes the 3xTF32 route; the split writes both
    operands anew wherever they lie."""

    base = torch.zeros(64 * 64 + 4, dtype=torch.float32)
    b = torch.zeros(64, 32, dtype=torch.float32)
    aligned = base[4:].view(64, 64)  # 16 bytes in
    offset = base[1:64 * 64 + 1].view(64, 64)  # 4 bytes in
    assert base.data_ptr() % 16 == 0
    for x, y in ((aligned, b), (offset, b), (b, offset)):
        assert ops.route(x.dtype, 64, 32, x.data_ptr(), y.data_ptr()) == "tma_wgmma_tf32x3"
        st = ops.staging(x.dtype, 64, 64, 32, x.data_ptr(), y.data_ptr())
        assert (st.a, st.b, st.lda, st.ldb) == (True, True, 64, 64)


def test_routes_count_every_route():
    assert set(ops.matmul.routes) == {"tma_wgmma", "tma_wgmma_tf32x3"}


# ---------------------------------------------------------------------- #
# staging: what a call restages, the stage and the padded split
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize(
    "dtype,M,K,N,a_addr,b_addr,expect",
    [
        # bf16: (restage A, restage B, lda, ldb)
        (torch.bfloat16, 2048, 4096, 11008, 0, 0, (False, False, 4096, 11008)),
        (torch.bfloat16, 300, 260, 136, 0, 0, (True, False, 264, 136)),     # K % 8
        (torch.bfloat16, 300, 264, 132, 0, 0, (False, True, 264, 136)),     # N % 8
        (torch.bfloat16, 2048, 2048, 49155, 0, 0, (False, True, 2048, 49160)),  # odd N
        (torch.bfloat16, 300, 257, 130, 0, 0, (True, True, 264, 136)),      # both
        (torch.bfloat16, 1, 8, 8, 2, 0, (True, False, 8, 8)),               # A 2 bytes in
        (torch.bfloat16, 64, 64, 64, 0, 4, (False, True, 64, 64)),          # B 4 bytes in
        (torch.bfloat16, 64, 64, 64, 8, 8, (True, True, 64, 64)),           # 8 bytes in
        (torch.bfloat16, 64, 64, 64, 32, 1 << 20, (False, False, 64, 64)),  # 16-byte multiples
        # f32: the split always writes both, K-major at K rounded up to 4
        (torch.float32, 300, 257, 130, 0, 0, (True, True, 260, 260)),       # K % 4
        (torch.float32, 2048, 4096, 11008, 0, 0, (True, True, 4096, 4096)),
        (torch.float32, 2048, 2048, 49155, 4, 8, (True, True, 2048, 2048)),
        (torch.float32, 8, 7, 5, 0, 0, (True, True, 8, 8)),
    ],
)
def test_staging_rule(dtype, M, K, N, a_addr, b_addr, expect):
    st = ops.staging(dtype, M, K, N, a_addr, b_addr)
    assert (st.a, st.b, st.lda, st.ldb) == expect
    assert st.lda % (16 // torch.tensor([], dtype=dtype).element_size()) == 0
    assert st.ldb % (16 // torch.tensor([], dtype=dtype).element_size()) == 0


def _bf16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


@pytest.mark.parametrize("rows,cols", [(300, 257), (64, 9), (33, 130), (257, 136), (1, 3)])
def test_stage_keeps_the_live_region_bit_equal(rows, cols):
    """The stage's plain version (what the wrapper takes on the CPU): the
    live (rows, cols) bit-equal to the source at the padded stride, the
    padding zero, and nothing launched."""

    x = _bf16((rows, cols), rows + cols)
    st = ops.staging(torch.bfloat16, rows, cols, cols, 0, 0)
    before = ops.stage_bf16.launches
    staged, also = ops.stage_bf16(x, x, st)
    assert ops.stage_bf16.launches == before
    ld = (cols + 7) // 8 * 8
    for s in (staged, also, stage_ref(x, ld)):
        assert tuple(s.shape) == (rows, ld) and s.is_contiguous()
        assert torch.equal(s[:, :cols].view(torch.int16), x.view(torch.int16))
        assert not s[:, cols:].any()
    view = torch.as_strided(staged, (rows, cols), (ld, 1))  # as the tensor map reads it
    assert torch.equal(view.view(torch.int16), x.view(torch.int16))


def test_stage_of_aligned_operands_is_no_copy():
    a, b = _bf16((16, 64), 1), _bf16((64, 24), 2)
    st = ops.staging(torch.bfloat16, 16, 64, 24, 0, 0)
    assert st.launches == 0
    got = ops.stage_bf16(a, b, st)
    assert got[0] is a and got[1] is b


@pytest.mark.parametrize("transpose", [False, True], ids=["rows", "transposed"])
@pytest.mark.parametrize("rows,cols", [(300, 257), (64, 9), (33, 130), (7, 5), (12, 8)])
def test_padded_split_keeps_the_live_region_of_the_plain_split(rows, cols, transpose):
    """The wrapper's split (on the CPU its plain version) at the padded
    stride: the live region bit-equal to ``split_tf32_ref``'s unpadded
    halves, the padding zero, hi + lo as close to x as unpadded."""

    x = torch.from_numpy(_normal_f32((rows, cols), seed=rows * cols))
    hi, lo = ops.split_tf32(x, transpose)
    width = rows if transpose else cols
    ld = (width + 3) // 4 * 4
    assert tuple(hi.shape) == ((cols, ld) if transpose else (rows, ld)) == tuple(lo.shape)
    want_hi, want_lo = split_tf32_ref(x, transpose)
    assert torch.equal(_bits(hi[:, :width]), _bits(want_hi))
    assert torch.equal(_bits(lo[:, :width]), _bits(want_lo))
    assert not hi[:, width:].any() and not lo[:, width:].any()
    got = split_tf32_ref(x, transpose, ld)
    assert torch.equal(_bits(got[0]), _bits(hi)) and torch.equal(_bits(got[1]), _bits(lo))


def _read_as_tensor_map(buf, rows, cols):
    """The (rows, cols) a tensor map of the true extents reads from a
    buffer at its padded leading dimension."""

    return torch.as_strided(buf, (rows, cols), (buf.shape[1], 1))


# (M, K, N) that TMA cannot describe as they lie: the smoke's ragged
# strides, a K and an N below one 16-byte row, N and K the other way round
ROUTE_SHAPES = [(300, 257, 130), (64, 9, 25), (33, 130, 257)]


@pytest.mark.parametrize("M,K,N", ROUTE_SHAPES)
def test_bf16_route_emulated_through_the_stage_matches_the_reference_kernel(M, K, N):
    """The bf16 route in plain arithmetic: staging(), the stage, then the
    product read through the padded strides (exact bf16 products summed in
    f32, as wgmma does), against the Pallas kernel within 3e-2 sqrt(K)."""

    a, b = _operands(M, K, N, seed=M + N)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    st = ops.staging(torch.bfloat16, M, K, N, ta.data_ptr(), tb.data_ptr())
    assert st.a or st.b
    sa, sb = ops.stage_bf16(ta, tb, st)
    va, vb = _read_as_tensor_map(sa, M, K), _read_as_tensor_map(sb, K, N)
    out = torch.matmul(va.float(), vb.float()).bfloat16()
    ref = ref_matmul(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                     blk_m=64, blk_n=64, blk_k=64)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2 * K**0.5, rtol=3e-2)


@pytest.mark.parametrize("M,K,N", ROUTE_SHAPES)
def test_f32_route_emulated_through_the_padded_split_matches_the_reference_kernel(M, K, N):
    """The 3xTF32 route in plain arithmetic: the padded split of A and of B
    transposed, read through the padded stride as the tensor maps read it,
    then the three TF32 products (exact in f64), against the Pallas kernel
    within 2e-5 sqrt(K)."""

    a, b = _operands(M, K, N, seed=M * N)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    st = ops.staging(torch.float32, M, K, N, ta.data_ptr(), tb.data_ptr())
    a_hi, a_lo = (_read_as_tensor_map(t, M, K).double().numpy() for t in ops.split_tf32(ta))
    bt_hi, bt_lo = (_read_as_tensor_map(t, N, K).double().numpy()
                    for t in ops.split_tf32(tb, transpose=True))
    assert ops.split_tf32(ta)[0].shape[1] == st.lda
    out = a_lo @ bt_hi.T + a_hi @ bt_lo.T + a_hi @ bt_hi.T
    np.testing.assert_allclose(out, _pallas_f32(a, b, 64), atol=2e-5 * K**0.5, rtol=2e-5)
    # the same three products as the unpadded emulation (f64 sums, any order)
    np.testing.assert_allclose(out, _three_tf32(a, b), rtol=1e-12, atol=1e-12)


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
    # every f32 call takes the 3xTF32 route: strides TMA cannot describe too
    with pytest.raises(NotImplementedError, match="tma_wgmma_tf32x3"):
        ops.matmul(torch.zeros(8, 7), torch.zeros(7, 5), depth=4)


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

    found = set()
    for src in (ops.TMA_SOURCE, ops.TF32X3_SOURCE):
        for name, args in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()
        ):
            params = [p.strip() for p in args.split(",")]
            ptrs = sum("void*" in p for p in params[:-1])
            assert params[-1] == "void* stream"
            assert ops._SIGNATURES[name] == (ptrs, len(params) - 1 - ptrs), name
            found.add(name)
    assert found == set(ops._SIGNATURES) and "pm_stage_bf16" in found


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
