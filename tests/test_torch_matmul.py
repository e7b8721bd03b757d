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
from repro_torch.kernels.pipelined_matmul.ref import matmul_ref

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
        (torch.float32, 4096, 11008, 0, 0, "ffma"),
        (torch.float32, 257, 130, 4, 0, "ffma"),
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
