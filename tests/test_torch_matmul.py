"""The port's pipelined matmul against the reference Pallas kernel (run in
interpret mode, as the reference's own tests run it on the CPU), and the
wiring from the K-loop plan to the Hopper kernel's ring depth and waits.

Inputs are made with numpy from a seed and handed to both sides.  The
tolerances are the reference's (``tests/test_kernels.py``): 2e-5 in f32
and 3e-2 in bf16, the absolute one scaled by sqrt(K).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pipelined_matmul.ops import matmul as ref_matmul

from repro_torch.core.dependence import FLOW, Dependence
from repro_torch.kernels.pipelined_matmul import ops
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
    before = ops.matmul.launches
    out = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), depth=1)
    assert ops.matmul.launches == before
    assert torch.equal(out, matmul_ref(torch.from_numpy(a), torch.from_numpy(b)))


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
