"""repro_torch.kernels.flash_attention held against the reference.

The same inputs, drawn with NumPy from a seed, go through the reference's
Pallas kernel (interpret mode on the CPU, as ``tests/test_kernels.py`` runs
it) or its ``flash_attention_ref`` and through the port's wrapper and plain
version.  On the CPU the port's wrapper runs its plain version; the kernel
itself is held against that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Shapes are those of
``tests/test_kernels.py``; tolerances are its 2e-5 (f32) and 3e-2 (bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.attention import attention_reference as jax_attention_reference

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bshd_ref,
    flash_attention_ref,
)
from repro_torch.models.attention import attention_reference

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, q_shape, kv_shape, dtype="float32"):
    """q, k, v as (jax, torch) pairs holding the same values."""

    rng = np.random.default_rng(seed)
    out = []
    for shape in (q_shape, kv_shape, kv_shape):
        a = rng.standard_normal(shape).astype(np.float32)
        out.append(
            (jnp.asarray(a).astype(JNP[dtype]), torch.from_numpy(a).to(TORCH[dtype]))
        )
    return out


def _close(port, ref, tol):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("S,blk", [(128, 64), (256, 128), (192, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_reference_kernel(S, blk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(0, (2, S, 4, 64), (2, S, 2, 64), dtype)
    ref = jax_flash(jq, jk, jv, causal=True, blk_q=blk, blk_k=blk)
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("window", [32, 100, 1000])
def test_sliding_window_matches_reference_kernel(window):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(1, (1, 256, 2, 32), (1, 256, 2, 32))
    ref = jax_flash(jq, jk, jv, causal=True, window=window, blk_q=64, blk_k=64)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(out, ref, 2e-5)


def test_unaligned_lengths_match_reference_kernel():
    (jq, tq), (jk, tk), (jv, tv) = _inputs(2, (1, 193, 4, 32), (1, 201, 4, 32))
    ref = jax_flash(jq, jk, jv, causal=False, blk_q=64, blk_k=64)
    out = ops.flash_attention(tq, tk, tv, causal=False)
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 24), (False, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_reference_ref(causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(3, (6, 96, 16), (6, 80, 16), dtype)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    out = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype
    _close(out, ref, TOL[dtype] if dtype == "bfloat16" else 1e-5)


def test_kernel_ref_matches_model_oracle():
    """ref.py and the model-level oracle implement the same contract, in
    the port as in the reference."""

    (_, tq), (_, tk), (_, tv) = _inputs(4, (2, 64, 4, 16), (2, 64, 4, 16))
    a = flash_attention_bshd_ref(tq, tk, tv, causal=True)
    b = attention_reference(tq, tk, tv, causal=True)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_plain_version_matches_model_oracle_of_the_reference():
    (jq, tq), (jk, tk), (jv, tv) = _inputs(5, (2, 72, 8, 32), (2, 72, 2, 32))
    ref = jax_attention_reference(jq, jk, jv, causal=True, window=20)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=20)
    _close(out, ref, 2e-5)


@settings(max_examples=10, deadline=None)
@given(
    sq=st.integers(16, 128),
    h=st.sampled_from([1, 2, 4]),
    kv=st.sampled_from([1, 2]),
    hd=st.sampled_from([16, 32, 64]),
)
def test_property_gqa_shapes(sq, h, kv, hd):
    if h % kv:
        kv = 1
    (jq, tq), (jk, tk), (jv, tv) = _inputs(6, (1, sq, h, hd), (1, sq, kv, hd))
    ref = jax_flash(jq, jk, jv, causal=True, blk_q=32, blk_k=32)
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == tq.shape
    _close(out, ref, 3e-5)


# ---------------------------------------------------------------------- #
# The wrapper's contract
# ---------------------------------------------------------------------- #

def test_wrapper_counts_no_launch_on_the_cpu():
    (_, tq), (_, tk), (_, tv) = _inputs(7, (1, 16, 2, 16), (1, 16, 2, 16))
    before = ops.flash_attention.launches
    ops.flash_attention(tq, tk, tv)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize(
    "q_shape,kv_shape",
    [((1, 8, 4, 16), (1, 8, 3, 16)), ((1, 8, 4, 16), (2, 8, 4, 16)), ((8, 4, 16), (8, 4, 16))],
    ids=["kv_heads_not_dividing", "batch_mismatch", "rank3"],
)
def test_wrapper_rejects_shapes(q_shape, kv_shape):
    q = torch.zeros(q_shape)
    k = torch.zeros(kv_shape)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)


def test_wrapper_rejects_mixed_devices_and_dtypes():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q, q.to("meta"), q)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: [torch.zeros(1, 8, 2, 48)] * 3, "hd=48"),
        (lambda: [torch.zeros(1, 8, 2, 16, dtype=torch.float16)] * 3, "dtype"),
        (lambda: [torch.zeros(1, 8, 2, 16, requires_grad=True)] * 3, "requires grad"),
        (lambda: [torch.zeros(1, 8, 16, 2).transpose(2, 3)] * 3, "strides"),
    ],
    ids=["hd", "dtype", "grad", "layout"],
)
def test_kernel_contract_raises_naming_the_argument(make, match):
    q, k, v = make()
    with pytest.raises(NotImplementedError, match=match):
        ops._check_kernel_call(q, k, v, None)


def test_kernel_contract_rejects_an_empty_window():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="window=0"):
        ops._check_kernel_call(q, q, q, 0)


def test_ring_depth_comes_from_the_kloop_plan(monkeypatch):
    from repro_torch.kernels.pipelined_matmul.ops import kernel_schedule

    assert ops.RING_DEPTH == 2
    assert sorted(kernel_schedule(2).waits) == sorted(ops.KERNEL_WAITS)
    ops._check_schedule()
    # depth 1 keeps the slot-reuse dependence, a credit wait the kernel lacks
    assert kernel_schedule(1).credit
    monkeypatch.setattr(ops, "RING_DEPTH", 1)
    with pytest.raises(NotImplementedError, match="depth 1"):
        ops._check_schedule()
