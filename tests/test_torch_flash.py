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


# ---------------------------------------------------------------------- #
# The TMA route: what the wrapper decides without a card
# ---------------------------------------------------------------------- #

def _strides(shape):
    """Contiguous (batch, seq, head) element strides of a (B, S, heads, hd)
    tensor."""

    B, S, heads, hd = shape
    return (S * heads * hd, heads * hd, hd)


@pytest.mark.parametrize(
    "dtype,hd,strides,addresses,expect",
    [
        (torch.bfloat16, 128, [_strides((4, 2048, 32, 128))] + [_strides((4, 2048, 4, 128))] * 2,
         (0, 1 << 20, 1 << 21), "tma_wgmma"),                                  # yi-6b prefill
        (torch.bfloat16, 64, [_strides((4, 2048, 32, 64))] + [_strides((4, 2048, 8, 64))] * 2,
         (0, 0, 0), "tma_wgmma"),                                              # granite hd 64
        (torch.bfloat16, 128, [(8 * 201 * 128, 8 * 128, 128)] + [(640 * 256, 256, 128)] * 2,
         (0, 16, 32), "tma_wgmma"),                                            # cache slices
        (torch.bfloat16, 32, [_strides((1, 193, 4, 32))] * 3, (0, 0, 0), "cp_async_mma"),
        (torch.bfloat16, 16, [_strides((1, 201, 4, 16))] * 3, (0, 0, 0), "cp_async_mma"),
        (torch.bfloat16, 128, [(132 * 100, 132, 1)] * 3, (0, 0, 0), "cp_async_mma"),  # 2-byte strides
        (torch.bfloat16, 128, [_strides((1, 64, 2, 128))] * 3, (0, 2, 0), "cp_async_mma"),  # k offset
        (torch.bfloat16, 128, [_strides((1, 64, 2, 128)), (0, 256, 128), (0, 256, 128)],
         (0, 0, 0), "cp_async_mma"),                                           # broadcast batch
        (torch.float32, 128, [_strides((4, 2048, 32, 128))] * 3, (0, 0, 0), "tma_wgmma_tf32x3"),
        (torch.float32, 32, [_strides((1, 193, 4, 32))] * 3, (4, 0, 0), "ffma"),
    ],
    ids=["yi6b", "hd64", "cache_slices", "hd32", "hd16", "odd_strides", "k_offset",
         "stride_0", "f32", "f32_hd32"],
)
def test_route_rule(dtype, hd, strides, addresses, expect):
    assert ops.route(dtype, hd, strides, addresses) == expect


def test_route_of_views_follows_strides_and_base_addresses():
    qkv = torch.zeros(2, 96, 8, 128, dtype=torch.bfloat16)
    cache = torch.zeros(2, 640, 2, 128, dtype=torch.bfloat16)
    q, k = qkv[:, :, :4], cache[:, :201]
    assert not (q.is_contiguous() or k.is_contiguous())
    assert ops._route_of(q, k, k) == "tma_wgmma"
    flat = torch.zeros(1 * 64 * 2 * 128 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 64 * 2 * 128].view(1, 64, 2, 128)  # 2 bytes in
    aligned = flat[8:8 + 64 * 2 * 128].view(1, 64, 2, 128)  # 16 bytes in
    assert ops._route_of(aligned, aligned, aligned) == "tma_wgmma"
    assert ops._route_of(aligned, shifted, aligned) == "cp_async_mma"
    assert ops._route_of(q.float(), k.float(), k.float()) == "tma_wgmma_tf32x3"
    assert ops._route_of(*(t[..., :32].float() for t in (q, k, k))) == "ffma"


@pytest.mark.parametrize("hd,depth", [(64, 4), (128, 3)])
def test_default_depth_is_the_deepest_ring_that_fits(hd, depth):
    assert ops.default_depth(hd) == depth <= ops.MAX_STAGES
    assert ops.tma_smem_bytes(hd, depth) <= ops.SMEM_PER_BLOCK
    assert depth == ops.MAX_STAGES or ops.tma_smem_bytes(hd, depth + 1) > ops.SMEM_PER_BLOCK
    # hd 128: 32 KB of Q and three 64 KB stages, 230480 of the 232448 bytes
    assert ops.tma_smem_bytes(128, 3) == 32768 + 3 * 65536 + 1024 + 80


def test_tma_kernel_constants_agree_with_the_wrapper():
    import re

    src = ops.TMA_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BQ"), const("BK"), const("BOX")) == (ops.TMA_BQ, ops.TMA_BK, ops.TMA_BOX)
    assert const("MAX_STAGES") == ops.MAX_STAGES
    assert const("SMEM_PER_BLOCK") == ops.SMEM_PER_BLOCK
    assert "SMEM_BYTES_EXTRA = 1024 + 8 * (2 + 2 * MAX_STAGES)" in src
    assert ops.TMA_SMEM_EXTRA == 1024 + 8 * (2 + 2 * ops.MAX_STAGES)
    assert tuple(ops.TMA_HEAD_DIMS) == (64, 128)


def test_tensor_map_of_a_contiguous_q():
    q = torch.zeros(2, 300, 4, 128, dtype=torch.bfloat16)
    tm = ops.tensor_map(q.shape, q.stride(), ops.TMA_BQ)
    assert tm.dims == (128, 4, 300, 2)               # hd, heads, S, B
    assert tm.strides == (256, 4 * 256, 300 * 4 * 256)  # bytes: head, seq, batch
    assert tm.box == (64, 1, 128, 1)
    assert tm.flat() == (*tm.dims, *tm.strides, *tm.box)


def test_tensor_map_of_a_kv_cache_slice():
    """The first 201 positions of a 640-position cache: the seq dim is 201
    (a box past it is zero-filled inside its own batch), the strides are
    the cache's."""

    cache = torch.zeros(2, 640, 2, 64, dtype=torch.bfloat16)
    k = cache[:, :201]
    tm = ops.tensor_map(k.shape, k.stride(), ops.TMA_BK)
    assert tm.dims == (64, 2, 201, 2)
    assert tm.strides == (128, 2 * 128, 640 * 2 * 128)
    assert tm.box == (64, 1, 128, 1)


def _with_waits(depth, waits):
    from repro_torch.kernels.pipelined_matmul.ops import HopperSchedule

    return HopperSchedule(depth=depth, waits=tuple(waits))


@pytest.mark.parametrize("waits", [("full",), ("empty",), ()], ids=["no_empty", "no_full", "none"])
def test_tma_route_refuses_a_schedule_without_both_waits(monkeypatch, waits):
    monkeypatch.setattr(ops, "hopper_schedule", lambda depth: _with_waits(depth, waits))
    with pytest.raises(NotImplementedError, match="full and the empty"):
        ops._tma_schedule(128, None)
    q = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="full and the empty"):
        ops.flash_attention(q, q, q)  # the plan is read on the CPU too
    small = torch.zeros(1, 16, 2, 32)
    ops.flash_attention(small, small, small)  # ffma: not this plan


def test_tma_route_takes_its_waits_from_the_kloop_plan(monkeypatch):
    import types

    from repro_torch.core.dependence import FLOW, Dependence
    from repro_torch.kernels.pipelined_matmul import ops as mm_ops

    for depth in range(1, ops.default_depth(128) + 1):
        sched = ops._tma_schedule(128, depth)
        assert sched.depth == depth and sched.full and sched.empty
    assert ops._tma_schedule(64, None).depth == 4
    # a plan that also keeps a dependence the kernel has no mbarrier for
    real = mm_ops.hopper_plan(3)
    odd = types.SimpleNamespace(
        retained=real.retained + (Dependence(FLOW, "COMPUTE", "LOAD", "buf", (5,)),),
        eliminated=(),
    )
    monkeypatch.setattr(mm_ops, "hopper_plan", lambda depth: odd)
    mm_ops.hopper_schedule.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="no mbarrier for"):
            ops._tma_schedule(128, 3)
    finally:
        mm_ops.hopper_schedule.cache_clear()


def test_tma_route_refuses_a_ring_that_does_not_fit():
    q = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ring depth 4 at hd=128"):
        ops.flash_attention(q, q, q, depth=4)
    with pytest.raises(NotImplementedError, match="ring depth 0"):
        ops.flash_attention(q, q, q, depth=0)
    small = torch.zeros(1, 16, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="cp_async_mma.*one depth"):
        ops.flash_attention(small, small, small, depth=3)
    out = ops.flash_attention(q, q, q, depth=3)  # fits: the plain version on the CPU
    assert out.shape == q.shape


def test_routes_are_counted_beside_launches():
    assert set(ops.flash_attention.routes) == {
        "tma_wgmma", "cp_async_mma", "tma_wgmma_tf32x3", "ffma"
    }
    (_, tq), (_, tk), (_, tv) = _inputs(8, (1, 16, 2, 64), (1, 16, 2, 64), "bfloat16")
    before = dict(ops.flash_attention.routes)
    ops.flash_attention(tq, tk, tv)
    assert ops.flash_attention.routes == before  # the CPU launches nothing


# ---------------------------------------------------------------------- #
# One-hot probes: outputs known exactly
# ---------------------------------------------------------------------- #

PROBES = [
    ((1, 200, 200, 4, 2), dict(causal=True)),
    ((1, 193, 201, 4, 2), dict(causal=False)),
    ((1, 150, 150, 4, 4), dict(causal=True, window=48)),
    ((1, 200, 200, 4, 2), dict(causal=True, identity_v=True)),
    ((1, 193, 201, 2, 1), dict(causal=False, identity_v=True)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize(
    "shape,kw", PROBES, ids=["causal", "ragged", "window", "causal_identity_v", "ragged_identity_v"]
)
def test_one_hot_probe_is_exact_in_the_reference_kernel_and_the_plain_version(shape, kw, hd, dtype):
    """Each row's one live key of margin >= 128 returns its v row bit for
    bit (with V = I: the one-hot P), in the reference's Pallas kernel
    (interpret mode) and in the port's plain version alike; the card runs
    the same probes through the TMA route (tests/test_torch_cuda.py)."""

    from repro_torch.kernels.flash_attention.probe import one_hot_probe

    B, Sq, Sk, H, KV = shape
    q, k, v, expected = one_hot_probe(B, Sq, Sk, H, KV, hd, seed=hd, **kw)
    mask = {n: x for n, x in kw.items() if n != "identity_v"}
    ref = jax_flash(
        *(jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, v)), blk_q=64, blk_k=64, **mask
    )
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)), expected)
    out = ops.flash_attention(*(torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v)), **mask)
    np.testing.assert_array_equal(out.float().numpy(), expected)


# whisper-medium's cross-attention keys: 1500 frames, the last 64-key tile
# holding 28; the first rows pick the last tile's keys and the key before it
WHISPER_SK = 1500
EDGE_PICKS = WHISPER_SK - 1 - np.arange(29)


@pytest.mark.parametrize("identity_v", [False, True])
@pytest.mark.parametrize("Sq", [1, 4])
def test_one_hot_probe_holds_the_last_ragged_tile_of_whisper_keys(Sq, identity_v):
    """The probe at whisper's cross shapes (non-causal, hd 64, Sk 1500)
    with its first rows on the last tile's 28 keys: exact in the reference
    kernel (interpret mode) and the plain version, and a planted one-key
    edge (the last key dropped) fails the exact match."""

    from repro_torch.kernels.flash_attention.probe import one_hot_probe

    B, H, KV, hd = 2, 16, 16, 64
    q, k, v, expected = one_hot_probe(
        B, Sq, WHISPER_SK, H, KV, hd, causal=False, identity_v=identity_v, seed=Sq,
        first_picks=EDGE_PICKS,
    )
    ref = jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), causal=False)
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)), expected)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_array_equal(out.float().numpy(), expected)
    edge = ops.flash_attention(qt, kt[:, :-1], vt[:, :-1], causal=False).float().numpy()
    differ = (edge != expected).any(-1)  # (B, Sq, H)
    assert differ.transpose(0, 2, 1).ravel()[0]  # the row on key 1499
    assert int(differ.sum()) == 1


def test_one_hot_probe_refuses_a_first_pick_its_row_does_not_keep():
    from repro_torch.kernels.flash_attention.probe import one_hot_probe

    with pytest.raises(ValueError, match="first_picks"):
        one_hot_probe(1, 4, 8, 1, 1, 16, causal=True, first_picks=[3])
