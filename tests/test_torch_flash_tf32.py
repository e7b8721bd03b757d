"""The f32 flash-attention route on the tensor cores (``tma_wgmma_tf32x3``),
as far as the CPU can hold it.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 6).  Here: its arithmetic, emulated in PyTorch
(``ref.flash_attention_tf32x3_ref``: rna_tf32 splits, three TF32 products
summed in f32), against the reference's Pallas kernel in interpret mode
within the f32 limit of ``tests/test_kernels.py`` (2e-5, held per output
row as relative L2), and one TF32 product missing it; the pre-pass's plain
version, its layout and key order; the register-fragment algebra that key
order rests on; the route rule; and the shared-memory budget and schedule
checks the wrapper makes before any launch.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    KEY_ORDER,
    flash_attention_tf32x3_ref,
    split_kv_tf32_ref,
)
from repro_torch.kernels.pipelined_matmul.ref import rna_tf32_ref

ROW_TOL = 2e-5  # tests/test_kernels.py's f32 tolerance, per output row

# (B, Sq, Sk, H, KV, hd, causal, window): the route's shapes at a small
# size, at each hd it takes: several key tiles causal with GQA, a window,
# ragged lengths
EMULATION_CASES = [
    (1, 256, 256, 4, 2, 64, True, None),
    (1, 256, 256, 2, 1, 128, True, 100),
    (1, 193, 201, 2, 2, 128, False, None),
    (1, 193, 201, 4, 2, 64, True, None),
    (1, 256, 256, 4, 2, 32, True, None),
    (1, 193, 201, 4, 4, 32, False, None),
    (1, 256, 256, 4, 2, 16, True, 100),
    (1, 193, 201, 2, 1, 16, False, None),
]


def _row_err(out, ref) -> float:
    ref = torch.as_tensor(np.array(ref, np.float32))
    d = (out.float() - ref).norm(dim=-1)
    return (d / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


def _inputs(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
    ]


@pytest.fixture(scope="module")
def pallas():
    """The reference's Pallas kernel (interpret mode) on each case, once."""

    out = {}
    for i, case in enumerate(EMULATION_CASES):
        B, Sq, Sk, H, KV, hd, causal, window = case
        arrays = _inputs(i, B, Sq, Sk, H, KV, hd)
        ref = jax_flash(*(jnp.asarray(a) for a in arrays), causal=causal,
                        window=window, blk_q=64, blk_k=64)
        out[case] = ([torch.from_numpy(a) for a in arrays], np.asarray(ref))
    return out


@pytest.mark.parametrize("case", EMULATION_CASES, ids=lambda c: "x".join(map(str, c)))
def test_3xtf32_emulation_within_the_f32_limit_of_the_pallas_kernel(pallas, case):
    (q, k, v), ref = pallas[case]
    out = flash_attention_tf32x3_ref(q, k, v, causal=case[6], window=case[7])
    assert out.shape == q.shape and out.dtype == torch.float32
    assert _row_err(out, ref) <= ROW_TOL / 4  # a quarter of the limit


@pytest.mark.parametrize("case", EMULATION_CASES, ids=lambda c: "x".join(map(str, c)))
def test_1xtf32_emulation_misses_the_f32_limit(pallas, case):
    """One TF32 product of each pair (what a TF32 matmul computes) reads
    well above the limit: the reason the route takes three."""

    (q, k, v), ref = pallas[case]
    out = flash_attention_tf32x3_ref(q, k, v, causal=case[6], window=case[7], terms=1)
    assert _row_err(out, ref) > 4 * ROW_TOL


def test_emulation_takes_q_offset_as_the_plain_version_does():
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, 1, 64, 200, 4, 2, 64))
    for window in (None, 48):
        out = flash_attention_tf32x3_ref(q, k, v, causal=True, window=window, q_offset=136)
        ref = ops.flash_attention(q, k, v, causal=True, window=window, q_offset=136)
        assert _row_err(out, ref) <= ROW_TOL / 4
    with pytest.raises(ValueError, match="terms=2"):
        flash_attention_tf32x3_ref(q, k, v, terms=2)


# ---------------------------------------------------------------------- #
# The K / V split
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("Sk", [64, 201, 5], ids=["whole", "ragged", "short"])
def test_split_kv_layout_and_key_order(Sk, hd):
    B, KV = 2, 3
    _, k, v = (torch.from_numpy(a) for a in _inputs(Sk, B, 1, Sk, KV, KV, hd))
    k_hi, k_lo, vt_hi, vt_lo = split_kv_tf32_ref(k, v)
    sk8 = -(-Sk // 8) * 8
    assert k_hi.shape == k_lo.shape == (B, KV, Sk, hd)
    assert vt_hi.shape == vt_lo.shape == (B, KV, hd, sk8)
    assert all(t.is_contiguous() for t in (k_hi, k_lo, vt_hi, vt_lo))
    # K: hi and lo of k in (B, KV, Sk, hd)
    assert torch.equal(k_hi, rna_tf32_ref(k.permute(0, 2, 1, 3).contiguous()))
    assert torch.equal(k_lo, rna_tf32_ref(k.permute(0, 2, 1, 3) - k_hi))
    # Vᵀ: position p of group g holds key 8 g + KEY_ORDER[p]; past Sk zeros
    for pos in range(sk8):
        key = pos // 8 * 8 + KEY_ORDER[pos % 8]
        if key < Sk:
            x = v[:, key].permute(1, 2, 0)  # (KV, hd, B)
            assert torch.equal(vt_hi[..., pos].permute(1, 2, 0), rna_tf32_ref(x.contiguous()))
        else:
            assert not vt_hi[..., pos].any() and not vt_lo[..., pos].any()
    # hi + lo keeps 22 of 24 significant bits
    rebuilt = (vt_hi + vt_lo).reshape(B, KV, hd, sk8 // 8, 8)[..., list(np.argsort(KEY_ORDER))]
    rebuilt = rebuilt.reshape(B, KV, hd, sk8)[..., :Sk]
    torch.testing.assert_close(rebuilt, v.permute(0, 2, 3, 1), rtol=2**-21, atol=0)
    # every hi and lo is a TF32 value (13 low bits clear)
    for t in (k_hi, k_lo, vt_hi, vt_lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()


def test_split_kv_reads_strided_views_on_the_cpu():
    cache = torch.randn(2, 64, 4, 64)
    k, v = cache[:, :40, :2], cache[:, :40, 2:]
    assert not k.is_contiguous()
    got = ops.split_kv_tf32(k, v)
    want = split_kv_tf32_ref(k.contiguous(), v.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = ops.split_kv_tf32.launches
    ops.flash_attention(torch.randn(2, 40, 4, 64), k, v)  # the plain version
    assert ops.split_kv_tf32.launches == before
    with pytest.raises(TypeError, match="float32"):
        ops.split_kv_tf32(k.bfloat16(), v.bfloat16())


# ---------------------------------------------------------------------- #
# Register fragments: the accumulator of S as the A operand of PV
# ---------------------------------------------------------------------- #

def _accumulator(lane: int, j: int, e: int):
    """(row, column) within a warp's 16 rows of element d[4 j + e] of a
    thread's f32 wgmma accumulator (columns of the 8-column group j)."""

    return lane // 4 + 8 * (e // 2), 8 * j + 2 * (lane % 4) + e % 2


def _a_fragment(lane: int, i: int):
    """(row, k-position) of register a[i] of the tf32 A fragment of wgmma
    m64nNk8 within a warp's 16 rows."""

    return lane // 4 + 8 * (i % 2), lane % 4 + 4 * (i // 2)


def _pv_through_fragments(P, V, order, take):
    """PV of one 8-key step as the tensor core sums it: A from each
    thread's accumulator registers ``take`` (indices into d[4j .. 4j+3]),
    B's k-position p holding key ``order[p]``."""

    A = np.zeros((16, 8))
    for lane in range(32):
        for i, e in enumerate(take):
            row, pos = _a_fragment(lane, i)
            r, key = _accumulator(lane, 0, e)
            assert r == row  # a register never moves to another row
            A[row, pos] = P[r, key]
    B = V[list(order)]  # k-position p holds V's key order[p]
    return A @ B


def test_accumulator_as_a_fragment_with_the_key_order_is_pv():
    """a = {d[4j], d[4j+2], d[4j+1], d[4j+3]} against Vᵀ in KEY_ORDER sums
    PV over the same keys as P V: the permutation makes the key sum the
    identity, without a shuffle."""

    rng = np.random.default_rng(0)
    P, V = rng.random((16, 8)), rng.standard_normal((8, 5))
    got = _pv_through_fragments(P, V, KEY_ORDER, (0, 2, 1, 3))
    np.testing.assert_allclose(got, P @ V, rtol=1e-12, atol=1e-12)
    # each (lane, register) lands on a distinct (row, k-position): a bijection
    cells = {_a_fragment(lane, i) for lane in range(32) for i in range(4)}
    assert len(cells) == 128
    # the natural key order, or the registers in order, would sum wrong keys
    assert not np.allclose(_pv_through_fragments(P, V, range(8), (0, 2, 1, 3)), P @ V)
    with pytest.raises(AssertionError):
        _pv_through_fragments(P, V, KEY_ORDER, (0, 1, 2, 3))


def test_key_order_agrees_with_the_kernel_source():
    src = ops.TF32X3_SOURCE.read_text()
    body = re.search(r"int key_order\(int p\) \{\s*return (.*?);", src).group(1)
    assert body == "p < 4 ? 2 * p : 2 * (p - 4) + 1"
    assert tuple(2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8)) == KEY_ORDER
    assert "{sc[4 * j], sc[4 * j + 2], sc[4 * j + 1], sc[4 * j + 3]}" in src


# ---------------------------------------------------------------------- #
# The route rule, the budget and the plan
# ---------------------------------------------------------------------- #

def _strides(shape):
    B, S, heads, hd = shape
    return (S * heads * hd, heads * hd, hd)


@pytest.mark.parametrize(
    "hd,strides,addresses,expect",
    [
        (128, [_strides((4, 2048, 32, 128))] + [_strides((4, 2048, 4, 128))] * 2,
         (0, 1 << 20, 1 << 21), "tma_wgmma_tf32x3"),                  # yi-6b prefill
        (64, [_strides((4, 2048, 32, 64))] + [_strides((4, 2048, 8, 64))] * 2,
         (0, 0, 0), "tma_wgmma_tf32x3"),                              # granite hd 64
        (128, [(8 * 201 * 128, 8 * 128, 128)] + [(640 * 256, 256, 128)] * 2,
         (0, 16, 32), "tma_wgmma_tf32x3"),                            # cache slices
        (32, [_strides((1, 193, 4, 32))] * 3, (0, 0, 0), "tma_wgmma_tf32x3"),  # hd 32
        (16, [_strides((1, 201, 4, 16))] * 3, (0, 0, 0), "tma_wgmma_tf32x3"),  # hd 16
        # strides or bases off 16 bytes: the route's rule, and then its
        # contract raises before any launch
        (128, [(130 * 100, 130, 1)] * 3, (0, 0, 0), "tma_wgmma_tf32x3"),   # 4-byte strides
        (64, [(66 * 64, 66 * 64, 66)] * 3, (0, 0, 0), "tma_wgmma_tf32x3"),  # 264-byte head stride
        (128, [_strides((1, 64, 2, 128))] * 3, (0, 8, 0), "tma_wgmma_tf32x3"),  # k 8 bytes in
        (128, [_strides((1, 64, 2, 128))] * 3, (4, 0, 0), "tma_wgmma_tf32x3"),  # q 4 bytes in
        (64, [_strides((1, 64, 2, 64)), (0, 128, 64), (0, 128, 64)],
         (0, 0, 0), "tma_wgmma_tf32x3"),                                  # broadcast batch
    ],
    ids=["yi6b", "hd64", "cache_slices", "hd32", "hd16", "odd_strides",
         "head_stride_264_bytes", "k_offset", "q_offset_bytes", "stride_0"],
)
def test_f32_route_rule(hd, strides, addresses, expect):
    assert ops.route(torch.float32, hd, strides, addresses) == expect


def test_f32_route_of_views_follows_strides_and_base_addresses():
    flat = torch.zeros(64 * 2 * 128 + 4)
    aligned = flat[4:4 + 64 * 2 * 128].view(1, 64, 2, 128)   # 16 bytes in
    shifted = flat[1:1 + 64 * 2 * 128].view(1, 64, 2, 128)   # 4 bytes in
    assert ops._route_of(aligned, aligned, aligned) == "tma_wgmma_tf32x3"
    assert ops._route_of(aligned, shifted, aligned) == "tma_wgmma_tf32x3"
    with pytest.raises(NotImplementedError, match="offset 4"):
        ops._check_kernel_call(aligned, shifted, aligned, None)  # before any launch
    qkv = torch.zeros(2, 96, 8, 64)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert ops._route_of(q, k, v) == "tma_wgmma_tf32x3"
    assert ops._route_of(*(t[..., :32] for t in (q, k, v))) == "tma_wgmma_tf32x3"
    ops._check_kernel_call(*(t[..., :16] for t in (q, k, v)), None)


@pytest.mark.parametrize(
    "hd,depth,smem",
    [(128, 3, 131072 + 3 * 32768 + 1104), (64, 4, 65536 + 4 * 32768 + 1104),
     (32, 4, 32768 + 4 * 32768 + 1104), (16, 4, 16384 + 4 * 16384 + 1104)],
    ids=["hd128_bk16", "hd64_bk32", "hd32_bk64", "hd16_bk64"],
)
def test_tf32x3_default_depth_is_the_deepest_ring_that_fits(hd, depth, smem):
    assert ops.tf32x3_default_depth(hd) == depth <= ops.MAX_STAGES
    assert ops.tf32x3_smem_bytes(hd, depth) == smem <= ops.SMEM_PER_BLOCK
    assert depth == ops.MAX_STAGES or (
        ops.tf32x3_smem_bytes(hd, depth + 1) > ops.SMEM_PER_BLOCK
    )


def test_tf32x3_default_tile_is_the_deeper_ring():
    """Each hd's key tile is the one whose ring is the deeper in the budget
    (16 or 32 keys at hd 128 and 64: a Vᵀ row of one 64- or 128-byte
    swizzle span), and at hd 32 and 16, where every depth fits either
    way, the wider 64 keys (Vᵀ in two 128-byte boxes)."""

    def ring(hd, bk):
        free = ops.SMEM_PER_BLOCK - ops.tf32x3_smem_bytes(hd, 0)
        return min(ops.MAX_STAGES, free // (4 * bk * hd * 4))

    assert ops.TF32X3_BK == {128: 16, 64: 32, 32: 64, 16: 64}
    assert (ring(128, 16), ring(128, 32), ring(64, 32), ring(64, 16)) == (3, 1, 4, 4)
    assert (ring(32, 64), ring(16, 64)) == (4, 4)  # every depth fits: the wider tile
    for hd, bk in ops.TF32X3_BK.items():
        assert ops.tf32x3_default_depth(hd) == ring(hd, bk) >= ring(hd, 32 if bk == 16 else 16)
        assert ops._tma_schedule(hd, None, "tma_wgmma_tf32x3").depth == (
            ops.tf32x3_default_depth(hd)
        )


def test_tf32x3_kernel_constants_agree_with_the_wrapper():
    src = ops.TF32X3_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BQ"), const("BOX")) == (ops.TMA_BQ, ops.TF32X3_BOX)
    assert const("MAX_STAGES") == ops.MAX_STAGES
    assert const("SMEM_PER_BLOCK") == ops.SMEM_PER_BLOCK
    assert "SMEM_BYTES_EXTRA = 1024 + 8 * (2 + 2 * MAX_STAGES)" in src
    # Q hi + lo, and a stage of K hi / lo and Vᵀ hi / lo, as the wrapper counts
    assert "return 2 * Q_BYTES + stages * STAGE_BYTES + SMEM_BYTES_EXTRA;" in src
    assert "STAGE_BYTES = 2 * K_BYTES + 2 * V_BYTES;" in src
    assert "static_assert(BK == 16 || BK == 32 || BK == 64," in src
    assert "constexpr int key_tile(int hd) { return hd == 128 ? 16 : hd == 64 ? 32 : 64; }" in src
    assert ops.TF32X3_BK == {hd: {128: 16, 64: 32}.get(hd, 64) for hd in ops.TMA_HEAD_DIMS}
    assert "launch_stages<128, key_tile(128)>" in src and "launch_stages<64, key_tile(64)>" in src
    assert "launch_stages<32, key_tile(32)>" in src and "launch_stages<16, key_tile(16)>" in src
    assert "(hd != 16 && hd != 32 && hd != 64 && hd != 128)" in src
    assert tuple(ops.TMA_HEAD_DIMS) == (16, 32, 64, 128)
    # the Vᵀ swizzle follows the row of BK keys: 64 bytes at BK 16
    assert "bk == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B" in src


def _with_waits(depth, waits):
    from repro_torch.kernels.pipelined_matmul.ops import HopperSchedule

    return HopperSchedule(depth=depth, waits=tuple(waits))


@pytest.mark.parametrize("waits", [("full",), ("empty",), ()], ids=["no_empty", "no_full", "none"])
def test_tf32x3_route_refuses_a_schedule_without_both_waits(monkeypatch, waits):
    monkeypatch.setattr(ops, "hopper_schedule", lambda depth: _with_waits(depth, waits))
    with pytest.raises(NotImplementedError, match=r"tma_wgmma_tf32x3.*full and the empty"):
        ops._tma_schedule(128, None, "tma_wgmma_tf32x3")
    q = torch.zeros(1, 16, 2, 64)
    with pytest.raises(NotImplementedError, match="full and the empty"):
        ops.flash_attention(q, q, q)  # the plan is read on the CPU too
    small = torch.zeros(1, 16, 2, 32)
    with pytest.raises(NotImplementedError, match=r"tma_wgmma_tf32x3.*full and the empty"):
        ops.flash_attention(small, small, small)  # hd 32: the same route, the same plan


@pytest.mark.parametrize(
    "hd,depth,match",
    [(128, 4, "ring depth 4 at hd=128"), (64, 5, "ring depth 5 at hd=64"),
     (128, 0, "ring depth 0"), (64, 0, "ring depth 0 at hd=64")],
    ids=["hd128_d4", "hd64_d5", "d0", "hd64_d0"],
)
def test_tf32x3_route_refuses_a_ring_that_does_not_fit(hd, depth, match):
    with pytest.raises(NotImplementedError, match=match):
        ops._tma_schedule(hd, depth, "tma_wgmma_tf32x3")
    q = torch.zeros(1, 16, 2, hd)
    with pytest.raises(NotImplementedError, match=match):
        ops.flash_attention(q, q, q, depth=depth)


def test_tf32x3_route_takes_its_waits_from_the_kloop_plan():
    for hd in (64, 128):
        for depth in range(1, ops.tf32x3_default_depth(hd) + 1):
            sched = ops._tma_schedule(hd, depth, "tma_wgmma_tf32x3")
            assert sched.depth == depth and sched.full and sched.empty
    q = torch.zeros(1, 16, 2, 128)
    out = ops.flash_attention(q, q, q, depth=3)  # fits: the plain version on the CPU
    assert out.shape == q.shape


def test_routes_and_split_launches_are_counted_on_the_cpu_as_none():
    assert set(ops.flash_attention.routes) == {"flash_decode", "tma_wgmma", "tma_wgmma_tf32x3"}
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 16, 16, 2, 2, 64))
    before = dict(ops.flash_attention.routes), ops.split_kv_tf32.launches
    ops.flash_attention(q, k, v)
    assert (dict(ops.flash_attention.routes), ops.split_kv_tf32.launches) == before


# ---------------------------------------------------------------------- #
# Rows without a live key: outside the kernels' contract
# ---------------------------------------------------------------------- #

def _every_row_keeps_a_key(Sq, Sk, causal, window, q_offset):
    p = q_offset + np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= j <= p
    if window is not None:
        keep &= j > p - window
    return bool(keep.any(axis=1).all())


@pytest.mark.parametrize("window", [None, 1, 3, 8])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kernel_contract_raises_iff_a_row_keeps_no_key(causal, window):
    """The check is exact: over small shapes and offsets, it raises where
    some query row's mask keeps no key, and nowhere else."""

    for Sq in (1, 5, 9):
        for Sk in (1, 4, 9):
            for q_offset in range(-3, 16):
                expect = _every_row_keeps_a_key(Sq, Sk, causal, window, q_offset)
                try:
                    ops._check_live_keys(Sq, Sk, causal, window, q_offset)
                    raised = False
                except NotImplementedError:
                    raised = True
                assert raised == (not expect), (Sq, Sk, causal, window, q_offset)


@pytest.mark.parametrize(
    "Sq,Sk,causal,window,q_offset,match",
    [(16, 16, True, None, -1, "q_offset=-1 < 0"),
     (8, 32, False, 4, 40, "window=4 with q_offset=40"),
     (8, 8, True, 2, 8, "window=2 with q_offset=8")],
    ids=["causal_before_the_keys", "window_after_the_keys", "causal_window_after_the_keys"],
)
def test_kernel_call_raises_for_a_row_without_keys(Sq, Sk, causal, window, q_offset, match):
    """A CUDA call is checked before any launch; the plain version (the
    CPU's) computes such rows as the reference does."""

    q, k = torch.zeros(1, Sq, 2, 64), torch.zeros(1, Sk, 2, 64)
    with pytest.raises(NotImplementedError, match=match):
        ops._check_kernel_call(q, k, k, window, q_offset, causal)
    out = ops.flash_attention(q, k, k, causal=causal, window=window, q_offset=q_offset)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", ["fa_split_kv_tf32", "fa_forward_tf32x3"])
def test_tf32x3_ctypes_signatures_agree_with_the_source(monkeypatch, name):
    """The argtypes the wrapper gives each host entry are the C parameter
    list of the source, one by one."""

    import ctypes
    import types

    from repro_torch.kernels import _build

    class Entry:
        pass

    monkeypatch.setattr(_build, "load", lambda path: types.SimpleNamespace(**{name: Entry()}))
    fn = ops._tf32x3_entry_point.__wrapped__(name)
    src = ops.TF32X3_SOURCE.read_text()
    params = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S).group(1)
    kinds = {"void*": ctypes.c_void_p, "long long*": ctypes.POINTER(ctypes.c_longlong),
             "int": ctypes.c_int, "float": ctypes.c_float}
    want = []
    for param in params.split(","):
        ctype = " ".join(param.split()[:-1]).replace("const ", "")
        want.append(kinds[ctype])
    assert fn.restype is ctypes.c_int and list(fn.argtypes) == want
