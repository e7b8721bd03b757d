"""The flash_decode route of repro_torch.kernels.flash_attention held
against the reference on the CPU.

The route's plain version, ``ref.flash_decode_ref`` (the key ranges'
partial softmax states, then their merge in the order of the ranges, as
the kernel's cluster merges them), is what the kernel
``csrc/flash_decode.cu`` computes and what ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against on the card.  Here the same inputs, drawn
with NumPy from a seed, go through the reference's Pallas kernel in
interpret mode (``blk_q`` at Sq, the reference's few-row case), its
``flash_attention_ref`` and its ``chunked_attention`` (which alone takes a
query offset, decode's position) and through ``flash_decode_ref``, in f32
at the reference tests' 2e-5.  The split count must not move the result
beyond 2e-6.  The route rule, the split rule (at most a cluster's ranges)
and the ring's depth are pure functions and pinned here, as is the K-loop
plan the wrapper reads; the CPU launches nothing.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.attention import chunked_attention as jax_chunked

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.probe import one_hot_probe, split_edge_picks
from repro_torch.kernels.flash_attention.ref import (
    combine_splits_ref,
    decode_partials_ref,
    flash_attention_bshd_ref,
    flash_decode_ref,
    key_ranges,
    live_span,
)

TOL = 2e-5  # f32, tests/test_kernels.py's
SPLIT_TOL = 2e-6  # f32, one result under another cut of the keys
H100_SMS = 132


def _inputs(seed, B, Sq, Sk, H, KV, hd=64):
    """q, k, v as NumPy f32 arrays from one seed."""

    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
    )


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _window(Sq, Sk):
    """A window that bites where it can and leaves every row a key (the
    reference kernel places query i at position i)."""

    return max(3, Sq - Sk + 2)


HEADS = [(8, 8), (8, 2)]  # MHA, GQA 4


@pytest.mark.parametrize("H,KV", HEADS, ids=["mha", "gqa"])
@pytest.mark.parametrize("mask", ["causal", "window", "none"])
@pytest.mark.parametrize("Sk", [1, 5, 130, 384])
@pytest.mark.parametrize("Sq", [1, 4, 16])
def test_matches_reference_kernel_at_few_rows(Sq, Sk, mask, H, KV):
    q, k, v = _inputs(Sq * 1000 + Sk, 2, Sq, Sk, H, KV)
    causal = mask != "none"
    window = _window(Sq, Sk) if mask == "window" else None
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                    window=window, blk_q=Sq, blk_k=128, interpret=True)
    splits = min(Sk, 3)
    out = flash_decode_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                           window=window, splits=splits)
    assert out.shape == q.shape and out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("H,KV", HEADS, ids=["mha", "gqa"])
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("Sq", [1, 4, 16])
def test_matches_reference_at_whisper_length(Sq, window, H, KV):
    """Sk 1500 (whisper's encoder frames) against ``flash_attention_ref``,
    non-causal and, with a window, causal; the ranges of the card's split
    rule at whisper's 16 KV heads."""

    B, Sk, hd = 2, 1500, 64
    q, k, v = _inputs(Sq, B, Sq, Sk, H, KV, hd)
    causal = window is not None
    fold = lambda a, n: jnp.asarray(  # noqa: E731
        np.repeat(a, H // a.shape[2], axis=2).transpose(0, 2, 1, 3).reshape(B * H, n, hd)
    )
    ref = jax_ref(fold(q, Sq), fold(k, Sk), fold(v, Sk), causal=causal, window=window)
    ref = np.asarray(ref).reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)
    splits = ops.decode_splits(4, 16, Sk, H100_SMS)
    assert splits == 4
    out = flash_decode_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                           window=window, splits=splits)
    _close(out, ref)


@pytest.mark.parametrize("H,KV", HEADS, ids=["mha", "gqa"])
@pytest.mark.parametrize("window", [None, 7, 100])
@pytest.mark.parametrize("Sk", [130, 384])
@pytest.mark.parametrize("Sq", [1, 4, 16])
def test_decode_position_matches_chunked_attention(Sq, Sk, window, H, KV):
    """Causal at decode's position (the last Sq of Sk keys: ``q_offset =
    Sk - Sq``) against the reference's ``chunked_attention``, which alone
    takes a query offset; with a window the live keys are a short span."""

    q, k, v = _inputs(Sq + Sk, 2, Sq, Sk, H, KV)
    q_offset = Sk - Sq
    ref = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                      window=window, q_offset=q_offset, chunk=128)
    lo, hi = live_span(Sq, Sk, True, window, q_offset)
    for splits in (1, 4):
        out = flash_decode_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                               window=window, q_offset=q_offset, splits=splits)
        _close(out, ref)
    assert hi == Sk and lo == (0 if window is None else max(0, q_offset - window + 1))


@pytest.mark.parametrize("mask", ["causal", "window", "none"])
@pytest.mark.parametrize("Sq,Sk", [(1, 130), (4, 384), (16, 130)])
def test_result_does_not_depend_on_the_split_count(Sq, Sk, mask):
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 2, Sq, Sk, 8, 2))
    causal = mask != "none"
    window = 40 if mask == "window" else None
    q_offset = Sk - Sq if causal else 0
    outs = [
        flash_decode_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                         splits=s)
        for s in (1, 2, 3, 7, Sk)
    ]
    for out in outs[1:]:
        assert (out - outs[0]).abs().max().item() <= SPLIT_TOL
    full = flash_attention_bshd_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    assert (outs[0] - full).abs().max().item() <= TOL


@pytest.mark.parametrize("splits", [6, 40])
def test_a_range_without_live_keys_adds_exactly_nothing(splits):
    """Sq 4 at decode's position with a 3-key window: the live span is 6
    keys, so at 6 ranges each row keeps keys in some ranges and none in the
    others, and at 40 ranges 34 are empty.  Such a range holds m = -inf,
    l = 0, acc = 0, and the output is finite and the reference's."""

    Sq, Sk, window = 4, 130, 3
    q, k, v = _inputs(11, 2, Sq, Sk, 8, 8)
    q_offset = Sk - Sq
    m, l, acc = decode_partials_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                                    window=window, q_offset=q_offset, splits=splits)
    dead = torch.isinf(m)
    assert dead.any() and (~dead).any()
    assert (m[dead] == -math.inf).all() and (l[dead] == 0).all()
    assert (acc[dead] == 0).all()
    out = combine_splits_ref(m, l, acc, torch.float32)
    assert torch.isfinite(out).all()
    ref = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                      window=window, q_offset=q_offset)
    _close(out, ref)


def test_key_ranges_cut_the_live_span():
    assert key_ranges(1, 1500, False, None, 0, 5) == [
        (0, 300), (300, 600), (600, 900), (900, 1200), (1200, 1500)
    ]
    assert key_ranges(4, 130, True, 3, 126, 4) == [(124, 126), (126, 128), (128, 130), (130, 130)]
    assert live_span(16, 2048, True, None, 0) == (0, 16)
    assert live_span(1, 2048, True, 1024, 2047) == (1024, 2048)
    with pytest.raises(ValueError):
        key_ranges(1, 10, False, None, 0, 0)


# ---------------------------------------------------------------------- #
# The split rule and the route rule: pure functions
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("window", [None, 1, 7, 1024])
@pytest.mark.parametrize("cache_len", [1, 2, 700, 2049, 3071, 3072])
def test_live_span_at_the_decode_position_keeps_the_plain_mask(cache_len, window):
    """Decode attention on the kernel sits its query at ``cache_len - 1``:
    the call's live span is exactly the keys the plain version's
    ``_valid_positions`` keeps, the filled prefix and the window."""

    from repro_torch.models.attention import _valid_positions

    Smax = 3072
    lo, hi = live_span(1, Smax, True, window, cache_len - 1)
    valid = _valid_positions(cache_len, Smax, window, "cpu")[0]
    assert valid.nonzero().flatten().tolist() == list(range(lo, hi))


@pytest.fixture
def fake_entry_points(monkeypatch):
    """``ops._decode_entry_point`` with no library: every entry returns 0,
    the cluster query reports one cluster; the calls are counted by name.
    The kept maps and cluster counts start empty and are emptied after."""

    import collections

    calls = collections.Counter()

    def entry(name):
        def fn(*args):
            calls[name] += 1
            if name == "fa_decode_clusters":
                args[-1]._obj.value = 1
            return 0
        return fn

    monkeypatch.setattr(ops, "_decode_entry_point", entry)
    monkeypatch.setattr(ops, "_DECODE_MAPS", type(ops._DECODE_MAPS)())
    ops._decode_clusters.cache_clear()
    yield calls
    ops._decode_clusters.cache_clear()


@pytest.mark.parametrize("B,KV,G,hd,window", [(256, 4, 8, 128, None), (8, 4, 8, 128, None),
                                              (4, 8, 4, 64, 1024)],
                         ids=["yi6b_pool", "yi6b_small", "granite_window"])
def test_a_decode_step_one_key_longer_encodes_and_queries_nothing(fake_entry_points, B, KV, G,
                                                                  hd, window):
    """The host's per-call work at consecutive decode positions over one
    cache: the tensor maps are encoded once for each layer's cache (they
    read no live span) and the cluster count is queried once for each
    shape, strides, splits and depth; the span itself rides in ``dims``."""

    calls = fake_entry_points
    Smax, layers = 3072, 3
    caches = [tuple(torch.zeros(B, Smax, KV, hd, dtype=torch.bfloat16) for _ in range(2))
              for _ in range(layers)]
    q = torch.zeros(B, 1, KV * G, hd, dtype=torch.bfloat16)
    for step, cache_len in enumerate(range(2049, 2049 + 4)):
        before = dict(calls)
        for k, v in caches:
            shape = (B, 1, KV * G, KV, Smax, hd)
            strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *q.stride()[:3])
            lo, hi = live_span(1, Smax, True, window, cache_len - 1)
            plan = ops._decode_plan(shape, strides, lo, hi, H100_SMS, 0)
            assert list(plan.dims)[6:8] == [lo, hi] == [max(0, cache_len - (window or Smax)),
                                                         cache_len]
            assert plan.splits * list(plan.dims)[8] >= hi - lo
            ops._decode_maps(plan, q, k, v)
        if step == 0:
            assert calls["fa_decode_maps"] == layers and calls["fa_decode_clusters"] == 1
        else:
            assert dict(calls) == before, cache_len


@pytest.mark.parametrize(
    "B,KV,Sk,splits",
    [
        (4, 16, 1500, 4),    # whisper's decode and prompt cross: 64 heads x 4 = 256 blocks
        (4, 16, 4, 1),       # whisper's 4 x 4 prompt self attention: one tile
        (4, 4, 2048, 16),    # yi-6b decode: 16 heads x 16 ranges of 128 keys, 8 in a cluster
        (1, 1, 64, 1),
        (1, 1, 65, 2),
        (64, 16, 1500, 1),   # 1024 heads fill the card alone
        (1, 8, 1, 1),
    ],
)
def test_decode_splits(B, KV, Sk, splits):
    """``splits``: the ranges two blocks an SM would take; the route takes
    at most a cluster's."""

    assert ops.decode_splits(B, KV, Sk, H100_SMS) == min(splits, ops.DECODE_MAX_CLUSTER)


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_decode_splits_plan_is_valid_everywhere(sms):
    """Every range non-empty, the ranges cover the span, at most a
    cluster's ``DECODE_MAX_CLUSTER`` of them and no more than the span's
    64-key tiles, and the blocks within ``DECODE_BLOCKS_PER_SM`` an SM
    (unless one range) and at least half of that wherever the tiles and the
    cap allow.  The grid's ranges are then whole clusters of (1, S, 1): the
    cluster is the grid's second dimension itself."""

    cap = ops.DECODE_MAX_CLUSTER
    for B in (1, 2, 4, 7):
        for KV in (1, 2, 8, 16):
            for Sk in (1, 2, 63, 64, 65, 300, 1500, 2048, 32768):
                tiles = -(-Sk // ops.DECODE_BK)
                want = ops.DECODE_BLOCKS_PER_SM * sms
                S = ops.decode_splits(B, KV, Sk, sms)
                chunk = -(-Sk // S)
                assert 1 <= S <= cap
                assert (S - 1) * chunk < Sk <= S * chunk
                assert S <= tiles
                assert S == 1 or B * KV * S <= want
                assert B * KV * S >= min(want, B * KV * tiles, B * KV * cap) / 2


def _strides(shape):
    B, S, heads, hd = shape
    return (S * heads * hd, heads * hd, hd)


def _kv(Sk, KV, hd):
    return [_strides((4, Sk, KV, hd))] * 2


@pytest.mark.parametrize(
    "dtype,hd,Sq,Sk,H,KV,expect",
    [
        (torch.bfloat16, 64, 1, 1500, 16, 16, "flash_decode"),     # whisper decode cross
        (torch.bfloat16, 64, 4, 1500, 16, 16, "flash_decode"),     # whisper prompt cross
        (torch.bfloat16, 64, 4, 4, 16, 16, "flash_decode"),        # whisper prompt self
        (torch.bfloat16, 64, 1500, 1500, 16, 16, "tma_wgmma"),     # whisper encoder
        (torch.bfloat16, 128, 8, 2048, 32, 4, "flash_decode"),     # yi-6b, 64 rows a KV head
        (torch.bfloat16, 128, 16, 2048, 32, 4, "tma_wgmma"),       # 128 rows a KV head
        (torch.bfloat16, 64, 16, 2048, 32, 8, "flash_decode"),     # granite, 64 rows
        (torch.bfloat16, 64, 17, 1500, 16, 16, "tma_wgmma"),       # above DECODE_MAX_SQ
        (torch.bfloat16, 32, 1, 2048, 4, 4, "tma_wgmma"),          # hd 32: not flash_decode
        (torch.float32, 64, 1, 1500, 16, 16, "tma_wgmma_tf32x3"),  # f32 keeps its route
        (torch.float32, 32, 1, 1500, 16, 16, "tma_wgmma_tf32x3"),
    ],
    ids=["decode_cross", "prompt_cross", "prompt_self", "encoder", "yi6b_8", "yi6b_16",
         "granite_16", "sq_17", "hd32", "f32", "f32_hd32"],
)
def test_route_rule_sends_few_rows_to_flash_decode(dtype, hd, Sq, Sk, H, KV, expect):
    strides = [_strides((4, Sq, H, hd))] + _kv(Sk, KV, hd)
    assert ops.route(dtype, hd, strides, (0, 0, 0), sq=Sq, group=H // KV) == expect
    # without the query rows (the f32 split pass reads k and v alone) the
    # rule is the TMA one
    if expect == "flash_decode":
        assert ops.route(dtype, hd, strides, (0, 0, 0)) == "tma_wgmma"


def test_route_of_misaligned_few_rows_is_cp_async():
    """A few-row call flash_decode cannot read (a base 2 bytes off 16)
    takes the TMA route's rule, now that the cp.async route is gone, and
    the kernel contract refuses it before any launch."""

    flat = torch.zeros(1 * 4 * 2 * 64 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 4 * 2 * 64].view(1, 4, 2, 64)
    aligned = flat[8:8 + 4 * 2 * 64].view(1, 4, 2, 64)
    assert ops._route_of(aligned, aligned, aligned) == "flash_decode"
    assert ops._route_of(shifted, aligned, aligned) == "tma_wgmma"
    with pytest.raises(NotImplementedError, match="offset 2"):
        ops._check_kernel_call(shifted, aligned, aligned, None)


def test_private_switch_times_tma_on_few_rows(monkeypatch):
    q = torch.zeros(4, 1, 16, 64, dtype=torch.bfloat16)
    k = torch.zeros(4, 1500, 16, 64, dtype=torch.bfloat16)
    assert ops._route_of(q, k, k) == "flash_decode"
    monkeypatch.setattr(ops, "_decode_route", False)
    assert ops._route_of(q, k, k) == "tma_wgmma"


def test_route_refuses_another_depth_and_reads_its_plan():
    """The route has one ring depth, ``DECODE_DEPTH`` (fewer stages for a
    range of fewer tiles): another is refused; each depth it runs reads the
    Hopper K-loop plan (the full and the empty mbarrier)."""

    q = torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="flash_decode.*one depth"):
        ops.flash_attention(q, q, q, depth=ops.DECODE_DEPTH + 1)
    assert ops.flash_attention(q, q, q, depth=ops.DECODE_DEPTH).shape == q.shape
    for depth in range(1, ops.DECODE_DEPTH + 1):
        sched = ops._decode_schedule(depth)
        assert sched.depth == depth and sorted(sched.waits) == sorted(ops.DECODE_WAITS)


def test_no_launch_is_counted_on_the_cpu():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(3, 2, 1, 130, 8, 8))
    assert ops._route_of(q, k, v) == "flash_decode"
    before = (dict(ops.flash_attention.routes), ops.flash_attention.launches)
    out = ops.flash_attention(q, k, v, causal=False)
    assert (dict(ops.flash_attention.routes), ops.flash_attention.launches) == before
    ref = flash_decode_ref(q, k, v, causal=False, splits=3)
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2  # bf16 output rounding


@pytest.mark.parametrize("waits", [("full",), ("empty",), ("full", "empty", "credit")],
                         ids=["no_empty", "no_full", "extra"])
def test_route_refuses_a_plan_whose_waits_differ(monkeypatch, waits):
    """The wrapper reads ``hopper_schedule`` at the ring's depth
    (``DECODE_DEPTH``) and raises unless its waits are the kernel's: on the
    CPU too, before the plain version runs."""

    from repro_torch.kernels.pipelined_matmul.ops import HopperSchedule

    q = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 1500, 2, 64, dtype=torch.bfloat16)
    assert ops._route_of(q, k, k) == "flash_decode" and ops.DECODE_DEPTH == 2
    asked = []

    def plan(depth, max_depth=4):
        asked.append((depth, max_depth))
        return HopperSchedule(depth=depth, waits=waits)

    monkeypatch.setattr(ops, "hopper_schedule", plan)
    with pytest.raises(NotImplementedError, match=r"\(flash_decode\).*depth 2 asks for waits"):
        ops.flash_attention(q, k, k, causal=False)
    assert asked == [(2, ops.DECODE_MAX_STAGES)]


@pytest.mark.parametrize(
    "hd,rows", [(64, 1), (64, 16), (64, 32), (64, 64), (128, 1), (128, 32), (128, 64)]
)
def test_decode_ring_depth_keeps_two_blocks_an_sm(hd, rows):
    """At the route's ``DECODE_DEPTH`` two blocks fit in an SM (228 KB, 1
    KB a block the system's), so that a KV head's clusters are placed at
    once; the kernel's deepest ring fits a block; the sizes and limits as
    ``csrc/flash_decode.cu`` has them."""

    import re

    assert 2 * (ops.decode_smem_bytes(hd, rows, ops.DECODE_DEPTH) + 1024) <= 233472
    src = ops.DECODE_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("MAX_STAGES") == ops.DECODE_MAX_STAGES >= ops.DECODE_DEPTH
    assert const("MAX_CLUSTER") == ops.DECODE_MAX_CLUSTER
    assert const("BK") == ops.DECODE_BK
    assert ops.decode_smem_bytes(hd, rows, ops.DECODE_MAX_STAGES) <= const("SMEM_LIMIT")


@pytest.mark.parametrize("mask", ["causal", "window", "none"])
def test_result_does_not_depend_on_the_range_count_up_to_the_cap(mask):
    """The merge of 1 to ``DECODE_MAX_CLUSTER`` ranges, in their order, at
    a whisper-like length: one result within 2e-6, the reference's within
    2e-5."""

    Sq, Sk = 4, 1500
    q, k, v = _inputs(17, 2, Sq, Sk, 8, 2)
    causal = mask != "none"
    window = 300 if mask == "window" else None
    q_offset = Sk - Sq if causal else 0
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    outs = [flash_decode_ref(tq, tk, tv, causal=causal, window=window, q_offset=q_offset,
                             splits=s) for s in range(1, ops.DECODE_MAX_CLUSTER + 1)]
    for out in outs[1:]:
        assert (out - outs[0]).abs().max().item() <= SPLIT_TOL
    ref = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                      window=window, q_offset=q_offset)
    _close(outs[-1], ref)


@pytest.mark.parametrize("at", [0, 2, 5])
def test_an_empty_range_adds_exactly_nothing_under_the_merge_order(at):
    """A range without a live key (m = -inf, l = 0, acc = 0) put anywhere
    among five ranges leaves the merge bit-equal to the merge without it:
    its weight is exp(-inf) = 0 and each running sum adds an exact 0."""

    rng = np.random.default_rng(at)
    m = torch.from_numpy(rng.standard_normal((5, 2, 3, 4)).astype(np.float32))
    m[1, 0, 1] = -math.inf  # and one row empty in another range
    l = torch.from_numpy(rng.random((5, 2, 3, 4)).astype(np.float32) + 0.5)
    l[1, 0, 1] = 0.0
    acc = torch.from_numpy(rng.standard_normal((5, 2, 3, 4, 64)).astype(np.float32))
    acc[1, 0, 1] = 0.0
    ins = lambda x, fill: torch.cat([x[:at], torch.full_like(x[:1], fill), x[at:]])  # noqa: E731
    want = combine_splits_ref(m, l, acc, torch.float32)
    got = combine_splits_ref(ins(m, -math.inf), ins(l, 0.0), ins(acc, 0.0), torch.float32)
    assert torch.equal(got, want) and torch.isfinite(got).all()


def test_combine_splits_on_the_cpu_is_its_plain_version():
    """The plain merge of the ranges (the kernel's cluster merge; no
    combine kernel is left): the bf16 output is the f32 merge rounded, and
    the f32 merge the softmax-weighted sum of the ranges, with one range
    empty for some rows."""

    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.standard_normal((5, 2, 3, 4)).astype(np.float32))
    m[1, 0] = -math.inf
    l = torch.from_numpy(rng.random((5, 2, 3, 4)).astype(np.float32) + 0.5)
    l[1, 0] = 0.0
    acc = torch.from_numpy(rng.standard_normal((5, 2, 3, 4, 64)).astype(np.float32))
    acc[1, 0] = 0.0
    out = combine_splits_ref(m, l, acc, torch.bfloat16)
    assert out.shape == (2, 4, 3, 64) and out.dtype == torch.bfloat16
    f32 = combine_splits_ref(m, l, acc, torch.float32)
    assert torch.equal(out, f32.to(torch.bfloat16))
    w = torch.exp(m.double() - m.double().amax(0))
    want = ((w[..., None] * acc.double()).sum(0) / (w * l.double()).sum(0)[..., None])
    assert (f32.double() - want.transpose(1, 2)).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------- #
# One-hot probes at whisper's cross shapes, on the route's edges
# ---------------------------------------------------------------------- #

def test_split_edge_picks():
    picks = split_edge_picks(1500, 5, 64)
    assert picks[:2].tolist() == [1199, 1200]
    assert sorted(picks[2:].tolist()) == list(range(1456, 1500))  # the last tile's 44 keys
    assert len(split_edge_picks(1500, 5, 10)) == 10
    with pytest.raises(ValueError):
        split_edge_picks(1500, 1, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("identity_v", [False, True])
@pytest.mark.parametrize("Sq", [1, 4])
def test_probes_are_exact_on_the_plain_version_at_the_split_edges(Sq, identity_v, dtype):
    B, Sk, H, KV, hd = 4, 1500, 16, 16, 64
    splits = ops.decode_splits(B, KV, Sk, H100_SMS)
    q, k, v, expected = one_hot_probe(
        B, Sq, Sk, H, KV, hd, causal=False, identity_v=identity_v, seed=Sq,
        first_picks=split_edge_picks(Sk, splits, B * H * Sq),
    )
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    out = flash_decode_ref(q, k, v, causal=False, splits=splits)
    assert torch.equal(out.float(), torch.from_numpy(expected))
    # the last key dropped: the rows that picked it miss
    dropped = flash_decode_ref(q, k[:, :-1], v[:, :-1], causal=False, splits=splits)
    assert int((dropped.float() != torch.from_numpy(expected)).any(-1).sum()) >= 1
