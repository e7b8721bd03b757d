"""repro_torch.models.{layers,attention} held against the reference.

The same parameters and inputs, drawn with NumPy from a seed, go through
the reference's JAX functions and the port's.  f32 comparisons hold to
2e-5 unless stated (the two frameworks sum in other orders); bf16 ones to
3e-2, the kernels' tolerance.  On the CPU ``chunked_attention`` is its
plain streaming version; its CUDA route (the flash kernel) is held against
that version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers

from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

F32 = 2e-5
BF16 = 3e-2


def _pair(a, dtype="float32"):
    """The NumPy array ``a`` as a (jax, torch) pair in ``dtype``."""

    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _close(port, ref, tol=F32):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol
    )


def _qkv(seed, B, Sq, Sk, H, KV, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    return [
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
    ]


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((2, 5, 32)), dtype)
    scale = rng.standard_normal(32).astype(np.float32)
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    out = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6)
    assert out.dtype == tx.dtype
    _close(out, ref, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 7, 3, 16)))
    pos = np.arange(3, 10)
    _close(
        tlayers.rope_frequencies(16, theta), jlayers.rope_frequencies(16, theta), 1e-6
    )
    ref = jlayers.apply_rope(jx, jnp.asarray(pos), theta)
    out = tlayers.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("arch", ["yi_6b", "granite_3_2b"])  # 256 and 251 → 512 rows
def test_embed_and_unembed_mask_the_padded_vocab(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    rng = np.random.default_rng(2)
    V, d = jcfg.padded_vocab_size, jcfg.d_model
    params = {
        "tok": (0.02 * rng.standard_normal((V, d))).astype(np.float32),
        "head": (0.02 * rng.standard_normal((d, V))).astype(np.float32),
    }
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    toks = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    x_ref = jlayers.embed(jp, jnp.asarray(toks))
    x = tlayers.embed(tp, torch.from_numpy(toks))
    _close(x, x_ref, 0)
    ref = jlayers.unembed(jp, x_ref, jcfg)
    out = tlayers.unembed(tp, x, tcfg)
    _close(out, ref)
    assert (out[..., jcfg.vocab_size:] == -1e30).all()
    tied = jcfg.scaled(tie_embeddings=True)
    _close(
        tlayers.unembed(tp, x, tcfg.scaled(tie_embeddings=True)),
        jlayers.unembed(jp, x_ref, tied),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    rng = np.random.default_rng(3)
    params = {
        name: (rng.standard_normal(shape) * 0.1).astype(np.float32)
        for name, shape in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))
    }
    pairs = {name: _pair(w, dtype) for name, w in params.items()}
    jx, tx = _pair(rng.standard_normal((2, 5, 32)), dtype)
    ref = jlayers.mlp({k: v[0] for k, v in pairs.items()}, jx)
    out = tlayers.mlp({k: v[1] for k, v in pairs.items()}, tx)
    _close(out, ref, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked else None
    ref = jlayers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask),
    )
    out = tlayers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask),
    )
    _close(out, ref, 1e-5)


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #

def test_qkv_and_out_projections():
    rng = np.random.default_rng(5)
    shapes = {"wq": (32, 4, 8), "wk": (32, 2, 8), "wv": (32, 2, 8), "wo": (4, 8, 32)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jx, tx = _pair(rng.standard_normal((2, 5, 32)))
    for ref, out in zip(jattn.qkv_project(jp, jx), tattn.qkv_project(tp, tx)):
        _close(out, ref)
    jq, tq = jattn.qkv_project(jp, jx)[0], tattn.qkv_project(tp, tx)[0]
    _close(tattn.out_project(tp, tq), jattn.out_project(jp, jq))


@pytest.mark.parametrize("chunk", [16, 48, 1024])
@pytest.mark.parametrize(
    "causal,window,q_offset",
    [(True, None, 0), (True, 24, 0), (False, None, 0), (True, None, 16)],
    ids=["causal", "window", "full", "q_offset"],
)
def test_chunked_attention(chunk, causal, window, q_offset):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(6, 2, 40, 56, 4, 2, 16)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    ref = jattn.chunked_attention(jq, jk, jv, **kw)
    out = tattn.chunked_attention(tq, tk, tv, **kw)
    assert out.shape == tq.shape
    _close(out, ref)


def test_chunked_attention_bf16():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(7, 2, 64, 64, 4, 2, 16, "bfloat16")
    ref = jattn.chunked_attention(jq, jk, jv, causal=True, chunk=16)
    out = tattn.chunked_attention(tq, tk, tv, causal=True, chunk=16)
    assert out.dtype == torch.bfloat16
    _close(out, ref, BF16)


@pytest.mark.parametrize("window", [None, 10])
def test_attention_reference(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(8, 2, 24, 24, 4, 1, 16)
    ref = jattn.attention_reference(jq, jk, jv, causal=True, window=window)
    out = tattn.attention_reference(tq, tk, tv, causal=True, window=window)
    _close(out, ref)


@pytest.mark.parametrize(
    "causal,window,q_offset",
    [(True, None, 16), (True, 24, 16), (True, 30, 40), (False, 24, 8), (False, None, 16)],
    ids=["causal", "causal_window", "causal_window_far", "window", "full"],
)
@pytest.mark.parametrize("hd", [64, 32])
def test_flash_attention_takes_q_offset_as_the_reference(causal, window, q_offset, hd):
    """The flash wrapper's ``q_offset`` (query i at position q_offset + i,
    on every CUDA route and in its plain version) against the reference's
    chunked_attention and quadratic oracle with the same offset; every row
    keeps at least one key."""

    (jq, tq), (jk, tk), (jv, tv) = _qkv(14, 2, 40, 56, 4, 2, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_ops.flash_attention(tq, tk, tv, **kw)
    assert out.shape == tq.shape
    _close(out, jattn.chunked_attention(jq, jk, jv, chunk=16, **kw))
    _close(out, jattn.attention_reference(jq, jk, jv, **kw))
    _close(tattn.chunked_attention(tq, tk, tv, chunk=16, **kw), out)


@pytest.mark.parametrize(
    "cache_len", [9, np.array([3, 9, 12], np.int32)], ids=["scalar", "per_row"]
)
@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(cache_len, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(9, 3, 1, 12, 4, 2, 16)
    ref = jattn.decode_attention(jq, jk, jv, jnp.asarray(cache_len), window=window)
    out = tattn.decode_attention(
        tq, tk, tv, torch.as_tensor(cache_len), window=window
    )
    _close(out, ref)


# (device, (q, k, v dtypes), hd, cache_len, seq_sharded, H / KV, k / v
# rows padded by) → takes the kernel
BF16_QKV = (torch.bfloat16,) * 3
DECODE_DISPATCH = {
    "bf16_hd64_int": (("cuda", BF16_QKV, 64, 2049, False, 4, 0), True),
    "bf16_hd128_int": (("cuda", BF16_QKV, 128, 3072, False, 8, 0), True),
    "bf16_hd128_first_slot": (("cuda", BF16_QKV, 128, 1, False, 8, 0), True),
    "bf16_64_rows_a_kv_head": (("cuda", BF16_QKV, 128, 9, False, 64, 0), True),
    "f32": (("cuda", (torch.float32,) * 3, 128, 2049, False, 8, 0), False),
    "bf16_q_f32_cache": (("cuda", (torch.bfloat16, torch.float32, torch.float32), 128, 9,
                          False, 8, 0), False),
    "hd32": (("cuda", BF16_QKV, 32, 2049, False, 8, 0), False),
    "hd16": (("cuda", BF16_QKV, 16, 2049, False, 8, 0), False),
    "hd8": (("cuda", BF16_QKV, 8, 2049, False, 8, 0), False),
    "tensor_0d": (("cuda", BF16_QKV, 128, torch.tensor(2049), False, 8, 0), False),
    "tensor_per_row": (("cuda", BF16_QKV, 128, torch.tensor([3, 9]), False, 8, 0), False),
    "seq_sharded": (("cuda", BF16_QKV, 128, 2049, True, 8, 0), False),
    "cpu": (("cpu", BF16_QKV, 128, 2049, False, 8, 0), False),
    "bf16_128_rows_a_kv_head": (("cuda", BF16_QKV, 128, 9, False, 128, 0), False),
    "cache_rows_off_16_bytes": (("cuda", BF16_QKV, 128, 9, False, 8, 1), False),
}


@pytest.mark.parametrize("case", sorted(DECODE_DISPATCH))
def test_decode_dispatch_rule(case):
    """``decode_takes_kernel``: CUDA operands that the flash kernel's rule
    sends to flash_decode (bf16, hd 64 or 128, at most 64 rows a KV head,
    16-byte rows) with a Python-int ``cache_len`` over a cache that is not
    sequence-sharded take the kernel; every other call the plain version."""

    (device, dtypes, hd, cache_len, seq_sharded, group, pad), kernel = DECODE_DISPATCH[case]
    KV = 2
    q = torch.zeros(2, 1, KV * group, hd, dtype=dtypes[0])
    k, v = (torch.zeros(2, 16, KV, hd + pad, dtype=d)[..., pad:] for d in dtypes[1:])
    assert tattn.decode_takes_kernel(device, q, k, v, cache_len, seq_sharded) is kernel


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_attention_stays_plain_on_the_cpu(hd, window):
    """A bf16 call at a kernel head dim with an int ``cache_len`` on the
    CPU is the plain version, bit for bit: no launch, and
    ``attention.decode_plain_calls`` (CUDA calls only) stays where it was."""

    (_, tq), (_, tk), (_, tv) = _qkv(15, 2, 1, 12, 4, 2, hd, "bfloat16")
    plain = tattn.DECODE_PLAIN_CALLS.value
    launches = flash_ops.flash_attention.launches
    out = tattn.decode_attention(tq, tk, tv, 9, window=window)
    assert torch.equal(out, tattn.decode_attention_plain(tq, tk, tv, cache_len=9, window=window))
    assert tattn.DECODE_PLAIN_CALLS.value == plain
    assert flash_ops.flash_attention.launches == launches


def test_update_kv_cache_matches_dynamic_update_slice():
    (jn, tn), (jc, tc), _ = _qkv(10, 2, 3, 10, 2, 2, 8)
    (jcv, tcv), _, _ = _qkv(11, 2, 10, 10, 2, 2, 8)
    jcache = (jc, jcv)
    tcache = (tc.clone(), tcv.clone())
    for start in (0, 4, 9):  # 9 is clamped to 7, as dynamic_update_slice does
        ref = jattn.update_kv_cache(*jcache, jn, jn, start)
        out = tattn.update_kv_cache(*(t.clone() for t in tcache), tn, tn, start)
        for o, r in zip(out, ref):
            _close(o, r, 0)


def test_int8_cache_round_trip():
    rng = np.random.default_rng(12)
    jx, tx = _pair(rng.standard_normal((2, 5, 2, 16)) * 3)
    jq8, js = jattn.quantize_kv(jx)
    tq8, ts = tattn.quantize_kv(tx)
    assert tq8.dtype == torch.int8
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    _close(ts, js, 1e-7)
    _close(
        tattn.dequantize_kv(tq8, ts, torch.float32),
        jattn.dequantize_kv(jq8, js, jnp.float32),
        1e-6,
    )


@pytest.mark.parametrize("window", [None, 3])
def test_int8_cache_update_and_decode(window):
    B, S, KV, hd, H = 2, 10, 2, 16, 4
    rng = np.random.default_rng(13)
    jcache = {
        "k_q": jnp.zeros((B, S, KV, hd), jnp.int8),
        "k_s": jnp.zeros((B, S, KV, 1), jnp.float32),
        "v_q": jnp.zeros((B, S, KV, hd), jnp.int8),
        "v_s": jnp.zeros((B, S, KV, 1), jnp.float32),
    }
    tcache = {k: tensor_from_numpy(v, "cpu") for k, v in jcache.items()}
    for start, n in ((0, 6), (6, 1), (7, 1)):
        jk, tk = _pair(rng.standard_normal((B, n, KV, hd)))
        jv, tv = _pair(rng.standard_normal((B, n, KV, hd)))
        jcache = jattn.update_kv_cache_q(jcache, jk, jv, start)
        tcache = tattn.update_kv_cache_q(tcache, tk, tv, start)
    for name in jcache:
        _close(tcache[name], jcache[name], 1e-7)
    jq, tq = _pair(rng.standard_normal((B, 1, H, hd)))
    ref = jattn.decode_attention_q(jq, jcache, 8, window=window)
    out = tattn.decode_attention_q(tq, tcache, 8, window=window)
    _close(out, ref, 1e-5)
