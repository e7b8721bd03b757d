"""Attention: GQA projections, streaming-softmax attention, decode attention
against a KV cache (bf16 or int8), as the reference's ``models/attention.py``.

``chunked_attention`` is the prefill / train-mode attention.  On a CPU
tensor it runs the plain version, the reference's streaming log-sum-exp
over KV chunks (:func:`chunked_attention_plain`), and so does every call
that needs a gradient (the kernel has no backward; the reference trains
through its jnp version too).  Otherwise, on a CUDA tensor, it is
the hand-written flash-attention kernel
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`), the
reference Pallas kernel's counterpart; a call outside the kernel's contract
raises ``NotImplementedError`` naming the argument and never runs the plain
version instead.

``decode_attention`` is plain PyTorch in the reference.  Here a call that
the flash kernel's rule sends to its few-row ``flash_decode`` route takes
the kernel (:func:`decode_takes_kernel`: CUDA operands the rule admits, a
Python-int ``cache_len`` and a cache whose sequence is not split over
ranks).  The kernel reads the cache in place, by stride, and only its live
keys, bounded by the query's position ``cache_len - 1`` and the window;
the plain version's two ``einsum``s lay the whole cache out again in every
layer and step.  Every other call (CPU, f32, another head dim, a tensor
``cache_len``, whose value the host would have to wait for, or a
sequence-sharded cache) takes the plain version, counted on CUDA in
``attention.decode_plain_calls``; a kernel call outside the kernel's
contract raises, as in ``chunked_attention``.  The int8 cache's
``decode_attention_q`` is plain.

The KV-cache updates write into the cache tensors in place (the
reference's ``dynamic_update_slice`` copies): at full size a copy per
layer and token would move the whole cache.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded
from repro_torch.models.layers import apply_rope, normal  # noqa: F401
from repro_torch.obs import metrics

NEG_INF = -1e30
TRAIN_PLAIN_CALLS = metrics.counter("attention.train_plain_calls")
DECODE_PLAIN_CALLS = metrics.counter("attention.decode_plain_calls")


def attn_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, KV, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    H, Hp = cfg.num_heads, cfg.padded_num_heads
    dtype = getattr(torch, cfg.dtype)
    s = d**-0.5
    so = (H * hd) ** -0.5
    wq = normal(generator, (d, Hp, hd), s, dtype)
    wk = normal(generator, (d, KV, hd), s, dtype)
    wv = normal(generator, (d, KV, hd), s, dtype)
    wo = normal(generator, (Hp, hd, d), so, dtype)
    if Hp != H:
        wo[H:] = 0  # padded query heads: zero wo rows → exactly no contribution
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def _einsum(spec: str, x, w):
    """``torch.einsum(spec, x, w)``; on DTensors a local product
    (:func:`repro_torch.models.sharded.product`)."""

    return sharded.product(lambda a, b: torch.einsum(spec, a, b), spec, x, w)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) · (d,H,hd) → (B,S,H,hd)."""

    return _einsum("bsd,dhk->bshk", x, w)


def qkv_project(
    params: dict, x: torch.Tensor, kv_x: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    kv_x = x if kv_x is None else kv_x
    q = project(x, params["wq"])
    k = project(kv_x, params["wk"])
    v = project(kv_x, params["wv"])
    return q, k, v


def out_project(params: dict, o: torch.Tensor) -> torch.Tensor:
    return _einsum("bshk,hkd->bsd", o, params["wo"])


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """GQA: repeat KV heads to match query heads (B,S,KV,hd)→(B,S,H,hd)."""

    kv = k.shape[2]
    if kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // kv, dim=2)


# ---------------------------------------------------------------------- #
# streaming-softmax attention (train / prefill)
# ---------------------------------------------------------------------- #

def chunked_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """The reference's streaming softmax over KV chunks, op for op: scores
    in the operands' dtype then f32, ``p`` cast to the value dtype before
    the PV product, f32 running max / sum / accumulator."""

    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = hd**-0.5
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        lo = idx * chunk
        kb, vb = k[:, lo : lo + chunk], v[:, lo : lo + chunk]
        k_pos = lo + torch.arange(kb.shape[1], device=dev)
        s = torch.einsum("bqhk,bchk->bhqc", q, kb).float() * scale
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqc,bchk->bhqk", p.to(vb.dtype), vb
        ).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,H,hd)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Streaming-softmax attention.

    q (B,Sq,H,hd); k,v (B,Sk,KV,hd).  ``window`` enables sliding-window
    masking (keys within [pos-window+1, pos]).  ``q_offset`` positions the
    query block inside the key space (prefill continuation).  A call whose
    inputs require grad (grad enabled) takes :func:`chunked_attention_plain`
    under autograd on any device, counted in ``attention.train_plain_calls``;
    otherwise CPU tensors take the plain version and CUDA tensors the flash
    kernel, whose tiles replace ``chunk``.  DTensor operands run this on
    their local shards (:func:`repro_torch.models.sharded.attention`), so
    the kernel sees plain tensors.
    """

    return sharded.attention(
        functools.partial(
            _chunked_attention, causal=causal, window=window, chunk=chunk, q_offset=q_offset
        ),
        q, k, v,
    )


def _chunked_attention(q, k, v, *, causal, window, chunk, q_offset):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel has no backward (nor has the reference's Pallas kernel)
        TRAIN_PLAIN_CALLS.inc()
        return chunked_attention_plain(
            q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset
        )
    if q.device.type == "cpu":
        return chunked_attention_plain(
            q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset
        )
    from repro_torch.kernels.flash_attention import ops

    return ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Quadratic oracle."""

    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bqhk,bshk->bhqs", q, k).float() * hd**-0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bshk->bqhk", p.to(v.dtype), v)
    return o.to(q.dtype)


# ---------------------------------------------------------------------- #
# decode attention against a KV cache
# ---------------------------------------------------------------------- #

def _valid_positions(cache_len, smax: int, window: Optional[int], device) -> torch.Tensor:
    """(B or 1, Smax) mask of the filled cache prefix (and the window).  A
    Python-int ``cache_len`` stays a scalar operand: no host-to-device copy,
    which would wait for the device on every layer."""

    pos = torch.arange(smax, device=device)
    if not isinstance(cache_len, int):
        cache_len = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    valid = pos[None, :] < cache_len
    if window is not None:
        valid &= pos[None, :] > (cache_len - 1 - window)
    return valid


def decode_takes_kernel(device_type: str, q, k_cache, v_cache, cache_len,
                        seq_sharded: bool) -> bool:
    """Whether a decode call takes the flash kernel, from what the call
    sees of its operands: a CUDA ``device_type``, q, k and v that the
    kernel's rule sends to its ``flash_decode`` route
    (:func:`ops.takes_flash_decode`: bf16, head dim, rows a KV head,
    alignment), ``cache_len`` a Python int (a tensor's value would wait on
    the device) and a cache that does not split its sequence over ranks."""

    from repro_torch.kernels.flash_attention import ops

    return (
        device_type == "cuda"
        and isinstance(cache_len, int)
        and not seq_sharded
        and ops.takes_flash_decode(q, k_cache, v_cache)
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-step attention: q (B,1,H,hd) vs cache (B,Smax,KV,hd).

    ``cache_len`` (an int, a 0-d tensor or a (B,) tensor) marks the filled
    prefix (the new token's KV must already be written at cache_len-1).
    A call :func:`decode_takes_kernel` admits is ``ops.flash_attention``
    over the whole cache at query position ``cache_len - 1``, which bounds
    its keys to the filled prefix (and the window), on the flash_decode
    route (on tma_wgmma where chip_smoke.py's A/B clears
    ``ops._decode_route``); every other call is the plain
    version, a grouped-GQA contraction that never repeats the cache to H
    heads.  DTensor operands run on their local shards unless the cache
    splits its sequence (then DTensor's rules reduce the softmax across
    shards, on the plain version).
    """

    body = functools.partial(_decode_attention, cache_len=cache_len, window=window)
    if sharded.seq_sharded(k_cache):
        return body(q, k_cache, v_cache, seq_sharded=True)
    return sharded.attention(body, q, k_cache, v_cache)


def _decode_attention(q, k_cache, v_cache, *, cache_len, window, seq_sharded=False):
    if decode_takes_kernel(q.device.type, q, k_cache, v_cache, cache_len, seq_sharded):
        from repro_torch.kernels.flash_attention import ops

        return ops.flash_attention(
            q, k_cache, v_cache, causal=True, window=window, q_offset=cache_len - 1
        )
    if q.device.type == "cuda":
        DECODE_PLAIN_CALLS.inc()
    return decode_attention_plain(q, k_cache, v_cache, cache_len=cache_len, window=window)


def decode_attention_plain(q, k_cache, v_cache, *, cache_len, window):
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float()
    s = s * hd**-0.5  # (B,KV,G,1,S)
    valid = _valid_positions(cache_len, Smax, window, q.device)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _start(start, sn: int, smax: int) -> int:
    """``dynamic_update_slice``'s start: clamped so the update fits."""

    return min(max(int(start), 0), smax - sn)


def update_kv_cache(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    start,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new (B,Sn,KV,hd) into the caches at position ``start``
    (in place); returns the caches."""

    i = _start(start, k_new.shape[1], k_cache.shape[1])
    sharded.write_cache(_write, [k_cache, v_cache], [k_new, v_new], i)
    return k_cache, v_cache


def _write(caches, news, i: int) -> None:
    for c, n in zip(caches, news):
        c[:, i : i + n.shape[1]] = n.to(c.dtype)


# ---------------------------------------------------------------------- #
# int8-quantized KV cache
# ---------------------------------------------------------------------- #

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,S,KV,hd) → (int8 values, per-(token,head) f32 scales (B,S,KV,1))."""

    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def decode_attention_q(
    q: torch.Tensor,
    cache: dict,
    cache_len,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-step attention against the int8 cache without a dequantized
    copy: the per-(token,head) scales factor out of the head_dim
    contraction (applied to the scores for K, folded into the
    probabilities for V).  DTensor operands run as
    :func:`decode_attention`'s do."""

    body = functools.partial(_decode_attention_q, cache_len=cache_len, window=window)
    parts = (cache["k_q"], cache["k_s"], cache["v_q"], cache["v_s"])
    if sharded.seq_sharded(cache["k_q"]):
        return body(q, *parts)
    return sharded.attention(body, q, *parts)


def _decode_attention_q(q, kq, ks, vq, vs, *, cache_len, window):
    # kq, vq (B,S,KV,hd) int8; ks, vs (B,S,KV,1) scales
    B, _, H, hd = q.shape
    Smax, KV = kq.shape[1], kq.shape[2]
    G = H // KV
    qg = q.float().reshape(B, 1, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kq.float())
    scale_k = ks[..., 0].transpose(1, 2)[:, :, None, None, :]  # (B,KV,1,1,S)
    s = s * scale_k * hd**-0.5
    valid = _valid_positions(cache_len, Smax, window, q.device)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    scale_v = vs[..., 0].transpose(1, 2)[:, :, None, None, :]
    o = torch.einsum("bkgqs,bskd->bqkgd", p * scale_v, vq.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def update_kv_cache_q(
    cache: dict, k_new: torch.Tensor, v_new: torch.Tensor, start
) -> dict:
    """Quantized-cache update (in place): the cache holds ``k_q``/``v_q``
    int8 and ``k_s``/``v_s`` scales."""

    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    i = _start(start, k_new.shape[1], cache["k_q"].shape[1])
    names = ("k_q", "k_s", "v_q", "v_s")
    sharded.write_cache(_write, [cache[n] for n in names], [kq, ks, vq, vs], i)
    return cache
