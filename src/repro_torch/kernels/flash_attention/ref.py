"""Plain PyTorch versions of the flash-attention kernels: the reference's
``flash_attention_ref`` (quadratic softmax attention over ``(BH, S, hd)``
in f32, cast back to the input dtype), its 3xTF32 emulation, the 3xTF32
route's K / V split, and the ``flash_decode`` route's split-key partials
and their merge."""

from __future__ import annotations

import math
from typing import Optional

NEG_INF = -1e30

# Vᵀ's keys in each group of 8, as the split writes them: k-position p of an
# 8-key step of the PV product holds key KEY_ORDER[p].  The f32 accumulator
# of S gives a thread keys (2t, 2t + 1) of each group (t = lane % 4); the
# tf32 A fragment of wgmma m64nNk8 reads k-positions (t, t + 4); so the
# accumulator taken as it stands puts key 2t at position t and 2t + 1 at
# t + 4, which is this order.
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _keep(Sq: int, Sk: int, causal: bool, window: Optional[int], q_offset: int, device):
    """The (Sq, Sk) mask of the keys each query keeps; query i sits at
    position ``q_offset + i``."""

    import torch

    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(
    q,  # (BH, Sq, hd)
    k,  # (BH, Sk, hd)
    v,  # (BH, Sk, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
):
    """``scale`` multiplies the scores: ``hd**-0.5`` by default."""

    import torch

    hd = q.shape[-1]
    s = torch.einsum("bqk,bsk->bqs", q.float(), k.float())
    s = s * (hd**-0.5 if scale is None else scale)
    mask = _keep(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsk->bqk", p, v.float()).to(q.dtype)


def _fold(q, k, v):
    """q ``(B, Sq, H, hd)`` and GQA k, v ``(B, Sk, KV, hd)`` as the
    reference's ``ops.py`` folds them: KV heads repeated, heads folded into
    the leading dimension."""

    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).reshape(B * H, k.shape[1], hd)
    vf = v.transpose(1, 2).reshape(B * H, v.shape[1], hd)
    return qf, kf, vf


def flash_attention_bshd_ref(
    q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
    scale: Optional[float] = None,
):
    """The same function over the wrapper's layout: q ``(B, Sq, H, hd)``,
    k/v ``(B, Sk, KV, hd)`` with GQA."""

    B, Sq, H, hd = q.shape
    of = flash_attention_ref(
        *_fold(q, k, v), causal=causal, window=window, q_offset=q_offset, scale=scale
    )
    return of.reshape(B, H, Sq, hd).transpose(1, 2)


def flash_attention_tf32x3_ref(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    terms: int = 3,
):
    """An emulation of the 3xTF32 route over the wrapper's layout (f32 in
    and out): every operand split as ``hi = rna_tf32(x)``, ``lo =
    rna_tf32(x - hi)``, S = (Q_lo K_hiᵀ + Q_hi K_loᵀ) + Q_hi K_hiᵀ and PV =
    (P_lo V_hi + P_hi V_lo) + P_hi V_hi, each product of TF32 values (exact
    in f32) summed in f32, and the softmax in f32 between them.  ``terms=1``
    keeps only hi·hi: one TF32 product, as TF32 matmuls compute."""

    import torch

    from repro_torch.kernels.pipelined_matmul.ref import rna_tf32_ref

    if terms not in (1, 3):
        raise ValueError(f"terms={terms}: 3 (3xTF32) or 1 (TF32)")
    B, Sq, H, hd = q.shape

    def split(x):
        hi = rna_tf32_ref(x)
        return hi, rna_tf32_ref(x - hi)

    def product(a, b):  # a (n, i, j) @ b (n, j, k) in the split terms
        a_hi, a_lo = split(a.contiguous())
        b_hi, b_lo = split(b.contiguous())
        out = torch.bmm(a_hi, b_hi)
        if terms == 3:
            out = (torch.bmm(a_lo, b_hi) + torch.bmm(a_hi, b_lo)) + out
        return out

    qf, kf, vf = (t.float() for t in _fold(q, k, v))
    s = product(qf, kf.transpose(1, 2)) * hd**-0.5
    mask = _keep(Sq, k.shape[1], causal, window, q_offset, q.device)
    p = torch.softmax(torch.where(mask[None], s, NEG_INF), dim=-1)
    of = product(p, vf)
    return of.reshape(B, H, Sq, hd).transpose(1, 2)


def split_kv_tf32_ref(k, v):
    """``(k_hi, k_lo, vt_hi, vt_lo)`` of f32 k, v ``(B, Sk, KV, hd)``, as
    the 3xTF32 route's pre-pass writes them: ``k_*`` ``(B, KV, Sk, hd)``;
    ``vt_*`` ``(B, KV, hd, Sk8)``, Vᵀ with Sk rounded up to 8 by zero keys
    and the keys of each group of 8 in :data:`KEY_ORDER`; hi =
    rna_tf32(x), lo = rna_tf32(x - hi)."""

    import torch

    from repro_torch.kernels.pipelined_matmul.ref import rna_tf32_ref

    B, Sk, KV, hd = k.shape
    sk8 = -(-Sk // 8) * 8
    kt = k.permute(0, 2, 1, 3).contiguous()
    vt = torch.zeros(B, KV, hd, sk8, dtype=v.dtype, device=v.device)
    vt[..., :Sk] = v.permute(0, 2, 3, 1)
    order = torch.tensor(KEY_ORDER, device=v.device)
    vt = vt.reshape(B, KV, hd, sk8 // 8, 8)[..., order].reshape(B, KV, hd, sk8)
    out = []
    for x in (kt, vt):
        hi = rna_tf32_ref(x)
        out += [hi, rna_tf32_ref(x - hi)]
    return tuple(out)


def pad_head_dim(x, to: int):
    """``x (..., hd)`` with zeros appended to ``to`` along the head dim: a
    query or key of zeros there adds 0 to every score, a value of zeros
    there fills output columns that are sliced away."""

    import torch

    return torch.nn.functional.pad(x, (0, to - x.shape[-1]))


def live_span(Sq: int, Sk: int, causal: bool, window: Optional[int], q_offset: int):
    """The keys ``[lo, hi)`` that some query row of a call keeps: rows sit
    at positions ``q_offset .. q_offset + Sq - 1``, so the last row's causal
    edge and the first row's window edge bound them."""

    lo, hi = 0, Sk
    if causal:
        hi = max(0, min(Sk, q_offset + Sq))
    if window is not None:
        lo = min(hi, max(0, q_offset - window + 1))
    return lo, hi


def key_ranges(Sq: int, Sk: int, causal: bool, window: Optional[int], q_offset: int,
               splits: int):
    """The ``splits`` contiguous key ranges ``[k0, k1)`` of the
    ``flash_decode`` route: the call's :func:`live_span` cut into ranges of
    ``ceil(span / splits)`` keys, the last ones possibly short or empty."""

    if splits < 1:
        raise ValueError(f"splits={splits} < 1")
    lo, hi = live_span(Sq, Sk, causal, window, q_offset)
    chunk = max(1, -(-(hi - lo) // splits))
    return [(min(hi, lo + s * chunk), min(hi, lo + (s + 1) * chunk)) for s in range(splits)]


def decode_partials_ref(q, k, v, *, causal: bool, window: Optional[int], q_offset: int,
                        splits: int, scale: Optional[float] = None):
    """The ``flash_decode`` route's first step over q ``(B, Sq, H, hd)`` and
    k, v ``(B, Sk, KV, hd)``: for each range of :func:`key_ranges` and each
    query row, the f32 max ``m`` of its scores (scaled by ``hd**-0.5``),
    ``l`` the sum of ``p = exp(s - m)`` and ``acc = p v`` unnormalised, with
    P rounded to the value dtype before the product (bf16 for bf16
    operands, as ``chunked_attention`` casts p).  A range with no live key
    for a row gives ``m = -inf``, ``l = 0`` and ``acc = 0``.  Returns ``(m,
    l, acc)``: ``(splits, B, H, Sq)`` twice and ``(splits, B, H, Sq, hd)``,
    f32."""

    import torch

    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qf, kf, vf = (t.float() for t in _fold(q, k, v))  # (B*H, S, hd)
    s_all = torch.einsum("bqd,bkd->bqk", qf, kf) * (hd**-0.5 if scale is None else scale)
    keep = _keep(Sq, Sk, causal, window, q_offset, q.device)
    ms, ls, accs = [], [], []
    for k0, k1 in key_ranges(Sq, Sk, causal, window, q_offset, splits):
        s = s_all[:, :, k0:k1].masked_fill(~keep[None, :, k0:k1], -math.inf)
        m = s.amax(dim=-1) if k1 > k0 else s.new_full(s.shape[:2], -math.inf)
        base = torch.where(m == -math.inf, 0.0, m)
        p = torch.exp(s - base[..., None])  # a masked score gives exp(-inf) = 0
        l = p.sum(dim=-1)
        acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), vf[:, k0:k1])
        ms.append(m.reshape(B, H, Sq))
        ls.append(l.reshape(B, H, Sq))
        accs.append(acc.reshape(B, H, Sq, hd))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_splits_ref(m, l, acc, dtype):
    """The ``flash_decode`` route's merge of its key ranges, in the kernel's
    order: ``M`` the largest ``m_s``; then range by range from the first,
    each range's weight ``w = exp(m_s - M)`` (0 for a range with ``m_s =
    -inf``), ``L += w l_s`` and ``o += w acc_s``; the output ``o`` times
    ``1 / max(L, 1e-30)``.  ``m``, ``l`` ``(splits, B, H, Sq)`` and ``acc``
    ``(splits, B, H, Sq, hd)`` in f32; returns the output ``(B, Sq, H, hd)``
    in ``dtype``.  A range with no live key for a row adds exactly 0 to it;
    a row with none in any range comes out 0."""

    import torch

    M = m.amax(dim=0)
    base = torch.where(M == -math.inf, 0.0, M)
    L = torch.zeros_like(M)
    o = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        w = torch.exp(m[s] - base)  # exp(-inf) = 0
        L = L + w * l[s]
        o = o + w[..., None] * acc[s]
    o = o * (1.0 / L.clamp_min(1e-30))[..., None]
    return o.transpose(1, 2).to(dtype)


def flash_decode_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                     q_offset: int = 0, splits: int = 1, _scale: Optional[float] = None):
    """The ``flash_decode`` route step by step (:func:`decode_partials_ref`
    over ``splits`` key ranges, one block of a cluster each, then their
    merge in the kernel's order, :func:`combine_splits_ref`): the same
    function as :func:`flash_attention_bshd_ref` wherever every row keeps a
    key, whatever ``splits`` is."""

    return combine_splits_ref(
        *decode_partials_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                             splits=splits, scale=_scale),
        q.dtype,
    )
