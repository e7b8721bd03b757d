"""Plain PyTorch version of the flash-attention kernel (the reference's
``flash_attention_ref``): quadratic softmax attention over ``(BH, S, hd)``
in f32, cast back to the input dtype."""

from __future__ import annotations

from typing import Optional

NEG_INF = -1e30


def flash_attention_ref(
    q,  # (BH, Sq, hd)
    k,  # (BH, Sk, hd)
    v,  # (BH, Sk, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
):
    import torch

    hd = q.shape[-1]
    s = torch.einsum("bqk,bsk->bqs", q.float(), k.float())
    s = s * hd**-0.5
    Sq, Sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsk->bqk", p, v.float()).to(q.dtype)


def flash_attention_bshd_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """The same function over the wrapper's layout: q ``(B, Sq, H, hd)``,
    k/v ``(B, Sk, KV, hd)`` with GQA, as the reference's ``ops.py`` folds
    it (KV heads repeated, heads folded into the leading dimension)."""

    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).reshape(B * H, k.shape[1], hd)
    vf = v.transpose(1, 2).reshape(B * H, v.shape[1], hd)
    of = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return of.reshape(B, H, Sq, hd).transpose(1, 2)
