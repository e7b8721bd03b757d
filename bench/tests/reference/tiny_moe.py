"""Plain PyTorch reference of the test fixture's family
(``tests/families/tiny_moe.py``): a decoder whose layers alternate a dense
SwiGLU MLP and a mixture of experts with shared experts, in the shape of
the port's ``deepseek_moe_16b.smoke_config``.  It imports nothing of the
program; the attention, the norms and the products are the dense
reference's.

An expert layer: the router's logits over the experts (``h @ router``),
their softmax, the ``top_k`` largest probabilities renormalised to sum to
1, and the sum over the chosen experts of each one's SwiGLU output times
its weight; then the shared experts' SwiGLU (one of ``num_shared`` times
the expert width) added.  Every token reaches every expert it chooses: the
fixture's capacity holds every (token, expert) pair, so the port drops
none.  Every product and activation in float32.

A near tie: where the last position's ``top_k``-th and next router
probabilities lie within ``TIE`` of each other, the bf16 activations of the
program can choose either expert (on 2 of 60 seeds at the fixture's size
the port chose the other, and its last-position logits lay 0.95 and 1.11
standard deviations from the reference's).  :func:`last_logits` then gives
a second row, with that position's choice swapped in that layer, and the
check judges the program against the nearer row.  Only the last position
is so treated: in the fixture the expert layer is the last layer, so no
other position's routing reaches the last logits.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from reference import decoder as dense
from reference.decoder import exact, fp8  # noqa: F401  (the products)


def _swiglu(h, w_gate, w_up, w_down, mm):
    a = torch.nn.functional.silu(dense._linear(h, w_gate, mm)) * dense._linear(h, w_up, mm)
    return dense._linear(a, w_down, mm)


# the k-th and (k+1)-th router probabilities of a near tie, relative to the
# k-th (the two flips seen on 60 seeds: 0.0023 and 0.0075)
TIE = 0.02


def moe(p: Dict[str, torch.Tensor], h: torch.Tensor, dims, mm, swap: bool = False,
        tied: Optional[List[bool]] = None) -> torch.Tensor:
    """The expert layer over h (B, S, d).  ``swap``: the last position takes
    its (k+1)-th expert in place of its k-th; ``tied`` is told whether the
    last position's choice is a near tie."""

    K = dims.top_k
    probs = torch.softmax(dense._linear(h, p["router"], mm), dim=-1)
    top_p, top_e = torch.topk(probs, K + 1, dim=-1)
    if tied is not None:
        tied.append(bool((top_p[0, -1, K - 1] - top_p[0, -1, K]) < TIE * top_p[0, -1, K - 1]))
    if swap:
        order = list(range(K - 1)) + [K, K - 1]
        top_p[:, -1], top_e[:, -1] = top_p[:, -1, order], top_e[:, -1, order]
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    y = _swiglu(h, p["shared_gate"], p["shared_up"], p["shared_down"], mm)
    for e in range(dims.num_experts):
        weight = (top_p * (top_e == e)).sum(dim=-1, keepdim=True)
        y = y + weight * _swiglu(h, p["w_gate"][e], p["w_up"][e], p["w_down"][e], mm)
    return y


def layer(p: Dict[str, torch.Tensor], x: torch.Tensor, dims, mm, cos, sin, swap=False,
          tied=None) -> torch.Tensor:
    B, S, d = x.shape
    H, KV, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    h = dense.rmsnorm(x, p["norm1"], dims.norm_eps)
    q = dense.rope(dense._linear(h, p["wq"], mm).view(B, S, H, hd), cos, sin)
    k = dense.rope(dense._linear(h, p["wk"], mm).view(B, S, KV, hd), cos, sin)
    v = dense._linear(h, p["wv"], mm).view(B, S, KV, hd)
    x = x + dense._linear(dense.attention(q, k, v, dims, mm).reshape(B, S, H * hd), p["wo"], mm)
    h = dense.rmsnorm(x, p["norm2"], dims.norm_eps)
    if "router" in p:
        return x + moe(p, h, dims, mm, swap, tied)
    return x + _swiglu(h, p["w_gate"], p["w_up"], p["w_down"], mm)


def layer_params(w: Dict[tuple, torch.Tensor], i: int, dims) -> Dict[str, torch.Tensor]:
    period = len(dims.block)
    b = ("blocks", i // period, f"pos{i % period}")
    p = {"norm1": w[b + ("norm1", "scale")], "norm2": w[b + ("norm2", "scale")],
         **{n: w[b + ("attn", n)] for n in ("wq", "wk", "wv", "wo")}}
    if dims.block[i % period] == "moe":
        p.update({n: w[b + ("moe", n)] for n in ("router", "w_gate", "w_up", "w_down")})
        p.update({f"shared_{n}": w[b + ("moe", "shared", f"w_{n}")] for n in ("gate", "up", "down")})
    else:
        p.update({n: w[b + ("mlp", n)] for n in ("w_gate", "w_up", "w_down")})
    return p


def last_logits(w, tokens: torch.Tensor, dims, mm) -> torch.Tensor:
    """The logits (V,) at the last position of one sequence ``tokens``
    (S,), every product through ``mm``; (R, V) where expert layers' choices
    at that position are near ties: the first row as computed, then one a
    tied layer with its choice there swapped."""

    with torch.no_grad(), dense.exact_matmul_mode():
        tied: List[bool] = []
        rows = [_last_row(w, tokens, dims, mm, tied=tied)]
        rows += [_last_row(w, tokens, dims, mm, swap=i) for i, t in enumerate(tied) if t]
        return rows[0] if len(rows) == 1 else torch.stack(rows)


def _last_row(w, tokens, dims, mm, swap=None, tied=None) -> torch.Tensor:
    """``swap``: the index among the expert layers of the one whose choice
    at the last position is swapped."""

    cos, sin = dense.rope_tables(tokens.shape[0], dims.head_dim, dims.rope_theta, tokens.device)
    x = w[("embed", "tok")].float()[tokens.long()][None]
    n_moe = 0
    for i in range(dims.num_layers):
        p = layer_params(w, i, dims)
        x = layer(p, x, dims, mm, cos, sin, swap=swap == n_moe, tied=tied)
        n_moe += "router" in p
    x = dense.rmsnorm(x[0, -1:], w[("final_norm", "scale")], dims.norm_eps)
    return dense.logits(w, x, dims, mm)[0]
