"""Plain PyTorch reference of the dense decoder that the configurations
describe, and of its training step.  It imports nothing of the program.

What it computes, from a configuration file's sizes (``bench/dims.py``)
and the weights of ``bench/weights.py``:

* the llama-form decoder: token embedding; per layer RMSNorm, q / k / v
  projections, rotary embeddings on the first and second halves of each
  head (angles in float64), causal softmax attention with grouped K/V
  heads (query head h reads K/V head h // (H / KV)), the output
  projection, RMSNorm, the SwiGLU MLP, each with a residual add; a final
  RMSNorm and the head over the real vocabulary.  Every product and
  activation in float32 (TF32 off: :func:`exact_matmul_mode`), the
  weights being the bf16 values both sides are handed;
* the training step as the configuration states it: the mean next-token
  cross entropy, gradients by autograd in float32, the global-norm clip,
  and AdamW with bias correction, decoupled weight decay on every matrix
  and on the per-block norm scales, linear warm-up then cosine decay, the
  update cast to the parameter's dtype and added in it (the parameters
  stay bf16, the moments float32).

Departures from the published models, as the port's models define them:
granite without its embedding, attention, residual and logit multipliers
(``BENCHMARK.json`` lists those keys under ``reduced``); the embedding
table padded to the port's row count (the padded rows are never read
here, and the padded head columns are dropped).  A tied head is the
embedding table's transpose.

``Fp8`` is the control: the same computation with every product's
operands rounded to float8 (e4m3 forward, e5m2 for the gradients) at a
per-tensor scale, accumulated in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils import checkpoint

NEG = -1e30


@contextlib.contextmanager
def exact_matmul_mode():
    """float32 products in full float32 (no TF32) while the block runs."""

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _q8(x: torch.Tensor, dtype) -> torch.Tensor:
    top = 448.0 if dtype == torch.float8_e4m3fn else 57344.0
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g, torch.float8_e5m2)
        return torch.matmul(qg, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), qg)


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8MatMul.apply(a, b)


# ---------------------------------------------------------------------- #
# the forward pass
# ---------------------------------------------------------------------- #

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.float()


def rope_tables(S: int, hd: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd))
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, heads, hd); cos / sin (S, 1, hd / 2)."""

    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _linear(x: torch.Tensor, w: torch.Tensor, mm) -> torch.Tensor:
    """x (..., k) times w reshaped to (k, n)."""

    k = x.shape[-1]
    y = mm(x.reshape(-1, k), w.float().reshape(k, -1))
    return y.reshape(*x.shape[:-1], y.shape[-1])


def attention(q, k, v, dims, mm) -> torch.Tensor:
    """Causal softmax attention; q (B, S, H, hd), k / v (B, S, KV, hd)."""

    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    s = mm(qh, kh.transpose(-1, -2)) * dims.score_scale
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(torch.where(keep, s, NEG), dim=-1)
    return mm(p, vh).transpose(1, 2)


def layer(p: Dict[str, torch.Tensor], x: torch.Tensor, dims, mm, cos, sin) -> torch.Tensor:
    B, S, d = x.shape
    H, KV, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    h = rmsnorm(x, p["norm1"], dims.norm_eps)
    q = rope(_linear(h, p["wq"], mm).view(B, S, H, hd), cos, sin)
    k = rope(_linear(h, p["wk"], mm).view(B, S, KV, hd), cos, sin)
    v = _linear(h, p["wv"], mm).view(B, S, KV, hd)
    o = attention(q, k, v, dims, mm)
    x = x + _linear(o.reshape(B, S, H * hd), p["wo"], mm)
    h = rmsnorm(x, p["norm2"], dims.norm_eps)
    a = torch.nn.functional.silu(_linear(h, p["w_gate"], mm)) * _linear(h, p["w_up"], mm)
    return x + _linear(a, p["w_down"], mm)


def layer_params(w: Dict[tuple, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    b = ("blocks", i, "pos0")
    return {"norm1": w[b + ("norm1", "scale")], "norm2": w[b + ("norm2", "scale")],
            **{n: w[b + ("attn", n)] for n in ("wq", "wk", "wv", "wo")},
            **{n: w[b + ("mlp", n)] for n in ("w_gate", "w_up", "w_down")}}


def hidden(w: Dict[tuple, torch.Tensor], tokens: torch.Tensor, dims, mm, *,
           remat: bool = False) -> torch.Tensor:
    """The final RMSNorm's output, (B, S, d) float32."""

    S = tokens.shape[1]
    cos, sin = rope_tables(S, dims.head_dim, dims.rope_theta, tokens.device)
    x = w[("embed", "tok")].float()[tokens.long()]
    for i in range(dims.num_layers):
        p = layer_params(w, i)
        if remat:
            x = checkpoint.checkpoint(layer, p, x, dims, mm, cos, sin, use_reentrant=False)
        else:
            x = layer(p, x, dims, mm, cos, sin)
    return rmsnorm(x, w[("final_norm", "scale")], dims.norm_eps)


def logits(w, x: torch.Tensor, dims, mm) -> torch.Tensor:
    if dims.tie_embeddings:
        return _linear(x, w[("embed", "tok")][:dims.vocab_size].T, mm)
    return _linear(x, w[("embed", "head")][:, :dims.vocab_size], mm)


# ---------------------------------------------------------------------- #
# served tokens: the widest gap below the reference's best
# ---------------------------------------------------------------------- #

def last_logits(w, tokens: torch.Tensor, dims, mm) -> torch.Tensor:
    """The logits (V,) at the last position of one sequence ``tokens``
    (S,), every product through ``mm``."""

    with torch.no_grad(), exact_matmul_mode():
        x = hidden(w, tokens[None], dims, mm)[0, -1:]
        return logits(w, x, dims, mm)[0]


def served_gaps(w, tokens: torch.Tensor, positions: Sequence[int], served: torch.Tensor,
                dims, *, control: bool = False) -> torch.Tensor:
    """For one sequence ``tokens`` (S,): at each of ``positions`` the gap by
    which the token chosen there lies below the reference's best logit,
    in units of the standard deviation of the reference's logits at that
    position.  The chosen token is ``served`` (one a position), or with
    ``control`` the one that the fp8 computation puts first."""

    with torch.no_grad(), exact_matmul_mode():
        x = hidden(w, tokens[None], dims, exact)[0]
        pos = torch.as_tensor(list(positions), device=tokens.device)
        ref = logits(w, x[pos], dims, exact)
        del x
        if control:
            xc = hidden(w, tokens[None], dims, fp8)[0]
            served = torch.argmax(logits(w, xc[pos], dims, fp8), dim=-1)
            del xc
        chosen = torch.gather(ref, 1, served.long().reshape(-1, 1))[:, 0]
        return (ref.amax(dim=-1) - chosen) / ref.std(dim=-1)


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #

def cross_entropy(w, batch: Dict[str, torch.Tensor], dims, mm) -> torch.Tensor:
    x = hidden(w, batch["tokens"], dims, mm, remat=True)
    z = logits(w, x, dims, mm)
    gold = torch.gather(z, -1, batch["labels"].long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(z, dim=-1) - gold)


def learning_rate(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    decay = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * frac))
    return opt["learning_rate"] * warm * decay


def decayed(path: tuple, t: torch.Tensor) -> bool:
    """Weight decay on every matrix and on the per-block norm scales, as
    the configuration's optimizer applies it to the stacked layout."""

    return t.dim() >= 2 or path[0] == "blocks"


def train(w0: Dict[tuple, torch.Tensor], batches: List[Dict[str, torch.Tensor]], dims,
          opt: dict, mm=exact, *, rows=None) -> dict:
    """The configuration's training steps from ``w0`` over ``batches``.
    Returns each step's loss, every leaf's first gradient as the optimizer
    gets it (after the clip) and before the clip, and the parameters after
    the last step.  ``rows`` keeps only those rows of each batch (a
    planted fault: part of the batch left out)."""

    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    paths = list(w0)
    params = {k: w0[k].clone() for k in paths}
    mu = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for k, t in params.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    losses, first, first_raw = [], None, None
    with exact_matmul_mode():
        for step, batch in enumerate(batches, start=1):
            if rows is not None:
                batch = {k: v[rows] for k, v in batch.items()}
            leaves = {k: params[k].detach().to(torch.float32, copy=True).requires_grad_(True)
                      for k in paths}
            loss = cross_entropy(leaves, batch, dims, mm)
            g = dict(zip(paths, torch.autograd.grad(loss, [leaves[k] for k in paths])))
            losses.append(float(loss.detach()))
            del leaves, loss
            gnorm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            clip = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            if step == 1:
                first_raw = {k: float(torch.linalg.vector_norm(x)) for k, x in g.items()}
                first = {}
            for k in paths:
                x = g.pop(k) * clip
                if step == 1:
                    first[k] = float(torch.linalg.vector_norm(x))
                mu[k].mul_(b1).add_((1 - b1) * x)
                nu[k].mul_(b2).add_((1 - b2) * x * x)
                del x
            lr = learning_rate(opt, step)
            for k in paths:
                p = params[k]
                u = (mu[k] / (1 - b1**step)) / (torch.sqrt(nu[k] / (1 - b2**step)) + eps)
                if opt["weight_decay"] and decayed(k, p):
                    u = u + opt["weight_decay"] * p.float()
                params[k] = p + (-lr * u).to(p.dtype)
    return {"losses": losses, "first_grad": first, "first_grad_raw": first_raw, "params": params}
