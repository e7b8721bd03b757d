"""Train, prefill and decode steps, as the reference's ``launch/steps.py``.
PyTorch runs eagerly, so a step is the plain function: the serving steps
under ``torch.inference_mode``, the train step under autograd.

``make_train_step`` closes over (config, optimizer) and returns
``(params, opt_state, batch) -> (params, opt_state, metrics)``.  Optional
microbatch gradient accumulation runs the microbatches in turn with a
SINGLE optimizer update at the end, as the reference's ``lax.scan`` does.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.optimizer import AdamW, AdamWState, global_norm


def _grads_of(params, batch, cfg: ModelConfig):
    """(loss, metrics, grads): the loss and its gradient with respect to
    every param leaf, in the leaf's dtype."""

    flat = [p.detach().requires_grad_(True) for p in tree_lib.leaves(params)]
    loss, metrics = zoo.loss_fn(tree_lib.unflatten(params, flat), batch, cfg)
    # a leaf the loss does not reach gets zeros, as under jax.grad
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_lib.unflatten(params, list(grads))


def make_train_step(
    cfg: ModelConfig,
    opt: AdamW,
    *,
    microbatches: int = 1,
    grad_compressor=None,
    mesh=None,
    seq_shard: bool = False,
    grad_shardings=None,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    metrics ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr``.

    With ``microbatches == 1`` the grads are in the params' dtype; with
    more they are accumulated in f32, each divided by ``microbatches``, and
    the loss is the mean over microbatches, as in the reference.
    ``grad_compressor(grads, opt_state) -> (grads, opt_state)`` runs
    between the gradient and the update.  ``mesh``, ``seq_shard`` and
    ``grad_shardings`` (the reference's SPMD knobs) are not ported yet.
    """

    if mesh is not None or seq_shard or grad_shardings is not None:
        raise NotImplementedError(
            "mesh / seq_shard / grad_shardings: SPMD training is not ported "
            "yet (ROADMAP Queue 1 item 13)"
        )

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            loss, metrics, grads = _grads_of(params, batch, cfg)
        else:
            def split(x, i):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(
                        f"batch of {b} rows does not split into {microbatches} "
                        "microbatches"
                    )
                return x.reshape((microbatches, b // microbatches) + x.shape[1:])[i]

            grads = tree_lib.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                params,
            )
            loss = torch.zeros(
                (), dtype=torch.float32, device=tree_lib.leaves(params)[0].device
            )
            for i in range(microbatches):
                mbatch = {k: split(v, i) for k, v in batch.items()}
                l, _, g = _grads_of(params, mbatch, cfg)
                grads = tree_lib.tree_map(
                    lambda a, x: a + x.float() / microbatches, grads, g
                )
                loss = loss + l / microbatches
            metrics = {"nll": loss, "aux": torch.zeros((), device=loss.device)}

        with torch.no_grad():
            if grad_compressor is not None:
                grads, opt_state = grad_compressor(grads, opt_state)
            gnorm = global_norm(grads)
            new_params, new_opt = opt.update(grads, opt_state, params)
            metrics = dict(metrics)
            metrics.update(
                loss=loss, grad_norm=gnorm, lr=opt.schedule(new_opt.step)
            )
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch, cache) -> (last-position logits, cache)."""

    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        return zoo.prefill(params, batch, cfg, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B,1), cache, cache_len) -> (next_tokens (B,1), cache),
    greedy, as the reference's."""

    @torch.inference_mode()
    def serve_step(params, tokens, cache, cache_len):
        logits, cache = zoo.decode_step(params, tokens, cfg, cache, cache_len)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step
