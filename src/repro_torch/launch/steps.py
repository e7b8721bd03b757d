"""Train, prefill and decode steps, as the reference's ``launch/steps.py``.
PyTorch runs eagerly, so a step is the plain function: the serving steps
under ``torch.inference_mode``, the train step under autograd.  Each call
opens one step span (:func:`repro_torch.spans.step`): ``train.step``,
``serve.prefill``, ``serve.decode`` (its argmax a child ``lm.sample``).

``make_train_step`` closes over (config, optimizer) and returns
``(params, opt_state, batch) -> (params, opt_state, metrics)``.  Optional
microbatch gradient accumulation runs the microbatches in turn with a
SINGLE optimizer update at the end, as the reference's ``lax.scan`` does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from repro_torch import spans
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.models.sharded import place
from repro_torch.obs import trace
from repro_torch.optim.optimizer import AdamW, AdamWState, global_norm


def _grads_of(params, batch, cfg: ModelConfig, act_constrain=None):
    """(loss, metrics, grads): the loss and its gradient with respect to
    every param leaf, in the leaf's dtype.  Under a mesh the gradient of a
    data-replicated leaf is a ``Partial`` sum over the data axes: nothing
    is reduced here."""

    flat = [p.detach().requires_grad_(True) for p in tree_lib.leaves(params)]
    loss, metrics = zoo.loss_fn(
        tree_lib.unflatten(params, flat), batch, cfg, act_constrain
    )
    # a leaf the loss does not reach gets zeros, as under jax.grad
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_lib.unflatten(params, list(grads))


def _microbatched(x, k: int, mesh):
    """(b, ...) → (k, b/k, ...): microbatch i is rows [i·b/k, (i+1)·b/k),
    as the reference's reshape makes it.  Under a mesh each microbatch's
    rows are split over the data axes, as the reference's sharding
    constraint keeps them, when b/k divides over them: each rank's rows go
    to the ranks that hold them in their microbatches, one all-to-all.
    Otherwise the microbatches are whole on every rank."""

    b = x.shape[0]
    if b % k:
        raise ValueError(f"batch of {b} rows does not split into {k} microbatches")
    shape = (k, b // k) + tuple(x.shape[1:])
    if mesh is None:
        return x.reshape(shape)

    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import data_axes, data_parallel_size
    from repro_torch.launch.sharding import _contiguous_stride

    dp, n = data_axes(mesh), data_parallel_size(mesh)
    names = mesh.mesh_dim_names
    if n == 1 or (b // k) % n:
        whole = place(x, mesh, [Replicate()] * mesh.ndim).to_local()
        return DTensor.from_local(
            whole.reshape(shape), mesh, [Replicate()] * mesh.ndim, run_check=False
        )
    x = place(x, mesh, [Shard(0) if a in dp else Replicate() for a in names])
    coord, sizes = mesh.get_coordinate(), dict(zip(names, mesh.shape))
    r = 0
    for a in dp:  # the rank's block of rows, in mesh order
        r = r * sizes[a] + coord[names.index(a)]
    L, m = b // n, b // k
    c = m // n
    dest = [((r * L + t) % m) // c for t in range(L)]
    order = sorted(range(L), key=lambda t: (dest[t], t))
    send = [dest.count(d) for d in range(n)]
    recv = [0] * n
    for i in range(k):
        recv[(i * m + r * c) // L] += c
    local = x.to_local()
    if order != list(range(L)):
        local = local[torch.tensor(order, device=local.device)]
    if len(dp) == 1:
        group = mesh.get_group(dp[0])
    else:  # the data axes as one group; its mesh is built on real tensors
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():
            group = mesh[dp]._flatten().get_group()
    out = funcol.wait_tensor(
        funcol.all_to_all_single(local.contiguous(), recv, send, group)
    )
    return DTensor.from_local(
        out.reshape((k, c) + tuple(x.shape[1:])), mesh,
        [Shard(1) if a in dp else Replicate() for a in names],
        run_check=False, shape=shape, stride=_contiguous_stride(shape),
    )


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
    between the gradient and the update.

    ``mesh`` (a ``DeviceMesh`` with a "data" and a "model" axis; params,
    optimizer state and batch DTensors on it, e.g. placed by
    :func:`repro_torch.launch.sharding.distribute` under
    :func:`repro_torch.launch.input_specs.cell_shardings`): the batch is
    split into microbatches by one all-to-all that keeps each
    microbatch's rows on the data axes, as the reference's sharding
    constraint does (:func:`_microbatched`).  The gradient of a
    data-replicated param is a ``Partial`` sum over the data axes; the
    microbatches add up in that state, and the step reduces it ONCE, after
    the last microbatch — one gradient synchronization for k microbatch
    dependences, the paper's send/wait merging lifted to data parallelism.
    The updated params and optimizer state return to their input
    placements.

    ``seq_shard``: Megatron-style sequence parallelism on the residual
    stream at block boundaries (batch on the data axes, sequence on the
    model axis).

    ``grad_shardings``: ZeRO-2-style sharding tree (the params' specs plus
    'data') for the f32 gradient accumulator: the one reduction is then a
    reduce-scatter to it.
    """

    from repro_torch.launch import sharding as shard_lib
    from repro_torch.launch.mesh import axis_sizes, data_axes, data_parallel_size

    def act_constrain(x):
        if mesh is None or not seq_shard or x.dim() != 3:
            return x
        dp = data_axes(mesh)
        b = dp if x.shape[0] % data_parallel_size(mesh) == 0 else None
        s = "model" if x.shape[1] % axis_sizes(mesh).get("model", 1) == 0 else None
        return place(x, mesh, shard_lib.placements(mesh, shard_lib.P(b, s, None)))

    def reduce_grads(grads, params):
        """The one reduction of the step: each gradient to its param's
        placements, or to ``grad_shardings``' when given."""

        if mesh is None:
            return grads
        targets = (
            [sh.placements for sh in tree_lib.leaves(grad_shardings)]
            if grad_shardings is not None
            else [p.placements for p in tree_lib.leaves(params)]
        )
        return tree_lib.unflatten(grads, [
            place(g, mesh, pl) for g, pl in zip(tree_lib.leaves(grads), targets)
        ])

    def grads_of(params, batch):
        return _grads_of(params, batch, cfg, act_constrain if seq_shard else None)

    def step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        with spans.step("train.step", batch["tokens"]):
            return _step(params, opt_state, batch)

    def _step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            mb = {k: _microbatched(v, microbatches, mesh) for k, v in batch.items()}
            grads = loss = None
            for i in range(microbatches):
                l, _, g = grads_of(params, {k: v[i] for k, v in mb.items()})
                # f32, each divided by k, summed in microbatch order, a leaf
                # at a time (one f32 copy of the grads, not two); under a
                # mesh the sum stays Partial over the data axes
                g = tree_lib.leaves(g)
                if grads is None:
                    grads = [None] * len(g)
                for j in range(len(g)):
                    x, g[j] = g[j].float() / microbatches, None
                    grads[j] = x if grads[j] is None else grads[j] + x
                del g
                loss = l / microbatches if loss is None else loss + l / microbatches
            grads = tree_lib.unflatten(params, grads)
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        grads = reduce_grads(grads, params)

        with torch.no_grad():
            if grad_compressor is not None:
                grads, opt_state = grad_compressor(grads, opt_state)
            gnorm = global_norm(grads)
            new_params, new_opt = opt.update(grads, opt_state, params)
            if mesh is not None:  # back to the input placements
                new_params = tree_lib.tree_map(
                    lambda n, p: place(n, mesh, p.placements), new_params, params
                )
                new_opt = tree_lib.tree_map(
                    lambda n, o: place(n, mesh, o.placements) if hasattr(o, "placements") else n,
                    new_opt, opt_state,
                )
            metrics = dict(metrics)
            metrics.update(
                loss=loss, grad_norm=gnorm, lr=opt.schedule(new_opt.step)
            )
        return new_params, new_opt, metrics

    if mesh is None:
        return step

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return step(params, opt_state, batch)

    return train_step


def _placed(params):
    """The context a step on ``params`` runs in: DTensor params (a mesh,
    as :func:`repro_torch.launch.input_specs.cell_shardings` places them,
    all of them or none) treat plain tensors as replicated values."""

    from repro_torch.models import sharded

    if sharded.is_dtensor(params["embed"]["tok"]):  # every model's first leaf
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch, cache) -> (last-position logits, cache); params,
    batch and cache may be DTensors on one mesh."""

    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        with spans.step("serve.prefill", batch["tokens"]), _placed(params):
            return zoo.prefill(params, batch, cfg, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B,1), cache, cache_len) -> (next_tokens (B,1), cache),
    greedy, as the reference's; params, tokens and cache may be DTensors
    on one mesh."""

    @torch.inference_mode()
    def serve_step(params, tokens, cache, cache_len):
        from repro_torch.models import sharded

        with spans.step("serve.decode", tokens), _placed(params):
            logits, cache = zoo.decode_step(params, tokens, cfg, cache, cache_len)
            with trace.module("lm.sample"):
                logits = logits[:, -1, :]
                if sharded.is_dtensor(logits):  # the vocab whole: one all-gather
                    logits = sharded.whole_along(logits, -1)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step
