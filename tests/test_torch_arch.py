"""Every architecture on the port, as the reference's ``tests/test_arch_smoke.py``
runs it: each of the ten smoke configurations through a forward, the
training loss and one train step on the CPU, incremental decoding against
the full forward, and each full configuration's parameter count against
the reference's without allocating the weights.

Tolerances: the loss (nll and aux) against the reference's within 2e-5
relative in f32 (``LOSS_RTOL``, the same parameters carried across with
``params_from_jax``, the frameworks summing in other orders); decode
against the full forward within 2e-4 (``DECODE_TOL``, the reference test's
own); counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model_zoo as jzoo

from repro_torch import tree as tree_lib
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model_zoo as tzoo
from repro_torch.optim.optimizer import AdamW

B, S, SMAX = 2, 12, 16
LOSS_RTOL = 2e-5
DECODE_TOL = 2e-4


def make_batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)
        ).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (
            0.1 * rng.standard_normal((B, cfg.num_patches, cfg.d_model))
        ).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("arch", ARCHITECTURES)
class TestArchSmoke:
    def test_forward_shapes_and_finite(self, arch):
        cfg = get_smoke_config(arch)
        params = tzoo.init(cfg, device="cpu")
        with torch.inference_mode():
            logits, aux = tzoo.forward_logits(params, _torch(make_batch(cfg)), cfg)
        S_out = S + (cfg.num_patches if cfg.frontend == "vision" else 0)
        assert logits.shape == (B, S_out, cfg.padded_vocab_size)
        assert bool(torch.isfinite(logits[..., : cfg.vocab_size].float()).all())
        assert int(torch.argmax(logits, -1).max()) < cfg.vocab_size
        assert aux.dtype == torch.float32 and bool(torch.isfinite(aux))
        if cfg.has_moe:
            assert float(aux) > 0.0

    def test_loss_matches_reference(self, arch):
        jcfg = jax_smoke_config(arch).scaled(dtype="float32")
        tcfg = get_smoke_config(arch).scaled(dtype="float32")
        jparams = jzoo.init(jax.random.PRNGKey(0), jcfg)
        tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        batch = make_batch(tcfg)
        jl, jm = jzoo.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        with torch.no_grad():
            tl, tm = tzoo.loss_fn(tparams, _torch(batch), tcfg)
        assert _rel(tm["nll"], jm["nll"]) <= LOSS_RTOL
        assert _rel(tl, jl) <= LOSS_RTOL
        if tcfg.has_moe:
            assert _rel(tm["aux"], jm["aux"]) <= LOSS_RTOL
        else:
            assert float(tm["aux"]) == float(jm["aux"]) == 0.0

    def test_train_gradient_step(self, arch):
        cfg = get_smoke_config(arch)
        params = tzoo.init(cfg, device="cpu")
        batch = _torch(make_batch(cfg))
        opt = AdamW(learning_rate=1e-3, warmup_steps=1)
        new_params, _, metrics = make_train_step(cfg, opt)(params, opt.init(params), batch)
        assert bool(torch.isfinite(metrics["loss"])) and float(metrics["grad_norm"]) > 0.0
        assert bool(torch.isfinite(metrics["grad_norm"]))
        for p in tree_lib.leaves(new_params):
            assert bool(torch.isfinite(p.float()).all())
        moved = sum(
            float((a.float() - b.float()).abs().sum())
            for a, b in zip(tree_lib.leaves(new_params), tree_lib.leaves(params))
        )
        assert moved > 0.0

    def test_decode_matches_forward(self, arch):
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        if cfg.has_moe:
            # exact match requires no capacity drops
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0)
            )
        params = tzoo.init(cfg, device="cpu")
        batch = _torch(make_batch(cfg))
        toks = batch["tokens"]
        with torch.inference_mode():
            full, _ = tzoo.forward_logits(params, batch, cfg)
            npfx = cfg.num_patches if cfg.frontend == "vision" else 0
            cache = tzoo.init_cache(cfg, B, SMAX + npfx, device="cpu")
            lp, cache = tzoo.prefill(params, {**batch, "tokens": toks[:, :6]}, cfg, cache)
            np.testing.assert_allclose(
                lp[:, 0].numpy(), full[:, npfx + 5].numpy(), atol=DECODE_TOL, rtol=DECODE_TOL
            )
            cl = 6 + npfx
            for t in range(6, S):
                lg, cache = tzoo.decode_step(params, toks[:, t : t + 1], cfg, cache, cl)
                cl += 1
                np.testing.assert_allclose(
                    lg[:, 0].numpy(), full[:, npfx + t].numpy(),
                    atol=DECODE_TOL, rtol=DECODE_TOL,
                )

    def test_full_config_param_count_is_the_reference(self, arch):
        """The full configuration's parameters as meta tensors (nothing
        allocated): the count, and each dtype's count, equal the
        reference's ``abstract_params``."""

        shapes = jzoo.abstract_params(jax_config(arch))
        params = tzoo.abstract_params(get_config(arch))
        assert all(p.device.type == "meta" for p in tree_lib.leaves(params))
        jcount, tcount = {}, {}
        for x in jax.tree.leaves(shapes):
            jcount[str(x.dtype)] = jcount.get(str(x.dtype), 0) + int(np.prod(x.shape))
        for p in tree_lib.leaves(params):
            key = str(p.dtype).split(".")[1]
            tcount[key] = tcount.get(key, 0) + p.numel()
        assert tcount == jcount
        assert tzoo.param_count(params) == sum(jcount.values())
        assert tzoo.active_param_count(params, get_config(arch)) == jzoo.active_param_count(
            shapes, jax_config(arch)
        )


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "jamba_v01_52b"])
def test_remat_keeps_the_aux_gradient(arch):
    """Under ``remat="full"`` the blocks run checkpointed, and the aux loss
    leaves the checkpointed body: the loss and every gradient equal the
    un-rematerialised run's (f32, 1e-6 relative to each leaf's norm)."""

    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = tzoo.init(cfg, device="cpu", seed=3)
    batch = _torch(make_batch(cfg))

    def grads(c):
        flat = [p.detach().requires_grad_(True) for p in tree_lib.leaves(params)]
        loss, m = tzoo.loss_fn(tree_lib.unflatten(params, flat), batch, c)
        return loss, m["aux"], torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)

    l0, a0, g0 = grads(cfg.scaled(remat="none"))
    l1, a1, g1 = grads(cfg.scaled(remat="full"))
    assert float(a0.detach()) > 0
    assert _rel(a1.detach(), a0.detach()) <= 1e-6 and _rel(l1.detach(), l0.detach()) <= 1e-6
    router = [
        i for i, (path, _) in enumerate(tree_lib.flatten_with_paths(params))
        if path[-1] == "router"
    ]
    assert router and all(float(g0[i].abs().max()) > 0 for i in router)
    for a, b in zip(g1, g0):
        assert float((a - b).norm()) <= 1e-6 * max(float(b.norm()), 1e-30) + 1e-12


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x7b", "jamba_v01_52b"])
def test_active_param_count_matches_reference_on_smoke(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jzoo.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    assert tzoo.active_param_count(tparams, tcfg) == jzoo.active_param_count(jparams, jcfg)
    assert tzoo.active_param_count(tparams, tcfg) < tzoo.param_count(tparams)
    assert tzoo.model_flops_per_token(tparams, tcfg) == jzoo.model_flops_per_token(jparams, jcfg)
