"""The port's training path held against the reference's on the CPU.

The same parameters (the reference's ``zoo.init``, carried across by
``repro_torch.convert``), data and optimizer state go through the JAX
functions (jitted, on the CPU, as the reference's own tests run them) and
the port's.  Limits, f32 unless stated:

- data stream: bit-equal;
- ``AdamW.update``: params, ``mu`` and ``nu`` within 1e-6 relative
  (``ADAM_RTOL``), ``schedule`` within 1e-6;
- int8 compression within one int8 quantum of the reference's leaf; top-k
  the same kept set;
- ``loss_fn``: loss within 1e-5 relative (``LOSS_RTOL``), each grad leaf
  within 1e-4 of the reference leaf's L2 norm (``GRAD_NORM_TOL``); in bf16
  the loss within 2e-2 relative and each grad leaf within 5e-2 of its norm
  (``BF16_LOSS_RTOL``, ``BF16_GRAD_NORM_TOL``: bf16's 2^-8 rounding on every
  product, summed over a few hundred terms);
- one train step: metrics within 1e-5 relative, ``mu`` / ``nu`` within
  1e-4 of each leaf's norm; params within 1e-3 of the learning rate where
  the gradient is at least 1e-6 (100 eps), and within 2 lr elsewhere
  (``STEP_PARAM_TOL_CLEAR``, ``STEP_PARAM_TOL``).  A first Adam step
  moves an element by ``lr * g / (|g| + eps)``, ill-conditioned where
  ``|g|`` is near ``eps`` (1e-8): there the gradient's own rounding (a few
  1e-10: the frameworks sum in other orders) may move the step by up to
  2 lr (1.3e-2 lr on the CPU against the reference, 0.18 lr between
  the CPU and an H100 at smoke size), and
  the moments, linear in g, hold those elements instead;
- remat ``none`` / ``full`` / ``dots``: loss and grads within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jdata
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.optim.compression import Int8Compressor as JInt8, TopKCompressor as JTopK
from repro.optim.optimizer import AdamW as JAdamW, AdamWState as JAdamWState
from repro.runtime.trainer import train_loop as jtrain_loop

from repro_torch import tree as tree_lib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    opt_state_from_jax,
    params_from_jax,
    snapshot_from_jax,
)
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.obs import metrics as tmetrics
from repro_torch.optim.compression import Int8Compressor, TopKCompressor
from repro_torch.optim.optimizer import AdamW, AdamWState
from repro_torch.runtime.trainer import train_loop

ADAM_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_NORM_TOL = 1e-4
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_NORM_TOL = 5e-2
METRIC_RTOL = 1e-5
STATE_NORM_TOL = 1e-4
STEP_PARAM_TOL = 2.0
STEP_PARAM_TOL_CLEAR = 1e-3
CLEAR_GRAD = 1e-6
REMAT_TOL = 1e-6
CPU = "cpu"
B, S = 4, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, dtype="float32", **overrides):
    """Both configs, the reference's params (jax) and the port's copy."""

    jcfg = jax_smoke_config(arch).scaled(dtype=dtype, **overrides)
    tcfg = get_smoke_config(arch).scaled(dtype=dtype, **overrides)
    jparams = jzoo.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(tcfg, _np(jparams), device=CPU)
    return jcfg, tcfg, jparams, tparams


def _batches(tcfg, seed=0, step=0, batch=B):
    dc = tdata.DataConfig(global_batch=batch, seq_len=S, seed=seed)
    tb = tdata.make_batch(dc, tcfg, tdata.DataState(seed, step))
    return (
        {k: jnp.asarray(v) for k, v in tb.items()},
        {k: torch.from_numpy(v) for k, v in tb.items()},
    )


def _as_port(tcfg, ref_tree):
    """A reference tree (stacked blocks) in the port's layout, f32."""

    return params_from_jax(
        tcfg, jax.tree.map(lambda x: np.asarray(x, np.float32), ref_tree), device=CPU
    )


def _leaf_pairs(port, ref_in_port_layout):
    return zip(
        tree_lib.flatten_with_paths(port),
        tree_lib.leaves(ref_in_port_layout),
    )


def _within_norm(port, ref, tol, what):
    """Each leaf within ``tol`` of the reference leaf's L2 norm."""

    for (path, a), b in _leaf_pairs(port, ref):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        limit = tol * max(b.norm().item(), 1e-30)
        assert err <= limit, f"{what} {path}: {err} > {limit}"


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["yi_6b", "llava_next_34b", "whisper_medium"])
def test_make_batch_bit_equal(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    for hosts in (1, 2):
        for host in range(hosts):
            jdc = jdata.DataConfig(global_batch=4, seq_len=16, seed=7,
                                   num_hosts=hosts, host_id=host)
            tdc = tdata.DataConfig(global_batch=4, seq_len=16, seed=7,
                                   num_hosts=hosts, host_id=host)
            for step in (0, 1, 5, 2**40 + 3):
                ref = jdata.make_batch(jdc, jcfg, jdata.DataState(7, step))
                out = tdata.make_batch(tdc, tcfg, tdata.DataState(7, step))
                assert sorted(ref) == sorted(out)
                for k in ref:
                    assert out[k].dtype == ref[k].dtype
                    np.testing.assert_array_equal(out[k], ref[k])


def test_data_iterator_bit_equal_across_a_resume():
    cfg_j, cfg_t = jax_smoke_config("granite_3_2b"), get_smoke_config("granite_3_2b")
    jit_ = jdata.DataIterator(jdata.DataConfig(global_batch=2, seq_len=8, seed=1), cfg_j)
    tit = tdata.DataIterator(tdata.DataConfig(global_batch=2, seq_len=8, seed=1), cfg_t)
    for _ in range(4):
        np.testing.assert_array_equal(next(tit)["tokens"], next(jit_)["tokens"])
    state = tit.peek_state()
    assert state == tdata.DataState(1, 4) and jit_.peek_state() == jdata.DataState(1, 4)
    resumed = tdata.DataIterator(
        tdata.DataConfig(global_batch=2, seq_len=8, seed=1), cfg_t, state=state
    )
    for _ in range(3):
        np.testing.assert_array_equal(next(resumed)["labels"], next(jit_)["labels"])


# ---------------------------------------------------------------------- #
# optimizer
# ---------------------------------------------------------------------- #

def _random_like(tree, rng, scale=1.0, positive=False):
    def one(x):
        a = scale * rng.standard_normal(np.shape(x)).astype(np.float32)
        return np.abs(a) if positive else a

    return jax.tree.map(one, tree)


def test_adamw_update_matches_reference():
    jcfg, tcfg, jparams, tparams = _setup("yi_6b")
    rng = np.random.default_rng(0)
    grads = _random_like(_np(jparams), rng, 0.1)
    mu = _random_like(grads, rng, 0.01)
    nu = _random_like(grads, rng, 1e-3, positive=True)
    jopt = JAdamW(learning_rate=1e-2, warmup_steps=3, total_steps=20)
    topt = AdamW(learning_rate=1e-2, warmup_steps=3, total_steps=20)
    jstate = JAdamWState(step=jnp.asarray(4, jnp.int32), mu=mu, nu=nu)
    jnew, jst = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, grads), jstate, jparams)
    tstate = opt_state_from_jax(tcfg, jstate, device=CPU)
    tnew, tst = topt.update(_as_port(tcfg, grads), tstate, tparams)
    assert int(tst.step) == int(jst.step) == 5 and tst.step.dtype == torch.int32
    for port, ref in ((tnew, jnew), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        for (path, a), b in _leaf_pairs(port, _as_port(tcfg, ref)):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=ADAM_RTOL, atol=ADAM_RTOL * b.abs().max().item(),
                err_msg=str(path),
            )


def test_adamw_schedule_matches_reference():
    jopt = JAdamW(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    topt = AdamW(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 10, 55, 100, 140):
        ref = float(jopt.schedule(jnp.asarray(step, jnp.int32)))
        out = float(topt.schedule(torch.tensor(step, dtype=torch.int32)))
        assert out == pytest.approx(ref, rel=ADAM_RTOL, abs=1e-12), step
    assert float(topt.schedule(torch.tensor(0))) == 0.0
    assert float(topt.schedule(torch.tensor(10))) == pytest.approx(3e-4, rel=1e-6)
    assert float(topt.schedule(torch.tensor(100))) == pytest.approx(3e-5, rel=1e-5)


def test_weight_decay_follows_the_reference_layout():
    """The reference stacks a block's norm scale to (num_blocks, d), rank 2,
    and decays it; the final norm is rank 1 and not decayed.  The port's
    unstacked block scale is 1-D and must be decayed all the same."""

    jcfg, tcfg, jparams, tparams = _setup("gemma3_27b")  # blocks and remainder layers
    assert jcfg.num_blocks >= 1 and jcfg.remainder_layers >= 1
    zeros = jax.tree.map(lambda x: np.zeros(np.shape(x), np.float32), _np(jparams))
    jopt = JAdamW(learning_rate=1e-2, warmup_steps=0, weight_decay=0.5)
    topt = AdamW(learning_rate=1e-2, warmup_steps=0, weight_decay=0.5)
    jnew, _ = jopt.update(zeros, jopt.init(jparams), jparams)
    tnew, _ = topt.update(_as_port(tcfg, zeros), topt.init(tparams), tparams)

    def moved(new, old):
        return not np.array_equal(np.asarray(new), np.asarray(old))

    assert moved(jnew["blocks"]["pos0"]["norm1"]["scale"], jparams["blocks"]["pos0"]["norm1"]["scale"])
    assert not moved(jnew["final_norm"]["scale"], jparams["final_norm"]["scale"])
    assert not moved(jnew["rem"]["layer0"]["norm1"]["scale"], jparams["rem"]["layer0"]["norm1"]["scale"])
    for b in range(tcfg.num_blocks):
        assert tparams["blocks"][b]["pos0"]["norm1"]["scale"].ndim == 1
        assert moved(tnew["blocks"][b]["pos0"]["norm1"]["scale"], tparams["blocks"][b]["pos0"]["norm1"]["scale"])
    assert not moved(tnew["final_norm"]["scale"], tparams["final_norm"]["scale"])
    assert not moved(tnew["rem"]["layer0"]["norm1"]["scale"], tparams["rem"]["layer0"]["norm1"]["scale"])
    for (path, a), b in _leaf_pairs(tnew, _as_port(tcfg, jnew)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ADAM_RTOL, err_msg=str(path))


# ---------------------------------------------------------------------- #
# compression
# ---------------------------------------------------------------------- #

def _grad_tree(seed=1):
    """A multi-block gradient tree whose blocks differ in scale, so that a
    per-block int8 scale or top-k set would differ from the stacked one."""

    jcfg, tcfg, jparams, _ = _setup("yi_6b")
    assert jcfg.num_blocks == 2
    rng = np.random.default_rng(seed)
    g = _random_like(_np(jparams), rng)
    g["blocks"] = jax.tree.map(
        lambda x: x * np.array([1.0, 5.0], np.float32).reshape((2,) + (1,) * (x.ndim - 1)),
        g["blocks"],
    )
    r = _random_like(g, rng, 0.01)
    return tcfg, g, r


def test_int8_compression_matches_reference_on_stacked_leaves():
    tcfg, g, r = _grad_tree()
    jq, jscales, jres = JInt8().compress(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    jout = JInt8().decompress(jq, jscales)
    tout, tres = Int8Compressor().apply(_as_port(tcfg, g), _as_port(tcfg, r))
    _, tscales, _ = Int8Compressor().compress(_as_port(tcfg, g), _as_port(tcfg, r))
    # one scale a reference leaf: both blocks share the stacked leaf's scale
    for b in range(2):
        assert float(tscales["blocks"][b]["pos0"]["mlp"]["w_up"]) == pytest.approx(
            float(jscales["blocks"]["pos0"]["mlp"]["w_up"]), rel=1e-6
        )
    flat_scales = {
        path: float(s) for path, s in tree_lib.flatten_with_paths(tscales)
    }
    for port, ref in ((tout, jout), (tres, jres)):
        for (path, a), b in _leaf_pairs(port, _as_port(tcfg, ref)):
            quantum = flat_scales[path]
            err = (a - b).abs().max().item()
            assert err <= quantum, f"{path}: {err} > one quantum {quantum}"


def test_topk_compression_keeps_the_reference_set():
    tcfg, g, r = _grad_tree(2)
    comp_j, comp_t = JTopK(fraction=0.05), TopKCompressor(fraction=0.05)
    jout, jres = comp_j.apply(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    tout, tres = comp_t.apply(_as_port(tcfg, g), _as_port(tcfg, r))
    assert comp_t.compressed_bytes(tout) == comp_j.compressed_bytes(jout)
    heavier = 0
    for (path, a), b in _leaf_pairs(tout, _as_port(tcfg, jout)):
        assert torch.equal(a != 0, b != 0), f"{path}: another kept set"
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, err_msg=str(path))
        if path[0] == "blocks" and path[1] == 1:
            heavier += int((a != 0).sum())
    # the block with 5x the gradient takes most of the stacked leaf's k
    assert heavier > 0
    for (path, a), b in _leaf_pairs(tres, _as_port(tcfg, jres)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, err_msg=str(path))


# ---------------------------------------------------------------------- #
# loss and grads
# ---------------------------------------------------------------------- #

def _loss_and_grads_both(arch, dtype, **overrides):
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype, **overrides)
    jb, tb = _batches(tcfg)
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(lambda p, b: jzoo.loss_fn(p, b, jcfg), has_aux=True)
    )(jparams, jb)
    flat = [p.requires_grad_(True) for p in tree_lib.leaves(tparams)]
    tl, tm = tzoo.loss_fn(tree_lib.unflatten(tparams, flat), tb, tcfg)
    tg = tree_lib.unflatten(tparams, list(torch.autograd.grad(tl, flat)))
    return tcfg, (jl, jm, jg), (tl.detach(), {k: v.detach() for k, v in tm.items()}, tg)


@pytest.mark.parametrize("arch", ["yi_6b", "granite_3_2b"])
def test_loss_and_grads_match_reference_f32(arch):
    tcfg, (jl, jm, jg), (tl, tm, tg) = _loss_and_grads_both(arch, "float32")
    assert _rel(tl, jl) <= LOSS_RTOL
    assert _rel(tm["nll"], jm["nll"]) <= LOSS_RTOL
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    _within_norm(tg, _as_port(tcfg, jg), GRAD_NORM_TOL, "grad")
    for (_, a), p in zip(tree_lib.flatten_with_paths(tg), tree_lib.leaves(_setup(arch)[3])):
        assert a.dtype == p.dtype and a.shape == p.shape


def test_loss_and_grads_match_reference_bf16():
    tcfg, (jl, _, jg), (tl, _, tg) = _loss_and_grads_both("granite_3_2b", "bfloat16")
    assert _rel(tl, jl) <= BF16_LOSS_RTOL
    _within_norm(tg, _as_port(tcfg, jg), BF16_GRAD_NORM_TOL, "bf16 grad")
    assert tg["blocks"][0]["pos0"]["attn"]["wq"].dtype == torch.bfloat16
    assert tg["final_norm"]["scale"].dtype == torch.float32


def test_vision_loss_skips_the_patch_prefix():
    jcfg, tcfg, jparams, tparams = _setup("llava_next_34b")
    jb, tb = _batches(tcfg)
    rng = np.random.default_rng(3)
    pe = (0.1 * rng.standard_normal((B, jcfg.num_patches, jcfg.d_model))).astype(np.float32)
    jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    jl, _ = jzoo.loss_fn(jparams, jb, jcfg)
    with torch.no_grad():
        tl, _ = tzoo.loss_fn(tparams, tb, tcfg)
    assert _rel(tl, jl) <= LOSS_RTOL


def test_flops_accounting_matches_reference():
    for arch in ("yi_6b", "granite_3_2b", "mixtral_8x7b", "deepseek_moe_16b"):
        jcfg, tcfg, jparams, tparams = _setup(arch)
        assert tzoo.active_param_count(tparams, tcfg) == jzoo.active_param_count(jparams, jcfg)
        assert tzoo.model_flops_per_token(tparams, tcfg) == jzoo.model_flops_per_token(jparams, jcfg)


# ---------------------------------------------------------------------- #
# attention with a gradient
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("window", [None, 5])
def test_train_attention_takes_the_plain_version_and_matches_reference_grads(window):
    rng = np.random.default_rng(5)
    shapes = ((2, 12, 4, 8), (2, 12, 2, 8), (2, 12, 2, 8))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    w = rng.standard_normal(shapes[0]).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, causal=True, window=window, chunk=5)
        return jnp.sum(o * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    before = tmetrics.counter("attention.train_plain_calls").value
    o = tattn.chunked_attention(*ts, causal=True, window=window, chunk=5)
    assert tmetrics.counter("attention.train_plain_calls").value == before + 1
    (o * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-5, atol=2e-5)
    with torch.no_grad():  # no gradient needed: not counted
        tattn.chunked_attention(*ts, causal=True, window=window, chunk=5)
    assert tmetrics.counter("attention.train_plain_calls").value == before + 1


# ---------------------------------------------------------------------- #
# train step
# ---------------------------------------------------------------------- #

def _int8_hook(comp):
    state = {"res": None}

    def hook(grads, opt_state):
        if state["res"] is None:
            state["res"] = comp.init(grads)
        out, state["res"] = comp.apply(grads, state["res"])
        return out, opt_state

    return hook


@pytest.mark.parametrize(
    "microbatches,compress", [(1, False), (2, False), (1, True)],
    ids=["mb1", "mb2", "mb1_int8"],
)
def test_train_step_matches_reference(microbatches, compress):
    jcfg, tcfg, jparams, tparams = _setup("granite_3_2b")
    jb, tb = _batches(tcfg)
    lr = 1e-3
    jopt = JAdamW(learning_rate=lr, warmup_steps=0, total_steps=10)
    topt = AdamW(learning_rate=lr, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jmake_train_step(
        jcfg, jopt, microbatches=microbatches,
        grad_compressor=_int8_hook(JInt8()) if compress else None,
    ))
    tstep = make_train_step(
        tcfg, topt, microbatches=microbatches,
        grad_compressor=_int8_hook(Int8Compressor()) if compress else None,
    )
    jp, js, jm = jstep(jparams, jopt.init(jparams), jb)
    tp, ts, tm = tstep(tparams, topt.init(tparams), tb)
    assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "loss", "lr", "nll"]
    for k in tm:
        assert _rel(tm[k], jm[k]) <= METRIC_RTOL or float(jm[k]) == float(tm[k]) == 0.0, k
    assert int(ts.step) == int(js.step) == 1
    _within_norm(ts.mu, _as_port(tcfg, js.mu), STATE_NORM_TOL, "mu")
    _within_norm(ts.nu, _as_port(tcfg, js.nu), STATE_NORM_TOL, "nu")
    # the clipped gradient the reference's update saw: mu = (1 - b1) g
    ref_g = tree_lib.leaves(_as_port(tcfg, js.mu))
    for ((path, a), b), g in zip(_leaf_pairs(tp, _as_port(tcfg, jp)), ref_g):
        err = (a - b).abs()
        assert err.max().item() <= STEP_PARAM_TOL * lr, f"{path}: {err.max().item()}"
        clear = g.abs() / (1 - jopt.b1) >= CLEAR_GRAD
        worst = err[clear].max().item() if clear.any() else 0.0
        assert worst <= STEP_PARAM_TOL_CLEAR * lr, f"{path}: {worst} where |g| >= {CLEAR_GRAD}"


def test_train_step_grads_keep_the_reference_dtypes():
    """One microbatch: the grads reach the compressor in the params' dtype
    (bf16); two: in f32, as the reference's accumulator."""

    _, tcfg, _, tparams = _setup("granite_3_2b", "bfloat16")
    seen = {}

    def spy(grads, opt_state):
        seen["grads"] = tree_lib.leaves(grads)
        return grads, opt_state

    tb = _batches(tcfg)[1]
    opt = AdamW()
    make_train_step(tcfg, opt, grad_compressor=spy)(tparams, opt.init(tparams), tb)
    assert {g.dtype for g in seen["grads"]} == {torch.bfloat16, torch.float32}
    for g, p in zip(seen["grads"], tree_lib.leaves(tparams)):
        assert g.dtype == p.dtype
    make_train_step(tcfg, opt, microbatches=2, grad_compressor=spy)(
        tparams, opt.init(tparams), tb
    )
    assert {g.dtype for g in seen["grads"]} == {torch.float32}


# ---------------------------------------------------------------------- #
# remat
# ---------------------------------------------------------------------- #

def test_remat_policies_give_the_same_loss_and_grads():
    _, tcfg, _, tparams = _setup("gemma3_27b")  # local + global layers, remainder
    tb = _batches(tcfg)[1]
    results = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        flat = [p.detach().requires_grad_(True) for p in tree_lib.leaves(tparams)]
        before = tmetrics.counter("attention.train_plain_calls").value
        loss, _ = tzoo.loss_fn(tree_lib.unflatten(tparams, flat), tb, cfg)
        forward_calls = tmetrics.counter("attention.train_plain_calls").value - before
        grads = torch.autograd.grad(loss, flat)
        recomputed = (
            tmetrics.counter("attention.train_plain_calls").value - before - forward_calls
        )
        results[remat] = (loss.detach(), grads)
        assert forward_calls == tcfg.num_layers
        # full / dots recompute every block's attention in the backward pass
        blocks = tcfg.num_blocks * len(tcfg.block)
        assert recomputed == (0 if remat == "none" else blocks), remat
    ref_loss, ref_grads = results["none"]
    for remat in ("full", "dots"):
        loss, grads = results[remat]
        assert _rel(loss, ref_loss) <= REMAT_TOL
        for a, b in zip(grads, ref_grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=REMAT_TOL, atol=REMAT_TOL)


# ---------------------------------------------------------------------- #
# resume a reference checkpoint in the port
# ---------------------------------------------------------------------- #

def test_port_resumes_a_reference_checkpoint(tmp_path):
    """The reference trains 8 steps, checkpointing every 4; the port takes
    its step-4 snapshot and trains on to step 8.  Steps 5-8's losses agree
    within the loss limit."""

    jcfg = jax_smoke_config("yi_6b").scaled(dtype="float32")
    tcfg = get_smoke_config("yi_6b").scaled(dtype="float32")
    jdc = jdata.DataConfig(global_batch=4, seq_len=16, seed=3)
    tdc = tdata.DataConfig(global_batch=4, seq_len=16, seed=3)
    jmgr = JCheckpointManager(tmp_path / "ref", async_writes=False, keep=10)
    ref = jtrain_loop(jcfg, jdc, total_steps=8, ckpt=jmgr, ckpt_every=4)
    jparams = jzoo.init(jax.random.PRNGKey(0), jcfg)
    jopt = JAdamW(warmup_steps=10, total_steps=8)
    jsnap = jmgr.restore_step(4, target={"params": jparams, "opt": jopt.init(jparams)})
    snap = snapshot_from_jax(tcfg, jsnap, device=CPU)
    assert snap.step == 4 and snap.data_state == tdata.DataState(3, 4)
    assert isinstance(snap.tree["opt"], AdamWState) and int(snap.tree["opt"].step) == 4
    mgr = CheckpointManager(tmp_path / "port", async_writes=False, keep=10)
    mgr.save(snap)
    res = train_loop(tcfg, tdc, total_steps=8, ckpt=mgr, ckpt_every=4, device=CPU)
    assert res.final_step == 8 and len(res.losses) == 4
    np.testing.assert_allclose(res.losses, ref.losses[4:], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------- #
# command-line entry points
# ---------------------------------------------------------------------- #

def test_train_main_runs_on_the_cpu(capsys):
    res = ttrain.main(["--device", "cpu", "--smoke", "--steps", "4", "--arch", "granite_3_2b"])
    out = capsys.readouterr().out
    assert "finished: step=4" in out and res.final_step == 4
    assert "smoke=True" in out


def test_train_main_smoke_defaults_on_with_the_cpu(capsys):
    ttrain.main(["--device", "cpu", "--steps", "2", "--compress-grads"])
    assert "smoke=True" in capsys.readouterr().out


def test_train_lm_main_recovers_from_an_injected_failure(tmp_path, capsys):
    from repro_torch.launch import train_lm

    res = train_lm.main([
        "--device", "cpu", "--arch", "granite_3_2b", "--steps", "6", "--batch", "4",
        "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--inject-failure", "3",
    ])
    assert res.restarts == 1 and res.final_step == 6
    assert "injecting WorkerFailure at step 3" in capsys.readouterr().out
