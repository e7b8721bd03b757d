"""repro_torch.models.moe held against the reference's ``models/moe.py``.

The reference initialises the parameters (``moe_init``), they cross as
NumPy arrays, and the same inputs, drawn with NumPy from a seed, go through
both packages.  f32 throughout; outputs and aux losses within 1e-5
(``TOL``, the reference's own ``TestMoE`` tolerance), the two frameworks
summing in other orders.  The router is f32, so exact top-k ties are rare;
every input here is checked to have none (``_no_ties``), since
``torch.topk`` does not promise ``jax.lax.top_k``'s lower-index-first
order on a tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as jlayers
from repro.models import moe as jmoe

from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

TOL = 1e-5


def _cfgs(arch, cap=None):
    j = jax_smoke_config(arch).scaled(dtype="float32")
    t = get_smoke_config(arch).scaled(dtype="float32")
    if cap is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, capacity_factor=cap))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, capacity_factor=cap))
    return j, t


def _params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    return jp, tp


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _no_ties(tp, tx, k):
    """The k-th and (k+1)-th router probabilities of every token differ."""

    probs = torch.softmax(torch.matmul(tx.float(), tp["router"]), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1).values
    assert float((top[..., k - 1] - top[..., k]).min()) > 1e-6


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_moe_16b", "jamba_v01_52b"])
@pytest.mark.parametrize("cap", [100.0, 1.0])
@pytest.mark.parametrize("B,S", [(2, 16), (1, 64)])
def test_moe_apply_matches_reference(arch, cap, B, S):
    jcfg, tcfg = _cfgs(arch, cap)
    jp, tp = _params(jcfg)
    jx, tx = _x((B, S, jcfg.d_model))
    _no_ties(tp, tx, tcfg.moe.top_k)
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg)
    assert ty.shape == (B, S, tcfg.d_model) and taux.dtype == torch.float32
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_moe_16b"])
def test_moe_reference_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 16, jcfg.d_model))
    _no_ties(tp, tx, tcfg.moe.top_k)
    _close(tmoe.moe_reference(tp, tx, tcfg), jmoe.moe_reference(jp, jx, jcfg))


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_moe_16b"])
def test_grouped_dispatch_matches_dense_oracle_without_drops(arch):
    """At capacity 100 nothing drops: the grouped dispatch is the dense
    oracle, on the port alone."""

    _, tcfg = _cfgs(arch, 100.0)
    _, tp = _params(_cfgs(arch, 100.0)[0])
    _, tx = _x((2, 16, tcfg.d_model))
    y, _ = tmoe.moe_apply(tp, tx, tcfg)
    _close(y, tmoe.moe_reference(tp, tx, tcfg).numpy())


def test_a_dropped_slot_matches_the_reference():
    """At capacity factor 1.0 over one group of 64 tokens some (token, k)
    pairs land past their expert's last slot (pos >= C): they leave the
    dispatch as all-zero one-hot rows, as in the reference, and the output
    parts from the dense oracle."""

    jcfg, tcfg = _cfgs("mixtral_8x7b", 1.0)
    jp, tp = _params(jcfg)
    jx, tx = _x((1, 64, jcfg.d_model), seed=5)
    _no_ties(tp, tx, tcfg.moe.top_k)
    mc = tcfg.moe
    G = min(mc.group_size, 64)
    C = tmoe._capacity(mc, G)
    top_e = torch.topk(torch.matmul(tx, tp["router"]), mc.top_k, dim=-1).indices
    first = top_e.reshape(-1, G * mc.top_k)  # slots in token-major, then k, order
    counts = torch.stack([torch.bincount(r, minlength=mc.num_experts) for r in first])
    assert int(counts.max()) > C, "no slot drops: the case does not test a drop"
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg)
    _close(ty, jy)
    _close(taux, jaux)
    dense = tmoe.moe_reference(tp, tx, tcfg)
    assert float((ty - dense).abs().max()) > 1e-3
    assert bool(torch.isfinite(ty).all())


def test_shared_experts_always_on():
    jcfg, tcfg = _cfgs("deepseek_moe_16b")
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 16, jcfg.d_model))
    y_with, _ = tmoe.moe_apply(tp, tx, tcfg)
    tp0 = dict(tp, w_down=torch.zeros_like(tp["w_down"]))  # kill routed experts
    y_shared, _ = tmoe.moe_apply(tp0, tx, tcfg)
    _close(y_shared, jlayers.mlp(jp["shared"], jx))
    _close(y_shared, tlayers.mlp(tp["shared"], tx).numpy())
    assert float((y_with - y_shared).abs().max()) > 1e-4


def test_capacity_matches_reference():
    for arch in ("mixtral_8x7b", "deepseek_moe_16b", "jamba_v01_52b"):
        jcfg, tcfg = _cfgs(arch)
        for group in (1, 4, 24, 32, 256):
            assert tmoe._capacity(tcfg.moe, group) == jmoe._capacity(jcfg.moe, group)


def test_aux_loss_has_a_gradient_to_the_router():
    _, tcfg = _cfgs("mixtral_8x7b")
    _, tp = _params(_cfgs("mixtral_8x7b")[0])
    _, tx = _x((2, 16, tcfg.d_model))
    router = tp["router"].clone().requires_grad_(True)
    _, aux = tmoe.moe_apply(dict(tp, router=router), tx, tcfg)
    (g,) = torch.autograd.grad(aux, router)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
