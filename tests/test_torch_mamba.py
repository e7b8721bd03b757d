"""repro_torch.models.mamba held against the reference's ``models/mamba.py``.

The same inputs, drawn with NumPy from a seed, go through both packages'
functions, in f32.  The SSD cases (``ssd_chunked`` against
``ssd_reference`` and against the reference's ``ssd_chunked``) hold to
1e-4 (``SSD_TOL``), the reference's own ``TestSSD`` tolerance: the chunked
and sequential forms sum in other orders.  The causal conv holds to 1e-5
(``CONV_TOL``), its state to 1e-6, as the reference's test holds them.  The
mixer (``mamba_apply``, ``mamba_decode_step``) holds to 1e-4 (``MIXER_TOL``)
against the reference's: it runs the SSD inside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import mamba as jmamba

from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import mamba as tmamba

SSD_TOL = 1e-4
CONV_TOL = 1e-5
MIXER_TOL = 1e-4


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(port, ref, tol):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol
    )


def _softplus_np(x):
    return np.logaddexp(x, 0.0)


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = _softplus_np(rng.standard_normal((B, S, H)))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    return [_pair(a) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("S,chunk", [(8, 4), (16, 16), (13, 4), (32, 8)])
def test_chunked_matches_sequential(S, chunk):
    pairs = _ssd_inputs(0, 2, S, 3, 4, 5)
    j = [p[0] for p in pairs]
    t = [p[1] for p in pairs]
    y, h = tmamba.ssd_chunked(*t, chunk)
    y_seq, h_seq = tmamba.ssd_reference(*t)
    _close(y, y_seq.numpy(), SSD_TOL)
    _close(h, h_seq.numpy(), SSD_TOL)
    jy, jh = jmamba.ssd_chunked(*j, chunk)
    jy_seq, jh_seq = jmamba.ssd_reference(*j)
    _close(y, jy, SSD_TOL)
    _close(h, jh, SSD_TOL)
    _close(y_seq, jy_seq, SSD_TOL)
    _close(h_seq, jh_seq, SSD_TOL)


def test_state_continuation():
    """prefill(first half) state + ssd(second half, h0) == full run."""

    x, dt, A, Bm, Cm = (p[1] for p in _ssd_inputs(1, 1, 16, 2, 4, 3))
    y_full, h_full = tmamba.ssd_chunked(x, dt, A, Bm, Cm, 4)
    _, h1 = tmamba.ssd_chunked(x[:, :8], dt[:, :8], A, Bm[:, :8], Cm[:, :8], 4)
    y2, h2 = tmamba.ssd_chunked(x[:, 8:], dt[:, 8:], A, Bm[:, 8:], Cm[:, 8:], 4, h0=h1)
    _close(y2, y_full[:, 8:].numpy(), SSD_TOL)
    _close(h2, h_full.numpy(), SSD_TOL)
    # and the sequential oracle continues the same way
    _, r1 = tmamba.ssd_reference(x[:, :8], dt[:, :8], A, Bm[:, :8], Cm[:, :8])
    r2, _ = tmamba.ssd_reference(x[:, 8:], dt[:, 8:], A, Bm[:, 8:], Cm[:, 8:], h0=r1)
    _close(y2, r2.numpy(), SSD_TOL)


def test_causal_conv_state():
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 10, 6)))
    jw, tw = _pair(rng.standard_normal((4, 6)))
    y_full, tail = tmamba._causal_conv(tx, tw)
    jy, jtail = jmamba._causal_conv(jx, jw)
    _close(y_full, jy, CONV_TOL)
    _close(tail, jtail, 1e-6)
    # step by step with state reproduces the full conv
    tail_s, ys = None, []
    for t in range(tx.shape[1]):
        yt, tail_s = tmamba._causal_conv(tx[:, t : t + 1], tw, tail_s)
        ys.append(yt)
    _close(torch.cat(ys, dim=1), y_full.numpy(), CONV_TOL)
    _close(tail_s, tail.numpy(), 1e-6)


def test_softplus_is_logaddexp_above_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 20.5, 40.0], np.float32)
    jx, tx = _pair(x)
    _close(tmamba.softplus(tx), jax.nn.softplus(jx), 1e-7)


def _mixer_setup(arch, seed=0):
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    tcfg = get_smoke_config(arch).scaled(dtype="float32")
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "jamba_v01_52b"])
@pytest.mark.parametrize("S", [8, 13, 24])
def test_mamba_apply_matches_reference(arch, S):
    jcfg, tcfg, jp, tp = _mixer_setup(arch)
    jx, tx = _pair(np.random.default_rng(3).standard_normal((2, S, jcfg.d_model)))
    jy, jst = jmamba.mamba_apply(jp, jx, jcfg, None)
    ty, tst = tmamba.mamba_apply(tp, tx, tcfg, None)
    _close(ty, jy, MIXER_TOL)
    _close(tst["ssm"], jst["ssm"], MIXER_TOL)
    _close(tst["conv"], jst["conv"], MIXER_TOL)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "jamba_v01_52b"])
def test_prefill_then_decode_matches_reference_and_updates_state_in_place(arch):
    jcfg, tcfg, jp, tp = _mixer_setup(arch, seed=1)
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((2, 9, jcfg.d_model)))
    jstate = jmamba.mamba_init_state(jcfg, 2)
    tstate = tmamba.mamba_init_state(tcfg, 2, "cpu")
    ssm, conv = tstate["ssm"], tstate["conv"]
    assert ssm.dtype == torch.float32 and conv.shape == tuple(jstate["conv"].shape)
    jy, jstate = jmamba.mamba_apply(jp, jx, jcfg, jstate)
    ty, tstate = tmamba.mamba_apply(tp, tx, tcfg, tstate)
    assert tstate["ssm"] is ssm and tstate["conv"] is conv  # the cache, in place
    _close(ty, jy, MIXER_TOL)
    for _ in range(4):
        jt, tt = _pair(rng.standard_normal((2, 1, jcfg.d_model)))
        jy, jstate = jmamba.mamba_decode_step(jp, jt, jcfg, jstate)
        ty, tstate = tmamba.mamba_decode_step(tp, tt, tcfg, tstate)
        assert tstate["ssm"] is ssm
        _close(ty, jy, MIXER_TOL)
        _close(tstate["ssm"], jstate["ssm"], MIXER_TOL)
        _close(tstate["conv"], jstate["conv"], MIXER_TOL)


def test_decode_steps_continue_the_full_sequence():
    """Prefill of the first tokens then one decode step per token gives the
    full-sequence mixer's outputs (the port alone)."""

    _, tcfg, _, tp = _mixer_setup("mamba2_2_7b", seed=2)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 12, tcfg.d_model)).astype(np.float32))
    full, _ = tmamba.mamba_apply(tp, x, tcfg, None)
    state = tmamba.mamba_init_state(tcfg, 2, "cpu")
    y, state = tmamba.mamba_apply(tp, x[:, :5], tcfg, state)
    steps = [y]
    for t in range(5, 12):
        y, state = tmamba.mamba_decode_step(tp, x[:, t : t + 1], tcfg, state)
        steps.append(y)
    _close(torch.cat(steps, dim=1), full.numpy(), MIXER_TOL)


def test_init_matches_reference_shapes_and_dtypes():
    for arch in ("mamba2_2_7b", "jamba_v01_52b"):
        jcfg = jax_smoke_config(arch)
        tcfg = get_smoke_config(arch)
        jp = jmamba.mamba_init(jax.random.PRNGKey(0), jcfg)
        tp = tmamba.mamba_init(torch.Generator().manual_seed(0), tcfg)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            assert str(tp[k].dtype).split(".")[1] == str(jp[k].dtype), k
        _close(tp["A_log"], jp["A_log"], 1e-6)
        dt = torch.nn.functional.softplus(tp["dt_bias"])
        assert float(dt.min()) >= 0.001 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
