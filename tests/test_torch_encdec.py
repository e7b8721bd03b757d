"""repro_torch.models.encdec held against the reference's ``models/encdec.py``.

whisper-medium's smoke configuration in f32: the reference initialises the
parameters, ``params_from_jax`` carries them across (the stacked encoder
and decoder layers become per-layer lists), and the same frame embeddings
and tokens, drawn with NumPy from a seed, go through ``encode``,
``prefill`` and ``decode_step`` of both packages.  Outputs, logits and
caches hold to 2e-5 (``TOL``), the frameworks summing in other orders; the
port's decode against its own full forward holds to 2e-4, the reference's
``tests/test_arch_smoke.py`` tolerance for that comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import encdec as jencdec

from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_to_jax_layout, params_from_jax
from repro_torch.models import encdec as tencdec

TOL = 2e-5
B, S, T = 2, 6, 5


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(port.detach().float().numpy() if torch.is_tensor(port) else port),
        np.asarray(ref, np.float32), atol=tol, rtol=tol,
    )


def _setup(num_frames=None, seed=0):
    jcfg = jax_smoke_config("whisper_medium").scaled(dtype="float32")
    tcfg = get_smoke_config("whisper_medium").scaled(dtype="float32")
    if num_frames is not None:
        jcfg = dataclasses.replace(
            jcfg, encoder=dataclasses.replace(jcfg.encoder, num_frames=num_frames)
        )
        tcfg = dataclasses.replace(
            tcfg, encoder=dataclasses.replace(tcfg.encoder, num_frames=num_frames)
        )
    jp = jencdec.init_encdec(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, tcfg.encoder.num_frames, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, frames, toks


def test_params_unstack_per_layer():
    jcfg, tcfg, jp, tp, _, _ = _setup()
    assert len(tp["enc_blocks"]) == tcfg.encoder.num_layers
    assert len(tp["dec_blocks"]) == tcfg.num_layers
    for i, lp in enumerate(tp["dec_blocks"]):
        _close(lp["cross_attn"]["wk"], jp["dec_blocks"]["cross_attn"]["wk"][i], 0)


def test_sinusoid_matches_reference():
    pos = np.arange(37)
    _close(tencdec._sinusoid(torch.from_numpy(pos), 64), jencdec._sinusoid(jnp.asarray(pos), 64), 1e-5)


@pytest.mark.parametrize("num_frames", [None, 40])
def test_encode_matches_reference(num_frames):
    jcfg, tcfg, jp, tp, frames, _ = _setup(num_frames)
    ref = jencdec.encode(jp, jnp.asarray(frames), jcfg)
    with torch.inference_mode():
        out = tencdec.encode(tp, torch.from_numpy(frames), tcfg)
    assert out.shape == (B, tcfg.encoder.num_frames, tcfg.d_model)
    _close(out, ref)


def test_forward_matches_reference():
    jcfg, tcfg, jp, tp, frames, toks = _setup()
    jl, jaux = jencdec.forward(jp, jnp.asarray(frames), jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        tl, taux = tencdec.forward(tp, torch.from_numpy(frames), torch.from_numpy(toks), tcfg)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_match_reference(seed):
    jcfg, tcfg, jp, tp, frames, toks = _setup(seed=seed)
    max_len = S + T
    jcache = jencdec.init_cache(jcfg, B, max_len)
    tcache = tencdec.init_cache(tcfg, B, max_len, "cpu")
    assert len(tcache) == tcfg.num_layers and sorted(tcache[0]) == ["ck", "cv", "k", "v"]
    ck0 = tcache[0]["ck"]
    jl, jcache = jencdec.prefill(jp, jnp.asarray(frames), jnp.asarray(toks), jcfg, jcache)
    with torch.inference_mode():
        tl, tcache = tencdec.prefill(tp, torch.from_numpy(frames), torch.from_numpy(toks), tcfg, tcache)
    assert tcache[0]["ck"] is ck0  # written in place
    _close(tl, jl)
    port = cache_to_jax_layout(tcfg, tcache)
    assert jax.tree.structure(port) == jax.tree.structure(jax.tree.map(np.asarray, jcache))
    for name in ("k", "v", "ck", "cv"):
        _close(port[name], jcache[name])

    cur = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    n = S
    for _ in range(T):
        jl, jcache = jencdec.decode_step(jp, jnp.asarray(cur), jcfg, jcache, jnp.int32(n))
        with torch.inference_mode():
            tl, tcache = tencdec.decode_step(tp, torch.from_numpy(cur), tcfg, tcache, n)
        _close(tl, jl)
        cur = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        n += 1
    port = cache_to_jax_layout(tcfg, tcache)
    for name in ("k", "v", "ck", "cv"):
        _close(port[name], jcache[name])


def test_decode_matches_full_forward():
    """Prefill of the first tokens and a decode step per later token give
    the training forward's logits (the port alone)."""

    _, tcfg, _, tp, frames, toks = _setup(seed=2)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(toks)
    with torch.inference_mode():
        full, _ = tencdec.forward(tp, tf, tt, tcfg)
        cache = tencdec.init_cache(tcfg, B, S, "cpu")
        lp, cache = tencdec.prefill(tp, tf, tt[:, :3], tcfg, cache)
        _close(lp[:, 0], full[:, 2].numpy(), 2e-4)
        for t in range(3, S):
            lg, cache = tencdec.decode_step(tp, tt[:, t : t + 1], tcfg, cache, t)
            _close(lg[:, 0], full[:, t].numpy(), 2e-4)
