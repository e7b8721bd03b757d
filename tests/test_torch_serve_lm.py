"""The port's LM serving path held against the reference, end to end.

For each dense smoke configuration the reference initialises its
parameters (``repro.models.model_zoo.init``), ``params_from_jax`` carries
them across, and the same prompts, drawn with NumPy from a seed, go
through both packages' prefill step and then 8 decode steps:

* f32 (``cfg.scaled(dtype="float32")``): last-position prefill logits and
  every decode step's logits within 2e-5 (the frameworks sum in other
  orders), the KV cache after prefill within 2e-5, and the greedy tokens
  equal, each side decoding its own tokens through its serve step;
* bf16: the logits within 3e-2 (the kernels' bf16 tolerance), the port
  decoding the reference's tokens so both see the same inputs.  The bf16
  caches are not compared: a few of their entries differ by several bf16
  ulps at depth, and the logits are what the contract holds.

On the CPU the port's attention is the plain streaming version; the flash
kernel is held against it on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo

from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_to_jax_layout, params_from_jax
from repro_torch.launch import serve_lm
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model_zoo as tzoo

DENSE = ["yi_6b", "granite_3_2b", "internlm2_20b", "gemma3_27b", "llava_next_34b"]
B, S, T = 2, 12, 8
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _close(port, ref, tol):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol
    )


def _setup(arch, **overrides):
    jcfg = jax_smoke_config(arch).scaled(**overrides)
    tcfg = get_smoke_config(arch).scaled(**overrides)
    jparams = jzoo.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if jcfg.frontend == "vision":
        pe = (0.1 * rng.standard_normal((B, jcfg.num_patches, jcfg.d_model))).astype(
            np.float32
        )
        jbatch["patch_embeds"] = jnp.asarray(pe)
        tbatch["patch_embeds"] = torch.from_numpy(pe)
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


def _serve_both(arch, **overrides):
    """Prefill and T decode steps on both sides; returns what to compare."""

    dtype = overrides.get("dtype", "bfloat16")
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _setup(arch, **overrides)
    assert tzoo.param_count(tparams) == jzoo.param_count(jparams)
    prefix = serve_lm.prefix_len(tcfg)
    max_len = S + prefix + T
    jcache = jzoo.init_cache(jcfg, B, max_len)
    tcache = tzoo.init_cache(tcfg, B, max_len, device="cpu")

    jlogits, jcache = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, jbatch, jcache)
    tlogits, tcache = make_prefill_step(tcfg)(tparams, tbatch, tcache)
    _close(tlogits, jlogits, TOL[dtype])
    ref_cache = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    port_cache = cache_to_jax_layout(tcfg, tcache)
    assert jax.tree.structure(ref_cache) == jax.tree.structure(port_cache)
    if dtype == "float32":  # bf16 caches drift by ulps with depth: logits only
        for r, p in zip(jax.tree.leaves(ref_cache), jax.tree.leaves(port_cache)):
            np.testing.assert_allclose(p, r, atol=TOL[dtype], rtol=TOL[dtype])

    jdecode = jax.jit(lambda p, t, c, n: jzoo.decode_step(p, t, jcfg, c, n))
    serve = make_serve_step(tcfg)
    jcur = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
    tcur = torch.argmax(tlogits[:, -1], -1)[:, None].to(torch.int32)
    jtokens, ttokens = [np.asarray(jcur)], [tcur.numpy()]
    n = S + prefix
    for _ in range(T):
        jlog, jcache = jdecode(jparams, jcur, jcache, jnp.int32(n))
        if dtype == "float32":  # each side decodes its own greedy tokens
            with torch.inference_mode():
                tlog, _ = tzoo.decode_step(
                    tparams, tcur, tcfg, _copy(tcache), n
                )
            tcur, tcache = serve(tparams, tcur, tcache, n)
        else:  # the port decodes the reference's tokens
            with torch.inference_mode():
                tlog, tcache = tzoo.decode_step(
                    tparams, torch.from_numpy(np.array(jcur)), tcfg, tcache, n
                )
        _close(tlog, jlog, TOL[dtype])
        jcur = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
        jtokens.append(np.asarray(jcur))
        ttokens.append(tcur.numpy())
        n += 1
    return np.concatenate(jtokens, 1), np.concatenate(ttokens, 1)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("arch", DENSE)
def test_f32_serving_matches_reference_tokens(arch):
    jtokens, ttokens = _serve_both(arch, dtype="float32")
    np.testing.assert_array_equal(ttokens, jtokens)


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_serving_logits_within_tolerance(arch):
    _serve_both(arch, dtype="bfloat16")


def test_int8_kv_cache_serving_matches_reference():
    """The int8 cache that ``launch/serve.py --kv-quant`` selects."""

    jtokens, ttokens = _serve_both("yi_6b", dtype="float32", kv_quant=True)
    np.testing.assert_array_equal(ttokens, jtokens)


@pytest.mark.parametrize(
    "arch,what",
    [
        ("mixtral_8x7b", "MoE"),
        ("deepseek_moe_16b", "MoE"),
        ("mamba2_2_7b", "Mamba"),
        ("jamba_v01_52b", "Mamba"),
        ("whisper_medium", "encoder-decoder"),
    ],
)
def test_unported_families_raise(arch, what):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match=f"{what}.*Queue 1 item 9"):
        tzoo.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tzoo.init_cache(cfg, 1, 8, device="cpu")


def test_entry_points_default_to_cuda():
    cfg = get_smoke_config("yi_6b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init_cache(cfg, 1, 8)


def test_forward_matches_reference():
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _setup(
        "gemma3_27b", dtype="float32"
    )
    jlogits, _ = jzoo.forward_logits(jparams, jbatch, jcfg)
    with torch.inference_mode():
        tlogits, aux = tzoo.forward_logits(tparams, tbatch, tcfg)
    assert float(aux) == 0.0
    _close(tlogits, jlogits, 2e-5)


@pytest.mark.parametrize("arch", ["yi_6b", "llava_next_34b"])
def test_serve_lm_main_runs_on_the_cpu(arch, capsys):
    res = serve_lm.main(
        ["--arch", arch, "--batch", "2", "--prompt-len", "8", "--tokens", "5",
         "--device", "cpu"]
    )
    assert res.tokens.shape == (2, 5) and res.tokens.dtype == torch.int32
    assert len(res.decode_ms) == 4
    assert int(res.tokens.max()) < get_smoke_config(arch).vocab_size
    out = capsys.readouterr().out
    assert "prefill:" in out and "device=cpu" in out


def test_generate_reuses_one_cache_across_waves():
    cfg = get_smoke_config("yi_6b").scaled(dtype="float32")
    params = tzoo.init(cfg, device="cpu", seed=1)
    batch = serve_lm.make_batch(cfg, 2, 8, device="cpu", seed=2)
    fresh = serve_lm.generate(params, cfg, batch, 6)
    cache = tzoo.init_cache(cfg, 2, 8 + 6, device="cpu")
    serve_lm.generate(params, cfg, serve_lm.make_batch(cfg, 2, 8, device="cpu", seed=3), 6, cache=cache)
    again = serve_lm.generate(params, cfg, batch, 6, cache=cache)
    assert torch.equal(again.tokens, fresh.tokens)
    torch.testing.assert_close(again.prefill_logits, fresh.prefill_logits, rtol=0, atol=0)
