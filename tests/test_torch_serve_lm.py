"""The port's LM serving path held against the reference, end to end.

For each of the ten smoke configurations (dense, MoE, Mamba, hybrid,
encoder-decoder, vision) the reference initialises its
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
  ulps at depth, and the logits are what the contract holds.  A MoE
  configuration's reference runs op by op here (``_serve_both`` says
  why), and a failure names the tokens whose top-k sets part
  (``_RouterLog``).

The cache is compared in the reference's layout (``cache_to_jax_layout``):
KV entries, Mamba ``ssm`` / ``conv`` states and whisper's cross-attention
K/V.

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

DENSE = [
    "yi_6b", "granite_3_2b", "internlm2_20b", "gemma3_27b", "llava_next_34b",
    "deepseek_moe_16b", "mixtral_8x7b", "mamba2_2_7b", "jamba_v01_52b", "whisper_medium",
]
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
    if jcfg.frontend == "audio":
        fe = rng.standard_normal((B, jcfg.encoder.num_frames, jcfg.d_model)).astype(
            np.float32
        )
        jbatch["frame_embeds"] = jnp.asarray(fe)
        tbatch["frame_embeds"] = torch.from_numpy(fe)
    return jcfg, tcfg, jparams, tparams, jbatch, tbatch


class _RouterLog:
    """Records every MoE layer's input on both sides (the port's
    ``moe_apply`` and the reference's, run op by op so its inputs are
    concrete) and names the tokens whose top-k sets part: what a bf16
    failure of a MoE configuration is read against."""

    def __init__(self, monkeypatch):
        from repro.models import moe as jmoe

        from repro_torch.models import moe as tmoe

        self.port, self.ref = [], []
        t_apply, j_apply = tmoe.moe_apply, jmoe.moe_apply

        def port(p, x, cfg):
            self.port.append((p["router"].float().numpy(), x.float().numpy(), cfg.moe.top_k))
            return t_apply(p, x, cfg)

        def ref(p, x, cfg):
            self.ref.append((np.asarray(p["router"], np.float32), np.asarray(x, np.float32)))
            return j_apply(p, x, cfg)

        monkeypatch.setattr(tmoe, "moe_apply", port)
        monkeypatch.setattr(jmoe, "moe_apply", ref)

    def report(self) -> str:
        lines = []
        for i, ((router, xt, k), (_, xj)) in enumerate(zip(self.port, self.ref)):
            sets = [
                np.sort(np.argsort(-(x.reshape(-1, x.shape[-1]) @ router), -1)[:, :k], -1)
                for x in (xt, xj)
            ]
            parted = np.nonzero((sets[0] != sets[1]).any(-1))[0]
            lines.append(
                f"MoE call {i}: tokens whose top-k sets part {parted.tolist()}: port "
                f"{sets[0][parted].tolist()} reference {sets[1][parted].tolist()}"
            )
        return "\n".join(lines)


def _checked(port, ref, tol, log):
    try:
        _close(port, ref, tol)
    except AssertionError as e:
        if log is None:
            raise
        raise AssertionError(f"{e}\n{log.report()}") from None


def _serve_both(arch, monkeypatch=None, **overrides):
    """Prefill and T decode steps on both sides; returns what to compare.

    A MoE configuration in bf16 (``monkeypatch`` given) runs the
    reference op by op (``jax.disable_jit``), each op rounding to bf16 as
    the port's eager ops do.  Capacity dropping makes a MoE layer's output
    jump where a router near-tie flips, and under jit XLA's fusion keeps
    f32 between fused ops: at jamba's fourth layer a near-tie (top-k
    probabilities 3.8e-4 apart) flips, and the jitted reference parts from
    its own op-by-op run by 0.046 at the prefill logits, where the port
    equals the op-by-op run bit for bit."""

    dtype = overrides.get("dtype", "bfloat16")
    jcfg, tcfg, jparams, tparams, jbatch, tbatch = _setup(arch, **overrides)
    log = None
    jit = jax.jit
    if dtype == "bfloat16" and tcfg.has_moe:
        log = _RouterLog(monkeypatch)

        def jit(f):
            def op_by_op(*args):
                with jax.disable_jit():
                    return f(*args)

            return op_by_op
    assert tzoo.param_count(tparams) == jzoo.param_count(jparams)
    prefix = serve_lm.prefix_len(tcfg)
    max_len = S + prefix + T
    jcache = jzoo.init_cache(jcfg, B, max_len)
    tcache = tzoo.init_cache(tcfg, B, max_len, device="cpu")

    jlogits, jcache = jit(jsteps.make_prefill_step(jcfg))(jparams, jbatch, jcache)
    tlogits, tcache = make_prefill_step(tcfg)(tparams, tbatch, tcache)
    _checked(tlogits, jlogits, TOL[dtype], log)
    ref_cache = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    port_cache = cache_to_jax_layout(tcfg, tcache)
    assert jax.tree.structure(ref_cache) == jax.tree.structure(port_cache)
    if dtype == "float32":  # bf16 caches drift by ulps with depth: logits only
        for r, p in zip(jax.tree.leaves(ref_cache), jax.tree.leaves(port_cache)):
            np.testing.assert_allclose(p, r, atol=TOL[dtype], rtol=TOL[dtype])

    jdecode = jit(lambda p, t, c, n: jzoo.decode_step(p, t, jcfg, c, n))
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
        _checked(tlog, jlog, TOL[dtype], log)
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
def test_bf16_serving_logits_within_tolerance(arch, monkeypatch):
    _serve_both(arch, monkeypatch, dtype="bfloat16")


def test_int8_kv_cache_serving_matches_reference():
    """The int8 cache that ``launch/serve.py --kv-quant`` selects."""

    jtokens, ttokens = _serve_both("yi_6b", dtype="float32", kv_quant=True)
    np.testing.assert_array_equal(ttokens, jtokens)


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


@pytest.mark.parametrize(
    "arch", ["yi_6b", "llava_next_34b", "deepseek_moe_16b", "mamba2_2_7b", "whisper_medium"]
)
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


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "jamba_v01_52b", "whisper_medium"])
def test_generate_reuses_one_cache_across_waves_with_recurrent_state(arch):
    """A reused cache is zeroed before its prefill: a Mamba layer starts
    from the state the cache holds, so the previous wave's final state
    must not carry over (nor whisper's cross-attention K/V)."""

    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = tzoo.init(cfg, device="cpu", seed=1)
    batch = serve_lm.make_batch(cfg, 2, 8, device="cpu", seed=2)
    if cfg.frontend == "audio":
        assert batch["frame_embeds"].shape == (2, cfg.encoder.num_frames, cfg.d_model)
    fresh = serve_lm.generate(params, cfg, batch, 6)
    cache = tzoo.init_cache(cfg, 2, 8 + 6, device="cpu")
    serve_lm.generate(params, cfg, serve_lm.make_batch(cfg, 2, 8, device="cpu", seed=3), 6, cache=cache)
    again = serve_lm.generate(params, cfg, batch, 6, cache=cache)
    assert torch.equal(again.tokens, fresh.tokens)
    torch.testing.assert_close(again.prefill_logits, fresh.prefill_logits, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "jamba_v01_52b", "whisper_medium"])
def test_init_and_init_cache_default_to_cuda_for_every_family(arch):
    cfg = get_smoke_config(arch)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init_cache(cfg, 1, 8)
