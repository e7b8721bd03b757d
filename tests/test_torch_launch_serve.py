"""The port's continuous-batching server (``repro_torch.launch.serve``)
held against the reference's ``launch/serve.py`` on the CPU.

* **Tokens** — each request's greedy tokens equal those of the reference's
  jitted ``make_prefill_step`` / ``make_serve_step`` run through the same
  slot schedule (waves of ``slots``, a short wave padded with copies of its
  first prompt, a fresh cache a wave), in f32, with the reference's
  parameters carried across by ``params_from_jax`` and the same prompts
  drawn with NumPy from a seed; with and without the int8 KV cache.
* **Plans** — the wave plans' retained dependences and the rescoring
  scan's recurrence strategy equal the reference's ``repro.serve`` with a
  ``"wavefront"`` default service (its waves compile ``"xla"``, whose
  ``report()`` builds host tables only, so it runs on this tree).
* **Cache counts** — the port's mirrors of ``tests/test_examples.py``'s two
  wave tests: 1 structural miss and 7 hits for the concurrent scan
  re-plans, 4 misses and 8 hits for ``plan_wave`` three times.
* **The CLI** — ``main(["--device", "cpu", ...])`` prints the lines
  ``test_serve_main`` asserts of the reference's.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro.serve as ref_serve
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo
from repro.serve import service as ref_service

import repro_torch.obs as obs
from repro_torch.compile import clear_compile_cache, compile_cache_stats
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.serve import PlanService, ServiceOptions
from repro_torch.serve import service as service_mod

REQUESTS, SLOTS, PROMPT, MAX_NEW = 6, 4, 8, 5  # waves of 4 and 2 (+2 pads)


@pytest.fixture
def cpu_default_service(monkeypatch):
    """The waves ride the process-default service, which defaults to CUDA;
    install a CPU one for the test."""

    obs.reset_all()
    svc = PlanService(ServiceOptions(device="cpu"))
    monkeypatch.setattr(service_mod, "_DEFAULT", svc)
    yield svc
    svc.close()
    obs.reset_all()


def _prompts(vocab: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, (REQUESTS, PROMPT)).astype(np.int32)


def _reference_schedule(jcfg, jparams, prompts):
    """The reference server's wave loop (``src/repro/launch/serve.py``)
    over the jitted steps, its planning left out: each request's tokens."""

    prefill = jax.jit(jsteps.make_prefill_step(jcfg))
    step = jax.jit(jsteps.make_serve_step(jcfg))
    generated = {rid: [] for rid in range(len(prompts))}
    queue = list(range(len(prompts)))
    while queue:
        active, queue = queue[:SLOTS], queue[SLOTS:]
        rids = active + [-1] * (SLOTS - len(active))
        toks = np.stack([prompts[r if r >= 0 else active[0]] for r in rids])
        cache = jzoo.init_cache(jcfg, SLOTS, PROMPT + MAX_NEW)
        logits, cache = prefill(jparams, {"tokens": jnp.asarray(toks)}, cache)
        cur = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
        cache_len = PROMPT
        for r, t in zip(rids, cur[:, 0].tolist()):
            if r >= 0:
                generated[r].append(int(t))
        for _ in range(MAX_NEW - 1):
            cur, cache = step(jparams, cur, cache, jnp.int32(cache_len))
            cache_len += 1
            for r, t in zip(rids, cur[:, 0].tolist()):
                if r >= 0:
                    generated[r].append(int(t))
    return generated


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tokens_match_the_reference_jitted_steps(kv_quant, cpu_default_service):
    jcfg = jax_smoke_config("yi_6b").scaled(dtype="float32", kv_quant=kv_quant)
    tcfg = get_smoke_config("yi_6b").scaled(dtype="float32", kv_quant=kv_quant)
    jparams = jzoo.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = _prompts(tcfg.vocab_size)

    requests = [
        serve.Request(rid=i, prompt=torch.from_numpy(p)) for i, p in enumerate(prompts)
    ]
    run = serve.serve_requests(
        tparams, tcfg, requests, slots=SLOTS, max_new=MAX_NEW, device="cpu"
    )
    want = _reference_schedule(jcfg, jparams, prompts)

    assert run.waves == 2 and run.kv_quant == kv_quant
    assert [r.rid for r in run.done] == list(range(REQUESTS))  # no pad served
    assert run.decoded_tokens == REQUESTS * (MAX_NEW - 1)
    for r in run.done:
        assert r.generated == want[r.rid], f"request {r.rid}"
    # every wave's non-affine workloads ran on the default (CPU) service
    assert run.route_exe.backend == run.rescore_exe.backend == "torch"
    assert sorted(cpu_default_service.stats()["tenants"]) == ["decode", "rescore", "route", "scan"]


def test_wave_plans_match_the_reference_service(cpu_default_service, monkeypatch):
    ref_obs.reset_all()
    rsvc = ref_serve.PlanService(ref_serve.ServiceOptions(backend="wavefront"))
    monkeypatch.setattr(ref_service, "_DEFAULT", rsvc)
    try:
        for max_new, slots in ((3, 3), (4, 3), (16, 4), (32, 4)):
            decode, scan, route, rescore = serve.plan_wave(max_new, slots)
            rdecode, rscan, rroute, rrescore = ref_serve.plan_wave(max_new, slots)
            for port, ref in ((decode, rdecode), (scan, rscan)):
                assert [d.pretty() for d in port.elimination.retained] == [
                    d.pretty() for d in ref.elimination.retained
                ]
            (rec,) = scan.summary()["scc"]["recurrences"]
            (rrec,) = rscan.summary()["scc"]["recurrences"]
            for key in ("statements", "strategy", "chunk", "offers"):
                assert rec[key] == rrec[key], (max_new, slots, key)
            assert route.plan.options.deps == rroute.plan.options.deps == "inspect"
            assert rescore.plan.options.deps == rrescore.plan.options.deps == "speculate"
    finally:
        rsvc.close()
        ref_obs.reset_all()


def test_serve_cyclic_plan_concurrent_replanning(cpu_default_service):
    """``tests/test_examples.py``'s scan test on the port: one artifact,
    counted hits for every wave after the first."""

    clear_compile_cache()
    first = serve.plan_scan_sync(3, 4)  # cold: the one structural miss
    (rec,) = first.summary()["scc"]["recurrences"]
    assert rec["strategy"] in ("skew", "chunk", "dswp")
    assert rec["statements"] == ["RESCORE"]
    assert first.summary()["scc"]["policy"] == "auto"

    waves = 6
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        plans = list(pool.map(lambda _: serve.plan_scan_sync(3, 4), range(waves)))
    other_bounds = serve.plan_scan_sync(5, 7)
    keys = {p.compiled.key for p in plans} | {first.compiled.key, other_bounds.compiled.key}
    assert len(keys) == 1, "concurrent re-plans must share one artifact"
    stats = compile_cache_stats()
    assert stats["misses"] == 1
    assert stats["hits"] == waves + 1


def test_serve_concurrent_wave_planning_pairs_decode_and_scan(cpu_default_service):
    """``tests/test_examples.py``'s ``plan_wave`` test on the port."""

    clear_compile_cache()
    for _ in range(3):
        decode_plan, scan_plan, route_exe, rescore_exe = serve.plan_wave(4, 3)
    assert decode_plan.summary()["scc"]["recurrences"] == []
    assert scan_plan.summary()["scc"]["recurrences"]
    assert route_exe.plan.options.deps == "inspect"
    assert rescore_exe.plan.options.deps == "speculate"
    stats = compile_cache_stats()
    assert stats["misses"] == 4  # one per structure, first wave only
    assert stats["hits"] == 8  # four hits per subsequent wave


def test_serve_main_prints_the_reference_lines(cpu_default_service, capsys):
    run = serve.main(
        ["--arch", "yi_6b", "--requests", "6", "--slots", "3", "--max-new", "3",
         "--device", "cpu"]
    )
    out = capsys.readouterr().out
    assert "decode sync plan:" in out
    assert "compile cache" in out
    assert "cyclic scan plan:" in out
    assert "strategy=" in out
    assert "served 6 requests, 12 decode tokens" in out and "kv_quant=False" in out
    assert "per-wave latency (2 waves)" in out and "run_ms: n=2" in out
    assert "non-affine wave workloads:" in out and "sample: 0" in out
    assert run.waves == 2 and all(len(r.generated) == 3 for r in run.done)


def test_main_kv_quant_and_a_cuda_default_service_is_replaced(capsys):
    """Without a caller's service, the default one (CUDA) is replaced by one
    on the model's device; ``--kv-quant`` selects the int8 cache."""

    obs.reset_all()
    try:
        run = serve.main(
            ["--requests", "2", "--slots", "2", "--max-new", "2", "--kv-quant",
             "--device", "cpu"]
        )
        assert service_mod.default_service().options.device == "cpu"
        assert run.kv_quant and "kv_quant=True" in capsys.readouterr().out
    finally:
        obs.reset_all()


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1", "--max-new", "2"])
