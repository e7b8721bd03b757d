"""A family added as files alone: ``tests/families/tiny_moe.py`` (a tiny
decoder whose layers alternate a dense MLP and a mixture of experts with
shared experts) and its plain reference ``tests/reference/tiny_moe.py``,
found by the configuration's ``model_type`` as a file of ``bench/families/``
would be.  A temporary spec written here names its configuration, traffic
mix and limits; the run goes through ``load_cell``, the seeded weights and
``prefill_closed``'s set-up, calls and check, on the CPU."""

import json
import time

import pytest
import torch
from conftest import BENCH, MIXES

import harness

SEED = 2**31 + 77
# a seed at which a sampled prompt's last position is a near tie of the
# router's second and third expert, and the port takes the third
TIED_SEED = 1000003 * 4 + 2**31
CELL = "tiny-moe.prefill"
# deepseek_moe_16b.smoke_config's sizes, its one block a dense and an expert
# layer; capacity factor num_experts / top_k: an expert's slots hold every
# token of a dispatch group, so the port drops no (token, expert) pair
CONFIG = {
    "model_type": "tiny_moe", "hidden_size": 64, "intermediate_size": 96,
    "moe_intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "head_dim": 16, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 2, "expert_layer_period": 2,
    "expert_layer_offset": 1, "moe_group_size": 32, "moe_capacity_factor": 4.0,
    "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
LIMITS = {"served_gap": {"limit": 0.25}, "logit_gap": {"limit": 0.4}}


@pytest.fixture
def spec(tmp_path, monkeypatch):
    """The temporary spec; the fixture's family and reference modules are
    made findable beside the benchmark's own."""

    import families
    import reference

    monkeypatch.setattr(families, "__path__", [*families.__path__, str(BENCH / "tests" / "families")])
    monkeypatch.setattr(reference, "__path__",
                        [*reference.__path__, str(BENCH / "tests" / "reference")])
    files = {
        "bench/configs/tiny-moe.json": CONFIG,
        "bench/traffic/tiny-prefill.json": MIXES["prefill_closed"],
        f"bench/limits/{CELL}.json": LIMITS,
        "BENCHMARK.json": {
            "paths": ["bench"],
            "configs": [{"name": "tiny-moe", "file": "bench/configs/tiny-moe.json"}],
            "workloads": [{"name": CELL, "config": "tiny-moe", "traffic": "tiny-prefill",
                           "chips": 1}],
            "end_to_end": [{"name": "ttft_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "mfu.prefill", "unit": "%"},
                          {"name": "flash_roofline", "unit": "%"}],
        },
    }
    for name, body in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(json.dumps(body))
    return tmp_path / "BENCHMARK.json"


def _run(spec, trace=False):
    cell = harness.load_cell(CELL, spec)
    return cell, harness.run(cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_the_fixture_family_reads_correct(spec, trace):
    cell, out = _run(spec, trace)
    assert cell.family.__name__ == "families.tiny_moe"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    if not trace:
        assert set(out["metrics"]) == {"ttft_p95_ms", "setup_s"}


def test_a_token_altered_in_the_fixtures_prefill_reads_not_correct(spec, monkeypatch):
    from repro_torch.launch import steps

    make = steps.make_prefill_step

    def altered(cfg):
        step = make(cfg)

        def prefill(params, batch, cache):
            logits, cache = step(params, batch, cache)
            best = torch.argmax(logits[0, -1, :cfg.vocab_size])
            logits = logits.clone()
            logits[0, -1, (best + 1) % cfg.vocab_size] += 1e4
            return logits, cache

        return prefill

    monkeypatch.setattr(steps, "make_prefill_step", altered)
    assert not _run(spec)[1]["correct"]


def test_the_fixture_refuses_a_capacity_that_drops_pairs(spec):
    import families

    family = harness.family_of("tiny_moe")
    assert family is families.tiny_moe
    with pytest.raises(ValueError, match="drop"):
        family.dims("x", dict(CONFIG, moe_capacity_factor=1.25))


def _window(spec, seed):
    cell = harness.load_cell(CELL, spec)
    drv = harness.driver_for(cell, seed, torch.device("cpu"))
    drv.setup()
    iters = [dict(drv.call(i), traced=False) for i in range(40)]
    return drv, iters


def test_the_control_reads_not_correct(spec):
    import control

    drv, iters = _window(spec, SEED)
    row = control.after_window(drv, iters, True)
    assert all(row["program"][k] <= v["limit"] for k, v in LIMITS.items()), row
    assert any(row["control"][k] > v["limit"] for k, v in LIMITS.items()), row


def test_a_router_near_tie_is_judged_against_either_choice(spec):
    """The reference gives a second row for the tied prompt; the program's
    logits lie far from the first and near the second."""

    drv, iters = _window(spec, TIED_SEED)
    drv.release()
    w = drv.flat_weights()
    tied = []
    for r in drv.sample(iters):
        for b, toks in enumerate(drv.prompts[r["prompt"]]):
            rows = drv.family.last_logits(w, toks, drv.dims, drv.family.exact)
            if rows.dim() == 2:
                row = r["logits"][b, :drv.dims.vocab_size].float()
                tied.append([float((row - x).abs().max() / x.std()) for x in rows])
    assert any(g[0] > LIMITS["logit_gap"]["limit"] > g[1] for g in tied), tied
    assert all(v <= LIMITS[k]["limit"] for k, v in drv.check(iters).items())
