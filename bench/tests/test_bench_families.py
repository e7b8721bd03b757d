"""The cells' configurations through their family (``families/llama.py``,
which ``llama`` and ``granite`` use) give, value for value, what the dense
code gave before it moved into a family: the leaves, the seeded weights,
the reference's logits, the operations, the bytes and the flash bounds.

The pins were taken from the dense code as it stood before the families
(on the CPU, torch 2.13, one thread).  The weights and the logits are of a
cut of each configuration to 2 layers, every width as published."""

import hashlib
import json

import pytest
import torch
from conftest import BENCH

import harness
import traffic
import weights
import yardstick

ROOT = BENCH.parent
SEEDS = (7, 2**31 + 101)

PINS = {
    "granite-3-2b": {
        "cell": "granite-3-2b.prefill-pool",
        "specs": (362, "e7b5aa98ec10fad7ff41b285a0b719d9de2455dacc48b8d118faeb0ad6914573"),
        "prefill_flops": {2048: 42608223109120.0, 2560: 54119071006720.0,
                          3072: 65973516288000.0, 3584: 78171558952960.0,
                          4096: 90713199001600.0},
        "train_step_flops": 132770357575680.0,
        "decode_step_bytes": {2049: 48060059648, 3071: 69492953088},
        "flash_bound_4x4096": 0.01112012197403438,
        "weights": {7: "7ae2fec46420f4d446d31d7a3419f7b8e99fb803711e8c26ffa2f7506bd8a0b2",
                    2**31 + 101: "c5e29ded4622c6f78ee373f6551313110892542db8227136f22fc9af65609bf3"},
        "logits": "6e3fe1a05c2fba98b873d4aeff2120d45f7bab5f19cae6ac56d89053b03831ba",
    },
    "yi-6b": {
        "cell": "yi-6b.prefill-pool",
        "specs": (291, "ae0863cfc04269088143d3401f3a76cd4b2dd856d0fca59b0790947db23111f8"),
        "prefill_flops": {2048: 95112000438272.0, 2560: 120263865794560.0,
                          3072: 145965486964736.0, 3584: 172216863948800.0,
                          4096: 199017996746752.0},
        "train_step_flops": 298214611746816.0,
        "decode_step_bytes": {2049: 45993705472, 3071: 63140020224},
        "flash_bound_4x4096": 0.017792195158455006,
        "weights": {7: "1f23e7b1c6ae16dcb9140614341a028bb6f071555dfd7ff64ecdc64bc7003806",
                    2**31 + 101: "20d31c02c04e697739c41809a890ef50966e3e7d6ea727cc71cca6a569a65316"},
        "logits": "d68ec0ee5a0b4807707c1ed8c0082d5f03f10b04147b5559f029fd1950ca9323",
    },
}


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cut(config: str):
    """The configuration cut to 2 layers, and its family."""

    raw = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    family = harness.family_of(raw["model_type"])
    return family, harness.sized(family, family.dims(config, dict(raw, num_hidden_layers=2)))


def _digest(flat) -> str:
    h = hashlib.sha256()
    for path, t in flat.items():
        h.update(repr(path).encode())
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        h.update(t.contiguous().view(bits).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(PINS))
def test_leaf_specs_are_the_dense_codes(config):
    cell = harness.load_cell(PINS[config]["cell"])
    specs = cell.family.leaf_specs(cell.dims)
    assert (len(specs), hashlib.sha256(repr(specs).encode()).hexdigest()) == PINS[config]["specs"]


@pytest.mark.parametrize("config", sorted(PINS))
def test_arithmetic_is_the_dense_codes(config):
    pin = PINS[config]
    cell = harness.load_cell(pin["cell"])
    fam, d = cell.family, cell.dims
    assert {S: fam.prefill_flops(d, 4, S) for S in cell.mix["lengths"]} == pin["prefill_flops"]
    assert fam.train_step_flops(d, 4, 2048) == pin["train_step_flops"]
    assert {n: fam.decode_step_bytes(d, 256, n) for n in (2049, 3071)} == pin["decode_step_bytes"]
    assert yardstick.flash_bound_sum(fam.flash_calls(d, 4, 4096)) == pin["flash_bound_4x4096"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", sorted(PINS))
def test_weights_and_reference_logits_are_the_dense_codes(config, seed, one_thread):
    """make_flat of the family's leaves at two seeds; at the first, the
    reference's logits at the last position of a 24-token prompt."""

    family, cut = _cut(config)
    cpu = torch.device("cpu")
    flat = weights.make_flat(family.leaf_specs(cut), seed, cpu)
    assert _digest(flat) == PINS[config]["weights"][seed]
    if seed == SEEDS[0]:
        toks = traffic.prompts(seed, 0, 1, 24, cut.vocab_size, cpu)[0]
        logits = family.last_logits(flat, toks, cut, family.exact)
        assert hashlib.sha256(logits.numpy().tobytes()).hexdigest() == PINS[config]["logits"]


def test_a_model_type_without_a_family_stops_the_run(tmp_path):
    """The message names the module that is missing."""

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    raw = json.loads((BENCH / "configs" / "yi-6b.json").read_text())
    (tmp_path / "x.json").write_text(json.dumps(dict(raw, model_type="no_such_family")))
    spec["configs"][[c["name"] for c in spec["configs"]].index("yi-6b")]["file"] = "x.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(SystemExit, match=r"families\.no_such_family"):
        harness.load_cell("yi-6b.prefill-pool", tmp_path / "BENCHMARK.json")
