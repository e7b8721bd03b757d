"""The benchmark's own tests, run on the CPU from the root of the repo:

    python -m pytest bench/tests

They put ``bench/`` and ``src/`` on the import path as ``bench/run.py``
does, and build cells at a size a test run holds."""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the smallest sizes at which the program's readings sit under the cells'
# limits and the control's above them, as at full size (the change of a
# small leaf is noisier: at d_model 256 and 4 layers sound runs read a
# change gap of 1.1e-3 to 1.3e-3)
TINY = {
    "hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 1021,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "torch_dtype": "bfloat16",
    "tie_word_embeddings": False,
}
TINY_TRAIN = dict(TINY, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                  num_attention_heads=8, tie_word_embeddings=True)  # tied, as granite's

MIXES = {
    "train": {"kind": "train", "batch": 4, "seq_len": 32, "warm_steps": 3, "remat": "full",
              "trace_calls": 1,
              "optimizer": json.loads((BENCH / "traffic" / "train-4x2048.json").read_text())["optimizer"]},
    "prefill_closed": {"kind": "prefill_closed", "batch": 2, "lengths": [48, 64],
                       "pool_calls": 20, "trace_calls": 2, "check_calls": 2},
    "decode_pool": {"kind": "decode_pool", "sequences": 4, "prompt_len": 16, "max_len": 80,
                    "prefill_batch": 2, "trace_calls": 2, "check_sequences": 2},
}


def tiny_cell(kind: str, limits=None, tied=None):
    import dims
    import harness

    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    name = next(w["name"] for w in spec["workloads"]
                if json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())["kind"] == kind)
    cell = harness.load_cell(name)
    raw = TINY_TRAIN if kind == "train" else TINY
    if tied is not None:
        raw = dict(raw, tie_word_embeddings=tied)
    cell.dims = harness.sized(dims.from_json("tiny", raw))
    cell.mix = copy.deepcopy(MIXES[kind])
    if limits is not None:
        cell.limits = limits
    return cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
