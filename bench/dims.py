"""A configuration file of ``bench/configs/`` read into the sizes that the
harness, the yardstick and the plain reference use.

The file keeps the published ``config.json``'s keys with the values as run;
``published`` holds the source's value of every key that differs, and
``BENCHMARK.json`` lists those keys under ``reduced``.  The harness refuses
a file that the decoder cannot run as written (a multiplier other than the
plain llama form).  The embedding table's padded row count is the port's
own rule; the harness fills ``padded_vocab`` from the port's configuration
(``harness.sized``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Dims:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    score_scale: float
    dtype: str
    tie_embeddings: bool
    padded_vocab: int = 0


def from_json(name: str, raw: dict) -> Dims:
    d, H = raw["hidden_size"], raw["num_attention_heads"]
    hd = raw.get("head_dim", d // H)
    for key, plain in (("embedding_multiplier", 1.0), ("residual_multiplier", 1.0),
                       ("logits_scaling", 1.0)):
        if raw.get(key, plain) != plain:
            raise ValueError(f"{name}: {key}={raw[key]!r}; the decoder runs only {plain!r}")
    if raw.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{name}: hidden_act {raw['hidden_act']!r}; the decoder runs silu")
    scale = raw.get("attention_multiplier", hd**-0.5)
    if abs(scale - hd**-0.5) > 1e-12:
        raise ValueError(f"{name}: attention_multiplier {scale}; the decoder scales by hd**-0.5")
    return Dims(
        name=name,
        num_layers=raw["num_hidden_layers"],
        d_model=d,
        num_heads=H,
        num_kv_heads=raw["num_key_value_heads"],
        head_dim=hd,
        d_ff=raw["intermediate_size"],
        vocab_size=raw["vocab_size"],
        rope_theta=float(raw["rope_theta"]),
        norm_eps=float(raw["rms_norm_eps"]),
        score_scale=float(scale),
        dtype=raw.get("torch_dtype", "bfloat16"),
        tie_embeddings=bool(raw.get("tie_word_embeddings", False)),
    )


def load(path: Path, name: str) -> Dims:
    return from_json(name, json.loads(Path(path).read_text()))
