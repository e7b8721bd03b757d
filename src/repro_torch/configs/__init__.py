"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full published config; ``get_smoke_config``
returns a reduced same-family config for CPU smoke tests."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_applicable,
    shape_by_name,
)

ARCHITECTURES: List[str] = [
    "deepseek_moe_16b",
    "mixtral_8x7b",
    "gemma3_27b",
    "yi_6b",
    "granite_3_2b",
    "internlm2_20b",
    "jamba_v01_52b",
    "mamba2_2_7b",
    "whisper_medium",
    "llava_next_34b",
]

_ALIASES: Dict[str, str] = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma3-27b": "gemma3_27b",
    "yi-6b": "yi_6b",
    "granite-3-2b": "granite_3_2b",
    "internlm2-20b": "internlm2_20b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-medium": "whisper_medium",
    "llava-next-34b": "llava_next_34b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.config()


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke_config()


__all__ = [
    "ARCHITECTURES",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "canonical",
    "cell_is_applicable",
    "get_config",
    "get_smoke_config",
    "shape_by_name",
]
