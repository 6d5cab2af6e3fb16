"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke twin).

The port's own copy of `repro.configs`: the same ten configurations, as
data.  `repro_torch.models.registry.get_model` builds the dense ones.

Ten assigned architectures plus the paper's own image-pipeline "configs"
(which live in repro_torch.pipelines).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "rwkv6-3b",
    "qwen3-4b",
    "deepseek-7b",
    "phi3-medium-14b",
    "minicpm-2b",
    "mixtral-8x7b",
    "qwen2-moe-a2.7b",
    "paligemma-3b",
    "whisper-medium",
    "zamba2-2.7b",
]

_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-7b": "deepseek_7b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minicpm-2b": "minicpm_2b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "paligemma-3b": "paligemma_3b",
    "whisper-medium": "whisper_medium",
    "zamba2-2.7b": "zamba2_2_7b",
}


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
