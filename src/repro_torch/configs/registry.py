"""--arch <id> registry: the JAX package's 10 assigned architectures and
the paper's ViT."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "vit-small-cifar": "repro_torch.configs.vit_small_cifar",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_archs() -> List[str]:
    return sorted(_MODULES)
