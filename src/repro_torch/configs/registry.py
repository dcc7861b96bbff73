"""--arch <id> registry of the archs the port can build."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "vit-small-cifar": "repro_torch.configs.vit_small_cifar",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to PyTorch yet; the port builds "
            f"{sorted(_MODULES)} (ROADMAP.md lists the other families)")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_archs() -> List[str]:
    return sorted(_MODULES)
