"""Public model API: build an arch, get its init and forward.

Twin of ``build`` in ``src/repro/models/model.py`` for the dense, ssm and
moe (MLA) families.
``init(generator, device)`` draws torch-native parameters
(``core.deploy.init_params``); parameters converted from a JAX tree come
from ``core.deploy.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.deploy import init_params
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Tuple[torch.Tensor, Any]]


def build(cfg: ModelConfig) -> ModelAPI:
    tf.check_family(cfg)
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device="cuda": init_params(cfg, generator,
                                                          device),
        forward=lambda params, batch, key=None, caches=None: tf.forward(
            params, batch, cfg, Ctx.make(cfg, key), caches),
    )
