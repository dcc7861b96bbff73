"""Public model API: build an arch, get its init, loss and forward.

Twin of ``build`` in ``src/repro/models/model.py`` for every family.
``init(generator, device)`` draws torch-native parameters
(``core.deploy.init_params``); parameters converted from a JAX tree come
from ``core.deploy.params_from_jax``. ``loss(params, batch, key)`` is the
training objective (``lm_loss``; ``vit_loss`` on ``batch["images"]``,
``batch["labels"]``), each under ``Ctx.make(cfg, key)``. For encdec,
``forward`` and ``loss`` read the stub frame embeddings
``batch["frames"]`` (B, n_frames, d_model) beside ``batch["tokens"]``
(on an uncached or prefill forward; a decode step reads the cached
cross K/V). ``param_specs(cfg)`` is the shape tree (meta tensors, nothing
allocated) and the logical-axes tree of a config's parameters, the
sharding rules' input.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.deploy import init_axes, init_params
from repro_torch.models import transformer as tf
from repro_torch.models import vit
from repro_torch.models.layers import Ctx


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., torch.Tensor]
    forward: Callable[..., Tuple[torch.Tensor, Any]]


def build(cfg: ModelConfig) -> ModelAPI:
    def init(generator, device="cuda"):
        return init_params(cfg, generator, device)

    if cfg.family == "vit":
        return ModelAPI(
            cfg=cfg, init=init,
            loss=lambda params, batch, key=None: vit.vit_loss(
                params, batch["images"], batch["labels"], cfg,
                Ctx.make(cfg, key)),
            forward=lambda params, batch, key=None: (vit.vit_forward(
                params, batch["images"], cfg, Ctx.make(cfg, key)), None),
        )
    tf.check_family(cfg)
    return ModelAPI(
        cfg=cfg, init=init,
        loss=lambda params, batch, key=None: tf.lm_loss(
            params, batch, cfg, Ctx.make(cfg, key)),
        forward=lambda params, batch, key=None, caches=None: tf.forward(
            params, batch, cfg, Ctx.make(cfg, key), caches),
    )


def param_specs(cfg: ModelConfig) -> Tuple[Any, Any]:
    """(meta-tensor tree, logical-axes tree) without allocation. The axes
    come from the reduced config, as the reference's do: a family's tree
    has the same paths at every width."""
    shapes = init_params(cfg, torch.Generator().manual_seed(0), "meta")
    return shapes, init_axes(cfg.reduced())
