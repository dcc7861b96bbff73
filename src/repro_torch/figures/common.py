"""Shared pieces of the figures: the trained tiny ViT and its accuracy.

Torch ports of ``benchmarks/common.py``'s ``trained_tiny_vit`` and
``vit_eval_acc``: a 4-layer, d 192 ViT trained with noise-aware QAT (the
paper's SAC policy) on the procedural CIFAR-shaped task, cached under
``build/`` after its first training, and its accuracy over eval batches
in a given CIM mode and noise multiplier.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CIMModelConfig, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.core.sac import Policy
from repro_torch.data.pipeline import DataConfig, image_batch
from repro_torch.models.layers import Ctx
from repro_torch.models.vit import vit_accuracy
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.trainer import make_train_step

CACHE = os.path.join("build", "figures", "tiny_vit")
DATA = DataConfig(seed=5, global_batch=64)


def tiny_vit_config() -> ModelConfig:
    cfg = get_config("vit-small-cifar").reduced()
    return dataclasses.replace(
        cfg, n_layers=4, d_model=192, d_ff=384, n_heads=4, n_kv_heads=4,
        head_dim=48, cim=CIMModelConfig(mode="qat", policy="paper_sac"))


def images(step: int, split: str, dev):
    """Batch ``step`` of the procedural task's ``split`` (64 images)."""
    x, y = image_batch(DATA, step, split=split)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def train_vit(cfg: ModelConfig, steps: int, dev,
              warmup: int = 15) -> Tuple[Any, list]:
    """Noise-aware QAT of ``cfg`` (lr 1.5e-3, weight decay 0.01) from the
    params of seed 0: step ``s`` trains on ``images(s, "train")`` under
    ``fold_in(PRNGKey(1), s)``. Returns the params and the step losses."""
    params = _init(cfg, dev)
    opt_cfg = opt_mod.OptConfig(lr=1.5e-3, warmup_steps=warmup,
                                total_steps=steps, weight_decay=0.01)
    opt = opt_mod.init_opt_state(params)
    step = make_train_step(cfg, opt_cfg)
    losses = []
    for s in range(steps):
        x, y = images(s, "train", dev)
        params, opt, m = step(params, opt, {"images": x, "labels": y},
                              prng.fold_in(prng.PRNGKey(1), s))
        losses.append(m["loss"])
    return params, [float(v) for v in losses]


def _init(cfg: ModelConfig, dev):
    from repro_torch.core.deploy import init_params
    return init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def trained_tiny_vit(steps: int = 200, device="cuda") -> Tuple[ModelConfig,
                                                               Any]:
    """The tiny ViT after ``steps`` QAT steps: loaded from ``build/`` when
    a run of the same length on the same kind of device is cached there,
    else trained and cached."""
    dev = resolve_device(device)
    cfg = tiny_vit_config()
    ckpt = CheckpointManager(f"{CACHE}_{dev.type}", keep=1)
    if ckpt.latest_step() == steps:
        (params,), _ = ckpt.restore(steps, (_init(cfg, dev),))
        return cfg, params
    params, _ = train_vit(cfg, steps, dev)
    ckpt.save(steps, (params,))
    return cfg, params


def with_noise_scale(policy: Policy, scale: float) -> Policy:
    """``policy`` with every spec's output noise multiplied by ``scale``."""
    return dataclasses.replace(
        policy,
        attn=(dataclasses.replace(policy.attn, noise_scale=scale)
              if policy.attn else None),
        mlp=(dataclasses.replace(policy.mlp, noise_scale=scale)
             if policy.mlp else None))


def vit_eval_acc(cfg: ModelConfig, params, mode: str,
                 noise_scale: float = 1.0, batches: int = 4,
                 device="cuda") -> float:
    """Mean accuracy over eval batches 2000 .. of ``image_batch``, batch
    ``s`` under ``fold_in(PRNGKey(9), s)``."""
    dev = resolve_device(device)
    accs = []
    for s in range(batches):
        x, y = images(2000 + s, "eval", dev)
        ctx = Ctx.make(cfg, prng.fold_in(prng.PRNGKey(9), s), mode=mode)
        if ctx.policy is not None and noise_scale != 1.0:
            ctx.policy = with_noise_scale(ctx.policy, noise_scale)
        accs.append(float(vit_accuracy(params, x, y, cfg, ctx)))
    return float(np.mean(accs))
