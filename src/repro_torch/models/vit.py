"""ViT-small for the paper's CIFAR-10 demonstration (Fig. 6).

Twin of ``src/repro/models/vit.py``. The patch embedding is a
weight-stationary linear on the macro (role ``mlp_in``); the pre-norm
blocks run the shared layer library (``gqa_attention`` without a cache,
non-causal, absolute positions and no rope; the GELU MLP), so the SAC
policy (attention 4b wo/CB, MLP 6b w/CB) applies as in the paper; the
classifier head is digital. Layer ``i`` keys its CIM noise off
``fold_in(key, i)`` with the counter reset (``Ctx.for_layer``), the patch
embedding off the top-level context, as the reference's scan does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import parallel
from repro_torch.models.layers import Ctx, Params, dense, gelu_mlp, layernorm


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, n_patches, patch * patch * C)."""
    b, h, w, c = images.shape
    nh, nw = h // patch, w // patch
    x = images.reshape(b, nh, patch, nw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, patch * patch * c)


def _layer(tree, i: int):
    """Layer ``i`` of the stacked block params."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def vit_forward(params: Params, images: torch.Tensor, cfg: ModelConfig,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
    """images: (B, H, W, C) float in [0, 1] -> logits (B, n_classes).
    Raises under rules over a live mesh (ROADMAP A7.3)."""
    parallel.begin(cfg, images.shape[0], 1)
    ctx = ctx or Ctx.make(cfg)
    x = patchify(images.to(torch.float32), cfg.patch_size)
    x = dense(ctx, params["patch"], x, "mlp_in")
    b, _, d = x.shape
    x = torch.cat([params["cls"].expand(b, 1, d), x], dim=1) + params["pos"]
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        lctx = ctx.for_layer(i)
        p = _layer(blocks, i)
        hh, _ = attn.gqa_attention(lctx, p["attn"],
                                   layernorm(p["n1"], x, cfg.norm_eps),
                                   positions, None, causal=False)
        x = x + hh
        x = x + gelu_mlp(lctx, p["mlp"], layernorm(p["n2"], x, cfg.norm_eps))
    x = layernorm(params["head_norm"], x, cfg.norm_eps)
    return dense(ctx, params["head"], x[:, 0], "head")


def vit_loss(params: Params, images: torch.Tensor, labels: torch.Tensor,
             cfg: ModelConfig, ctx: Optional[Ctx] = None) -> torch.Tensor:
    """Mean cross-entropy of the class logits."""
    logits = vit_forward(params, images, cfg, ctx).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def vit_accuracy(params: Params, images: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, ctx: Optional[Ctx] = None) -> torch.Tensor:
    """Share of the batch whose arg-max class is the label (f32 scalar)."""
    logits = vit_forward(params, images, cfg, ctx)
    return torch.mean((torch.argmax(logits, -1) == labels.long())
                      .to(torch.float32))
