"""Decoder-LM assembly for the dense family (GQA + SwiGLU pre-norm blocks),
the ssm family (pre-norm mamba2 blocks) and the moe family with MLA
attention (deepseek-v2: MLA + routed and shared experts).

Twin of the dense, ssm and moe parts of ``src/repro/models/transformer.py``.
The layer stack is a Python loop over the layers (the reference scans over
stacked parameters); layer ``i`` keys its CIM noise off
``fold_in(ctx.key, i)`` exactly as the reference's scan body does.

Caches are stacked over layers like the reference's: dense
``{"k": (L, B, T, KV, D), "v": ..., ["ks", "vs": (L, B, T, KV, 1)],
"len": (L, B)}``; ssm ``{"conv": (L, B, width-1, conv_dim) in the model
dtype, "state": (L, B, H, P, N) f32}``, with no length; MLA
``{"ckv": (L, B, T, kv_lora), "krope": (L, B, T, rope_hd), "len": (L, B)}``. ``forward``
writes the new keys (or window and state) in place and returns the same
dict; ``take_slot`` returns views of one slot row, so a forward on a
slot's views updates the engine's cache without a copy.

With ``cfg.fuse_layer`` a decode-shaped dense block runs as one launch of
the per-layer megakernel (``kernels/fused_step.py``), routed exactly where
the reference routes it (``_use_fused_layer``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.deploy import dtype_of
from repro_torch.kernels.fused_step import (fused_dense_layer, kernel_takes,
                                            layer_specs)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Ctx, Params, embed, rmsnorm, swiglu, \
    unembed

_NOT_PORTED = "is not ported yet; ROADMAP.md lists it as later work"


def _use_fused_layer(ctx: Ctx, p: Params, x, cache) -> bool:
    """Route a decode-shaped dense block through the per-layer megakernel
    (``kernels/fused_step.py``): single-token cached decode of a float32
    model with rope, in ideal-digital ("off") mode or in sim mode on
    deployed planes with a key and a clip-fitted activation scale. On the
    card, only where the kernel takes the shape (``kernel_takes``); the
    plain version on the CPU takes any, so there the route is the
    reference's."""
    cfg = ctx.cfg
    if not (cfg.fuse_layer and cache is not None and x.shape[1] == 1):
        return False
    if not cfg.use_rope or x.dtype != torch.float32:
        return False
    if x.device.type == "cuda" and not kernel_takes(cfg, x.shape[0],
                                                    layer_specs(ctx)):
        return False        # a shape the kernel cannot take serves unfused
    if ctx.mode == "off":
        return True
    spec = ctx.spec_for("attn_qkv")
    return (ctx.mode == "sim" and ctx.key is not None
            and cfg.cim.act_clip_sigmas > 0
            and f"wq{spec.w_bits}" in p["attn"]["q"])


def _dense_block(ctx: Ctx, p: Params, x, positions, cache):
    if _use_fused_layer(ctx, p, x, cache):
        return fused_dense_layer(ctx, p, x, cache)
    h, new_cache = attn.gqa_attention(
        ctx, p["attn"], rmsnorm(p["n1"], x, ctx.cfg.norm_eps), positions,
        cache)
    x = x + h
    x = x + swiglu(ctx, p["mlp"], rmsnorm(p["n2"], x, ctx.cfg.norm_eps))
    return x, new_cache


def _ssm_block(ctx: Ctx, p: Params, x, positions, cache):
    h, new_cache = ssm_mod.mamba2_block(
        ctx, p["mamba"], rmsnorm(p["n"], x, ctx.cfg.norm_eps), cache)
    return x + h, new_cache


def _moe_block(ctx: Ctx, p: Params, x, positions, cache):
    h, new_cache = attn.mla_attention(
        ctx, p["attn"], rmsnorm(p["n1"], x, ctx.cfg.norm_eps), positions,
        cache)
    x = x + h
    # serving (cached) forwards route dropless, as in the reference
    x = x + moe_mod.moe_block(ctx, p["moe"],
                              rmsnorm(p["n2"], x, ctx.cfg.norm_eps),
                              dropless=cache is not None)
    return x, new_cache


_BLOCKS = {"dense": _dense_block, "ssm": _ssm_block, "moe": _moe_block}


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _BLOCKS:
        raise NotImplementedError(f"family {cfg.family!r} {_NOT_PORTED}")
    if cfg.family == "moe" and cfg.mla is None:
        raise NotImplementedError(
            f"the moe family with GQA attention ({cfg.name}) {_NOT_PORTED}")


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Stacked per-layer decoding caches (leading 'layers' axis)."""
    check_family(cfg)
    if cfg.family == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, dtype_of(cfg), device)
    elif cfg.family == "moe":
        one = attn.init_mla_cache(cfg, batch, max_len, dtype_of(cfg), device)
    else:
        one = attn.init_gqa_cache(cfg, batch, max_len, dtype_of(cfg), device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim)
            for k, v in one.items()}


def take_slot(caches, slot: int) -> Dict[str, torch.Tensor]:
    """Batch-1 views of one slot row of the stacked slot cache."""
    return {k: v[:, slot:slot + 1] for k, v in caches.items()}


def put_slot(caches, slot_caches, slot: int):
    """Write a batch-1 slot cache back into row ``slot`` (the inverse of
    ``take_slot``; a no-op copy when ``slot_caches`` are its views)."""
    for k, v in caches.items():
        v[:, slot:slot + 1].copy_(slot_caches[k])
    return caches


def set_cache_lens(caches, value) -> Dict[str, torch.Tensor]:
    """Overwrite every per-sequence 'len' with ``value`` (broadcast), in
    place; a cache without lengths (ssm) is left as it is."""
    if "len" in caches:
        caches["len"].copy_(torch.as_tensor(value).to(caches["len"].dtype)
                            .expand_as(caches["len"]))
    return caches


# leaves a decode step must leave unchanged in inactive slots: the length,
# and the ssm window and state, which every step rolls and decays in place
# (attention K/V and MLA latent writes land past the frozen length, where
# no mask looks)
_FROZEN = ("len", "conv", "state")


def freeze_rows(caches, rows: List[int]) -> Dict[str, torch.Tensor]:
    """Copies of the ``_FROZEN`` leaves of slot rows ``rows``, taken before a
    batch decode step, for ``mask_cache_advance`` (the twin of the
    reference's host-list form; the engine freezes by a device mask)."""
    if not rows:
        return {}
    idx = torch.tensor(rows, device=next(iter(caches.values())).device)
    return {k: v.index_select(1, idx) for k, v in caches.items()
            if k in _FROZEN}


def freeze_all(caches) -> Dict[str, torch.Tensor]:
    """Copies of the whole ``_FROZEN`` leaves, for ``mask_cache_advance_by``:
    the form of ``freeze_rows`` that takes no host list of rows, so that a
    CUDA graph of the decode step replays under any active mask (the
    engine refills one such copy before every decode step)."""
    return {k: v.clone() for k, v in caches.items() if k in _FROZEN}


def mask_cache_advance_by(new_caches, frozen: Dict[str, torch.Tensor],
                          active: torch.Tensor):
    """``mask_cache_advance`` under a device (B,) bool mask: slot rows that
    are not active take back the ``freeze_all`` copies (a select: the same
    values as ``index_copy_``, bit for bit)."""
    for k, old in frozen.items():
        leaf = new_caches[k]
        m = active.reshape((1, -1) + (1,) * (leaf.ndim - 2))
        leaf.copy_(torch.where(m, leaf, old))
    return new_caches


def mask_cache_advance(new_caches, frozen: Dict[str, torch.Tensor],
                       rows: List[int]):
    """Freeze inactive slots after a batch decode step: rows ``rows`` of the
    ``_FROZEN`` leaves go back to the copies ``freeze_rows`` took, as the
    reference's ``mask_cache_advance`` does."""
    if rows:
        idx = torch.tensor(rows, device=next(iter(new_caches.values())).device)
        for k, old in frozen.items():
            new_caches[k].index_copy_(1, idx, old)
    return new_caches


def cache_len(caches) -> torch.Tensor:
    """Per-sequence lengths (B,) already written into the cache (zeros for
    a state cache, which carries none)."""
    if "len" not in caches:
        return torch.zeros((caches["conv"].shape[1],), dtype=torch.int32,
                           device=caches["conv"].device)
    return caches["len"][0]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _run_blocks(ctx: Ctx, blocks: Params, x, positions, caches):
    for i in range(ctx.cfg.n_layers):
        lctx = ctx.for_layer(i)
        layer_cache = None if caches is None else _index(caches, i)
        x, _ = _BLOCKS[ctx.cfg.family](lctx, _index(blocks, i), x,
                                       positions, layer_cache)
    return x, caches


def forward(params: Params, batch: Dict[str, Any], cfg: ModelConfig,
            ctx: Optional[Ctx] = None, caches=None
            ) -> Tuple[torch.Tensor, Any]:
    """Forward to logits. train: caches=None; prefill/decode: the stacked
    cache, updated in place."""
    check_family(cfg)
    ctx = ctx or Ctx.make(cfg)
    x = embed(params["embed"], batch["tokens"], dtype_of(cfg))
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device)[None]
    if caches is None:
        positions = steps.expand(b, s)
    else:
        positions = cache_len(caches)[:, None] + steps
    x, caches = _run_blocks(ctx, params["blocks"], x, positions, caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(ctx, params["embed"], x), caches
