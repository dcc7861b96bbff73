"""Decoder-LM assembly for every LM family of the registry: dense (GQA +
SwiGLU pre-norm blocks), vlm (the dense blocks behind a stub patch prefix:
pixtral's backbone), ssm (pre-norm mamba2 blocks), moe (MLA attention with
routed and shared experts, deepseek-v2; or GQA attention with routed
experts, olmoe), hybrid (zamba2: super-blocks of ``attn_period - 1``
mamba2 layers and one attention+MLP block whose weights all super-blocks
share) and encdec (whisper: a bidirectional encoder over stub frame
embeddings, a causal decoder with cross-attention).

Twin of ``src/repro/models/transformer.py``.
The layer stack is a Python loop over the layers (the reference scans over
stacked parameters); layer ``i`` keys its CIM noise off
``fold_in(ctx.key, i)`` exactly as the reference's scan body does. A
hybrid super-block ``i`` has one such context, which its mamba layers and
the shared block draw from in turn (11 keys for zamba2: in_proj, out_proj
twice, then q, k, v, o, gate, up, down); encoder layer ``i`` is keyed
``fold_in(key, i)``, decoder layer ``i`` ``fold_in(key, 1000 + i)``.

Caches are stacked over layers like the reference's: dense
``{"k": (L, B, T, KV, D), "v": ..., ["ks", "vs": (L, B, T, KV, 1)],
"len": (L, B)}`` (also vlm and moe with GQA); ssm ``{"conv": (L, B,
width-1, conv_dim) in the model dtype, "state": (L, B, H, P, N) f32}``,
with no length; MLA
``{"ckv": (L, B, T, kv_lora), "krope": (L, B, T, rope_hd), "len": (L, B)}``;
hybrid one flat dict, ``conv``/``state`` (n_super * n_mamba, B, ...) in
super-block-major order and ``k``/``v``/``len`` (with ``ks``/``vs``)
(n_super, B, ...) (the reference nests them, ``hybrid_nested`` gives its
layout as views); encdec the decoder's GQA self-cache over its layers,
joined at prefill by the encoder memory's cross K/V ``xk``/``xv`` (L, B,
n_frames, KV, D). The slot is axis 1 of every leaf. ``forward``
writes the new keys (or window and state) in place and returns the same
dict; ``take_slot`` returns views of one slot row, so a forward on a
slot's views updates the engine's cache without a copy.

With ``cfg.fuse_layer`` a decode-shaped dense block runs as one launch of
the per-layer megakernel (``kernels/fused_step.py``), routed exactly where
the reference routes it (``_use_fused_layer``).

Under rules over a live mesh of more than one rank the dense, vlm and
moe-with-GQA families run tensor- and expert-parallel
(``models/parallel.py``, ``models/moe.py``; the fused layer's route
serves unfused there); the other families raise ``NotImplementedError``
naming ROADMAP A7.3. ``shard`` stands at the reference's call sites.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.deploy import dtype_of
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import get_rules, shard
from repro_torch.kernels.fused_step import (fused_dense_layer, kernel_takes,
                                            layer_specs)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Ctx, Params, embed, gelu_mlp, \
    layernorm, rmsnorm, sinusoidal_positions, swiglu, unembed

def _use_fused_layer(ctx: Ctx, p: Params, x, cache) -> bool:
    """Route a decode-shaped dense block through the per-layer megakernel
    (``kernels/fused_step.py``): single-token cached decode of a float32
    model with rope and no guard or fault instrumentation, in
    ideal-digital ("off") mode or in sim mode on deployed planes with a key
    and a clip-fitted activation scale. On the card, only where the kernel
    takes the shape (``kernel_takes``); the plain version on the CPU takes
    any, so there the route is the reference's."""
    cfg = ctx.cfg
    if not (cfg.fuse_layer and cache is not None and x.shape[1] == 1):
        return False
    if ctx.guard is not None or ctx.fault is not None:
        return False
    if not cfg.use_rope or x.dtype != torch.float32 or ctx.tp is not None:
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
    return shard(x, "batch", "seq", "embed"), new_cache


def _ssm_block(ctx: Ctx, p: Params, x, positions, cache):
    h, new_cache = ssm_mod.mamba2_block(
        ctx, p["mamba"], rmsnorm(p["n"], x, ctx.cfg.norm_eps), cache)
    return shard(x + h, "batch", "seq", "embed"), new_cache


def _moe_block(ctx: Ctx, p: Params, x, positions, cache):
    xn = rmsnorm(p["n1"], x, ctx.cfg.norm_eps)
    if ctx.cfg.mla is not None:
        h, new_cache = attn.mla_attention(ctx, p["attn"], xn, positions,
                                          cache)
    else:
        h, new_cache = attn.gqa_attention(ctx, p["attn"], xn, positions,
                                          cache)
    x = x + h
    # serving (cached) forwards route dropless, as in the reference
    x = x + moe_mod.moe_block(ctx, p["moe"],
                              rmsnorm(p["n2"], x, ctx.cfg.norm_eps),
                              dropless=cache is not None)
    return shard(x, "batch", "seq", "embed"), new_cache


_BLOCKS = {"dense": _dense_block, "vlm": _dense_block, "ssm": _ssm_block,
           "moe": _moe_block}
_SSM_LEAVES = ("conv", "state")
_CROSS_LEAVES = ("xk", "xv")


def check_family(cfg: ModelConfig) -> None:
    """Raise on a family this module does not assemble (vit lives in
    ``models/vit.py``)."""
    if cfg.family not in _BLOCKS and cfg.family not in ("hybrid", "encdec"):
        raise ValueError(f"family {cfg.family!r} is not a decoder-LM "
                         f"family of models/transformer.py")


def hybrid_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(super-blocks, mamba layers a super-block) of a hybrid config."""
    return cfg.n_layers // cfg.attn_period, cfg.attn_period - 1


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree; a plane that ``deploy(rules=)``
    placed as a DTensor gives layer ``i`` of this rank's block (the
    layers axis is never split)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if hasattr(tree, "to_local"):
        return tree.to_local()[i]
    return tree[i]


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Stacked per-layer decoding caches (leading 'layers' axis); on a live
    mesh this rank's rows and KV heads (``parallel.local_cache_dims``)."""
    check_family(cfg)
    if col.live_mesh(get_rules()) is not None:
        parallel.check_family(cfg, "cache")
    dt = dtype_of(cfg)

    def stack(one, n):
        return {k: v[None].repeat((n,) + (1,) * v.ndim)
                for k, v in one.items()}

    if cfg.family == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, dt, device)
    elif cfg.family == "moe" and cfg.mla is not None:
        one = attn.init_mla_cache(cfg, batch, max_len, dt, device)
    elif cfg.family == "hybrid":
        n_super, n_mamba = hybrid_dims(cfg)
        return {**stack(ssm_mod.init_ssm_cache(cfg, batch, dt, device),
                        n_super * n_mamba),
                **stack(attn.init_gqa_cache(cfg, batch, max_len, dt,
                                            device), n_super)}
    else:
        one = attn.init_gqa_cache(cfg, batch, max_len, dt, device)
    return stack(one, cfg.n_layers)


def hybrid_nested(cfg: ModelConfig, caches) -> Dict[str, Any]:
    """A hybrid flat cache as views in the reference's nested layout:
    ``{"mamba": {"conv", "state": (n_super, n_mamba, B, ...)}, "attn":
    {"k", "v", "len", ...: (n_super, B, ...)}}``."""
    n_super, n_mamba = hybrid_dims(cfg)
    return {"mamba": {k: caches[k].reshape((n_super, n_mamba)
                                           + caches[k].shape[1:])
                      for k in _SSM_LEAVES},
            "attn": {k: v for k, v in caches.items()
                     if k not in _SSM_LEAVES}}


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


def _leaves(caches, i: int, keys):
    """Layer ``i``'s views of the cache leaves ``keys`` (None uncached)."""
    if caches is None:
        return None
    return {k: caches[k][i] for k in keys if k in caches}


def _run_blocks(ctx: Ctx, params: Params, x, positions, caches):
    """The layer stack. Under a guard each layer gets fresh trip and hard
    lists and its pinned rows ``pin_layers[:, i]``; the per-layer sums are
    stacked into (L, B) ``ctx.guard_trips`` / ``ctx.guard_hard``, as the
    reference's scan outputs them."""
    if ctx.cfg.family == "hybrid":
        return _hybrid_blocks(ctx, params, x, positions, caches)
    blocks = params["blocks"]
    guard = ctx.guard is not None
    trips, hard = [], []
    for i in range(ctx.cfg.n_layers):
        lctx = ctx.for_layer(i)
        if guard:
            lctx.trip_log, lctx.hard_log = [], []
            if ctx.pin_layers is not None:
                lctx.pin_rows = ctx.pin_layers[:, i]
        layer_cache = None if caches is None else _index(caches, i)
        x, _ = _BLOCKS[ctx.cfg.family](lctx, _index(blocks, i), x,
                                       positions, layer_cache)
        if guard:
            zero = torch.zeros((x.shape[0],), dtype=torch.int32,
                               device=x.device)
            trips.append(sum(lctx.trip_log, zero))
            hard.append(sum(lctx.hard_log, zero))
    if guard:
        ctx.guard_trips, ctx.guard_hard = torch.stack(trips), torch.stack(hard)
    return x


def _hybrid_blocks(ctx: Ctx, params: Params, x, positions, caches):
    """zamba2's super-blocks: ``n_mamba`` mamba2 layers, then the shared
    attention+MLP block (the same weights in every super-block, its own
    GQA cache in each), all keyed by the super-block's one context."""
    n_super, n_mamba = hybrid_dims(ctx.cfg)
    attn_keys = [k for k in (caches or {}) if k not in _SSM_LEAVES]
    for i in range(n_super):
        lctx = ctx.for_layer(i)
        sp = _index(params["mamba_blocks"], i)
        for j in range(n_mamba):
            x, _ = _ssm_block(lctx, _index(sp, j), x, positions,
                              _leaves(caches, i * n_mamba + j, _SSM_LEAVES))
        x, _ = _dense_block(lctx, params["shared_attn"], x, positions,
                            _leaves(caches, i, attn_keys))
    return x


def _embed_input(ctx: Ctx, params: Params, batch: Dict[str, Any]):
    """Token embeddings; for vlm behind ``batch["patch_embeds"]`` (B, P, d),
    the stub vision frontend's prefix, when the batch carries one. On a
    live mesh this rank's rows (``parallel.embed``)."""
    cfg, tp = ctx.cfg, ctx.tp
    if tp is None:
        x = embed(params["embed"], batch["tokens"], dtype_of(cfg))
    else:
        x = parallel.embed(tp, params["embed"], batch["tokens"],
                           dtype_of(cfg))
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pre = batch["patch_embeds"]
        if tp is not None:
            pre = parallel.batch_block(tp, pre)
        x = torch.cat([pre.to(x.dtype), x], dim=1)
    return shard(x, "batch", "seq", "embed")


def _unembed(ctx: Ctx, params: Params, x):
    if ctx.tp is None:
        logits = unembed(ctx, params["embed"], x)
    else:
        logits = parallel.unembed(ctx.tp, params["embed"], x)
    return shard(logits, "batch", "seq", "vocab")


def forward(params: Params, batch: Dict[str, Any], cfg: ModelConfig,
            ctx: Optional[Ctx] = None, caches=None
            ) -> Tuple[torch.Tensor, Any]:
    """Forward to logits. train: caches=None; prefill/decode: the stacked
    cache, updated in place (encdec: ``batch["frames"]`` (B, n_frames,
    d_model) feed the encoder, on the uncached and the prefill forward).
    Under rules over a live mesh (``models/parallel.py``) every rank passes
    the global batch and gets its block of the logits, vocab-sharded
    (``parallel.gather_logits`` assembles them); the caches are the
    rank's (``init_caches`` under the same rules)."""
    check_family(cfg)
    ctx = ctx or Ctx.make(cfg)
    tokens = batch["tokens"]
    ctx.tp = parallel.begin(cfg, tokens.shape[0], tokens.shape[1])
    if cfg.family == "encdec":
        return _encdec_forward(params, batch, cfg, ctx, caches)
    x = _embed_input(ctx, params, batch)
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device)[None]
    if caches is None:
        positions = steps.expand(b, s)
    else:
        positions = cache_len(caches)[:, None] + steps
    x = _run_blocks(ctx, params, x, positions, caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(ctx, params, x), caches


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           ctx: Ctx) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings -> memory (B, T, d):
    sinusoidal positions, pre-layernorm blocks of non-causal self-attention
    and a GELU MLP, a final layernorm."""
    dt, eps = dtype_of(cfg), cfg.norm_eps
    mem = frames.to(dt)
    mem = mem + sinusoidal_positions(mem.shape[1], cfg.d_model,
                                     mem.device).to(dt)[None]
    b, t, _ = mem.shape
    pos = torch.arange(t, device=mem.device)[None].expand(b, t)
    for i in range(cfg.n_enc_layers):
        lctx = ctx.for_layer(i)
        p = _index(params["enc_blocks"], i)
        h, _ = attn.gqa_attention(lctx, p["attn"],
                                  layernorm(p["n1"], mem, eps), pos, None,
                                  causal=False)
        mem = mem + h
        mem = mem + gelu_mlp(lctx, p["mlp"], layernorm(p["n2"], mem, eps))
    return layernorm(params["enc_norm"], mem, eps)


def _encdec_forward(params: Params, batch: Dict[str, Any], cfg: ModelConfig,
                    ctx: Ctx, caches=None):
    """Whisper's decoder. Uncached and on the prefill (a cache without
    ``xk``) the encoder runs and every layer computes its cross K/V from
    the memory (``cross_kv``, after the self-attention's draws), which a
    prefill stores in the cache; a cached decode reads them back."""
    dt, eps = dtype_of(cfg), cfg.norm_eps
    cached_cross = caches is not None and "xk" in caches
    mem = None if cached_cross else encode(params, batch["frames"], cfg, ctx)
    x = embed(params["embed"], batch["tokens"], dt)
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device)[None]
    positions = (steps.expand(b, s) if caches is None
                 else cache_len(caches)[:, None] + steps)
    x = x + sinusoidal_positions(positions, cfg.d_model).to(dt)
    self_keys = [k for k in (caches or {}) if k not in _CROSS_LEAVES]
    new_cross = []
    for i in range(cfg.n_layers):
        lctx = ctx.for_layer(1000 + i)
        p = _index(params["dec_blocks"], i)
        h, _ = attn.gqa_attention(lctx, p["attn"], layernorm(p["n1"], x, eps),
                                  positions, _leaves(caches, i, self_keys))
        x = x + h
        if cached_cross:
            kv = {"k": caches["xk"][i], "v": caches["xv"][i]}
        else:
            kv = attn.cross_kv(lctx, p["cross"], mem)
            new_cross.append(kv)
        x = x + attn.cross_attention(lctx, p["cross"],
                                     layernorm(p["n2"], x, eps), kv)
        x = x + gelu_mlp(lctx, p["mlp"], layernorm(p["n3"], x, eps))
    if caches is not None and not cached_cross:
        caches["xk"] = torch.stack([kv["k"] for kv in new_cross])
        caches["xv"] = torch.stack([kv["v"] for kv in new_cross])
    x = rmsnorm(params["final_norm"], x, eps)
    return unembed(ctx, params["embed"], x), caches


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------


def lm_loss(params: Params, batch: Dict[str, Any], cfg: ModelConfig,
            ctx: Optional[Ctx] = None) -> torch.Tensor:
    """Next-token cross-entropy plus 1e-4 z-loss; labels < 0 are masked.
    A train forward (no cache): nothing is written in place, so autograd
    runs through it."""
    ctx = ctx or Ctx.make(cfg)
    logits, _ = forward(params, batch, cfg, ctx)
    if ctx.tp is not None:
        return parallel.lm_loss(ctx.tp, cfg, logits, batch["labels"])
    labels = batch["labels"].long()
    if cfg.family == "vlm":     # the image prefix carries no labels
        logits = logits[:, -labels.shape[1]:]
    logits = logits.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    zloss = 1e-4 * torch.square(torch.logsumexp(logits, dim=-1))
    return (torch.sum((nll + zloss) * valid)
            / torch.clamp_min(torch.sum(valid), 1))
