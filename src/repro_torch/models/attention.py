"""GQA, cross and MLA attention against the per-sequence slot cache.

Twin of ``src/repro/models/attention.py``. The cache is a
dict ``{"k": (B, T, KV, D), "v": ..., "len": (B,)}`` (int8 ``k``/``v`` plus
``ks``/``vs`` (B, T, KV, 1) f32 scales with ``kv_cache_int8``); ``len`` is
per sequence, so ragged slots share one batch. Unlike the functional
reference, the cache is updated **in place** (``row_update`` scatters into
the given tensors) and ``gqa_attention`` returns the same dict: the engine
keeps one cache for its lifetime and never copies it.

Two implementations, selected by ``cfg.attn_impl``:

  * ``"einsum"`` — dense masked softmax over the whole cache (the reference
    path; plain tensor code);
  * ``"kernel"`` — decode (S == 1) through the length-aware decode kernel,
    prefill (S > 1) through the GQA flash kernel with per-row start
    offsets (``kernels/decode_attention.py``, ``kernels/flash_attention.py``).

On a live mesh (``models/parallel.py``) q, k and v are this rank's
heads (``split_heads``), the cache holds its rows and KV heads, rows 2
and 3 split their keys by the whole model's plan (``plan_kv``), and
``o`` runs row-parallel.

Cross-attention (whisper's decoder, ``cross_kv`` and ``cross_attention``)
reads the encoder memory's K/V, computed once at prefill, through the
unmasked einsum softmax, as the reference does.

MLA (deepseek-v2, ``mla_attention``) caches the compressed latent
``{"ckv": (B, T, kv_lora), "krope": (B, T, rope_hd), "len": (B,)}``, also
updated in place. Train and prefill up-project the whole cache row through
``uk``/``uv`` (CIM linears) and run a masked f32 softmax; a decode step
runs the *absorbed* form, W_uk folded into the query and W_uv applied to
the latent context (float weights in the model dtype, as the reference),
through the latent-cache kernel (``kernels/mla_decode.py``) with
``attn_impl="kernel"`` or the masked einsum otherwise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_gqa_attention
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.models.layers import Ctx, Params, apply_rope, dense
from repro_torch.models.parallel import local_cache_dims, split_heads

NEG_INF = -1e30


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device="cpu") -> Dict[str, Any]:
    """On a live mesh this rank's rows and KV heads
    (``parallel.local_cache_dims``)."""
    batch, kv = local_cache_dims(cfg, batch)
    hd = cfg.hd
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    cache = {"len": z((batch,), torch.int32)}
    if cfg.kv_cache_int8:
        cache.update(k=z((batch, max_len, kv, hd), torch.int8),
                     v=z((batch, max_len, kv, hd), torch.int8),
                     ks=z((batch, max_len, kv, 1), torch.float32),
                     vs=z((batch, max_len, kv, 1), torch.float32))
    else:
        cache.update(k=z((batch, max_len, kv, hd), dtype),
                     v=z((batch, max_len, kv, hd), dtype))
    return cache


def _kv_quant(x: torch.Tensor):
    """Per (batch, pos, kv-head) symmetric int8: (int8 vals, f32 scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,KV,D); mask: (B,1,S,T) or None -> (B,S,H,D)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qr = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qr, k).to(torch.float32)
    logits = logits / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def _sdpa_int8(q, kq, ks, vq, vs, mask) -> torch.Tensor:
    """Int8-KV attention: the per-key scales fold into the logits (k side)
    and the probabilities (v side), as in the reference."""
    b, s, h, d = q.shape
    kvh = kq.shape[2]
    qr = q.reshape(b, s, kvh, h // kvh, d)
    ks_t = ks[..., 0].permute(0, 2, 1)[:, :, None, None, :]    # (B,KV,1,1,T)
    vs_t = vs[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    logits = torch.einsum("bskgd,btkd->bkgst", qr, kq.to(q.dtype))
    logits = logits.to(torch.float32) * ks_t / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1) * vs_t
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype),
                       vq.to(q.dtype))
    return out.reshape(b, s, h, d)


def _causal_mask(s: int, t: int, device=None) -> torch.Tensor:
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    return (kj <= qi)[None, None]


def row_update(cache_arr: torch.Tensor, update: torch.Tensor,
               starts: torch.Tensor) -> torch.Tensor:
    """In-place per-row write: row b of ``update`` lands at ``starts[b]``
    along axis 1. A start that would run past the end is clamped back, as
    ``dynamic_update_slice`` does in the reference."""
    b, s = update.shape[:2]
    t = cache_arr.shape[1]
    st = torch.clamp(starts.to(torch.int64), 0, t - s)
    pos = st[:, None] + torch.arange(s, device=update.device)[None, :]
    rows = torch.arange(b, device=update.device)[:, None]
    cache_arr[rows, pos] = update.to(cache_arr.dtype)
    return cache_arr


def _cached_mask(start: torch.Tensor, s: int, t: int) -> torch.Tensor:
    """(B, 1, s, t): query i of row b (absolute position start[b] + i) sees
    key j iff j <= start[b] + i and j < start[b] + s (recycled slots keep
    stale keys past the written prefix; they are never exposed)."""
    qi = torch.arange(s, device=start.device)[None, :] + start[:, None]
    kj = torch.arange(t, device=start.device)
    mask = (kj[None, None, :] <= qi[:, :, None]) & \
           (kj[None, None, :] < (start + s)[:, None, None])
    return mask[:, None]


def gqa_attention(ctx: Ctx, p: Params, x: torch.Tensor,
                  positions: torch.Tensor,
                  cache: Optional[Dict[str, Any]] = None,
                  causal: bool = True
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self-attention; with ``cache`` acts as prefill (S>1) or decode
    (S==1) and writes the new keys into the cache in place. Without a
    cache (training, ViT) it is the einsum softmax over the whole sequence,
    masked causally unless ``causal=False``, and writes nothing."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(ctx, dense(ctx, p["q"], x, "attn_qkv"), b, s, h, hd,
                    "heads")
    k = split_heads(ctx, dense(ctx, p["k"], x, "attn_qkv"), b, s, kv, hd,
                    "kv_heads")
    v = split_heads(ctx, dense(ctx, p["v"], x, "attn_qkv"), b, s, kv, hd,
                    "kv_heads")
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # on a live mesh the rank's heads (split_heads): the port computes
    # 'qseq' whole where the reference shards it (sharding.port_spec)
    q = shard(q, "batch", "qseq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")

    impl = cfg.attn_impl
    if impl not in ("einsum", "kernel"):
        raise ValueError(f"attn_impl must be 'einsum' or 'kernel', "
                         f"got {impl!r}")
    if cache is None:
        out = _sdpa(q, k, v, _causal_mask(s, s, x.device) if causal else None)
    else:
        start = cache["len"].clone()             # (B,) per-sequence lengths
        int8_cache = "ks" in cache
        if int8_cache:
            kq, ks_ = _kv_quant(k)
            vq, vs_ = _kv_quant(v)
            row_update(cache["k"], kq, start)
            row_update(cache["v"], vq, start)
            row_update(cache["ks"], ks_, start)
            row_update(cache["vs"], vs_, start)
        else:
            row_update(cache["k"], k, start)
            row_update(cache["v"], v, start)
        cache["len"].copy_(start + s)
        ck = shard(cache["k"], "batch", "seq", "kv_heads", "head_dim")
        cv = shard(cache["v"], "batch", "seq", "kv_heads", "head_dim")
        cks, cvs = cache.get("ks"), cache.get("vs")
        t = ck.shape[1]
        # on a mesh a rank's rows and heads split the keys as the whole
        # model's batch and heads do (the kernels' plans read rows x KV
        # heads)
        plan = ({} if ctx.tp is None
                else {"plan_kv": kv * ctx.tp.batch_size // b})
        if impl == "kernel" and s == 1:
            # lens counts the freshly written key
            out = decode_attention(q[:, 0], ck, cv, start + 1,
                                   ks=cks, vs=cvs, **plan)[:, None]
        elif impl == "kernel":
            out = flash_gqa_attention(q, ck, cv, start=start, ks=cks, vs=cvs,
                                      **plan)
        elif int8_cache:
            out = _sdpa_int8(q, ck, cks, cv, cvs, _cached_mask(start, s, t))
        else:
            out = _sdpa(q, ck, cv, _cached_mask(start, s, t))
    out = out.reshape(b, s, -1)
    return dense(ctx, p["o"], out, "attn_out"), cache


# ------------------------------------------------------------- cross-attn

def cross_kv(ctx: Ctx, p: Params, memory: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The encoder memory's K/V for one decoder layer (whisper), computed
    once a request at prefill: two CIM linears, role ``cross_qkv``."""
    cfg = ctx.cfg
    b, t, _ = memory.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = dense(ctx, p["k"], memory, "cross_qkv").reshape(b, t, kv, hd)
    v = dense(ctx, p["v"], memory, "cross_qkv").reshape(b, t, kv, hd)
    return {"k": k, "v": v}


def cross_attention(ctx: Ctx, p: Params, x: torch.Tensor,
                    kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Unmasked attention of the decoder's queries over the encoder
    memory's K/V (the einsum softmax; the reference reaches no kernel
    here)."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = dense(ctx, p["q"], x, "cross_qkv").reshape(b, s, h, hd)
    out = _sdpa(q, kv["k"], kv["v"], None).reshape(b, s, h * hd)
    return dense(ctx, p["o"], out, "cross_out")


# ----------------------------------------------------------------- MLA

def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device="cpu") -> Dict[str, Any]:
    a = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, a.kv_lora), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_len, a.rope_head_dim), dtype=dtype,
                             device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_attention(ctx: Ctx, p: Params, x: torch.Tensor,
                  positions: torch.Tensor,
                  cache: Optional[Dict[str, Any]] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Multi-head latent attention with the compressed-KV cache; with
    ``cache`` writes the new latent rows in place (see module doc). The CIM
    keys are drawn in the reference's order: dq, uq, dkv, (uk, uv when not
    decoding), o."""
    cfg = ctx.cfg
    a = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    impl = cfg.attn_impl
    if impl not in ("einsum", "kernel"):
        raise ValueError(f"attn_impl must be 'einsum' or 'kernel', "
                         f"got {impl!r}")

    cq = dense(ctx, p["dq"], x, "attn_qkv")
    q = dense(ctx, p["uq"], cq, "attn_qkv").reshape(
        b, s, h, a.nope_head_dim + a.rope_head_dim)
    q_nope, q_rope = torch.split(q, [a.nope_head_dim, a.rope_head_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = dense(ctx, p["dkv"], x, "attn_qkv")
    ckv, krope = torch.split(dkv, [a.kv_lora, a.rope_head_dim], dim=-1)
    krope = apply_rope(krope[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0]

    if cache is not None:
        start = cache["len"].clone()             # (B,) per-sequence lengths
        ckv_all = row_update(cache["ckv"], ckv, start)
        krope_all = row_update(cache["krope"], krope, start)
        cache["len"].copy_(start + s)
    else:
        start = torch.zeros((b,), dtype=torch.int32, device=x.device)
        ckv_all, krope_all = ckv, krope
    t = ckv_all.shape[1]

    # 1 / sqrt(nope + rope) rounded to f32, as the reference's jnp scalar
    scale = float(np.float32(1.0) / np.sqrt(
        np.float32(a.nope_head_dim + a.rope_head_dim)))

    if s == 1 and cache is not None:
        # absorbed decode: attention in the latent space, O(t * kv_lora)
        wuk = p["uk"]["w"].to(x.dtype).reshape(a.kv_lora, h, a.nope_head_dim)
        q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wuk)
        wuv = p["uv"]["w"].to(x.dtype).reshape(a.kv_lora, h, a.v_head_dim)
        if impl == "kernel":
            out_lat = mla_decode_attention(
                q_lat[:, 0], q_rope[:, 0], ckv_all, krope_all, start + 1,
                scale=float(1.0 / (a.nope_head_dim + a.rope_head_dim) ** 0.5),
            )[:, None]
        else:
            logits = (torch.einsum("bshl,btl->bhst", q_lat, ckv_all)
                      + torch.einsum("bshd,btd->bhst", q_rope, krope_all)
                      ).to(torch.float32) * scale
            logits = torch.where(_cached_mask(start, s, t), logits, NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out_lat = torch.einsum("bhst,btl->bshl", probs, ckv_all)
        out = torch.einsum("bshl,lhv->bshv", out_lat, wuv)
    else:
        # train / prefill: up-project the whole cache row once
        k_nope = dense(ctx, p["uk"], ckv_all, "attn_qkv").reshape(
            b, t, h, a.nope_head_dim)
        v = dense(ctx, p["uv"], ckv_all, "attn_qkv").reshape(
            b, t, h, a.v_head_dim)
        logits = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshd,btd->bhst", q_rope, krope_all)
                  ).to(torch.float32) * scale
        logits = torch.where(_cached_mask(start, s, t), logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, v)

    out = out.reshape(b, s, h * a.v_head_dim)
    return dense(ctx, p["o"], out, "attn_out"), cache
