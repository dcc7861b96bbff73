"""Length-aware GQA decode attention: CUDA kernel and plain PyTorch version.

Replaces ``src/repro/kernels/decode_attention.py`` ``decode_attention``
(TPU kernel ``_kernel``); the kernel is ``csrc/decode_attention.cu``, whose
note gives its bound on the H100 (the live cache bytes) and its design: the
key axis split over blocks of ``split`` keys (``decode_plan``), the last
block of each (row, KV head) merging the partials in the same launch.

One query token per batch row against the (B, T, KV, D) slot cache.
``lens[b]`` counts the valid keys including the current token; keys at or
past ``lens[b]`` are never read and a ``lens[b] == 0`` row yields zeros.
An int8 cache is dequantized in-kernel with its (B, T, KV, 1) f32 scales.
CPU tensors take ``decode_attention_plain`` (twin of
``ref.decode_attention_ref``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attn import (SM_TARGET, arrival_counters,
                                       check_cache_operands)

GROUP_MAX = 8      # query heads per KV head one block holds
TILE_K = 16        # keys per shared-memory tile; a split is a multiple
MAX_SPLITS = 64    # blocks per (row, KV head) at most (the merge's buffer)


def decode_plan(b: int, t: int, kv: int, d: int) -> dict:
    """Launch plan of the kernel for B rows, T cache slots, KV heads, head
    dim D: ``split`` keys per block (the fewest whole tiles that keep the
    grid near ``SM_TARGET`` blocks, at most ``MAX_SPLITS`` of them per
    (row, KV head)), ``n_split`` blocks per (row, KV head),
    the grid (n_split, KV, B) and the scratch shapes of the partials."""
    n_tiles = -(-t // TILE_K)
    want = min(-(-SM_TARGET // (b * kv)), MAX_SPLITS)   # per (row, head)
    split = TILE_K * -(-n_tiles // want)
    n_split = -(-t // split)
    return {"split": split, "n_split": n_split, "grid": (n_split, kv, b),
            "part_acc": (b * kv, n_split, GROUP_MAX, d),
            "part_ml": (b * kv, n_split, GROUP_MAX, 2),
            "counters": b * kv}


def decode_attention_plain(q, k, v, lens, ks=None, vs=None) -> torch.Tensor:
    """Masked-softmax oracle: q (B, H, D), cache (B, T, KV, D) -> (B, H, D)."""
    b, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if ks is not None:
        kf = kf * ks
        vf = vf * vs
    qr = q.reshape(b, kvh, g, d).to(torch.float32)
    logits = torch.einsum("bkgd,btkd->bkgt", qr, kf) / math.sqrt(d)
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, vf)
    out = torch.where(lens[:, None, None, None] > 0, out, 0.0)
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: torch.Tensor, ks: Optional[torch.Tensor] = None,
                     vs: Optional[torch.Tensor] = None,
                     plan_kv: Optional[int] = None) -> torch.Tensor:
    """q (B, H, D); k, v (B, T, KV, D); lens (B,) int -> (B, H, D) in q's
    dtype. ``plan_kv``: split the keys as the plan for that many KV heads
    (of B rows) would: the plan reads only rows x KV heads, so a rank's
    rows and heads of a sharded model keep the whole model's splits, and
    so its numbers."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lens, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, h, d = q.shape
    _, t, kvh, _ = k.shape
    if h % kvh or h // kvh > GROUP_MAX:
        raise ValueError(f"decode_attention: H={h}, KV={kvh} needs a group "
                         f"of at most {GROUP_MAX}")
    qd, kd, (q, k, v, ks, vs) = check_cache_operands(q, k, v, ks, vs,
                                                     "decode_attention")
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    plan = decode_plan(b, t, max(plan_kv or kvh, kvh), d)
    out = torch.empty_like(q)
    part_acc = torch.empty(plan["part_acc"], dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(plan["part_ml"], dtype=torch.float32,
                          device=q.device)
    counters = arrival_counters(q.device, plan["counters"])
    rc = _build.library().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        counters.data_ptr(), b, t, h, kvh, d, plan["split"],
        plan["n_split"], qd, kd, 1.0 / math.sqrt(d),
        _build.stream_ptr(q.device))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
