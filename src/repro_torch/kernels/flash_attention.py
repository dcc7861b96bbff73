"""GQA-native causal flash prefill: CUDA kernel and plain PyTorch version.

Replaces the GQA part of ``src/repro/kernels/flash_attention.py``:
``flash_gqa_attention`` (TPU kernel ``_gqa_kernel``); the kernel is
``csrc/flash_gqa.cu``, whose note gives its bound on the H100 and its
design.

Queries (B, S, H, D) of the S freshly written tokens against the
(B, T, KV, D) slot cache; query i of row b sits at ``start[b] + i`` and
sees key j iff j <= start[b] + i and j < start[b] + S. Heads group
in-kernel, the cache streams as stored (int8 dequantized in-kernel), key
blocks past each query block's causal frontier are never read, and
``return_block_counts`` adds the (B, KV, n_q) count of key blocks visited
(the kernel's blocks: ``BLOCK_Q`` query positions, ``BLOCK_K`` keys).
CPU tensors take ``flash_gqa_plain`` (twin of ``ref.flash_gqa_ref``); CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attn import check_cache_operands

ROWS_MAX = 56      # query rows (positions x grouped heads) one block holds
BLOCK_Q = 8        # query positions per block (fewer when G > 7)
BLOCK_K = 32       # keys per step


def flash_gqa_plain(q, k, v, start=None, ks=None, vs=None) -> torch.Tensor:
    """Masked-softmax oracle: q (B, S, H, D), cache (B, T, KV, D)."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if ks is not None:
        kf = kf * ks
        vf = vf * vs
    if start is None:
        start = torch.zeros((b,), dtype=torch.int64, device=q.device)
    qr = q.reshape(b, s, kvh, g, d).to(torch.float32)
    logits = torch.einsum("bskgd,btkd->bkgst", qr, kf) / math.sqrt(d)
    qi = torch.arange(s, device=q.device)[None, :, None] + start[:, None, None]
    kj = torch.arange(t, device=q.device)[None, None, :]
    mask = (kj <= qi) & (kj < (start[:, None, None] + s))
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, vf)
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        start: Optional[torch.Tensor] = None,
                        ks: Optional[torch.Tensor] = None,
                        vs: Optional[torch.Tensor] = None,
                        return_block_counts: bool = False):
    """(B, S, H, D) queries -> (B, S, H, D) in q's dtype [, block counts]."""
    if q.device.type == "cpu":
        if return_block_counts:
            raise ValueError("block counts come from the kernel's own blocks; "
                             "the plain version has none")
        return flash_gqa_plain(q, k, v, start, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_attention: unsupported device {q.device}")
    b, s, h, d = q.shape
    _, t, kvh, _ = k.shape
    if h % kvh or h // kvh > ROWS_MAX:
        raise ValueError(f"flash_gqa_attention: H={h}, KV={kvh} needs a group "
                         f"of at most {ROWS_MAX}")
    bq = min(BLOCK_Q, ROWS_MAX // (h // kvh))
    qd, kd, (q, k, v, ks, vs) = check_cache_operands(q, k, v, ks, vs,
                                                     "flash_gqa_attention")
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    start = start.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    n_q = -(-s // bq)
    counts = (torch.empty((b, kvh, n_q), dtype=torch.int32, device=q.device)
              if return_block_counts else None)
    rc = _build.library().flash_gqa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), start.data_ptr(),
        out.data_ptr(), None if counts is None else counts.data_ptr(),
        b, s, t, h, kvh, bq, qd, kd, 1.0 / math.sqrt(d),
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_gqa_attention")
    flash_gqa_attention.launches += 1
    return (out, counts) if return_block_counts else out


flash_gqa_attention.launches = 0
