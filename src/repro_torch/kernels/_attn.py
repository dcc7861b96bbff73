"""Argument checks shared by the two attention kernel wrappers."""

from __future__ import annotations

from typing import Optional

import torch

HEAD_DIM = 64
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_cache_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         ks: Optional[torch.Tensor],
                         vs: Optional[torch.Tensor], name: str):
    """Validate q / cache / scale operands for a CUDA launch; returns the
    (q, kv) dtype codes and contiguous operands."""
    d = q.shape[-1]
    if d != HEAD_DIM or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: kernel takes head_dim {HEAD_DIM}, got {d}")
    if q.dtype not in Q_DTYPES or k.dtype not in KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"{name}: unsupported dtypes q={q.dtype} k={k.dtype} "
                         f"v={v.dtype}")
    int8 = k.dtype == torch.int8
    if int8 != (ks is not None) or (ks is None) != (vs is None):
        raise ValueError(f"{name}: an int8 cache needs both ks and vs scales")
    if not int8 and q.dtype != k.dtype:
        raise ValueError(f"{name}: q {q.dtype} and cache {k.dtype} differ")
    tensors = [q, k, v] + ([ks, vs] if int8 else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")
    if int8 and (ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise ValueError(f"{name}: int8 scales must be float32")
    cont = [t.contiguous() for t in tensors]
    if not int8:
        cont += [None, None]
    return Q_DTYPES[q.dtype], KV_DTYPES[k.dtype], cont
