"""Argument checks and launch-plan helpers shared by the two GQA attention
kernel wrappers (decode and flash prefill)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

HEAD_DIMS = (64, 96, 112, 128)   # head dims the kernels are built for
SM_COUNT = 132             # streaming multiprocessors of an H100
# Blocks a launch aims for: two per SM. A key axis is split over blocks
# until the grid reaches it.
SM_TARGET = 2 * SM_COUNT
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_cache_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         ks: Optional[torch.Tensor],
                         vs: Optional[torch.Tensor], name: str):
    """Validate q / cache / scale operands for a CUDA launch; returns the
    (q, kv) dtype codes and contiguous operands."""
    d = q.shape[-1]
    if d not in HEAD_DIMS or k.shape[-1] != d:
        raise ValueError(f"{name}: kernel takes head_dim in {HEAD_DIMS}, "
                         f"got q {d}, cache {k.shape[-1]}")
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
    # the kernels copy rows in 16-byte pieces: a view whose data does not
    # start on 16 bytes is copied to a fresh (aligned) tensor
    cont = [t.contiguous() for t in tensors]
    cont = [t if t.data_ptr() % 16 == 0 else t.clone() for t in cont]
    if not int8:
        cont += [None, None]
    return Q_DTYPES[q.dtype], KV_DTYPES[k.dtype], cont


_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_OUTGROWN: List[torch.Tensor] = []   # earlier buffers a captured graph may
                                     # still point at: never freed


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """(n,) int32 zeros on ``device`` for the kernels' last-block-merges
    counters. The kernels leave them at zero, so one buffer per device
    serves every launch on a stream (launches on one stream run in order).
    The buffer is made (or grown) by an eager call: under CUDA graph
    capture its zero fill would only be recorded, so a capture that needs
    a larger buffer raises (a warm-up forward before the capture makes
    it)."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"arrival counters: {n} needed inside a CUDA graph capture; "
                "run the captured forward once eagerly first")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def split_plan(n_kb: int, blocks: int, max_splits: int):
    """The key blocks of a work item (``n_kb`` of them) in groups of
    ``kbps`` over ``n_split`` blocks, for a grid that holds ``blocks``
    blocks without the split: split until the grid reaches about
    ``SM_TARGET`` blocks, at most ``max_splits`` (the merge's buffer).
    Returns (kbps, n_split)."""
    want = min(-(-SM_TARGET // blocks), max_splits)
    kbps = -(-n_kb // want)
    return kbps, -(-n_kb // kbps)
