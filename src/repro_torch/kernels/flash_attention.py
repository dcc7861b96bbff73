"""Flash attention: CUDA kernels and plain PyTorch versions.

Replaces both kernels of ``src/repro/kernels/flash_attention.py``:
``flash_gqa_attention`` (TPU kernel ``_gqa_kernel``) by the kernel of
``csrc/flash_gqa.cu``, and the MHA-shaped ``flash_attention`` (TPU kernel
``_kernel``) by the kernel of ``csrc/flash_mha.cu``; each source's note
gives its bound on the H100 and its design.

``flash_attention`` takes (BH, S, D) queries against (BH, T, D) keys and
values (training and cross-attention shapes, heads folded into rows),
causal or not, with optional per-row start offsets (causal only), head dims
64, 96, 112 and 128 (``HEAD_DIMS``, as the GQA kernels), float32 or
bfloat16. CPU tensors take ``flash_attention_plain``,
which follows the kernel's arithmetic (online softmax over the same blocks
of ``MHA_BLOCK_K[dtype]`` keys, p rounded to v's dtype before p @ V); CUDA
tensors launch the kernel or raise.

Queries (B, S, H, D) of the S freshly written tokens against the
(B, T, KV, D) slot cache; query i of row b sits at ``start[b] + i`` and
sees key j iff j <= start[b] + i and j < start[b] + S. Heads group
in-kernel, the cache streams as stored (int8 dequantized in-kernel), key
blocks past each query block's causal frontier are never read, and
``return_block_counts`` adds the (B, KV, n_q) count of key blocks visited
(the kernel's blocks: ``block_q`` query positions and ``block_k`` keys of
``flash_gqa_plan``). bf16 queries run the tensor-core body, f32 queries
the register-tiled CUDA-core body (each shared with the MHA kernel); in
both the key blocks of a q block may split over several blocks of the
grid.
For ``flash_gqa_attention`` CPU tensors take ``flash_gqa_plain`` (twin of
``ref.flash_gqa_ref``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attn import (HEAD_DIMS, arrival_counters,
                                       check_cache_operands, split_plan)

BLOCK_ROWS = 64    # query rows (positions x grouped heads) per block
MAX_SPLITS = 16    # blocks a q block's key blocks split over, at most
# keys per key block, by the queries' dtype (the body): the tensor-core body
# (bf16) measured faster at 32 than at 64 on the H100 (PERF.md); the
# register-tiled f32 body's tile is 64
BLOCK_K = {torch.bfloat16: 32, torch.float32: 64}


def flash_gqa_plan(b: int, s: int, t: int, h: int, kv: int, d: int,
                   tensor_cores: bool) -> dict:
    """Launch plan of the GQA prefill kernel: ``block_q`` = 64 // G query
    positions (``BLOCK_ROWS`` rows of positions x grouped heads) and
    ``block_k`` keys (32 for the tensor-core body of bf16 queries, 64 for
    the f32 body) per block of the count witness, ``n_q`` q blocks, and the
    key blocks of a q block in groups of ``kbps`` over ``n_split`` blocks:
    split until the grid (n_split, n_q, B * KV) reaches about ``SM_TARGET``
    blocks, at most ``MAX_SPLITS`` (the merge's buffer)."""
    g = h // kv
    if h % kv or g > BLOCK_ROWS:
        raise ValueError(f"flash_gqa_attention: H={h}, KV={kv} needs a group "
                         f"of at most {BLOCK_ROWS}")
    bq = BLOCK_ROWS // g
    block_k = BLOCK_K[torch.bfloat16 if tensor_cores else torch.float32]
    n_q = -(-s // bq)
    kbps, n_split = split_plan(-(-t // block_k), n_q * kv * b, MAX_SPLITS)
    return {"block_q": bq, "block_k": block_k, "n_q": n_q, "kbps": kbps,
            "n_split": n_split, "grid": (n_split, n_q, b * kv),
            "part_o": (b * kv * n_q * n_split, BLOCK_ROWS, d),
            "part_ml": (b * kv * n_q * n_split, BLOCK_ROWS, 2),
            "counters": b * kv * n_q}


MHA_BLOCK_Q = BLOCK_ROWS   # query rows per block of the MHA kernel
MHA_BLOCK_K = BLOCK_K
MHA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30


def flash_mha_plan(bh: int, s: int, t: int, d: int,
                   dtype: torch.dtype) -> dict:
    """Launch plan of the MHA kernel: ``MHA_BLOCK_Q`` query rows and
    ``block_k`` = ``MHA_BLOCK_K[dtype]`` keys per block of the count
    witness, ``n_q`` q blocks, and for the tensor-core body (bf16) the
    key blocks of a q block in groups of ``kbps`` over ``n_split`` blocks:
    split until the grid (n_split, n_q, BH) reaches about ``SM_TARGET``
    blocks, at most ``MAX_SPLITS``. The f32 body takes one block per (q
    block, row): grid (1, n_q, BH)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    n_q = -(-s // MHA_BLOCK_Q)
    block_k = MHA_BLOCK_K[dtype]
    n_kb = -(-t // block_k)
    if dtype == torch.bfloat16:
        kbps, n_split = split_plan(n_kb, n_q * bh, MAX_SPLITS)
    else:
        kbps, n_split = n_kb, 1
    return {"block_q": MHA_BLOCK_Q, "block_k": block_k, "n_q": n_q,
            "kbps": kbps, "n_split": n_split, "grid": (n_split, n_q, bh),
            "part_o": (bh * n_q * n_split, BLOCK_ROWS, d),
            "part_ml": (bh * n_q * n_split, BLOCK_ROWS, 2),
            "counters": bh * n_q}


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
                        return_block_counts: bool = False,
                        plan_kv: Optional[int] = None):
    """(B, S, H, D) queries -> (B, S, H, D) in q's dtype [, block counts].
    ``plan_kv``: split the key blocks as the plan for that many KV heads
    (of the same group, B rows) would, as ``decode_attention``'s."""
    if q.device.type == "cpu":
        if return_block_counts:
            raise ValueError("block counts come from the kernel's own blocks; "
                             "the plain version has none")
        return flash_gqa_plain(q, k, v, start, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_attention: unsupported device {q.device}")
    b, s, h, d = q.shape
    _, t, kvh, _ = k.shape
    qd, kd, (q, k, v, ks, vs) = check_cache_operands(q, k, v, ks, vs,
                                                     "flash_gqa_attention")
    pkv = max(plan_kv or kvh, kvh)
    plan = flash_gqa_plan(b, s, t, h // kvh * pkv, pkv, d,
                          q.dtype == torch.bfloat16)
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    start = start.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    counts = (torch.zeros((b, kvh, plan["n_q"]), dtype=torch.int32,
                          device=q.device)
              if return_block_counts else None)
    part_o = part_ml = counters = None
    if plan["n_split"] > 1:
        part_o = torch.empty(plan["part_o"], dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(plan["part_ml"], dtype=torch.float32,
                              device=q.device)
        counters = arrival_counters(q.device, plan["counters"])
    ptr = (lambda x: None if x is None else x.data_ptr())
    rc = _build.library().flash_gqa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
        start.data_ptr(), out.data_ptr(), ptr(counts), ptr(part_o),
        ptr(part_ml), ptr(counters), b, s, t, h, kvh, d, plan["block_q"],
        plan["kbps"], plan["n_split"], qd, kd, 1.0 / math.sqrt(d),
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_gqa_attention")
    flash_gqa_attention.launches += 1
    return (out, counts) if return_block_counts else out


flash_gqa_attention.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the MHA kernel, in its arithmetic: f32 scores
    times 1/sqrt(D), masked to -1e30, online softmax over blocks of
    ``MHA_BLOCK_K[q.dtype]`` keys (64 for other dtypes) in order, p rounded
    to v's dtype before p @ V, f32 sums, denominator max(l, 1e-30), output
    in q's dtype. Blocks past a
    causal frontier are fully masked here, where the kernel skips them: they
    add p = 0 and alpha = 1 exactly (block 0 holds key 0, live in every row,
    so the running max is finite from the first block on)."""
    if start is not None and not causal:
        raise ValueError("per-row start offsets require causal attention")
    bh, s, d = q.shape
    t = k.shape[1]
    st = (torch.zeros((bh,), dtype=torch.int64, device=q.device)
          if start is None else start.to(device=q.device, dtype=torch.int64))
    pos = st[:, None] + torch.arange(s, device=q.device)[None, :]
    # exclusive key bound per row: the written prefix when causal, else T
    kv_end = torch.clamp(st + s, max=t) if causal else torch.full_like(st, t)
    scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32)
    m = torch.full((bh, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
    bk = MHA_BLOCK_K.get(q.dtype, MHA_BLOCK_K[torch.float32])
    for j0 in range(0, t, bk):
        kb = k[:, j0:j0 + bk].to(torch.float32)
        vb = v[:, j0:j0 + bk].to(torch.float32)
        sc = torch.einsum("bsd,btd->bst", qf, kb) * scale
        kj = torch.arange(j0, j0 + kb.shape[1], device=q.device)
        live = kj[None, None, :] < kv_end[:, None, None]
        if causal:
            live = live & (kj[None, None, :] <= pos[:, :, None])
        sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[:, :, None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bst,btd->bsd", p.to(v.dtype).to(torch.float32), vb)
        acc = acc * alpha[:, :, None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[:, :, None]).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, start: Optional[torch.Tensor] = None,
                    return_block_counts: bool = False):
    """(BH, S, D) queries, (BH, T, D) keys and values -> (BH, S, D) in q's
    dtype [, (BH, n_q) int32 counts of the key blocks each query block of
    ``MHA_BLOCK_Q`` rows visited, in blocks of ``MHA_BLOCK_K[q.dtype]``
    keys, summed over the blocks its key range is split over]."""
    if start is not None and not causal:
        raise ValueError("per-row start offsets require causal attention")
    if q.device.type == "cpu":
        if return_block_counts:
            raise ValueError("block counts come from the kernel's own blocks; "
                             "the plain version has none")
        return flash_attention_plain(q, k, v, causal, start)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out, counts = flash_mha_launch(q, k, v, causal, start,
                                   return_block_counts)
    return (out, counts) if return_block_counts else out


def flash_mha_launch(q, k, v, causal, start, with_counts):
    """Check the CUDA operands, plan (``flash_mha_plan``) and launch the MHA kernel once; returns (out, counts or None)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (BH, S, D), k and v (BH, T, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    t = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in BH or D")
    if q.dtype not in MHA_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    if s == 0 or t == 0:
        raise ValueError(f"flash_attention: empty S={s} or T={t}")
    plan = flash_mha_plan(bh, s, t, d, q.dtype)
    # the kernels copy rows in 16-byte pieces: a view whose data does not
    # start on 16 bytes is copied to a fresh (aligned) tensor
    q, k, v = (x.contiguous() for x in (q, k, v))
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    st = None
    if start is not None:
        st = start.to(device=q.device, dtype=torch.int32).reshape(-1)
        st = st.contiguous()
        if st.numel() != bh:
            raise ValueError(f"flash_attention: start has {st.numel()} rows, "
                             f"q has {bh}")
    out = torch.empty_like(q)
    counts = (torch.zeros((bh, plan["n_q"]), dtype=torch.int32,
                          device=q.device) if with_counts else None)
    part_o = part_ml = counters = None
    if plan["n_split"] > 1:
        part_o = torch.empty(plan["part_o"], dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(plan["part_ml"], dtype=torch.float32,
                              device=q.device)
        counters = arrival_counters(q.device, plan["counters"])
    ptr = (lambda x: None if x is None else x.data_ptr())
    rc = _build.library().flash_mha(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(st), out.data_ptr(),
        ptr(counts), ptr(part_o), ptr(part_ml), ptr(counters), bh, s, t, d,
        int(causal), MHA_DTYPES[q.dtype], plan["kbps"], plan["n_split"],
        1.0 / math.sqrt(d), _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, counts


flash_attention.launches = 0
