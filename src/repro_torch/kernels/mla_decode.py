"""Absorbed MLA decode attention over the latent cache: CUDA kernel and
plain PyTorch version.

Replaces ``src/repro/kernels/mla_decode.py`` ``mla_decode_attention``
(TPU kernel ``_kernel`` :43, ``pl.pallas_call`` at :144); the kernel is
``csrc/mla_decode.cu``, whose note gives its bound on the H100 and its
designs: bf16 operands on the tensor cores, 16 heads a block against each
32-key tile of [ckv | krope] loaded into shared memory once and used twice
(scores operand and values), the key tiles of a row split over blocks with
the merge in the same launch (``mla_decode_plan``); f32 operands on the
CUDA cores, one block per 4 heads and batch row.

One query token per batch row: ``q_lat`` (B, H, L) has W_uk folded in,
``q_rope`` (B, H, R) is the rope channel; ``ckv`` (B, T, L) is the latent
cache and ``krope`` (B, T, R) the shared rope key. Scores
``(q_lat . ckv + q_rope . krope) * scale`` in f32 over the first
``lens[b]`` positions (the current token included; keys at or past
``lens[b]`` are never read), softmax, and the probability-weighted ``ckv``
rows, divided by ``max(l, 1e-30)`` and returned in ``q_lat``'s dtype;
``lens[b] == 0`` gives a zero row. W_uv is applied by the caller.

CPU tensors take ``mla_decode_attention_plain``, which computes in f32 as
the TPU kernel does (for f32 operands it is ``ref.mla_decode_attention_ref``
term for term); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attn import arrival_counters, split_plan

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
L_MAX = 512        # latent width the kernel's accumulator holds
R_MAX = 64         # rope width
BLOCK_K = 32       # keys a tile, both bodies
HEADS = {torch.bfloat16: 16, torch.float32: 4}   # heads a block, by dtype
MAX_SPLITS = 16    # blocks a (row, head group) at most (the merge's buffer)


def mla_decode_plan(b: int, h: int, t: int, lat: int,
                    dtype: torch.dtype) -> dict:
    """Launch plan of the kernel for B rows, H heads, T cache slots and
    latent width L: ``heads`` per block, ``block_k`` keys a tile, and the
    tiles of a batch row in groups of ``kbps`` over ``n_split`` blocks.
    bf16 (the tensor-core body) splits until the grid (n_split, head
    groups, B) reaches about ``SM_TARGET`` blocks, at most ``MAX_SPLITS``;
    f32 (the CUDA-core body) takes one block per (4 heads, row): grid
    (head groups, B). Blocks past a row's live tiles exit at once."""
    heads = HEADS[dtype]
    n_hg = -(-h // heads)
    n_kb = -(-t // BLOCK_K)
    if dtype == torch.bfloat16:
        kbps, n_split = split_plan(n_kb, n_hg * b, MAX_SPLITS)
        grid = (n_split, n_hg, b)
    else:
        kbps, n_split, grid = n_kb, 1, (n_hg, b)
    return {"heads": heads, "block_k": BLOCK_K, "kbps": kbps,
            "n_split": n_split, "grid": grid,
            "part_o": (b * n_hg * n_split, heads, lat),
            "part_ml": (b * n_hg * n_split, heads, 2),
            "counters": b * n_hg}


def mla_decode_attention_plain(q_lat, q_rope, ckv, krope, lens,
                               scale: float) -> torch.Tensor:
    """Masked-softmax oracle in f32 (see module doc) -> (B, H, L)."""
    f32 = torch.float32
    t = ckv.shape[1]
    ckv32 = ckv.to(f32)
    logits = (torch.einsum("bhl,btl->bht", q_lat.to(f32), ckv32)
              + torch.einsum("bhd,btd->bht", q_rope.to(f32),
                             krope.to(f32))) * scale
    lens = lens.to(q_lat.device)
    valid = torch.arange(t, device=q_lat.device)[None, :] < lens[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.tensor(-1e30, device=q_lat.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,btl->bhl", probs, ckv32)
    out = torch.where(lens[:, None, None] > 0, out, 0.0)
    return out.to(q_lat.dtype)


def mla_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         ckv: torch.Tensor, krope: torch.Tensor,
                         lens: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, L) latent context rows in q_lat's dtype; see module doc."""
    if q_lat.device.type == "cpu":
        return mla_decode_attention_plain(q_lat, q_rope, ckv, krope, lens,
                                          scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_decode_attention: unsupported device "
                         f"{q_lat.device}")
    b, h, lat = q_lat.shape
    t, rope = ckv.shape[1], q_rope.shape[-1]
    want = {"q_rope": (q_rope, (b, h, rope)), "ckv": (ckv, (b, t, lat)),
            "krope": (krope, (b, t, rope)), "lens": (lens, (b,))}
    bad = {k: tuple(v.shape) for k, (v, s) in want.items()
           if tuple(v.shape) != s}
    if bad:
        raise ValueError(f"mla_decode_attention: shapes inconsistent with "
                         f"q_lat {tuple(q_lat.shape)}: {bad}")
    if (lat % 32 or not 0 < lat <= L_MAX or rope % 16
            or not 0 < rope <= R_MAX or t < 1):
        raise ValueError(f"mla_decode_attention: kernel takes a latent "
                         f"width that is a multiple of 32 up to {L_MAX} and "
                         f"a rope width that is a multiple of 16 up to "
                         f"{R_MAX}, got L={lat}, R={rope}, T={t}")
    dts = {x.dtype for x in (q_lat, q_rope, ckv, krope)}
    if len(dts) != 1 or q_lat.dtype not in _DTYPES:
        raise ValueError(f"mla_decode_attention: queries and caches must "
                         f"share one dtype of {list(_DTYPES)}, got "
                         f"{sorted(map(str, dts))}")
    if any(x.device != q_lat.device for x in (q_rope, ckv, krope, lens)):
        raise ValueError("mla_decode_attention: operands on different "
                         "devices")
    q_lat, q_rope, ckv, krope = (x.contiguous()
                                 for x in (q_lat, q_rope, ckv, krope))
    if any(x.data_ptr() % 16 for x in (q_lat, q_rope, ckv, krope)):
        raise ValueError("mla_decode_attention: the kernel reads 16-byte "
                         "aligned operands")
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q_lat)
    plan = mla_decode_plan(b, h, t, lat, q_lat.dtype)
    part_o = part_ml = counters = None
    if plan["n_split"] > 1:
        part_o = torch.empty(plan["part_o"], dtype=torch.float32,
                             device=q_lat.device)
        part_ml = torch.empty(plan["part_ml"], dtype=torch.float32,
                              device=q_lat.device)
        counters = arrival_counters(q_lat.device, plan["counters"])
    ptr = (lambda x: None if x is None else x.data_ptr())
    rc = _build.library().mla_decode_attention(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
        krope.data_ptr(), lens.data_ptr(), out.data_ptr(), ptr(part_o),
        ptr(part_ml), ptr(counters), b, h, t, lat, rope,
        _DTYPES[q_lat.dtype], plan["kbps"], plan["n_split"], float(scale),
        _build.stream_ptr(q_lat.device))
    _build.check(rc, "mla_decode_attention")
    mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0
