"""Fused activation-quant CIM matmul: CUDA kernel and plain PyTorch version.

Replaces ``src/repro/kernels/cim_matmul.py`` ``cim_matmul_fused_pallas``
(TPU kernel ``_fused_kernel``). The kernel is ``csrc/cim_matmul.cu``; its
design note says what bounds it on the H100 (the int8 weight stream) and
how it streams the plane once.

``cim_matmul_fused`` takes the float activation (M, K), quantizes it
against the scalar ``x_scale`` (round half to even, clip at +-qmax), takes
the int32 dot with the deployed int8 plane per 1024-row macro tile, adds
``sigma`` times the Threefry/Box-Muller readout noise of each tile
(``core.prng.tile_gaussian``: key (seed0 ^ DOMAIN, seed1 ^ tile), counter
global (row, col)), sums the tiles in f32 in order and multiplies by
``out_scale``. Scales arrive as a device tensor ``qp = [x_scale,
out_scale]`` so the host never waits for them.

CPU tensors take ``cim_matmul_fused_plain``, the twin of
``ref.cim_matmul_fused_ref``; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import MACRO_ROWS
from repro_torch.kernels import _build


def cim_matmul_fused_plain(x: torch.Tensor, wq: torch.Tensor,
                           qp: torch.Tensor, seed: Optional[Tuple[int, int]],
                           sigma: float, in_bits: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arithmetic, tile by tile).

    The int32 dot runs as a float64 product: every partial sum is an integer
    below 2^53, so it is exact in any order, on the CPU and on the card."""
    q = quant.qmax(in_bits)
    xq = torch.clamp(torch.round(x.to(torch.float32) / qp[0]), -q, q)
    m, k = xq.shape
    n = wq.shape[1]
    noise = seed is not None and sigma > 0.0
    if noise:
        rows = torch.arange(m, dtype=torch.int64, device=x.device)[:, None]
        cols = torch.arange(n, dtype=torch.int64, device=x.device)[None, :]
        rows, cols = rows.expand(m, n), cols.expand(m, n)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for t in range(-(-k // MACRO_ROWS)):
        sl = slice(t * MACRO_ROWS, (t + 1) * MACRO_ROWS)
        s = (xq[:, sl].to(torch.float64) @ wq[sl].to(torch.float64)).to(torch.float32)
        if noise:
            s = s + sigma * prng.tile_gaussian(seed[0], seed[1], t, rows, cols)
        y = y + s
    return y * qp[1]


def cim_matmul_fused(x: torch.Tensor, wq: torch.Tensor, qp: torch.Tensor,
                     seed: Optional[Tuple[int, int]], sigma: float,
                     in_bits: int) -> torch.Tensor:
    """(M, K) float x, (K, N) int8 plane -> (M, N) float32. See module doc."""
    if x.device.type == "cpu":
        return cim_matmul_fused_plain(x, wq, qp, seed, sigma, in_bits)
    if x.device.type != "cuda":
        raise ValueError(f"cim_matmul_fused: unsupported device {x.device}")
    m, k = x.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(wq.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if wq.dtype != torch.int8 or qp.dtype != torch.float32 or qp.numel() != 2:
        raise ValueError("wq must be int8 and qp a (2,) float32 tensor")
    if not (wq.device == x.device == qp.device):
        raise ValueError("x, wq and qp must be on one device")
    if in_bits > 8:
        raise ValueError(f"kernel takes in_bits <= 8, got {in_bits}")
    x = x.contiguous()
    wq = wq.contiguous()
    qp = qp.contiguous()
    if k % 4 or n % 4 or wq.data_ptr() % 4:
        raise ValueError(f"kernel needs K % 4 == 0, N % 4 == 0 and an aligned "
                         f"plane, got K={k}, N={n}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    noise = seed is not None and sigma > 0.0
    s0, s1 = seed if noise else (0, 0)
    rc = _build.library().cim_matmul_fused(
        x.data_ptr(), 0 if x.dtype == torch.float32 else 1, wq.data_ptr(),
        qp.data_ptr(), out.data_ptr(), m, k, n, quant.qmax(in_bits),
        float(sigma) if noise else 0.0, s0, s1, int(noise),
        _build.stream_ptr(x.device))
    _build.check(rc, "cim_matmul_fused")
    cim_matmul_fused.launches += 1
    return out


cim_matmul_fused.launches = 0
