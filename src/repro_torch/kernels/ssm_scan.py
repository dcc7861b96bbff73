"""Mamba2 selective-scan decode step: CUDA kernel and plain PyTorch version.

Replaces ``src/repro/kernels/ssm_scan.py`` ``ssm_decode_step`` (TPU kernel
``_kernel`` :42, ``pl.pallas_call`` at :140); the kernel is
``csrc/ssm_scan.cu``, whose note gives its bound on the H100 (the f32
state, read once and written once) and its design (blocks of state rows
of one head and slot row, every state load in flight before the first
store; ``ssm_decode_plan`` lays out the grid).

One decode token advances a mamba2 block: the rolling depthwise conv over
the cached window and the current in-projection slice ``xbc``, SiLU, the
per-head recurrence ``state * exp(dt * A) + (dt * x) outer B`` and the
readout ``state . C + D * x``. ``dt1`` arrives with softplus applied;
``conv_w`` and ``conv_b`` in float32 or in the window's dtype, widened to
float32 before the conv as the TPU kernel widens them. Returns ``(y (B,
d_inner) f32, new window (B, width-1, conv_dim) in the window's dtype, new
state (B, H, P, N) f32)``; with ``state_out`` the new state is written
there (it may be ``state`` itself, an in-place update).

CPU tensors take ``ssm_decode_step_plain`` (the conv weights widened
first), the twin of ``ref.ssm_decode_step_ref``; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._attn import SM_TARGET

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256              # a block's threads (csrc/ssm_scan.cu THREADS)
MAX_ROWS_PER_THREAD = 2    # csrc/ssm_scan.cu MAX_RPT
TEMPLATED_N = (16, 64, 128)   # d_state values with a body of their own


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x) (torch's own silu divides instead)."""
    return x * torch.sigmoid(x)


def ssm_decode_step_plain(conv_cache, xbc, conv_w, conv_b, dt1, a, d, state,
                          d_inner: int, ngroups: int, d_state: int):
    """The reference oracle's arithmetic in PyTorch (see module doc)."""
    nheads = a.shape[0]
    headdim = d_inner // nheads
    f32 = torch.float32
    conv_win = torch.cat([conv_cache.to(xbc.dtype), xbc], dim=1)
    ct = torch.promote_types(conv_win.dtype, conv_w.dtype)
    conv = torch.einsum("bwc,wc->bc", conv_win.to(ct), conv_w.to(ct)) + conv_b
    xbc_c = silu(conv)
    gn = ngroups * d_state
    xh = xbc_c[:, :d_inner].reshape(-1, nheads, headdim).to(f32)
    bm = xbc_c[:, d_inner:d_inner + gn].reshape(-1, ngroups, d_state)[:, 0]
    cm = xbc_c[:, d_inner + gn:].reshape(-1, ngroups, d_state)[:, 0]
    bm, cm = bm.to(f32), cm.to(f32)
    dt1 = dt1.to(f32)
    da = torch.exp(dt1 * a[None, :])
    upd = (dt1[:, :, None] * xh)[..., None] * bm[:, None, None, :]
    new_state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cm) + d[None, :, None] * xh
    return y.reshape(-1, d_inner), conv_win[:, 1:], new_state


def ssm_decode_plan(b: int, h: int, p: int, n: int) -> dict:
    """Launch plan of the kernel for B slot rows, H heads, P state rows a
    head and N = d_state: ``lanes`` lanes stream a row (min(32, N) for the
    N of ``TEMPLATED_N``, else 32), a block holds THREADS // lanes rows at
    once and ``rows_per_thread`` of them a thread, ``rows`` in all; grid
    (H * groups, B), a head's rows in ``groups`` blocks. The most rows a
    thread (the most loads in flight) that still gives ``SM_TARGET``
    blocks; else one row a thread (the most blocks)."""
    lanes = min(32, n) if n in TEMPLATED_N else 32
    slices = THREADS // lanes
    for rpt in range(MAX_ROWS_PER_THREAD, 0, -1):
        rows = slices * rpt
        groups = -(-p // rows)
        if groups * h * b >= SM_TARGET:
            break
    return {"grid": (h * groups, b), "threads": THREADS, "rows": rows,
            "lanes": lanes, "rows_per_thread": rpt, "groups": groups}


def ssm_decode_step(conv_cache: torch.Tensor, xbc: torch.Tensor,
                    conv_w: torch.Tensor, conv_b: torch.Tensor,
                    dt1: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                    state: torch.Tensor, d_inner: int, ngroups: int,
                    d_state: int, state_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused mamba2 decode step; see the module doc for the contract."""
    if conv_cache.device.type == "cpu":
        y, conv, st = ssm_decode_step_plain(conv_cache, xbc, conv_w.float(),
                                            conv_b.float(), dt1, a, d, state,
                                            d_inner, ngroups, d_state)
        if state_out is not None:
            st = state_out.copy_(st)
        return y, conv, st
    if conv_cache.device.type != "cuda":
        raise ValueError(f"ssm_decode_step: unsupported device "
                         f"{conv_cache.device}")
    b, win, conv_dim = conv_cache.shape
    nheads = a.shape[0]
    headdim = d_inner // nheads
    shapes = {"xbc": (xbc, (b, 1, conv_dim)),
              "conv_w": (conv_w, (win + 1, conv_dim)),
              "conv_b": (conv_b, (conv_dim,)), "dt1": (dt1, (b, nheads)),
              "A": (a, (nheads,)), "D": (d, (nheads,)),
              "state": (state, (b, nheads, headdim, d_state))}
    bad = {k: tuple(t.shape) for k, (t, want) in shapes.items()
           if tuple(t.shape) != want}
    if (bad or conv_dim != d_inner + 2 * ngroups * d_state
            or headdim * nheads != d_inner):
        raise ValueError(
            f"ssm_decode_step: shapes inconsistent with window "
            f"{tuple(conv_cache.shape)}, d_inner {d_inner}, ngroups "
            f"{ngroups}, d_state {d_state}: {bad}")
    if xbc.dtype != conv_cache.dtype or conv_cache.dtype not in _DTYPES:
        raise ValueError(f"ssm_decode_step: window and xbc must share one "
                         f"dtype of {list(_DTYPES)}, got {conv_cache.dtype} "
                         f"and {xbc.dtype}")
    if (conv_b.dtype != conv_w.dtype
            or conv_w.dtype not in (torch.float32, conv_cache.dtype)):
        raise ValueError(f"ssm_decode_step: conv_w and conv_b must share one "
                         f"dtype, float32 or the window's, got {conv_w.dtype} "
                         f"and {conv_b.dtype}")
    f32 = (dt1, a, d, state)
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("ssm_decode_step: dt1, A, D and the state must be "
                         "float32")
    if any(t.device != conv_cache.device for t in (xbc, conv_w, conv_b) + f32):
        raise ValueError("ssm_decode_step: operands on different devices")
    conv_cache, xbc, conv_w, conv_b = (
        t.contiguous() for t in (conv_cache, xbc, conv_w, conv_b))
    dt1, a, d, state = (t.contiguous() for t in f32)
    if state_out is None:
        state_out = torch.empty_like(state)
    elif (state_out.shape != state.shape or state_out.dtype != torch.float32
          or not state_out.is_contiguous()
          or state_out.device != state.device):
        raise ValueError("ssm_decode_step: state_out must be a contiguous "
                         "float32 tensor of the state's shape")
    y = torch.empty((b, d_inner), dtype=torch.float32, device=state.device)
    new_conv = torch.empty_like(conv_cache)
    plan = ssm_decode_plan(b, nheads, headdim, d_state)
    rc = _build.library().ssm_decode_step(
        conv_cache.data_ptr(), xbc.data_ptr(), conv_w.data_ptr(),
        conv_b.data_ptr(), dt1.data_ptr(), a.data_ptr(), d.data_ptr(),
        state.data_ptr(), y.data_ptr(), new_conv.data_ptr(),
        state_out.data_ptr(), b, nheads, headdim, d_state, ngroups, conv_dim,
        win, _DTYPES[conv_cache.dtype], _DTYPES[conv_w.dtype], *plan["grid"],
        plan["threads"], plan["rows"], plan["lanes"],
        _build.stream_ptr(conv_cache.device))
    _build.check(rc, "ssm_decode_step")
    ssm_decode_step.launches += 1
    return y, new_conv, state_out


ssm_decode_step.launches = 0
