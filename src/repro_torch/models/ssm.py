"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

Twin of ``src/repro/models/ssm.py``. The in/out projections are CIM
linears (roles ``ssm_in``/``ssm_out``); the depthwise conv and the
selective scan are digital. Prefill runs the chunked SSD (within-chunk
quadratic term plus a recurrence over chunk states) from the cached state;
decode advances ``{conv window (width-1 rows), state (B, H, P, N) f32}``
by one token, through the selective-scan kernel (``attn_impl="kernel"``,
``kernels/ssm_scan.py``) or the einsum branch.

Each branch keeps the reference's dtype and operation order: prefill and
the einsum decode compute the conv in the model dtype (prefill as a sum of
``conv_width`` taps), the kernel branch in float32. Softplus is
``jax.nn.softplus``'s ``max(x, 0) + log1p(exp(-|x|))`` and SiLU is
``x * sigmoid(x)``. With a cache the block writes the new window and state
into it in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import silu, ssm_decode_step
from repro_torch.models.layers import Ctx, Params, dense


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return s, di, di // s.headdim


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device="cpu") -> Dict[str, torch.Tensor]:
    s, di, nheads = _dims(cfg)
    conv_dim = di + 2 * s.ngroups * s.d_state
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nheads, s.headdim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, di, nheads = _dims(cfg)
    gn = s.ngroups * s.d_state
    return torch.split(zxbcdt, [di, di + 2 * gn, nheads], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (= ``logaddexp(x, 0)``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    y = y * silu(z.to(torch.float32))
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=-1, keepdim=True)
                        + eps)
    return (y * p["norm_g"].to(torch.float32)).to(z.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j<k<=i} x[..., k] (i >= j),
    -inf above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD forward (prefill).

    x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, g, n), group 0
    used; h0: optional (b, h, p, n) float32 incoming state (None = zeros).
    Positions with dt == 0 leave the state unchanged (decay 1, update 0).
    Returns y (b, l, h, p) and the final state (b, h, p, n).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    assert l % chunk == 0, (l, chunk)

    xb = x.reshape(b, nc, chunk, h, p)
    dtb = dt.reshape(b, nc, chunk, h)
    Bb = B.reshape(b, nc, chunk, -1, n)[:, :, :, 0]      # (b,nc,q,n)
    Cb = C.reshape(b, nc, chunk, -1, n)[:, :, :, 0]

    dA = dtb * A[None, None, None, :]                     # (b,nc,q,h)
    dAc = torch.cumsum(dA, dim=2)

    # intra-chunk: decay kernel x C.B scores x dt, against x
    lmat = torch.exp(_segsum(dA.movedim(-1, 2)))          # (b,nc,h,q,q)
    scores = torch.einsum("bcin,bcjn->bcij", Cb, Bb)      # (b,nc,q,q)
    wgt = lmat * scores[:, :, None] * dtb.movedim(-1, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", wgt, xb)

    # chunk states
    decay_to_end = torch.exp(dAc[:, :, -1:, :] - dAc)     # (b,nc,q,h)
    S = torch.einsum("bcjn,bcjhp->bchpn", Bb,
                     xb * (decay_to_end * dtb)[..., None])

    # inter-chunk recurrence
    chunk_decay = torch.exp(dAc[:, :, -1, :])             # (b,nc,h)
    hcur = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
            if h0 is None else h0)
    before = []
    for c in range(nc):
        before.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + S[:, c].to(
            torch.float32)
    h_before = torch.stack(before, dim=1)                 # (b,nc,h,p,n)

    y_off = (torch.einsum("bcin,bchpn->bcihp", Cb, h_before)
             * torch.exp(dAc)[..., None])
    return (y_diag + y_off).reshape(b, l, h, p), hcur


def mamba2_block(ctx: Ctx, p: Params, x: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, S, d). A cache with S == 1 is a single-token decode step."""
    cfg = ctx.cfg
    s_cfg, di, nheads = _dims(cfg)
    g, n = s_cfg.ngroups, s_cfg.d_state
    b, l, _ = x.shape
    f32 = torch.float32

    zxbcdt = dense(ctx, p["in_proj"], x, "ssm_in")
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    dt = softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is None or l > 1:
        # prefill: causal depthwise conv from the cached window (zeros on a
        # fresh slot) and the chunked SSD seeded from the cached state
        w = p["conv_w"].to(xbc.dtype)
        win = s_cfg.conv_width - 1
        if cache is not None:
            pad = cache["conv"].to(xbc.dtype)
        else:
            pad = torch.zeros((b, win, xbc.shape[-1]), dtype=xbc.dtype,
                              device=x.device)
        xp = torch.cat([pad, xbc], dim=1)
        conv = sum(xp[:, i:i + l, :] * w[i][None, None, :]
                   for i in range(s_cfg.conv_width))
        xbc_c = silu(conv + p["conv_b"].to(xbc.dtype))
        xs, B, C = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
        xh = xs.reshape(b, l, nheads, s_cfg.headdim)
        Bm = B.reshape(b, l, g, n)
        Cm = C.reshape(b, l, g, n)
        # the chunk's right-pad: dt = 0 makes those positions state no-ops
        valid = ctx.prefill_valid if cache is not None else None
        if valid is not None:
            valid = valid.to(device=x.device, dtype=torch.int64)
            keep = (torch.arange(l, device=x.device)[None, :, None]
                    < valid[:, None, None])
            dt = torch.where(keep, dt, 0.0)
        q = s_cfg.chunk
        padlen = -(-l // q) * q - l
        xh_p, dt_p, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, padlen))
                              for t in (xh, dt, Bm, Cm))
        h0 = cache["state"] if cache is not None else None
        y, hT = ssd_chunked(xh_p.to(f32), dt_p, A, Bm.to(f32), Cm.to(f32), q,
                            h0=h0)
        y = y[:, :l] + p["D"][None, None, :, None] * xh.to(f32)
        y = y.reshape(b, l, di)
        if cache is not None:
            if valid is not None:
                # the window ends at the last valid token: xp row win + i
                # holds token i, so it starts at xp row `valid`
                rows = valid[:, None] + torch.arange(win, device=x.device)
                conv_keep = xp[torch.arange(b, device=x.device)[:, None],
                               rows]
            else:
                conv_keep = xp[:, -win:, :]
            cache["conv"].copy_(conv_keep)
            cache["state"].copy_(hT)
    elif cfg.attn_impl == "kernel":
        y, new_conv, _ = ssm_decode_step(
            cache["conv"], xbc, p["conv_w"], p["conv_b"], dt[:, 0], A,
            p["D"], cache["state"], di, g, n,
            state_out=cache["state"])
        cache["conv"].copy_(new_conv)
        y = y.reshape(b, 1, di)
    else:
        conv_win = torch.cat([cache["conv"], xbc], dim=1)   # (b, w, cd)
        w = p["conv_w"].to(xbc.dtype)
        conv = (torch.einsum("bwc,wc->bc", conv_win, w)
                + p["conv_b"].to(xbc.dtype))
        xs, B, C = torch.split(silu(conv), [di, g * n, g * n], dim=-1)
        xh = xs.reshape(b, nheads, s_cfg.headdim).to(f32)
        Bm = B.reshape(b, g, n)[:, 0].to(f32)
        Cm = C.reshape(b, g, n)[:, 0].to(f32)
        dt1 = dt[:, 0]                                      # (b, h)
        dA = torch.exp(dt1 * A[None, :])
        upd = (dt1[:, :, None] * xh)[..., None] * Bm[:, None, None, :]
        state = cache["state"] * dA[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, Cm) + p["D"][None, :, None] * xh
        y = y.reshape(b, 1, di)
        cache["conv"].copy_(conv_win[:, 1:])
        cache["state"].copy_(state)

    y = _gated_norm(p, y, z, cfg.norm_eps)
    return dense(ctx, p["out_proj"], y, "ssm_out"), cache
