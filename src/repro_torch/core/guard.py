"""ABFT checksum guard for CIM-routed matmuls, with its escalation ladder.

Twin of ``src/repro/core/guard.py``. ``core.deploy`` attaches to every
CIM-routed plane the checksum ``wc = sum_n wq[:, n]`` of the *clean*
plane (or G per-segment sums). Per output row position the guard compares
the analog column sum ``s = sum_n y[..., n]`` with the digital checksum
``chk = (xq @ wc) * xs * ws`` and trips where ``|s - chk|`` exceeds
``threshold_sigmas`` of the healthy noise of the sum (``sqrt(N)`` times
the per-element std, ``sqrt(N / G)`` per segment) plus a relative floor.

On a trip the ladder escalates, every rung computed and selected per row:
rung 1 re-reads with boosted majority voting (``retry_votes``, CB on) and
re-checks at that read's own sigma; rows still tripping are *hard*: rung
2 is the digital product ``x @ w``, the ``cim="off"`` path bit for bit.
Rows the engine pinned take the digital product and stop counting. The
trip and hard counts per batch row go to ``ctx.trip_log`` /
``ctx.hard_log``, which ``models.transformer`` stacks into (L, B).

The checksum dot runs in float64 and rounds to float32: every partial sum
is an integer below 2^53, so it is exact, where the reference's f32
"HIGHEST" einsum rounds in its own order; the relative floor (1e-5) covers
the difference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import CIMSpec, cim_dense, output_noise_std_int
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """ABFT guard operating point."""

    threshold_sigmas: float = 6.0  # trip at this many noise sigmas
    retry_votes: int = 12          # rung-1 CB majority votes for the re-read
    rel_floor: float = 1e-5        # rounding floor, relative to |chk|+|s|
    segments: int = 1              # checksum segments G (match the deployed
                                   # plane, core.deploy.checksum_plane)


def checksum_trips(y: torch.Tensor, xq: torch.Tensor, wc: torch.Tensor,
                   unit, sigma_deq, gs: GuardSpec) -> torch.Tensor:
    """Per-row-position trip decision of one guarded matmul: ``y`` (..., N)
    the dequantized analog output, ``xq`` (..., K) the integer activations,
    ``wc`` (K,) or (K, G) the checksum, ``unit`` the dequant scale ``xs *
    ws``, ``sigma_deq`` the healthy per-element std in y's units. Returns
    (...,) bool; with segments a row trips when any segment does."""
    n = y.shape[-1]
    xf = xq.to(torch.float64)
    wf = wc.to(torch.float64)
    chk = torch.matmul(xf, wf).to(torch.float32) * unit
    yf = y.to(torch.float32)
    if wc.ndim == 1:
        s = torch.sum(yf, dim=-1)
        tau = (gs.threshold_sigmas * math.sqrt(n) * sigma_deq
               + gs.rel_floor * (torch.abs(chk) + torch.abs(s)))
        return torch.abs(s - chk) > tau
    g = wc.shape[-1]
    s = torch.sum(yf.reshape(y.shape[:-1] + (g, n // g)), dim=-1)
    tau = (gs.threshold_sigmas * math.sqrt(n / g) * sigma_deq
           + gs.rel_floor * (torch.abs(chk) + torch.abs(s)))
    return torch.any(torch.abs(s - chk) > tau, dim=-1)


def _retry_spec(spec: CIMSpec, gs: GuardSpec) -> CIMSpec:
    """Rung-1 operating point: CB on, majority votes boosted."""
    return dataclasses.replace(
        spec, cb=True,
        adc=dataclasses.replace(spec.adc, mv_votes=gs.retry_votes))


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (B,) row mask shaped to broadcast over a rank-``ndim`` tensor."""
    return mask.reshape(mask.shape[:1] + (1,) * (ndim - 1))


def guarded_dense(ctx, p, x: torch.Tensor, spec: CIMSpec,
                  key: Optional[prng.Key],
                  xs: Optional[torch.Tensor]) -> torch.Tensor:
    """The checksum-guarded deployed sim-mode dense with its ladder (the
    caller adds the bias). The re-read draws under ``fold_in(key,
    0x9E77)``, not the layer's next key, so every other call's noise is
    the unguarded run's. ``ctx.fault.transient_mag`` disturbs the rows of
    ``ctx.fault_rows`` on both analog reads (not the digital one)."""
    gs = ctx.guard
    wq = p[f"wq{spec.w_bits}"]
    ws = p[f"ws{spec.w_bits}"]
    wc = p[f"wc{spec.w_bits}"]
    k = x.shape[-1]
    if xs is None:
        xs = quant.abs_max_scale(x, spec.in_bits)
    xq = quant.quantize(x.to(torch.float32), xs, spec.in_bits)
    unit = ws.to(torch.float32) * xs
    sigma_deq = output_noise_std_int(spec, k) * unit
    dstate = ctx.drift_state if ctx.drift is not None else None

    def run(sp: CIMSpec, kk):
        if ctx.cfg.cim.use_kernel:
            return kops.cim_matmul_deployed(x, wq, ws, sp, kk, x_scale=xs,
                                            dstate=dstate).to(x.dtype)
        return cim_dense(x, None, sp, kk, mode="sim", x_scale=xs,
                         w_scale=ws, wq=wq, dstate=dstate)

    dist = None
    if (ctx.fault is not None and ctx.fault.transient_mag > 0.0
            and ctx.fault_rows is not None and x.ndim >= 2):
        dist = torch.where(_rows(ctx.fault_rows, x.ndim),
                           ctx.fault.transient_mag * sigma_deq,
                           torch.zeros_like(sigma_deq))

    y0 = run(spec, key)
    if dist is not None:
        y0 = y0 + dist
    trip0 = checksum_trips(y0, xq, wc, unit, sigma_deq, gs)

    rspec = _retry_spec(spec, gs)
    y1 = run(rspec, None if key is None else prng.fold_in(key, 0x9E77))
    if dist is not None:
        y1 = y1 + dist
    sigma1 = output_noise_std_int(rspec, k) * unit
    trip1 = checksum_trips(y1, xq, wc, unit, sigma1, gs)
    y = torch.where(trip0[..., None], y1, y0)

    y_dig = x @ p["w"].to(x.dtype)
    hard = trip0 & trip1
    y = torch.where(hard[..., None], y_dig, y)

    if ctx.pin_rows is not None and x.ndim >= 2:
        pin = _rows(ctx.pin_rows, x.ndim - 1)
        y = torch.where(pin[..., None], y_dig, y)
        trip0 = trip0 & ~pin
        hard = hard & ~pin

    if ctx.trip_log is not None:
        dims = tuple(range(1, trip0.ndim))
        ctx.trip_log.append(trip0.to(torch.int32).sum(dim=dims)
                            if dims else trip0.to(torch.int32))
        ctx.hard_log.append(hard.to(torch.int32).sum(dim=dims)
                            if dims else hard.to(torch.int32))
    # in the model's dtype: the reference's f32 disturbance promotes a
    # bf16 model's activations to f32 from here on (ROADMAP C16); a row
    # it disturbs on both reads ends on the digital product, which the
    # model's dtype holds
    return y.to(x.dtype)
