"""Symmetric quantizers of the CR-CIM co-design (twin of ``core/quant.py``).

Weights are signed ``w_bits`` integers with one scale per weight plane;
activations signed ``in_bits`` integers with one per-tensor scale. Rounding
is half to even (``torch.round``, like ``jnp.round``).
"""

from __future__ import annotations

import torch


def qmax(bits: int) -> int:
    """Largest magnitude of a signed ``bits`` integer (symmetric)."""
    return 2 ** (bits - 1) - 1


def storage_dtype(bits: int) -> torch.dtype:
    """Narrowest signed dtype that holds ``bits``-bit values (int8 wraps
    above 8 bits)."""
    return torch.int8 if bits <= 8 else torch.int16


def abs_max_scale(x: torch.Tensor, bits: int, axis=None,
                  eps: float = 1e-8) -> torch.Tensor:
    """Symmetric scale mapping max|x| to qmax(bits), in x's dtype."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(amax, eps) / qmax(bits)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize to signed integers in [-qmax, qmax] (int32)."""
    q = qmax(bits)
    return torch.clamp(torch.round(x / scale), -q, q).to(torch.int32)


def dequantize(xi: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return xi.to(torch.float32) * scale


def quantize_operands(x: torch.Tensor, w, in_bits: int, w_bits: int,
                      x_scale=None, w_scale=None, wq=None):
    """Quantize both operands of a CIM matmul: ``(xq, xs, wq, ws)`` with
    ``xq``/``wq`` int32 in symmetric range and per-tensor abs-max scales.
    Scales come from the operands as given (the caller's dtype) unless
    passed in; rounding is done in f32 by division, half to even. A
    pre-quantized plane ``wq`` (with its ``w_scale``, from ``core.deploy``)
    skips the weight side, and ``w`` is not read."""
    xs = x_scale if x_scale is not None else abs_max_scale(x, in_bits)
    xq = quantize(x.to(torch.float32), xs, in_bits)
    if wq is not None:
        if w_scale is None:
            raise ValueError("pre-quantized wq requires its w_scale")
        return xq, xs, wq.to(torch.int32), w_scale
    ws = w_scale if w_scale is not None else abs_max_scale(w, w_bits)
    return xq, xs, quantize(w.to(torch.float32), ws, w_bits), ws


class _SteRound(torch.autograd.Function):
    """round() forward, identity backward (the straight-through estimator)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor, scale: torch.Tensor,
               bits: int) -> torch.Tensor:
    """Quantize->dequantize with straight-through gradients (clipped STE).

    The clip is ``min(max(x, lo), hi)`` as ``jnp.clip`` computes it:
    ``torch.maximum``/``torch.minimum`` split the cotangent evenly at ties,
    as ``lax.max``/``lax.min`` do (``torch.clamp`` would pass all of it),
    and the abs-max scale puts ``q * scale`` exactly on the abs-max
    element, so the tie is the common case."""
    q = qmax(bits)
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    x_c = torch.minimum(torch.maximum(-q * scale, x), q * scale)
    return _SteRound.apply(x_c / scale) * scale


def unsigned_bitplanes(xi: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement bit planes of signed ints, (bits,) + xi.shape int32;
    plane ``i`` weighs ``2**i``, the MSB plane ``-2**(bits-1)``."""
    u = torch.remainder(xi.to(torch.int64), 2 ** bits)
    return torch.stack([(u >> i) & 1 for i in range(bits)]).to(torch.int32)


def plane_weights(bits: int) -> torch.Tensor:
    """Signed shift-add weights of the two's-complement planes (int32)."""
    return torch.tensor([2 ** i for i in range(bits - 1)]
                        + [-(2 ** (bits - 1))], dtype=torch.int32)


def sum_sq_plane_weights(bits: int) -> int:
    """sum_j w_j^2 of the two's-complement planes (the shift-add noise gain)."""
    return sum(4 ** i for i in range(bits - 1)) + 4 ** (bits - 1)
