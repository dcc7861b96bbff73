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


def quantize_operands(x: torch.Tensor, w: torch.Tensor, in_bits: int,
                      w_bits: int):
    """Quantize both operands of a CIM matmul: ``(xq, xs, wq, ws)`` with
    ``xq``/``wq`` int32 in symmetric range and per-tensor abs-max scales.
    Scales come from the operands as given (the caller's dtype); rounding
    is done in f32 by division, half to even."""
    xs = abs_max_scale(x, in_bits)
    ws = abs_max_scale(w, w_bits)
    return (quantize(x.to(torch.float32), xs, in_bits), xs,
            quantize(w.to(torch.float32), ws, w_bits), ws)
