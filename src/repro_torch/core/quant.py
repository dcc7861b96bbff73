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
