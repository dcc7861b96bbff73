"""Public CIM matmul ops (twin of ``src/repro/kernels/ops.py``).

``cim_matmul_fused_int`` and ``cim_matmul_deployed``: the inference path of
every CIM linear, without the drift and fault epilogues (not ported yet).
The weight arrives as the resident int8 plane ``(wq, ws)`` from
``core.deploy``; the activation is quantized inside the kernel against the
batch-global scale; the readout-noise seed is both words of the layer key.

``cim_matmul_int`` and ``cim_matmul``: the integer-domain op on already
quantized operands and the differentiable op on float operands, with a
straight-through (STE) backward so the same op serves QAT training. Both
run the int8 kernel ``cim_matmul_int8``; the backward is two f32
``torch.matmul`` products on the dequantized residuals, as the reference
computes them outside any kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import CIMSpec, output_noise_std_int_per_tile
from repro_torch.kernels.cim_matmul import cim_matmul_fused, cim_matmul_int8


def cim_matmul_fused_int(x: torch.Tensor, wq: torch.Tensor,
                         x_scale: torch.Tensor,
                         seed: Optional[Tuple[int, int]], sigma: float,
                         in_bits: int,
                         scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused act-quant CIM matmul of float (M, K) ``x`` on an int8 plane;
    ``scale`` (default 1) multiplies the f32 tile sum in the epilogue."""
    xs = x_scale.to(torch.float32).reshape(())
    out_scale = (torch.ones((), dtype=torch.float32, device=x.device)
                 if scale is None else scale.to(torch.float32).reshape(()))
    qp = torch.stack([xs, out_scale])
    return cim_matmul_fused(x, wq, qp, seed, sigma, in_bits)


def cim_matmul_deployed(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                        spec: CIMSpec, key: Optional[prng.Key],
                        x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y ~ macro(x @ (wq * ws)) with fused activation quantization; f32."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1])
    xs = (x_scale if x_scale is not None
          else quant.abs_max_scale(x2.to(torch.float32), spec.in_bits))
    k = x2.shape[1]
    n = wq.shape[1]
    sigma = output_noise_std_int_per_tile(spec, k)
    seed = prng.seed_from_key(key) if key is not None and sigma > 0 else None
    y = cim_matmul_fused_int(x2, wq, xs, seed, sigma, spec.in_bits,
                             scale=xs * ws.to(torch.float32))
    return y.reshape(orig[:-1] + (n,))


# Integer-domain CIM matmul of int8 (M, K) ``xq`` and (K, N) ``wq``:
# ``cim_matmul_int(xq, wq, seed, sigma, scale=None)``, the reference's
# ``ops.cim_matmul_int``. ``seed`` None (noiseless), a scalar (zero-extended)
# or a pair of words; a CPU tensor takes the plain version, a CUDA tensor
# the kernel.
cim_matmul_int = cim_matmul_int8


class _CimMatmulSTE(torch.autograd.Function):
    """Forward through the macro model; backward as the dequantized exact
    matmul (straight-through)."""

    @staticmethod
    def forward(ctx, x, w, spec: CIMSpec, key: Optional[prng.Key]):
        if spec.in_bits > 8 or spec.w_bits > 8:
            raise ValueError(f"cim_matmul takes operands of at most 8 bits "
                             f"(int8 kernel), got in_bits={spec.in_bits}, "
                             f"w_bits={spec.w_bits}")
        orig = x.shape
        x2 = x.reshape(-1, orig[-1]).to(torch.float32)
        xq, xs, wq, ws = quant.quantize_operands(
            x2, w.to(torch.float32), spec.in_bits, spec.w_bits)
        k, n = w.shape
        sigma = output_noise_std_int_per_tile(spec, k)
        seed = (prng.seed_from_key(key) if key is not None and sigma > 0
                else None)
        xq = xq.to(quant.storage_dtype(spec.in_bits))
        wq = wq.to(quant.storage_dtype(spec.w_bits))
        y = cim_matmul_int(xq, wq, seed, sigma, scale=xs * ws)
        # narrow residuals: the backward dequantizes them lazily
        ctx.save_for_backward(xq, xs, wq, ws)
        ctx.shapes = (orig, x.dtype, w.dtype)
        return y.reshape(orig[:-1] + (n,))

    @staticmethod
    def backward(ctx, g):
        xq, xs, wq, ws = ctx.saved_tensors
        orig, x_dtype, w_dtype = ctx.shapes
        g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
        dx = (g2 @ quant.dequantize(wq, ws).T).reshape(orig)
        dw = quant.dequantize(xq, xs).T @ g2
        return dx.to(x_dtype), dw.to(w_dtype), None, None


def cim_matmul(x: torch.Tensor, w: torch.Tensor, spec: CIMSpec,
               key: Optional[prng.Key]) -> torch.Tensor:
    """y ~ macro(x @ w), f32 with x's leading dimensions: per-tensor abs-max
    quantization of both operands, the int8 kernel with the per-tile readout
    noise (``key`` None: noiseless) and the ``xs * ws`` epilogue.
    Differentiable in ``x`` and ``w`` through the straight-through
    estimator; ``spec`` and ``key`` get no gradient."""
    return _CimMatmulSTE.apply(x, w, spec, key)
