"""Deployed sim-mode CIM matmul: the inference path of every CIM linear.

Twin of ``src/repro/kernels/ops.py`` ``cim_matmul_fused_int`` and
``cim_matmul_deployed`` without the drift and fault epilogues (out of this
slice). The weight arrives as the resident int8 plane ``(wq, ws)`` from
``core.deploy``; the activation is quantized inside the kernel against the
batch-global scale; the readout-noise seed is both words of the layer key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import CIMSpec, output_noise_std_int_per_tile
from repro_torch.kernels.cim_matmul import cim_matmul_fused


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
