"""Public CIM matmul ops (twin of ``src/repro/kernels/ops.py``).

``cim_matmul_fused_int`` and ``cim_matmul_deployed``: the inference path of
every CIM linear. The weight arrives as the resident int8 plane ``(wq,
ws)`` from ``core.deploy`` (stuck-at bitcells already in it); the
activation is quantized inside the kernel against the batch-global scale;
the readout-noise seed is both words of the layer key. The temporal drift
and the runtime faults (column gain and offset, stuck ADC columns, the
brownout stand-in) act after the kernel, on its dequantized output, as in
the reference: plain PyTorch ops, outside any kernel.

``cim_matmul_int`` and ``cim_matmul``: the integer-domain op on already
quantized operands and the differentiable op on float operands, with a
straight-through (STE) backward so the same op serves QAT training. Both
run the int8 kernel ``cim_matmul_int8``; the backward is two f32
``torch.matmul`` products on the dequantized residuals, as the reference
computes them outside any kernel.

On a mesh (``models.layers.dense``) a column shard runs
``cim_matmul_deployed`` with its place in the noise counter (``row0``,
``col0``) and a row shard ``cim_matmul_deployed_rows`` (int32 tile
partials, an all-reduce, the tile epilogue): both bit-equal to the
unsharded call.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import (CIMSpec, adc_stuck_value_int,
                                  brownout_extra_std_int,
                                  output_noise_std_int,
                                  output_noise_std_int_per_tile)
from repro_torch.core.drift import apply_drift
from repro_torch.core.faults import BROWNOUT_FOLD, apply_output_faults
from repro_torch.kernels.cim_matmul import (cim_matmul_fused, cim_matmul_int8,
                                            cim_tile_merge, cim_tile_partials)


def _qp(x_scale: torch.Tensor, scale: Optional[torch.Tensor],
        device) -> torch.Tensor:
    xs = x_scale.to(torch.float32).reshape(())
    out_scale = (torch.ones((), dtype=torch.float32, device=device)
                 if scale is None else scale.to(torch.float32).reshape(()))
    return torch.stack([xs, out_scale])


def cim_matmul_fused_int(x: torch.Tensor, wq: torch.Tensor,
                         x_scale: torch.Tensor,
                         seed: Optional[prng.Seed], sigma: float,
                         in_bits: int,
                         scale: Optional[torch.Tensor] = None,
                         row0: int = 0, col0: int = 0) -> torch.Tensor:
    """Fused act-quant CIM matmul of float (M, K) ``x`` on an int8 plane;
    ``scale`` (default 1) multiplies the f32 tile sum in the epilogue;
    ``row0``/``col0`` offset the noise counter (a shard's place)."""
    return cim_matmul_fused(x, wq, _qp(x_scale, scale, x.device), seed,
                            sigma, in_bits, row0=row0, col0=col0)


def _noise_seed(key: Optional[prng.Seed], sigma: float):
    if key is None or sigma <= 0:
        return None
    return key if isinstance(key, prng.SeedRow) else prng.seed_from_key(key)


def cim_matmul_deployed(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                        spec: CIMSpec, key: Optional[prng.Seed],
                        x_scale: Optional[torch.Tensor] = None,
                        dstate=None, row0: int = 0,
                        col0: int = 0) -> torch.Tensor:
    """y ~ macro(x @ (wq * ws)) with fused activation quantization; f32.
    ``key``: a host key or a ``prng.SeedRow`` of a seed table (whose row
    holds the key's words). Then ``spec.drift`` at ``dstate`` and the
    runtime faults of ``spec.fault``, in dequant units (the brownout normal
    under ``fold_in(key, 0x0FA1)``: a ``SeedRow`` must carry that fold).
    ``row0``/``col0``: the first global row (flattened token) and column of
    a column shard, for the noise counter; the epilogues take whole
    products only."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1])
    xs = (x_scale if x_scale is not None
          else quant.abs_max_scale(x2.to(torch.float32), spec.in_bits))
    k = x2.shape[1]
    n = wq.shape[1]
    sigma = output_noise_std_int_per_tile(spec, k)
    seed = _noise_seed(key, sigma)
    unit = xs * ws.to(torch.float32)
    y = cim_matmul_fused_int(x2, wq, xs, seed, sigma, spec.in_bits,
                             scale=unit, row0=row0, col0=col0)
    d, f = spec.drift, spec.fault
    if (row0 or col0) and ((d is not None and d.active())
                           or (f is not None and f.any_output_fault())):
        raise NotImplementedError(
            "drift and fault epilogues on a shard of a product (ROADMAP "
            "A7.3)")
    if d is not None and d.active() and dstate is not None:
        unit = unit.reshape(-1)[0]
        y = apply_drift(y, d, output_noise_std_int(spec, k) * unit, dstate)
    if f is not None and f.any_output_fault():
        unit = unit.reshape(-1)[0]
        bkey = (prng.fold_seed(key, BROWNOUT_FOLD)
                if key is not None and f.brownout_rate > 0.0 else None)
        y = apply_output_faults(
            y, f, output_noise_std_int(spec, k) * unit,
            adc_stuck_value_int(spec, k) * unit,
            brownout_extra_std_int(spec, k) * unit, key=bkey)
    return y.reshape(orig[:-1] + (n,))


def cim_matmul_deployed_rows(x: torch.Tensor, wq: torch.Tensor,
                             ws: torch.Tensor, spec: CIMSpec,
                             key: Optional[prng.Seed], x_scale: torch.Tensor,
                             k_off: int, k_total: int,
                             all_reduce: Callable[[torch.Tensor], torch.Tensor],
                             row0: int = 0) -> torch.Tensor:
    """The row-parallel ``cim_matmul_deployed``: ``x`` (..., K) and ``wq``
    (K, N) hold rows ``[k_off, k_off + K)`` of a K axis of ``k_total``
    rows, ``x_scale`` is the whole activation's scale. The shard's int32
    tile partials (``cim_tile_partials``), ``all_reduce`` (the int32 sum
    over the shards), then the tile epilogue with the whole product's
    sigma and noise (``cim_tile_merge``): (..., N) f32, bit-equal to the
    unsharded call."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1])
    sigma = output_noise_std_int_per_tile(spec, k_total)
    qp = _qp(x_scale, x_scale * ws.to(torch.float32), x.device)
    parts = all_reduce(cim_tile_partials(x2, wq, qp, spec.in_bits, k_off,
                                         k_total))
    y = cim_tile_merge(parts, qp, _noise_seed(key, sigma), sigma, row0)
    return y.reshape(orig[:-1] + (wq.shape[1],))


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
