"""SQNR / CSNR measurement on the bit-exact macro (paper Figs. 5-6).

Twin of ``core/metrics.py``. SQNR (Jia et al.) is the SNR of one column
readout chain under a full-scale uniform signal, its error counting
quantization, comparator noise and static INL/DNL. CSNR (Gonugondla et
al.) is the compute SNR of the macro matmul at the peak operating point,
its error the random part only (repeated conversions of the same inputs,
the per-input mean removed). Every draw replays ``jax.random`` under the
reference's keys (``core.prng``), so the port measures the same Monte-Carlo
samples; each function runs on ``device``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng, quant
from repro_torch.core.adc import inl_curve, linspace, sar_convert
from repro_torch.core.cim import MACRO_ROWS, CIMSpec, cim_matmul_bit_exact


def _var(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Population variance (``jnp.var``)."""
    if dim is None:
        return torch.mean(torch.square(x - x.mean()))
    return torch.mean(torch.square(x - x.mean(dim=dim, keepdim=True)),
                      dim=dim)


def measure_sqnr_db(spec: CIMSpec, n_samples: int = 8192, seed: int = 3,
                    device="cuda") -> float:
    """Single-conversion SQNR with a full-scale uniform signal."""
    dev = resolve_device(device)
    adc = spec.effective_adc()
    kv, kn = prng.split(prng.PRNGKey(seed))
    v = prng.uniform(kv, (n_samples,), 0.0, float(adc.codes - 1), device=dev)
    code = sar_convert(v, kn, adc, spec.cb)
    err = code.to(torch.float32) - v
    return 10.0 * math.log10(float(_var(v)) / float(_var(err)))


def _operands(spec: CIMSpec, m: int, n: int, seed: int, dev):
    """Full-range random int operands (M, 1024) and (1024, N) and the
    conversion key, as the reference draws them."""
    kx, kw, kn = prng.split(prng.PRNGKey(seed), 3)
    qx, qw = quant.qmax(spec.in_bits), quant.qmax(spec.w_bits)
    xq = prng.randint(kx, (m, MACRO_ROWS), -qx, qx + 1, device=dev)
    wq = prng.randint(kw, (MACRO_ROWS, n), -qw, qw + 1, device=dev)
    exact = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)
    return xq, wq, kn, exact


def measure_csnr_db(spec: CIMSpec, m: int = 64, n: int = 16, reps: int = 8,
                    seed: int = 5, device="cuda") -> float:
    """Compute-SNR of the macro matmul (noise-referred, peak operating
    point): K = one macro tile, ``reps`` conversions of the same operands
    under ``fold_in(key, r)``, the per-input mean removed."""
    dev = resolve_device(device)
    xq, wq, kn, exact = _operands(spec, m, n, seed, dev)
    ys = torch.stack([cim_matmul_bit_exact(xq, wq, prng.fold_in(kn, r), spec)
                      for r in range(reps)])
    noise_var = float(torch.mean(_var(ys, dim=0))) * reps / (reps - 1)
    return 10.0 * math.log10(float(_var(exact)) / noise_var)


def measure_total_csnr_db(spec: CIMSpec, m: int = 64, n: int = 16,
                          seed: int = 5, device="cuda") -> float:
    """CSNR counting the total error (quantization of the partial sums and
    INL included)."""
    dev = resolve_device(device)
    xq, wq, kn, exact = _operands(spec, m, n, seed, dev)
    y = cim_matmul_bit_exact(xq, wq, kn, spec)
    return 10.0 * math.log10(float(_var(exact)) / float(_var(y - exact)))


def column_characteristics(spec: CIMSpec, n_codes: int = 64, reps: int = 48,
                           seed: int = 11,
                           device="cuda") -> Dict[str, np.ndarray]:
    """Fig. 5: transfer curve, INL and read noise per code."""
    dev = resolve_device(device)
    adc = spec.effective_adc()
    v = linspace(4.0, adc.codes - 4.0, n_codes, device=dev)
    out = sar_convert(v[None].repeat(reps, 1), prng.PRNGKey(seed), adc,
                      spec.cb).to(torch.float32)
    return {
        "v": v.cpu().numpy(),
        "mean_code": out.mean(dim=0).cpu().numpy(),
        "noise_lsb": torch.sqrt(_var(out, dim=0)).cpu().numpy(),
        "inl": inl_curve(adc),
    }


def noise_summary(spec: CIMSpec, device="cuda") -> Tuple[float, float]:
    """(mean read noise in LSB at the spec's CB state, max |INL|)."""
    ch = column_characteristics(spec, device=device)
    return float(np.mean(ch["noise_lsb"])), float(np.max(np.abs(ch["inl"])))
