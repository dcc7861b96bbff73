"""CR-CIM macro operating point, its output-referred noise figure and the
behavioural macro matmul.

Twin of the part of ``core/cim.py`` that the serving paths need:
``CIMSpec`` (without the fault and drift fields, ROADMAP A5), the
per-layer analog gain, the per-K-tile readout-noise std that the CIM
kernel injects, and the behavioural sim path (``cim_matmul_behavioral``,
``cim_dense``) that ``layers.dense`` takes when ``cim.use_kernel`` is
False: the exact integer dot plus one whole-K ``jax.random.normal`` draw,
replayed by ``prng.normal``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import prng, quant
from repro_torch.core.adc import ADCSpec, adc_total_error_var_lsb2

# Rows of one macro: the K tile of the readout noise and of the CUDA kernel
# (csrc/cim_matmul.cu), fixed in the port.
MACRO_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class CIMSpec:
    in_bits: int = 6
    w_bits: int = 6
    cb: bool = True
    adc: ADCSpec = ADCSpec()
    clip_sigmas: float = 34.0
    scheme: str = "crcim"            # "crcim" | "conventional"
    comparator: str = "relaxed"      # "relaxed" | "lownoise"
    noise_scale: float = 1.0

    @property
    def adc_bits(self) -> int:
        return self.adc.adc_bits if self.scheme == "crcim" else 8

    @property
    def attenuation(self) -> float:
        return 1.0 if self.scheme == "crcim" else 0.5

    def effective_adc(self) -> ADCSpec:
        sigma = self.adc.sigma_cmp
        if self.comparator == "lownoise":
            sigma = sigma / 2.0
        if self.scheme == "crcim":
            return dataclasses.replace(self.adc, sigma_cmp=sigma)
        return dataclasses.replace(self.adc, adc_bits=8,
                                   sigma_cmp=sigma / self.attenuation)

    def analog_gain(self, x_rms_frac: float = 0.29,
                    rows: Optional[int] = None) -> float:
        """LSB per unit plane-sum charge, Vref fitted to the active rows."""
        r = min(rows or MACRO_ROWS, MACRO_ROWS)
        sigma_s = math.sqrt(r * (x_rms_frac ** 2) * 0.5)
        half = 2 ** (self.adc_bits - 1)
        return half / (self.clip_sigmas * sigma_s)


def output_noise_std_int(spec: CIMSpec, k: int) -> float:
    """Std (integer product units) of the macro error of a K-long dot."""
    adc = spec.effective_adc()
    var_lsb = adc_total_error_var_lsb2(adc, spec.cb)
    gain = spec.analog_gain(rows=k) * spec.attenuation
    s_bw = sum(4 ** i for i in range(spec.w_bits - 1)) + 4 ** (spec.w_bits - 1)
    qx = quant.qmax(spec.in_bits)
    tiles = -(-k // MACRO_ROWS)
    return spec.noise_scale * math.sqrt(tiles * s_bw * var_lsb) * qx / gain


def output_noise_std_int_per_tile(spec: CIMSpec, k: int) -> float:
    """Per-K-tile error std, the analog gain fitted to the true K."""
    tiles = -(-k // MACRO_ROWS)
    return output_noise_std_int(spec, k) / math.sqrt(tiles)


def cim_matmul_behavioral(xq: torch.Tensor, wq: torch.Tensor,
                          key: prng.Key, spec: CIMSpec) -> torch.Tensor:
    """Behavioural macro matmul: exact integer dot plus the equivalent
    Gaussian error, f32 (twin of ``cim_matmul_behavioral``).

    When ``qmax_x * qmax_w * K < 2**24`` every partial sum is an integer
    below 2^24, exact in f32 in any summation order, so the dot runs as an
    f32 matmul (no TF32: ``torch.backends.cuda.matmul.allow_tf32`` is off by
    default). Otherwise it runs in f64, exact below 2^53, and rounds to f32
    as the reference's int32 dot does while its sums fit int32. The noise is
    ``output_noise_std_int(spec, K) * normal(key, y.shape)``, one draw over
    the whole output. The reference's drift and fault epilogues read
    ``spec.drift`` / ``spec.fault``; this ``CIMSpec`` has neither (ROADMAP
    A5), so neither is applied."""
    k = xq.shape[-1]
    if quant.qmax(spec.in_bits) * quant.qmax(spec.w_bits) * k < 2 ** 24:
        y = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
    else:
        y = torch.matmul(xq.to(torch.float64),
                         wq.to(torch.float64)).to(torch.float32)
    sigma = output_noise_std_int(spec, k)
    if sigma > 0.0:
        y = y + sigma * prng.normal(key, tuple(y.shape), device=y.device)
    return y


def cim_dense(x: torch.Tensor, w: Optional[torch.Tensor],
              spec: Optional[CIMSpec], key: Optional[prng.Key],
              mode: str = "digital", x_scale: Optional[torch.Tensor] = None,
              w_scale: Optional[torch.Tensor] = None,
              wq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w, digitally or on the behavioural macro model.

    ``digital`` (or no spec): the plain product. ``sim``: quantize both
    operands (a deployed plane ``wq`` with its ``w_scale`` skips the weight
    side; ``w`` may then be None), run ``cim_matmul_behavioral`` under
    ``key`` (None: ``PRNGKey(0)``, as in the reference) and rescale by
    ``xs * ws``, in x's dtype. ``qat`` is not ported (ROADMAP A3)."""
    if mode == "digital" or spec is None:
        return torch.einsum("...k,kn->...n", x, w)
    if mode == "qat":
        raise NotImplementedError(
            "cim_dense mode 'qat' (noise-aware STE fake-quant) is not "
            "ported yet; ROADMAP.md item A3")
    if mode != "sim":
        raise ValueError(f"unknown cim mode: {mode}")
    xq, xs, wq_i, ws = quant.quantize_operands(
        x, w, spec.in_bits, spec.w_bits, x_scale=x_scale, w_scale=w_scale,
        wq=wq)
    if key is None:
        key = prng.PRNGKey(0)
    y = cim_matmul_behavioral(xq, wq_i, key, spec)
    return (y * xs * ws).to(x.dtype)
