"""CR-CIM macro operating point and its output-referred noise figure.

Twin of the part of ``core/cim.py`` that the deployed kernel path needs:
``CIMSpec`` (without the fault and drift fields, which this slice does not
port), the per-layer analog gain, and the per-K-tile readout-noise std that
the CIM kernel injects.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import quant
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
