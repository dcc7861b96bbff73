"""CR-CIM macro operating point, its output-referred noise figure and the
macro matmul at its two fidelities.

Twin of ``core/cim.py``: ``CIMSpec`` (with its structural-fault and
temporal-drift scenarios, ``core/faults.py`` and ``core/drift.py``), the
per-layer analog gain, the per-K-tile readout-noise std that the CIM
kernel injects, the output values of the runtime faults
(``adc_stuck_value_int``, ``brownout_extra_std_int``), the bit-exact
engine (``cim_matmul_bit_exact``: every K-tile x weight-plane partial sum
through one batched SAR conversion with its conversion-level faults, the
paper-metrics path), the behavioural sim path (``cim_matmul_behavioral``:
the exact integer dot plus one whole-K ``jax.random.normal`` draw,
replayed by ``prng.normal``, then the drift and fault epilogues) and
``cim_dense`` in its digital, qat (straight-through fake-quant plus the
macro's noise, for training) and sim modes, and the load ladder's
``vote_drop_extra_std_int`` (the extra noise of a conversion voted fewer
times).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng, quant
from repro_torch.core.adc import (ADCSpec, adc_noise_error_var_lsb2,
                                  adc_total_error_var_lsb2, sar_convert)
from repro_torch.core.drift import DriftSpec, apply_drift
from repro_torch.core.faults import (BROWNOUT_FOLD, FaultSpec,
                                     apply_output_faults,
                                     column_gain, column_offset_z)

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
    fault: Optional[FaultSpec] = None  # structural faults; None = healthy
    drift: Optional[DriftSpec] = None  # temporal drift; None = stable,
                                       # evaluated at the caller's step

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


def _num_k_tiles(k: int) -> int:
    return -(-k // MACRO_ROWS)


def plane_sums(xq: torch.Tensor, wq: torch.Tensor,
               spec: CIMSpec) -> torch.Tensor:
    """The analog array's partial sums of every K tile and weight plane,
    (T, w_bits, M, N) f32 in charge units: the drive ``xq / qmax_x`` of
    each tile's rows against each two's-complement plane of ``wq``."""
    m, k = xq.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {xq.shape} @ {wq.shape}")
    t = _num_k_tiles(k)
    kp = t * MACRO_ROWS
    xq = torch.nn.functional.pad(xq, (0, kp - k))
    wq = torch.nn.functional.pad(wq, (0, 0, 0, kp - k))
    wplanes = quant.unsigned_bitplanes(wq, spec.w_bits)    # (w_bits, Kp, N)
    # XLA folds a division by a constant into a product with the
    # constant's f32 reciprocal; the drive (x / qx) and the readout
    # (/ gain) take the reference's values only so
    inv_qx = float(np.float32(1.0) / np.float32(quant.qmax(spec.in_bits)))
    x3 = (xq.to(torch.float32) * inv_qx).reshape(m, t, MACRO_ROWS)
    w4 = wplanes.reshape(spec.w_bits, t, MACRO_ROWS, n).to(torch.float32)
    return torch.einsum("mtr,jtrn->tjmn", x3, w4)


def cim_matmul_bit_exact(xq: torch.Tensor, wq: torch.Tensor, key: prng.Key,
                         spec: CIMSpec) -> torch.Tensor:
    """Bit-exact macro matmul of int32 ``xq`` (M, K) and ``wq`` (K, N), on
    their device: every (K-tile, weight-plane) partial sum of the analog
    array from one einsum (``plane_sums``), all ``T * w_bits`` of them
    through one ``sar_convert`` of the ``(T * w_bits, M, N)`` conversion
    tensor, then the signed shift-add of the codes. Returns the (M, N) f32
    estimate of ``xq @ wq`` in integer product units. ``spec.fault``: the
    brownouts and stuck ADC codes act inside the conversion, the column
    gain and offset on the shift-added output, as in the reference."""
    m, k = xq.shape
    n = wq.shape[1]
    s = plane_sums(xq, wq, spec)
    t = s.shape[0]
    qx = quant.qmax(spec.in_bits)
    half = 2.0 ** (spec.adc_bits - 1)
    gain = spec.analog_gain(rows=k) * spec.attenuation
    v = torch.clamp(gain * s + half, 0.0, 2.0 ** spec.adc_bits - 1.0)
    code = sar_convert(v.reshape(t * spec.w_bits, m, n), key,
                       spec.effective_adc(), spec.cb, fault=spec.fault)
    c = code.reshape(t, spec.w_bits, m, n).to(torch.float32) - half
    inv_gain = float(np.float32(1.0) / np.float32(gain))
    # the reference sums the tiles out first, each product with 1/gain
    # fused into the running sum (one rounding: an FMA, emulated in f64,
    # where the product of two f32 values is exact)
    acc = c[0] * inv_gain
    for i in range(1, t):
        acc = (c[i].to(torch.float64) * inv_gain
               + acc.to(torch.float64)).to(torch.float32)
    # then contracts the planes in order with their signed weights (powers
    # of two: every product is exact)
    pw = quant.plane_weights(spec.w_bits).tolist()
    y = pw[0] * acc[0]
    for j in range(1, spec.w_bits):
        y = y + pw[j] * acc[j]
    y = qx * y
    f = spec.fault
    if f is not None:
        g = column_gain(f, n, y.device)
        if g is not None:
            y = y * g
        z = column_offset_z(f, n, y.device)
        if z is not None:
            y = y + (f.col_offset_std * output_noise_std_int(spec, k)) * z
    return y


def output_noise_std_int(spec: CIMSpec, k: int,
                         include_static: bool = True) -> float:
    """Std (integer product units) of the macro error of a K-long dot;
    ``include_static=False`` leaves out the static INL and DNL (the random
    error only, what noise-aware QAT injects)."""
    adc = spec.effective_adc()
    var_lsb = (adc_total_error_var_lsb2(adc, spec.cb) if include_static
               else adc_noise_error_var_lsb2(adc, spec.cb))
    gain = spec.analog_gain(rows=k) * spec.attenuation
    s_bw = quant.sum_sq_plane_weights(spec.w_bits)
    qx = quant.qmax(spec.in_bits)
    tiles = _num_k_tiles(k)
    return spec.noise_scale * math.sqrt(tiles * s_bw * var_lsb) * qx / gain


def output_noise_std_int_per_tile(spec: CIMSpec, k: int) -> float:
    """Per-K-tile error std, the analog gain fitted to the true K."""
    tiles = _num_k_tiles(k)
    return output_noise_std_int(spec, k) / math.sqrt(tiles)


def adc_stuck_value_int(spec: CIMSpec, k: int) -> float:
    """Output (integer product units) of a stuck-ADC column: every one of
    the ``T * w_bits`` conversions returns ``adc_stuck_code``, and the
    two's-complement plane weights sum to -1."""
    f = spec.fault
    if f is None:
        return 0.0
    gain = spec.analog_gain(rows=k) * spec.attenuation
    half = 2.0 ** (spec.adc_bits - 1)
    qx = quant.qmax(spec.in_bits)
    return -_num_k_tiles(k) * qx * (f.adc_stuck_code - half) / gain


def brownout_extra_std_int(spec: CIMSpec, k: int) -> float:
    """The behavioural stand-in of vote brownouts: the extra output noise
    std (integer product units) of a Bernoulli(rate) mixture of the
    conversion variances at ``brownout_votes`` and at ``mv_votes``; 0
    without CB."""
    f = spec.fault
    if f is None or f.brownout_rate <= 0.0 or not spec.cb:
        return 0.0
    adc = spec.effective_adc()
    dvar = max(
        adc_total_error_var_lsb2(
            dataclasses.replace(adc, mv_votes=f.brownout_votes), spec.cb)
        - adc_total_error_var_lsb2(adc, spec.cb), 0.0)
    gain = spec.analog_gain(rows=k) * spec.attenuation
    s_bw = quant.sum_sq_plane_weights(spec.w_bits)
    qx = quant.qmax(spec.in_bits)
    tiles = _num_k_tiles(k)
    return (spec.noise_scale
            * math.sqrt(f.brownout_rate * tiles * s_bw * dvar) * qx / gain)


def vote_drop_extra_std_int(spec: CIMSpec, k: int,
                            votes: Optional[int]) -> float:
    """Extra output noise std (integer product units) when the CB majority
    votes run at ``votes`` instead of ``spec.adc.mv_votes``: the variance
    of the smaller vote count less the full one's, through the gain and
    shift-add chain of ``output_noise_std_int`` (``brownout_extra_std_int``
    at rate 1 with an explicit count). ``votes=None``, ``votes >=
    mv_votes`` or a spec without CB give exactly 0.0, so a ladder-level-0
    row adds no noise."""
    if votes is None or not spec.cb or votes >= spec.adc.mv_votes:
        return 0.0
    if votes < 1:
        raise ValueError(f"degraded vote count must be >= 1, got {votes}")
    adc = spec.effective_adc()
    dvar = max(
        adc_total_error_var_lsb2(
            dataclasses.replace(adc, mv_votes=votes), spec.cb)
        - adc_total_error_var_lsb2(adc, spec.cb), 0.0)
    gain = spec.analog_gain(rows=k) * spec.attenuation
    s_bw = quant.sum_sq_plane_weights(spec.w_bits)
    qx = quant.qmax(spec.in_bits)
    tiles = _num_k_tiles(k)
    return (spec.noise_scale
            * math.sqrt(tiles * s_bw * dvar) * qx / gain)


def cim_matmul_behavioral(xq: torch.Tensor, wq: torch.Tensor,
                          key: prng.Key, spec: CIMSpec,
                          dstate=None) -> torch.Tensor:
    """Behavioural macro matmul: exact integer dot plus the equivalent
    Gaussian error, f32 (twin of ``cim_matmul_behavioral``).

    When ``qmax_x * qmax_w * K < 2**24`` every partial sum is an integer
    below 2^24, exact in f32 in any summation order, so the dot runs as an
    f32 matmul (no TF32: ``torch.backends.cuda.matmul.allow_tf32`` is off by
    default). Otherwise it runs in f64, exact below 2^53, and rounds to f32
    as the reference's int32 dot does while its sums fit int32. The noise is
    ``output_noise_std_int(spec, K) * normal(key, y.shape)``, one draw over
    the whole output. Then the drift epilogue at ``dstate`` (``spec.drift``)
    and the runtime fault epilogue (``spec.fault``; the brownout normal
    under ``fold_in(key, 0x0FA1)``, so the healthy noise stream is the
    same with and without a fault), in the reference's order."""
    k = xq.shape[-1]
    if quant.qmax(spec.in_bits) * quant.qmax(spec.w_bits) * k < 2 ** 24:
        y = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
    else:
        y = torch.matmul(xq.to(torch.float64),
                         wq.to(torch.float64)).to(torch.float32)
    sigma = output_noise_std_int(spec, k)
    if sigma > 0.0:
        y = y + sigma * prng.normal(key, tuple(y.shape), device=y.device)
    y = apply_drift(y, spec.drift, sigma, dstate)
    f = spec.fault
    if f is not None and f.any_output_fault():
        y = apply_output_faults(
            y, f, sigma, adc_stuck_value_int(spec, k),
            brownout_extra_std_int(spec, k),
            key=prng.fold_in(key, BROWNOUT_FOLD))
    return y


def cim_dense(x: torch.Tensor, w: Optional[torch.Tensor],
              spec: Optional[CIMSpec], key: Optional[prng.Key],
              mode: str = "digital", x_scale: Optional[torch.Tensor] = None,
              w_scale: Optional[torch.Tensor] = None,
              wq: Optional[torch.Tensor] = None,
              dstate=None) -> torch.Tensor:
    """y = x @ w, digitally, as QAT fake-quant or on the behavioural macro.

    ``digital`` (or no spec): the plain product. ``qat``: straight-through
    fake-quant of x and w at the spec's precisions (abs-max scales unless
    given), and with a key the macro's random output error
    ``sigma * xs * ws * normal(key)`` (noise-aware QAT). ``sim``: quantize
    both operands (a deployed plane ``wq`` with its ``w_scale`` skips the
    weight side; ``w`` may then be None), run ``cim_matmul_behavioral``
    under ``key`` (None: ``PRNGKey(0)``, as in the reference) with the
    drift state ``dstate`` and rescale by ``xs * ws``, in x's dtype."""
    if mode == "digital" or spec is None:
        return torch.einsum("...k,kn->...n", x, w)
    if mode == "qat":
        xs = (x_scale if x_scale is not None
              else quant.abs_max_scale(x, spec.in_bits))
        ws = (w_scale if w_scale is not None
              else quant.abs_max_scale(w, spec.w_bits))
        xf = quant.fake_quant(x.to(torch.float32), xs, spec.in_bits)
        wf = quant.fake_quant(w.to(torch.float32), ws, spec.w_bits)
        y = torch.einsum("...k,kn->...n", xf, wf)
        if key is not None:
            sigma = output_noise_std_int(spec, x.shape[-1],
                                         include_static=False)
            y = y + (sigma * xs * ws) * prng.normal(key, tuple(y.shape),
                                                    device=y.device)
        return y.to(x.dtype)
    if mode != "sim":
        raise ValueError(f"unknown cim mode: {mode}")
    xq, xs, wq_i, ws = quant.quantize_operands(
        x, w, spec.in_bits, spec.w_bits, x_scale=x_scale, w_scale=w_scale,
        wq=wq)
    if key is None:
        key = prng.PRNGKey(0)
    y = cim_matmul_behavioral(xq, wq_i, key, spec, dstate)
    return (y * xs * ws).to(x.dtype)
