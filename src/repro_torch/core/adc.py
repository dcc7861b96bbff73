"""SAR ADC statistics behind the CIM readout-noise figure.

The port's twin of the part of ``core/adc.py`` that the kernel's noise
``sigma`` depends on: the mismatched C-DAC weights (a ``jax.random.normal``
draw under ``PRNGKey(mismatch_seed)``), the INL curve, the static DNL table
(``PRNGKey(mismatch_seed + 1)``), the analytic comparator decision
probabilities, the one-pass SAR conversion (with the conversion-level
faults of ``core/faults.py``: vote brownouts and stuck ADC codes) and its
Monte-Carlo noise figure under ``PRNGKey(7)``. The card has no JAX to ask,
so every draw replays ``jax.random`` through ``core.prng``. The DAC weights
and the DNL table are computed once per operating point on the CPU, in
float32 like the reference; ``sar_convert`` runs on ``v``'s device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.faults import adc_stuck_cols, brownout_mask


@dataclasses.dataclass(frozen=True)
class ADCSpec:
    adc_bits: int = 10
    sigma_cmp: float = 0.82
    coarse_frac: float = 0.35
    p_glitch: float = 0.18
    glitch_mag: float = 24.0
    cap_sigma: float = 0.10
    sigma_dnl: float = 1.29
    mv_votes: int = 6
    mv_bits: int = 3
    mismatch_seed: int = 0xC1

    @property
    def codes(self) -> int:
        return 2 ** self.adc_bits

    def decisions(self, cb: bool) -> int:
        if not cb:
            return self.adc_bits
        return (self.adc_bits - self.mv_bits) + self.mv_bits * self.mv_votes


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis in index order, the order XLA's CPU
    reduction takes for these short axes (torch.sum pairs differently)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


# per operating point, computed once on the CPU: the DAC weights, the DNL
# table, the INL curve and the conversion noise (per device type)
_CACHE: dict = {}


def dac_bit_weights(spec: ADCSpec) -> torch.Tensor:
    """Mismatched weight of each binary C-DAC group, normalised to full scale
    (f32, on the CPU)."""
    kk = ("dac", spec)
    if kk not in _CACHE:
        z = prng.normal(prng.PRNGKey(spec.mismatch_seed), (spec.adc_bits,))
        nominal = 2.0 ** torch.arange(spec.adc_bits, dtype=torch.float32)
        w = nominal + torch.sqrt(nominal) * spec.cap_sigma * z
        _CACHE[kk] = w * (spec.codes - 1) / _seq_sum(w)
    return _CACHE[kk]


def dac_level(code: torch.Tensor, spec: ADCSpec) -> torch.Tensor:
    """Analog level (ideal-LSB units) a digital code produces."""
    w = dac_bit_weights(spec).to(code.device)
    bits = torch.stack([(code >> i) & 1 for i in range(spec.adc_bits)],
                       dim=-1)
    return _seq_sum(bits.to(torch.float32) * w)


def inl_curve(spec: ADCSpec) -> np.ndarray:
    """INL(code) = dac_level(code) - code, for all codes."""
    kk = ("inl", spec)
    if kk not in _CACHE:
        codes = torch.arange(spec.codes, dtype=torch.int32)
        _CACHE[kk] = (dac_level(codes, spec)
                      - codes.to(torch.float32)).numpy()
    return _CACHE[kk]


_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327


def _phi(x):
    return 0.5 * (1.0 + torch.erf(x * _INV_SQRT2))


def _npdf(x):
    return _INV_SQRT2PI * torch.exp(-0.5 * x * x)


def _norm_int(x):
    return x * _phi(x) + _npdf(x)


def decision_prob(d: torch.Tensor, sigma: float, p_glitch: float,
                  glitch_mag: float) -> torch.Tensor:
    """P(one comparator vote fires 'up') at decision gap ``d`` (LSB)."""
    if p_glitch <= 0.0 or glitch_mag <= 0.0:
        p_glitch = 0.0
    if sigma > 0.0:
        base = _phi(d * (1.0 / sigma))
        if p_glitch > 0.0:
            a = (d - glitch_mag) * (1.0 / sigma)
            b = (d + glitch_mag) * (1.0 / sigma)
            gl = (sigma / (2.0 * glitch_mag)) * (_norm_int(b) - _norm_int(a))
            return (1.0 - p_glitch) * base + p_glitch * gl
        return base
    base = (d > 0.0).to(torch.float32)
    if p_glitch > 0.0:
        gl = torch.clamp((d + glitch_mag) * (1.0 / (2.0 * glitch_mag)), 0.0, 1.0)
        return (1.0 - p_glitch) * base + p_glitch * gl
    return base


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y by binary exponentiation, the multiplication order of
    ``lax.integer_pow``."""
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def majority_prob(p: torch.Tensor, votes: int) -> torch.Tensor:
    """P(strict majority of ``votes`` iid Bernoulli(p) votes fire 'up')."""
    if votes == 1:
        return p
    thr = votes // 2 + 1
    q = 1.0 - p
    out = torch.zeros_like(p)
    for i in range(thr, votes + 1):
        out = out + float(math.comb(votes, i)) * _ipow(p, i) * _ipow(q, votes - i)
    return out


def _dnl_shift(v: torch.Tensor, spec: ADCSpec) -> torch.Tensor:
    if spec.sigma_dnl <= 0.0:
        return v
    kk = ("dnl", spec)
    if kk not in _CACHE:
        _CACHE[kk] = spec.sigma_dnl * prng.normal(
            prng.PRNGKey(spec.mismatch_seed + 1), (spec.codes,))
    table = _CACHE[kk].to(v.device)
    idx = torch.clamp(torch.floor(v).to(torch.int64), 0, spec.codes - 1)
    return v + table[idx]


def validate_adc_spec(spec: ADCSpec) -> None:
    if spec.sigma_cmp < 0.0 or spec.p_glitch < 0.0 or spec.glitch_mag < 0.0:
        raise ValueError(f"ADCSpec has negative noise parameters: {spec}")
    if spec.sigma_cmp == 0.0 and spec.p_glitch > 0.0 and spec.glitch_mag > 0.0:
        raise ValueError(f"degenerate ADCSpec: sigma_cmp=0 with p_glitch="
                         f"{spec.p_glitch} > 0")


def sar_convert(v: torch.Tensor, key: prng.Key, spec: ADCSpec,
                cb: bool, fault=None) -> torch.Tensor:
    """Convert analog values ``v`` (ideal-LSB units) to int32 codes on
    ``v``'s device: one Threefry uniform per decision at counter (flat
    index, step), each decision fired with its analytic (vote-summed)
    probability.

    ``fault`` (``core.faults.FaultSpec``): under CB a brownout conversion
    (``faults.brownout_mask`` of this call's key) votes its fine decisions
    ``brownout_votes`` times; a stuck column (global column index: the
    last axis of ``v``) returns ``adc_stuck_code``."""
    validate_adc_spec(spec)
    dev = v.device
    w = dac_bit_weights(spec).to(dev)
    vshape = v.shape
    v = _dnl_shift(v.reshape(-1).to(torch.float32), spec)
    k0, k1 = prng.key_words(key)
    k0 ^= prng.DOMAIN_SAR
    idx = torch.arange(v.shape[0], dtype=torch.int64, device=dev)
    brown = None
    if fault is not None and fault.brownout_rate > 0.0 and cb:
        brown = brownout_mask(fault, k0, k1, idx)
    n_coarse = spec.adc_bits - spec.mv_bits
    code = torch.zeros(v.shape, dtype=torch.int32, device=dev)
    level = torch.zeros_like(v)
    for step in range(spec.adc_bits):
        fine = step >= n_coarse
        sigma = spec.sigma_cmp if fine else spec.coarse_frac * spec.sigma_cmp
        p_glitch = spec.p_glitch if fine else 0.0
        votes = (spec.mv_votes if cb else 1) if fine else 1
        b = spec.adc_bits - 1 - step
        trial = level + w[b]
        bits, _ = prng.threefry2x32(k0, k1, idx, step)
        u = prng.uniform_from_bits(bits)
        p1 = decision_prob(v - trial, sigma, p_glitch, spec.glitch_mag)
        p = majority_prob(p1, votes)
        if brown is not None and votes > 1:
            p = torch.where(brown, majority_prob(p1, fault.brownout_votes), p)
        bit = u < p
        code = code + bit.to(torch.int32) * (1 << b)
        level = torch.where(bit, trial, level)
    code = code.reshape(vshape)
    if fault is not None and fault.adc_stuck_rate > 0.0 and code.ndim >= 1:
        stuck = adc_stuck_cols(fault, vshape[-1], dev)
        code = torch.where(stuck, torch.tensor(fault.adc_stuck_code,
                                               dtype=torch.int32, device=dev),
                           code)
    return code


def linspace(start: float, stop: float, num: int,
             device="cpu") -> torch.Tensor:
    """f32 ``jnp.linspace(start, stop, num)``: ``start * (1 - step) + stop *
    step`` over ``step = i / (num - 1)``, ``stop`` appended."""
    lo = _f32(start).to(device)
    hi = _f32(stop).to(device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def conversion_noise_lsb(spec: ADCSpec, cb: bool, device="cpu") -> float:
    """Output-referred conversion noise std in LSB: Monte-Carlo std of
    repeated conversions of 256 mid-range levels (64 repeats each), run
    on ``device``; cached per spec and device type."""
    kk = ("noise", spec, cb, torch.device(device).type)
    if kk not in _CACHE:
        n_levels, n_rep = 256, 64
        v = linspace(8.0, spec.codes - 8.0, n_levels,
                     device=device)[None].repeat(n_rep, 1)
        codes = sar_convert(v, prng.PRNGKey(7), spec, cb).to(torch.float32)
        std = torch.sqrt(torch.mean(
            torch.abs(codes - codes.mean(dim=0, keepdim=True)) ** 2, dim=0))
        _CACHE[kk] = float(torch.mean(std))
    return _CACHE[kk]


def adc_total_error_var_lsb2(spec: ADCSpec, cb: bool) -> float:
    """Variance (LSB^2) of the total per-conversion error: quantization,
    noise, INL and DNL."""
    q = 1.0 / 12.0
    n = conversion_noise_lsb(spec, cb) ** 2
    inl = float(np.mean(inl_curve(spec) ** 2))
    return q + n + inl + spec.sigma_dnl ** 2


def adc_noise_error_var_lsb2(spec: ADCSpec, cb: bool) -> float:
    """Variance (LSB^2) of the noise-only error: quantization and conversion
    noise, the static INL and DNL excluded (what CSNR counts)."""
    return 1.0 / 12.0 + conversion_noise_lsb(spec, cb) ** 2
