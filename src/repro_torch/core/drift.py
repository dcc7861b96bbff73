"""Temporal drift of the analog macro, a deterministic function of time.

Twin of ``src/repro/core/drift.py``. Per output column ``c`` at step
``t``: a random walk (a truncated Karhunen-Loeve expansion of a Brownian
motion, ``walk_terms`` N(0, 1) coefficients per column), a temperature
excursion (one global sinusoid of seeded phase times a per-column N(0, 1)
sensitivity) and supply steps (a global level that jumps to a fresh N(0,
1) draw every ``supply_every`` steps, zero in epoch 0). Each draw is
Threefry under ``(seed ^ DOMAIN_DRIFT, tag)`` at a global counter, so the
fields are the reference's bit for bit in their draws, and within the
ulps of ``sin`` in their values.

``step`` is a Python int or a 0-d integer tensor on the output's device:
the engine stages it in device memory every iteration, so a CUDA graph of
a forward replays with the current step rather than the captured one.
The per-column coefficients do not depend on the step and are drawn once
per (spec, width, device).

``apply_drift`` composes ``y * gain + sigma * offset_z`` and then the
inverse of the installed calibration trims ``(y - sigma * trim_off) /
trim_gain`` (``core/calibrate.py``). With no spec, an all-zero spec or no
state it returns ``y`` itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import prng

DOMAIN_DRIFT = 0x7A3C95E1

TAG_WALK_GAIN = 1
TAG_WALK_OFFSET = 2
TAG_TEMP_GAIN = 3
TAG_TEMP_OFFSET = 4
TAG_SUPPLY_GAIN = 5
TAG_SUPPLY_OFFSET = 6
TAG_TEMP_PHASE = 7


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Temporal drift model parameters (the reference's fields)."""

    seed: int = 0
    walk_gain_std: float = 0.0
    walk_offset_std: float = 0.0
    temp_gain_amp: float = 0.0
    temp_offset_amp: float = 0.0
    temp_period: int = 4096
    supply_gain_mag: float = 0.0
    supply_offset_mag: float = 0.0
    supply_every: int = 0
    horizon: int = 65536
    walk_terms: int = 12

    def __post_init__(self):
        if self.temp_period <= 0:
            raise ValueError("temp_period must be positive")
        if self.horizon <= 0 or self.walk_terms <= 0:
            raise ValueError("horizon and walk_terms must be positive")
        if self.supply_every < 0:
            raise ValueError("supply_every must be >= 0")

    def has_gain(self) -> bool:
        return (self.walk_gain_std > 0.0 or self.temp_gain_amp > 0.0
                or (self.supply_every > 0 and self.supply_gain_mag > 0.0))

    def has_offset(self) -> bool:
        return (self.walk_offset_std > 0.0 or self.temp_offset_amp > 0.0
                or (self.supply_every > 0 and self.supply_offset_mag > 0.0))

    def active(self) -> bool:
        """False iff every drift channel is zero."""
        return self.has_gain() or self.has_offset()


class DriftState(tuple):
    """``(step, trim_gain, trim_off)``: the step, and the (Nmax,) f32 trims
    (identity: ones and zeros) or both None when no calibration runs; a
    plain tuple of the three serves as well. This form also memoizes the
    fields of one width for one forward (``fields``), so the layers of a
    forward share them: the engine makes one per forward."""

    def __new__(cls, step, trim_gain=None, trim_off=None):
        self = super().__new__(cls, (step, trim_gain, trim_off))
        self.fields = {}
        return self


def _dkey(seed: int) -> int:
    return (seed & prng.M32) ^ DOMAIN_DRIFT


def _draw(seed: int, tag: int, c0, c1) -> torch.Tensor:
    """One N(0, 1) per (tag, c0, c1) counter under the drift domain key
    (Box-Muller on the two output words)."""
    b0, b1 = prng.threefry2x32(_dkey(seed), tag, c0, c1)
    return prng.gaussian_from_bits(b0, b1)


_COEFFS: dict = {}


def _coeffs(spec: DriftSpec, what: str, tag: int, n: int, device):
    """The step-free draws of a field, cached: the walk's ``walk_terms``
    (n,) coefficients, the (n,) temperature sensitivities or the
    temperature phase."""
    dev = torch.device(device)
    kk = (spec.seed, spec.walk_terms, what, tag, n, dev)
    if kk not in _COEFFS:
        if len(_COEFFS) >= 512:
            _COEFFS.clear()
        cols = torch.arange(n, dtype=torch.int64, device=dev)
        if what == "walk":
            _COEFFS[kk] = [_draw(spec.seed, tag, cols, j)
                           for j in range(spec.walk_terms)]
        elif what == "phase":
            b0, _ = prng.threefry2x32(_dkey(spec.seed), tag, 0, 0)
            u = prng.uniform_from_bits(torch.tensor(b0, dtype=torch.int64,
                                                    device=dev))
            _COEFFS[kk] = (2.0 * math.pi) * u
        else:
            _COEFFS[kk] = _draw(spec.seed, tag, cols, 0)
    return _COEFFS[kk]


def _time(step, device) -> torch.Tensor:
    """The step as an f32 0-d tensor on ``device``."""
    return torch.as_tensor(step, device=device).to(torch.float32)


def _kl_walk(spec: DriftSpec, tag: int, n: int, step,
             device="cpu") -> torch.Tensor:
    """Brownian surrogate B(t)/sqrt(horizon) per column; the terms summed
    in the reference's order."""
    t = _time(step, device)
    acc = torch.zeros((n,), dtype=torch.float32, device=device)
    horizon = float(spec.horizon)
    for j, z in enumerate(_coeffs(spec, "walk", tag, n, device)):
        w = (j + 0.5) * math.pi
        amp = math.sqrt(2.0) / w
        acc = acc + z * (amp * torch.sin((w / horizon) * t))
    return acc


def _temp_wave(spec: DriftSpec, step, device="cpu") -> torch.Tensor:
    """Global temperature sinusoid with a seeded phase, in [-1, 1]."""
    phase = _coeffs(spec, "phase", TAG_TEMP_PHASE, 0, device)
    t = _time(step, device)
    return torch.sin((2.0 * math.pi / float(spec.temp_period)) * t + phase)


def _supply_level(spec: DriftSpec, tag: int, step,
                  device="cpu") -> torch.Tensor:
    """Global piecewise-constant N(0, 1) level per supply epoch (0 in
    epoch 0)."""
    epoch = torch.div(torch.as_tensor(step, device=device).to(torch.int64),
                      spec.supply_every, rounding_mode="floor")
    z = _draw(spec.seed, tag, epoch & prng.M32, 0)
    return torch.where(epoch > 0, z, torch.zeros_like(z))


def drift_gain(spec: DriftSpec, n: int, step,
               device="cpu") -> Optional[torch.Tensor]:
    """(n,) multiplicative gain at ``step``, or None without a gain
    channel."""
    if not spec.has_gain():
        return None
    val = torch.zeros((n,), dtype=torch.float32, device=device)
    if spec.walk_gain_std > 0.0:
        val = val + spec.walk_gain_std * _kl_walk(spec, TAG_WALK_GAIN, n,
                                                  step, device)
    if spec.temp_gain_amp > 0.0:
        sens = _coeffs(spec, "temp", TAG_TEMP_GAIN, n, device)
        val = val + spec.temp_gain_amp * sens * _temp_wave(spec, step,
                                                           device)
    if spec.supply_every > 0 and spec.supply_gain_mag > 0.0:
        val = val + spec.supply_gain_mag * _supply_level(
            spec, TAG_SUPPLY_GAIN, step, device)
    return 1.0 + val


def drift_offset_z(spec: DriftSpec, n: int, step,
                   device="cpu") -> Optional[torch.Tensor]:
    """(n,) additive offset at ``step`` in z-units (multiples of the
    analytic readout sigma), or None without an offset channel."""
    if not spec.has_offset():
        return None
    val = torch.zeros((n,), dtype=torch.float32, device=device)
    if spec.walk_offset_std > 0.0:
        val = val + spec.walk_offset_std * _kl_walk(spec, TAG_WALK_OFFSET, n,
                                                    step, device)
    if spec.temp_offset_amp > 0.0:
        sens = _coeffs(spec, "temp", TAG_TEMP_OFFSET, n, device)
        val = val + spec.temp_offset_amp * sens * _temp_wave(spec, step,
                                                             device)
    if spec.supply_every > 0 and spec.supply_offset_mag > 0.0:
        val = val + spec.supply_offset_mag * _supply_level(
            spec, TAG_SUPPLY_OFFSET, step, device)
    return val


def apply_drift(y: torch.Tensor, spec: Optional[DriftSpec], sigma,
                dstate: Optional[DriftState]) -> torch.Tensor:
    """Drift and trim-correction epilogue on a (..., n) output block:
    ``y * gain + sigma * offset_z`` at ``dstate``'s step, then the inverse
    of the installed trims. ``sigma``: the analytic readout std in y's
    units. ``y`` itself when drift is off."""
    if spec is None or dstate is None or not spec.active():
        return y
    step, trim_gain, trim_off = dstate
    n = y.shape[-1]
    memo = getattr(dstate, "fields", None)
    kk = (spec, n, y.device)
    if memo is not None and kk in memo:
        g, o = memo[kk]
    else:
        g = drift_gain(spec, n, step, y.device)
        o = drift_offset_z(spec, n, step, y.device)
        if memo is not None:
            memo[kk] = (g, o)
    if g is not None:
        y = y * g
    if o is not None:
        y = y + sigma * o
    if trim_gain is not None:
        y = (y - sigma * trim_off[:n]) / trim_gain[:n]
    return y
