"""Online background calibration and canary watchdog for the drifting macro.

Twin of ``src/repro/core/calibrate.py``. The temporal drift of
``core/drift.py`` is per-column affine, ``y = gain_c * y_true + sigma *
offset_c``, so probes recover it: ``M`` known rows go through the analog
path on a synthetic probe plane, each column is regressed on the exact
digital product, and the fitted ``(gain, offset)`` become the trims that
``apply_drift`` inverts. Trims are indexed by the global column, so one
pair serves every layer; offsets ride in z-units of the analytic sigma.

``DriftController.tick`` runs at most one probe launch per serving step:
a full calibration streams ``probe_chunk`` rows a tick and installs new
trims on its last chunk; between calibrations a canary row, trim
corrected, is held against its golden digital output (per-column and
common-mode tests); a trip recalibrates (boosted after a bad fit), and
``max_recals`` consecutive bad fits escalate to the engine. The probes
draw under their own key chain off ``CalibPolicy.seed``, never the
engine's, and read the raw drift (no trims); the canary reads the trimmed
one.

The probe plane is ``prng.randint`` (exact), the probe rows
``prng.normal`` (within the ulps of C4); the probe runs
``ops.cim_matmul_deployed`` (the CIM kernel on the card) or the
behavioural ``cim_dense``. The trims live in two device tensors that a
new calibration overwrites in place, so a CUDA graph that reads them
replays with the current trims.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import CIMSpec, cim_dense, output_noise_std_int
from repro_torch.core.drift import DriftSpec


@dataclasses.dataclass(frozen=True)
class CalibPolicy:
    """Calibration/watchdog schedule and thresholds."""

    seed: int = 0
    probe_rows: int = 64      # rows per full calibration (whole chunks)
    probe_chunk: int = 16     # rows a tick
    probe_k: int = 256        # contraction dim of the probe plane
    every_steps: int = 256    # full-calibration cadence (first at step 0)
    canary_every: int = 8     # canary cadence (0 disables)
    canary_sigmas: float = 6.0  # trip threshold, in noise sigmas
    quality_max: float = 4.0  # residual_var/sigma^2 above this = bad fit
    max_recals: int = 2       # consecutive bad fits before escalating
    boost: int = 4            # probe-row multiplier of boosted recals

    def __post_init__(self):
        if self.probe_rows <= 0 or self.probe_chunk <= 0 or self.probe_k <= 0:
            raise ValueError("probe dimensions must be positive")
        if self.every_steps <= 0:
            raise ValueError("every_steps must be >= 1")

    def chunks_for(self, boost: bool) -> int:
        rows = self.probe_rows * (self.boost if boost else 1)
        return -(-rows // self.probe_chunk)


def detection_bound(policy: CalibPolicy) -> int:
    """Worst-case steps from an abrupt drift event to a watchdog trip."""
    return policy.canary_every + policy.chunks_for(True) + 1


def max_plane_width(params) -> int:
    """Widest deployed plane ``wq<bits>`` (K, N) or (L, K, N) of a params
    tree: the macro columns the trims must cover."""
    widest = 0

    def walk(node):
        nonlocal widest
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif (name.startswith("wq") and hasattr(leaf, "shape")
                  and len(leaf.shape) >= 2):
                widest = max(widest, int(leaf.shape[-1]))

    walk(params)
    return widest


def estimate_trims(y: torch.Tensor, d: torch.Tensor, sigma: float,
                   gain_floor: float = 0.05
                   ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Per-column least squares of analog probes ``y`` (M, N) on the exact
    digital ``d`` (M, N): ``y ~ gain * d + sigma * off_z``. Returns (gain,
    off_z, quality), quality the mean residual variance over sigma^2."""
    yf = y.to(torch.float32)
    df = d.to(torch.float32)
    dm = df.mean(dim=0)
    ym = yf.mean(dim=0)
    dc = df - dm
    var = torch.sum(dc * dc, dim=0)
    cov = torch.sum(dc * (yf - ym), dim=0)
    gain = cov / torch.clamp_min(var, 1e-12)
    gain = torch.clamp_min(gain, gain_floor)
    s = max(float(sigma), 1e-12)
    off_z = (ym - gain * dm) / s
    resid = yf - gain * df - (s * off_z)
    quality = float(torch.mean(resid * resid) / (s * s))
    return gain, off_z, quality


class DriftController:
    """Host-side calibration scheduler, canary watchdog and escalation.

    ``tick(step)`` runs at most one probe launch and returns event dicts
    (kind "calibrate" | "watchdog_trip" | "escalate"). ``trim_gain`` /
    ``trim_off`` are (n_cols,) f32 tensors on ``device``, written in
    place."""

    def __init__(self, spec: CIMSpec, drift: DriftSpec, policy: CalibPolicy,
                 n_cols: int, use_kernel: bool = True, device="cpu"):
        if n_cols <= 0:
            raise ValueError("n_cols must be positive (no deployed planes?)")
        dev = torch.device(device)
        self.device = dev
        self.policy = policy
        self.n_cols = n_cols
        # the probes measure the temporal drift only: the static faults
        # live on the real planes (the guard's domain)
        self.spec = dataclasses.replace(spec, fault=None, drift=drift)
        self._use_kernel = use_kernel

        p = policy
        kx, kw, _ = prng.split(prng.PRNGKey(p.seed), 3)
        qw = quant.qmax(self.spec.w_bits)
        k = p.probe_k
        self._wq = prng.randint(kw, (k, n_cols), -qw, qw + 1,
                                device=dev).to(torch.int8)
        self._ws = torch.tensor(1.0 / qw, dtype=torch.float32, device=dev)
        rows_max = p.probe_chunk * p.chunks_for(True)
        x = prng.normal(kx, (rows_max, k), device=dev)
        self._xs = quant.abs_max_scale(x, self.spec.in_bits)
        self._x = x
        xq = quant.quantize(x, self._xs, self.spec.in_bits)
        unit = self._xs * self._ws
        self._digital = (torch.matmul(xq.to(torch.float64),
                                      self._wq.to(torch.float64))
                         .to(torch.float32) * unit).cpu().numpy()
        # the reference's float32 product of sigma and the unit
        self.sigma_deq = float(np.float32(output_noise_std_int(self.spec, k))
                               * np.float32(float(unit)))
        self._xc = x[:1]
        self._golden = self._digital[:1]

        self.trim_gain = torch.ones((n_cols,), dtype=torch.float32,
                                    device=dev)
        self.trim_off = torch.zeros((n_cols,), dtype=torch.float32,
                                    device=dev)
        self.calibrations = 0
        self.watchdog_trips = 0
        self.last_quality: Optional[float] = None
        self.escalated = False
        self._calibrating = False
        self._boosted = False
        self._chunk_i = 0
        self._chunks: List[np.ndarray] = []
        self._last_cal_end: Optional[int] = None
        self._bad_fits = 0
        self._call = 0

    def _probe(self, xrows: torch.Tensor, key: prng.Key, dstate):
        if self._use_kernel:
            from repro_torch.kernels import ops as kops
            return kops.cim_matmul_deployed(
                xrows, self._wq, self._ws, self.spec, key, x_scale=self._xs,
                dstate=dstate)
        return cim_dense(xrows, None, self.spec, key, mode="sim",
                         x_scale=self._xs, w_scale=self._ws, wq=self._wq,
                         dstate=dstate)

    def _key(self) -> prng.Key:
        """The probes' own key chain, never the engine's."""
        self._call += 1
        return prng.fold_in(prng.PRNGKey(self.policy.seed ^ 0x0CA11B),
                            self._call)

    def _raw_state(self, step):
        """Drift state without trims: probes measure the raw drift."""
        return (int(step), None, None)

    def trimmed_state(self, step):
        return (int(step), self.trim_gain, self.trim_off)

    def start_calibration(self, boost: bool = False) -> None:
        self._calibrating = True
        self._boosted = boost
        self._chunk_i = 0
        self._chunks = []

    def tick(self, step: int) -> List[Dict[str, Any]]:
        """One serving step: at most one probe chunk or one canary."""
        events: List[Dict[str, Any]] = []
        p = self.policy
        if self.escalated:
            return events
        if self._calibrating:
            rows = p.probe_chunk
            off = self._chunk_i * rows
            y = self._probe(self._x[off:off + rows], self._key(),
                            self._raw_state(step))
            self._chunks.append(y.cpu().numpy())
            self._chunk_i += 1
            if self._chunk_i >= p.chunks_for(self._boosted):
                self._finish_calibration(step, events)
        elif (self._last_cal_end is None
              or step - self._last_cal_end >= p.every_steps):
            self.start_calibration()
        elif p.canary_every > 0 and step % p.canary_every == 0:
            tripped, dev = self._canary(step)
            if tripped:
                self.watchdog_trips += 1
                events.append({"kind": "watchdog_trip", "step": step,
                               "deviation_sigmas": dev})
                self.start_calibration(boost=self._bad_fits > 0)
        return events

    def _finish_calibration(self, step: int, events: list) -> None:
        p = self.policy
        y = np.concatenate(self._chunks, axis=0)
        d = self._digital[: y.shape[0]]
        gain, off_z, quality = estimate_trims(torch.from_numpy(y),
                                              torch.from_numpy(d),
                                              self.sigma_deq)
        self.trim_gain.copy_(gain)
        self.trim_off.copy_(off_z)
        self.calibrations += 1
        self.last_quality = quality
        self._calibrating = False
        self._last_cal_end = step
        ok = quality <= p.quality_max
        events.append({"kind": "calibrate", "step": step,
                       "quality": quality, "rows": int(y.shape[0]),
                       "boosted": self._boosted, "ok": bool(ok)})
        if ok:
            self._bad_fits = 0
            return
        self._bad_fits += 1
        if self._bad_fits > p.max_recals:
            self.escalated = True
            events.append({
                "kind": "escalate", "step": step,
                "detail": (f"{self._bad_fits} consecutive calibrations "
                           f"with quality > {p.quality_max:g}")})
        else:
            self.start_calibration(boost=True)

    def _canary(self, step: int) -> Tuple[bool, float]:
        """Trim-corrected canary read against its golden digital output."""
        p = self.policy
        y = self._probe(self._xc, self._key(),
                        self.trimmed_state(step)).cpu().numpy()
        r = y[0] - self._golden[0]
        s = max(self.sigma_deq, 1e-12)
        col_dev = float(np.max(np.abs(r)) / s)
        cm_dev = float(abs(r.mean()) / (s / math.sqrt(r.shape[0])))
        dev = max(col_dev, cm_dev)
        return dev > p.canary_sigmas, dev
