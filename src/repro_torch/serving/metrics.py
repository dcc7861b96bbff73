"""Structured per-request serving records and tail-latency summaries.

Twin of ``src/repro/serving/metrics.py`` (standard library only, copied,
not imported). Every request that reaches the front-end ends with exactly
one ``RequestRecord`` whose ``outcome`` is one of the engine's terminal
outcomes (``engine.OUTCOMES``: completed, failed, cancelled,
deadline_expired, shed). A record carries the ladder level and vote count
a request was admitted at beside its queue wait and TTFT; ladder
transitions (``MetricsLog.transitions``) keep the queue depth that
triggered them, and the drift controller's events
(``MetricsLog.calibrations``) the engine step they happened at.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input.

    Nearest-rank (not interpolated) so a p99 over a handful of samples is
    an actual observed latency, never an extrapolation past the max.
    """
    if not xs:
        return None
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    rank = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[rank]


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle, closed exactly once."""

    rid: str
    outcome: str = "pending"          # terminal: engine.OUTCOMES
    reason: Optional[str] = None      # shed/cancel/failure detail
    submitted_s: float = 0.0          # clock at front-end submit
    admitted_s: Optional[float] = None   # clock at slot admission
    finished_s: Optional[float] = None   # clock at terminal outcome
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None    # submit -> first streamed token
    tps: Optional[float] = None       # decode tokens/s (admit -> finish)
    tokens_out: int = 0
    degrade_level: int = 0            # ladder level at admission
    votes_used: Optional[int] = None  # majority-vote count at that level
    retries: int = 0                  # failure-retry attempts consumed
    guard_trips: Optional[int] = None  # ABFT per-request (L,) trip total
    guard_hard: Optional[int] = None   # ... hard-fault (digital-rung) total
    replica: Optional[str] = None      # replica that finished the request
    migrations: int = 0                # health-failover re-dispatches (router)

    def close(self, outcome: str, now: float,
              reason: Optional[str] = None) -> "RequestRecord":
        self.outcome = outcome
        self.finished_s = now
        if reason is not None:
            self.reason = reason
        if self.admitted_s is not None and self.tokens_out > 1:
            dt = now - self.admitted_s
            if dt > 0:
                self.tps = (self.tokens_out - 1) / dt
        return self


@dataclasses.dataclass
class LadderTransition:
    t_s: float
    level_from: int
    level_to: int
    queue_depth: int


@dataclasses.dataclass
class CalibrationEvent:
    """One background-calibration or watchdog event."""

    t_s: float
    step: int                         # engine drift_step at the event
    kind: str                         # calibrate | watchdog | escalate
    quality: Optional[float] = None   # residual_var/sigma^2 (calibrate)
    detail: Optional[Dict[str, object]] = None


class MetricsLog:
    """Append-only request records + ladder transitions + summary()."""

    def __init__(self) -> None:
        self.records: List[RequestRecord] = []
        self.transitions: List[LadderTransition] = []
        self.calibrations: List[CalibrationEvent] = []

    def open(self, rid: str, now: float) -> RequestRecord:
        rec = RequestRecord(rid=rid, submitted_s=now)
        self.records.append(rec)
        return rec

    def note_transition(self, now: float, frm: int, to: int,
                        depth: int) -> None:
        self.transitions.append(LadderTransition(now, frm, to, depth))

    def note_calibration(self, now: float, event: Dict[str, object]) -> None:
        """Fold one engine drift event (``Engine.take_drift_events``) in."""
        detail = {k: v for k, v in event.items()
                  if k not in ("kind", "step", "quality")}
        self.calibrations.append(CalibrationEvent(
            t_s=now, step=int(event.get("step", -1)),
            kind=str(event.get("kind", "?")),
            quality=event.get("quality"),
            detail=detail or None))

    def summary(self) -> Dict[str, object]:
        recs = self.records
        by_outcome: Dict[str, int] = {}
        for r in recs:
            by_outcome[r.outcome] = by_outcome.get(r.outcome, 0) + 1
        waits = [r.queue_wait_s for r in recs if r.queue_wait_s is not None]
        ttfts = [r.ttft_s for r in recs if r.ttft_s is not None]
        tpss = [r.tps for r in recs if r.tps is not None]
        return {
            "n_requests": len(recs),
            "outcomes": by_outcome,
            "open_requests": sum(r.outcome == "pending" for r in recs),
            "queue_wait_p50_s": percentile(waits, 50),
            "queue_wait_p99_s": percentile(waits, 99),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p99_s": percentile(ttfts, 99),
            "tps_mean": (sum(tpss) / len(tpss)) if tpss else None,
            "degraded_admissions": sum(r.degrade_level > 0 for r in recs
                                       if r.admitted_s is not None),
            "retries_total": sum(r.retries for r in recs),
            "ladder_transitions": len(self.transitions),
            "shed_fraction": (by_outcome.get("shed", 0) / len(recs)
                              if recs else 0.0),
            "calibrations": sum(c.kind == "calibrate"
                                for c in self.calibrations),
            "watchdog_trips": sum(c.kind == "watchdog_trip"
                                  for c in self.calibrations),
            "drift_escalations": sum(c.kind == "escalate"
                                     for c in self.calibrations),
            "guard_trips_total": sum(r.guard_trips or 0 for r in recs),
            "guard_hard_total": sum(r.guard_hard or 0 for r in recs),
        }
