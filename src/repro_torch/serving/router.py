"""Replica pool and health-aware request router, on the port's engine.

Twin of ``src/repro/serving/router.py``: N ``Engine`` replicas, each with
its own slot cache, deployed planes, CUDA graphs and PRNG chain, behind
one object that speaks the engine's session API (``submit / cancel / step
/ drain_pending / status_of / free_slots`` ...), so the front-end fronts a
pool unchanged: ``Frontend(ReplicaRouter([...]), ...)``.

Routing. Admissions go to the accepting replica with the most free slots
(ties round-robin). Every replica carries a health score in [0, 1],
updated each tick from its robustness telemetry: guard hard trips,
watchdog trips and calibrations, drift escalation, and per-request
failures. A replica whose score falls below ``drain_below`` is drained:
it takes no admissions and its in-flight requests move to healthy
replicas. Scores recover ``recover_rate`` a tick, and a drained replica
takes admissions again above ``recover_above``.

Failover. A request's sampling keys derive from ``fold_in(seed-derived
base, crc32(rid))`` alone and off-mode streams are batch-invariant, so
replicas built with one engine seed replay any rid's stream bit for bit.
Migration resubmits a clone of the request (same rid) on another replica,
lets it regenerate from the start, and appends only the tokens past the
length already delivered: a migrated greedy request continues token for
token with no re-emitted prefix, whether the old replica died mid-decode
or mid-chunked-prefill. A replica whose ``step()``/``drain_pending()``
raises (device loss, ``Engine.kill()``) is marked dead at once; one whose
``iter_count`` stalls ``wedge_patience`` ticks while it has work is
wedged (``Engine.wedge()``) and is marked dead too.

Fault injection rides ``core.faults.ReplicaFaultSpec``: the router
applies kill and wedge at its own step counter, and ``build_pool`` builds
a storm victim with the spec's ``FaultSpec`` on every slot.

Without ``build_pool(devices=)`` every replica of a pool shares one card
and its current stream, each replaying its own CUDA graphs;
``devices=`` places replica i on ``devices[i % len(devices)]``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.faults import ReplicaFaultSpec
from repro_torch.serving.engine import (Engine, OUTCOMES, Request,
                                        RequestError, _validate_requests)


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Health-score dynamics (host-side, all O(replicas) per tick).

    The score starts at 1.0, recovers ``recover_rate`` per tick, and is
    charged per *new* telemetry event since the last tick. ``drain_below``
    / ``recover_above`` give the drain decision hysteresis. A dead or
    wedged replica scores 0 permanently (dead) or until unwedged.
    """

    drain_below: float = 0.5
    recover_above: float = 0.9
    recover_rate: float = 0.05
    w_hard: float = 0.08       # per ABFT hard trip (digital-rung recompute)
    w_watchdog: float = 0.3    # per canary-watchdog trip
    w_calib: float = 0.02      # per background recalibration (mild: routine)
    w_fail: float = 0.4        # per failed request attributed to the replica
    escalated_score: float = 0.25  # cap while drift-escalated (pinned digital)
    wedge_patience: int = 6    # no-progress ticks (with work) -> wedged
    max_migrations: int = 3    # per-request re-dispatch budget


class _Track:
    """Router-side state of one logical request."""

    __slots__ = ("req", "replica", "ereq", "status", "error", "migrations",
                 "guard_report")

    def __init__(self, req: Request):
        self.req = req
        self.replica: Optional[int] = None   # current replica index
        self.ereq: Optional[Request] = None  # clone submitted to it
        self.status = "running"
        self.error: Optional[RequestError] = None
        self.migrations = 0
        self.guard_report: Optional[Dict[str, Any]] = None

    @property
    def terminal(self) -> bool:
        return self.status in OUTCOMES


class _ReplicaState:
    __slots__ = ("score", "state", "stall_ticks", "last_iter",
                 "hard", "watchdog", "calib")

    def __init__(self):
        self.score = 1.0
        self.state = "healthy"       # healthy | draining | dead
        self.stall_ticks = 0
        self.last_iter = 0
        self.hard = 0                # telemetry snapshots (deltas charged)
        self.watchdog = 0
        self.calib = 0


class ReplicaRouter:
    """N engine replicas behind the single-engine session API."""

    def __init__(self, engines: List[Engine],
                 health: Optional[HealthPolicy] = None,
                 replica_fault: Optional[ReplicaFaultSpec] = None,
                 timing: bool = False):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.engines = list(engines)
        for i, e in enumerate(self.engines):
            if e.replica is None:
                e.replica = f"r{i}"
        self.health = health or HealthPolicy()
        self.fault = replica_fault
        self._victim = (replica_fault.victim_of(len(self.engines))
                        if replica_fault is not None else None)
        # timing=True records per-replica busy seconds (step + drain, the
        # step synchronized with the replica's card) and the router's own
        # host seconds
        self.timing = timing
        self.busy_s = [0.0] * len(self.engines)
        self.host_s = 0.0
        self.step_count = 0
        self.events: List[Dict[str, Any]] = []
        self._rr = 0                     # round-robin tie-break cursor
        self.begin()

    # ----------------------------------------------------------- lifecycle
    def begin(self) -> None:
        self._tracks: List[_Track] = []
        self._track_of: Dict[int, _Track] = {}
        self._rstate = [_ReplicaState() for _ in self.engines]
        for st, e in zip(self._rstate, self.engines):
            st.last_iter = e.iter_count
            st.hard = int(e.guard_hard_counts.sum())
            st.watchdog = e.watchdog_trips
            st.calib = e.calibrations
            if e.dead is not None:
                st.state, st.score = "dead", 0.0
            elif e.has_work():
                raise RuntimeError(f"replica {e.replica} has live work; "
                                   "drain it before begin()")
            else:
                e.begin()

    # ------------------------------------------------------------- metrics
    @property
    def cfg(self):
        return self.engines[0].cfg

    @property
    def ladder(self):
        return self.engines[0].ladder

    @property
    def drift(self):
        return self.engines[0].drift

    @property
    def max_len(self):
        return self.engines[0].max_len

    # launch/serve.py's reporting surface: replicas share cfg and params
    # (planes are deployed per replica with one structure), so engines[0]
    # gives the plane summary; guard and drift telemetry sum over the pool
    @property
    def deployed(self):
        return self.engines[0].deployed

    @property
    def params(self):
        return self.engines[0].params

    @property
    def guard(self):
        return self.engines[0].guard

    @property
    def guard_trip_counts(self):
        return sum(e.guard_trip_counts for e in self.engines)

    @property
    def guard_hard_counts(self):
        return sum(e.guard_hard_counts for e in self.engines)

    @property
    def drift_step(self):
        return max(e.drift_step for e in self.engines)

    @property
    def drift_degraded(self):
        return any(e.drift_degraded for e in self.engines)

    def _accepting(self, i: int) -> bool:
        st = self._rstate[i]
        return st.state == "healthy" and self.engines[i].dead is None \
            and not self.engines[i].wedged

    @property
    def free_slots(self) -> int:
        return sum(max(0, self.engines[i].free_slots)
                   for i in range(len(self.engines)) if self._accepting(i))

    def has_work(self) -> bool:
        return any(not t.terminal for t in self._tracks)

    def replica_states(self) -> List[Dict[str, Any]]:
        return [{"replica": e.replica, "state": st.state,
                 "score": round(st.score, 3)}
                for e, st in zip(self.engines, self._rstate)]

    # ------------------------------------------------------------ requests
    def _clone(self, r: Request) -> Request:
        return Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                       temperature=r.temperature, rid=r.rid,
                       degrade_level=r.degrade_level, deadline=r.deadline)

    def _pick_replica(self, exclude: Optional[int] = None) -> Optional[int]:
        n = len(self.engines)
        best, best_key = None, None
        for off in range(n):
            i = (self._rr + off) % n
            if i == exclude or not self._accepting(i):
                continue
            key = self.engines[i].free_slots
            if best_key is None or key > best_key:
                best, best_key = i, key
        if best is not None:
            self._rr = (best + 1) % n
        return best

    def _dispatch(self, t: _Track, exclude: Optional[int] = None) -> bool:
        i = self._pick_replica(exclude=exclude)
        if i is None:
            # total outage: keep the track pending; re-dispatched as soon
            # as a replica recovers (deadlines still expire it meanwhile)
            t.replica, t.ereq = None, None
            return False
        t.replica = i
        t.ereq = self._clone(t.req)
        self.engines[i].submit(t.ereq)
        return True

    def submit(self, r: Request) -> int:
        # validate before tracking: a rejected request must not linger as
        # pool work (the per-engine submit would validate the clone anyway,
        # but only after the track exists)
        _validate_requests([r], self.max_len)
        t = _Track(r)
        r.out_tokens = []
        self._tracks.append(t)
        self._track_of[id(r)] = t
        self._dispatch(t)
        return len(self._tracks) - 1

    def cancel(self, r: Request, outcome: str = "cancelled") -> bool:
        if outcome not in OUTCOMES[1:]:
            raise ValueError(f"cancel outcome must be one of {OUTCOMES[1:]}")
        t = self._track_of.get(id(r))
        if t is None or t.terminal:
            return False
        self._retire_clone(t)
        t.status = outcome
        return True

    def _retire_clone(self, t: _Track) -> None:
        # keeps t.replica for attribution (replica_of after a failure);
        # _dispatch overwrites it on the next assignment
        if t.ereq is not None and t.replica is not None:
            e = self.engines[t.replica]
            if e.dead is None:
                self._capture_report(t)
                e.cancel(t.ereq, outcome="cancelled")
        t.ereq = None

    def _capture_report(self, t: _Track) -> None:
        if t.ereq is None or t.replica is None:
            return
        rep = self.engines[t.replica].guard_report_of(t.ereq)
        if rep is not None:
            t.guard_report = rep

    # ------------------------------------------------------------- queries
    def status_of(self, r: Request) -> Optional[str]:
        t = self._track_of.get(id(r))
        if t is None:
            return None
        if t.terminal:
            return t.status
        if t.ereq is None:
            return "queued"
        st = self.engines[t.replica].status_of(t.ereq)
        return "running" if st in (None, "completed", "failed") else st

    def error_of(self, r: Request) -> Optional[RequestError]:
        t = self._track_of.get(id(r))
        return None if t is None else t.error

    def result_of(self, r: Request):
        t = self._track_of.get(id(r))
        if t is None or not t.terminal:
            return None
        return t.error if t.status == "failed" else t.req.out_tokens

    def guard_report_of(self, r: Request) -> Optional[Dict[str, Any]]:
        t = self._track_of.get(id(r))
        if t is None:
            return None
        self._capture_report(t)
        return t.guard_report

    def replica_of(self, r: Request) -> Optional[str]:
        t = self._track_of.get(id(r))
        if t is None or t.replica is None:
            return None
        return self.engines[t.replica].replica

    def migrations_of(self, r: Request) -> int:
        t = self._track_of.get(id(r))
        return 0 if t is None else t.migrations

    def take_drift_events(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for e in self.engines:
            if e.dead is not None:
                continue
            for ev in e.take_drift_events():
                ev = dict(ev)
                ev["replica"] = e.replica
                out.append(ev)
        return out

    # ------------------------------------------------------------ stepping
    def _inject_fault(self) -> None:
        f = self.fault
        if f is None or f.mode == "storm" or self._victim is None:
            return
        if self.step_count != f.at_step:
            return
        e = self.engines[self._victim]
        if f.mode == "kill":
            e.kill("injected device loss")
        else:
            e.wedge()
        self.events.append({"step": self.step_count, "kind": f.mode,
                            "replica": e.replica})

    def _mark_dead(self, i: int, reason: str) -> None:
        st = self._rstate[i]
        if st.state == "dead":
            return
        st.state, st.score = "dead", 0.0
        if self.engines[i].dead is None:
            self.engines[i].kill(reason)
        self.events.append({"step": self.step_count, "kind": "dead",
                            "replica": self.engines[i].replica,
                            "reason": reason})

    def step(self, now: Optional[float] = None) -> bool:
        """One pool iteration: inject scheduled faults, advance every live
        replica (a raising replica is marked dead; its requests migrate in
        the next ``drain_pending``), expire deadlines of unassigned tracks."""
        t_tick = time.perf_counter()
        busy_tick = 0.0
        self.step_count += 1
        self._inject_fault()
        did = False
        for i, e in enumerate(self.engines):
            if self._rstate[i].state == "dead":
                continue
            t0 = time.perf_counter()
            try:
                did = e.step(now=now) or did
                if self.timing and e.device.type == "cuda":
                    torch.cuda.synchronize(e.device)
            except Exception as ex:   # device loss / wedged-launch raise
                self._mark_dead(i, f"step raised: {ex!r}")
                continue
            if self.timing:
                dt = time.perf_counter() - t0
                self.busy_s[i] += dt
                busy_tick += dt
        if now is not None:
            for t in self._tracks:
                if not t.terminal and t.ereq is None \
                        and t.req.deadline is not None \
                        and now >= t.req.deadline:
                    t.status = "deadline_expired"
        if self.timing:
            self.host_s += max(0.0,
                               time.perf_counter() - t_tick - busy_tick)
        return did or self.has_work()

    def drain_pending(self) -> None:
        """Drain device tokens from every live replica, pump them into the
        router-level requests (append-only past the delivered length: the
        no-re-emitted-prefix contract), resolve statuses, update health
        scores, and migrate in-flight requests off dead/wedged/drained
        replicas."""
        t_tick = time.perf_counter()
        busy_tick = 0.0
        for i, e in enumerate(self.engines):
            if self._rstate[i].state == "dead":
                continue
            t0 = time.perf_counter()
            try:
                e.drain_pending()
            except Exception as ex:
                self._mark_dead(i, f"drain raised: {ex!r}")
                continue
            if self.timing:
                dt = time.perf_counter() - t0
                self.busy_s[i] += dt
                busy_tick += dt
        self._detect_wedges()
        self._update_health()
        self._sync_tracks()
        if self.timing:
            self.host_s += max(0.0,
                               time.perf_counter() - t_tick - busy_tick)

    # ------------------------------------------------------- health + sync
    def _detect_wedges(self) -> None:
        hp = self.health
        for i, e in enumerate(self.engines):
            st = self._rstate[i]
            if st.state == "dead":
                continue
            busy = any(t.replica == i and not t.terminal and t.ereq is not None
                       for t in self._tracks)
            if busy and e.iter_count == st.last_iter:
                st.stall_ticks += 1
                if st.stall_ticks >= hp.wedge_patience:
                    self._mark_dead(i, f"wedged: no progress in "
                                       f"{st.stall_ticks} ticks")
            else:
                st.stall_ticks = 0
            st.last_iter = e.iter_count

    def _update_health(self) -> None:
        hp = self.health
        for i, e in enumerate(self.engines):
            st = self._rstate[i]
            if st.state == "dead":
                continue
            hard = int(e.guard_hard_counts.sum())
            wd = e.watchdog_trips
            cal = e.calibrations
            st.score = min(1.0, st.score + hp.recover_rate)
            st.score -= (hp.w_hard * (hard - st.hard)
                         + hp.w_watchdog * (wd - st.watchdog)
                         + hp.w_calib * (cal - st.calib))
            st.hard, st.watchdog, st.calib = hard, wd, cal
            if e.drift_degraded or getattr(e, "_drift_pin_all", False):
                st.score = min(st.score, hp.escalated_score)
            st.score = max(0.0, st.score)
            if st.state == "healthy" and st.score < hp.drain_below:
                st.state = "draining"
                self.events.append({"step": self.step_count, "kind": "drain",
                                    "replica": e.replica,
                                    "score": round(st.score, 3)})
            elif st.state == "draining" and st.score >= hp.recover_above:
                st.state = "healthy"
                self.events.append({"step": self.step_count, "kind": "recover",
                                    "replica": e.replica,
                                    "score": round(st.score, 3)})

    def _charge_failure(self, i: Optional[int]) -> None:
        if i is None:
            return
        st = self._rstate[i]
        if st.state != "dead":
            st.score = max(0.0, st.score - self.health.w_fail)

    def _migrate(self, t: _Track, reason: str) -> None:
        old = t.replica
        self._retire_clone(t)
        if t.migrations >= self.health.max_migrations:
            t.status = "failed"
            t.error = RequestError(
                reason=f"migration budget exhausted after {reason}",
                phase="route", retryable=False,
                replica=None if old is None else self.engines[old].replica)
            return
        t.migrations += 1
        self.events.append({
            "step": self.step_count, "kind": "migrate", "rid": t.req.rid,
            "from": None if old is None else self.engines[old].replica,
            "delivered": len(t.req.out_tokens), "reason": reason})
        self._dispatch(t, exclude=old)

    def _pump(self, t: _Track) -> None:
        if t.ereq is None:
            return
        toks = t.ereq.out_tokens
        have = len(t.req.out_tokens)
        if len(toks) > have:
            t.req.out_tokens.extend(toks[have:])

    def _sync_tracks(self) -> None:
        for t in self._tracks:
            if t.terminal:
                continue
            if t.replica is not None and t.ereq is not None:
                i = t.replica
                st = self._rstate[i]
                if st.state == "dead":
                    # replica lost under the request: undrained device
                    # tokens are gone; the clone's replay resupplies them
                    self._migrate(t, f"replica {self.engines[i].replica} died")
                    continue
                self._pump(t)
                est = self.engines[i].status_of(t.ereq)
                if est == "completed":
                    self._capture_report(t)
                    t.status = "completed"
                elif est == "failed":
                    err = self.engines[i].error_of(t.ereq)
                    self._charge_failure(i)
                    self._capture_report(t)
                    # any engine-side failure is charged to the replica and
                    # re-dispatched elsewhere (analog faults are replica-
                    # local by construction); a request that fails on
                    # max_migrations distinct replicas is genuinely bad and
                    # fails with the last replica-tagged error
                    if t.migrations < self.health.max_migrations:
                        self._migrate(t, f"failed on {self.engines[i].replica}"
                                         f": {err.reason if err else '?'}")
                    else:
                        t.status = "failed"
                        t.error = err or RequestError(
                            reason="failed", replica=self.engines[i].replica)
                elif est in ("cancelled", "deadline_expired"):
                    t.status = est
                elif st.state == "draining":
                    self._migrate(t, f"drained {self.engines[i].replica}")
            else:
                # pending (no healthy replica at dispatch time): retry now;
                # dead is permanent, so a total outage fails fast instead of
                # holding the request open forever
                if all(st.state == "dead" for st in self._rstate):
                    t.status = "failed"
                    t.error = RequestError(reason="no live replicas",
                                           phase="route", retryable=False)
                else:
                    self._dispatch(t)

    # ------------------------------------------------------------- batch
    def generate(self, requests: List[Request]) -> List[Any]:
        """Pool analogue of ``Engine.generate`` (same failure contract)."""
        self.begin()
        for r in requests:
            self.submit(r)
        steps = 0
        while self.has_work():
            self.step()
            self.drain_pending()
            steps += 1
            if steps > 100_000:
                raise RuntimeError("replica router ran away")
        out = []
        for r in requests:
            t = self._track_of[id(r)]
            out.append(t.error if t.status == "failed" else r.out_tokens)
        return out


def build_pool(cfg, params, n_replicas: int,
               replica_fault: Optional[ReplicaFaultSpec] = None,
               devices: Optional[List[Any]] = None,
               seed: int = 0,
               **engine_kwargs) -> List[Engine]:
    """Construct N identically-seeded replicas (labels ``r0..rN-1``).

    The shared ``seed`` is what makes migration deterministic: per-request
    sampling keys depend only on (seed, rid), so any replica replays any
    rid bit-for-bit in off mode. ``devices`` places replica i on
    ``devices[i % len]`` (the engine's ``device=``); without it every
    replica takes ``engine_kwargs``' device (by default the card). A
    ``ReplicaFaultSpec(mode="storm")`` victim is built with the spec's
    FaultSpec on every slot: its health decays through guard telemetry,
    not a router-injected event (pass ``guard=`` in engine_kwargs; the
    storm disturbance acts through the guarded dense path).
    """
    storm_victim = None
    if replica_fault is not None and replica_fault.mode == "storm":
        storm_victim = replica_fault.victim_of(n_replicas)
        if not engine_kwargs.get("guard"):
            raise ValueError("storm replica faults need guard=: the "
                             "disturbance acts through the guarded dense "
                             "path (core/guard.py)")
    engines = []
    for i in range(n_replicas):
        kw = dict(engine_kwargs)
        if i == storm_victim:
            kw["fault"] = replica_fault.storm_fault()
            kw["fault_slots"] = range(kw.get("max_slots", 4))
        if devices:
            kw["device"] = devices[i % len(devices)]
        engines.append(Engine(cfg, params, seed=seed, replica=f"r{i}",
                              **kw))
    return engines
