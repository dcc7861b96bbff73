"""Resilient asyncio front-end over the serving engine.

Twin of ``src/repro/serving/frontend.py``, driving the port's ``Engine``
(``serving/engine.py``), a synchronous slot scheduler with a per-request
lifecycle (``submit / cancel / step / status_of``). The front-end owns
what the engine does not:

* **Bounded admission**: a backlog deque with a hard ``queue_limit``;
  past it new work is *shed* at once with a structured reason (never
  dropped silently, never blocking the caller). High and low watermarks on
  the backlog depth drive the degradation ladder.

* **Deadlines and TTFT budgets**, on the front-end's injectable clock:
  expiry cancels queued, mid-prefill or mid-decode requests alike; the
  freed slot is wiped by its next occupant's first chunk, so cancelling
  costs no device work.

* **Client cancellation**: ``Ticket.cancel()`` between steps; the tokens
  already streamed stay delivered.

* **Deterministic retries**: a request that dies to a *retryable*
  ``RequestError`` is re-queued with exponential backoff, past the
  admission bound. The engine keys sampling off ``crc32(rid)``, so a retry
  replays the same token stream; the ticket's stream cursor survives the
  retry and consumers never see a prefix twice.

* **Load-adaptive vote degradation**: with an engine built with a
  ``sac.DegradeLadder``, a backlog at or above ``high_watermark`` climbs
  the ladder one rung per tick and new admissions run their CB majority
  votes at the rung's count (in sim mode, extra output noise:
  ``core.cim.vote_drop_extra_std_int``); below ``low_watermark`` it walks
  back down. Transitions are logged with the queue depth behind them.

* **Graceful drain**: ``stop()`` stops admission (late arrivals shed with
  reason "draining"); accepted work runs to completion within
  ``drain_deadline_s``, after which the survivors are cancelled.

Every request ends in exactly one terminal outcome of ``engine.OUTCOMES``.
The control loop is a synchronous ``tick(now)`` (one scheduler iteration
on an explicit clock) driven by the async ``run()``: tests drive ``tick``
with a fake clock, the serving CLI awaits ``run()``.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque

import numpy as np
from typing import Callable, Deque, List, Optional

from repro_torch.serving.engine import OUTCOMES, Engine, Request, \
    RequestError
from repro_torch.serving.metrics import MetricsLog, RequestRecord

_END = object()  # stream sentinel


class Ticket:
    """Front-end handle for one request: stream, outcome, record.

    ``tokens`` accumulates the delivered stream (stable across retries —
    the deterministic-retry contract means a retry's re-decoded prefix is
    recognised by cursor, not re-delivered). ``record`` is the structured
    per-request log entry; ``record.outcome`` is terminal once ``done``
    is set.
    """

    def __init__(self, rid: str, prompt: List[int], max_new: int,
                 temperature: float, deadline: Optional[float],
                 ttft_deadline: Optional[float], record: RequestRecord):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.deadline = deadline            # absolute, front-end clock
        self.ttft_deadline = ttft_deadline  # absolute, front-end clock
        self.record = record
        self.request: Optional[Request] = None  # current engine attempt
        self.level: Optional[int] = None        # ladder level at admission
        self.cursor = 0                         # engine tokens delivered
        self.tokens: List[int] = []
        self.error: Optional[RequestError] = None
        self.retry_at: Optional[float] = None   # backoff wake time
        self.done = asyncio.Event()
        self._stream: asyncio.Queue = asyncio.Queue()
        self._cancel_asked = False

    # ------------------------------------------------------------- client
    @property
    def outcome(self) -> str:
        return self.record.outcome

    def cancel(self) -> None:
        """Client-initiated cancellation; takes effect next tick."""
        self._cancel_asked = True

    async def wait(self) -> "Ticket":
        await self.done.wait()
        return self

    async def stream(self):
        """Async-iterate delivered tokens until the request is terminal."""
        while True:
            item = await self._stream.get()
            if item is _END:
                return
            yield item

    def result(self) -> List[int]:
        """Token list on success; raises on any non-completed outcome."""
        if not self.done.is_set():
            raise RuntimeError(f"request {self.rid} still in flight")
        if self.record.outcome != "completed":
            raise RuntimeError(
                f"request {self.rid} ended {self.record.outcome}"
                + (f": {self.error}" if self.error else
                   f": {self.record.reason}" if self.record.reason else ""))
        return self.tokens

    # ----------------------------------------------------------- internal
    def _push(self, toks: List[int]) -> None:
        self.tokens.extend(toks)
        self.record.tokens_out = len(self.tokens)
        for t in toks:
            self._stream.put_nowait(t)

    def _close(self, outcome: str, now: float,
               reason: Optional[str] = None) -> None:
        assert outcome in OUTCOMES
        self.record.close(outcome, now, reason)
        self._stream.put_nowait(_END)
        self.done.set()


class Frontend:
    """Bounded-admission asyncio front-end around one ``Engine``."""

    def __init__(self, engine: Engine, queue_limit: int = 16,
                 high_watermark: Optional[int] = None,
                 low_watermark: Optional[int] = None,
                 default_ttft_budget_s: Optional[float] = None,
                 max_retries: int = 1, retry_backoff_s: float = 0.05,
                 drain_deadline_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[MetricsLog] = None):
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        self.engine = engine
        self.queue_limit = queue_limit
        # watermarks default to the top half of the backlog bound; low must
        # sit strictly below high for the hysteresis band to exist.
        self.high_watermark = (high_watermark if high_watermark is not None
                               else max(1, queue_limit // 2))
        self.low_watermark = (low_watermark if low_watermark is not None
                              else max(0, self.high_watermark // 2))
        if self.low_watermark >= self.high_watermark:
            raise ValueError("low_watermark must be < high_watermark")
        self.default_ttft_budget_s = default_ttft_budget_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.drain_deadline_s = drain_deadline_s
        self.clock = clock
        self.metrics = metrics if metrics is not None else MetricsLog()
        self.ladder = engine.ladder
        self.level = 0                      # current ladder rung
        self._backlog: Deque[Ticket] = deque()
        self._retries: Deque[Ticket] = deque()  # exempt from queue_limit
        self._live: List[Ticket] = []           # engine-submitted, in flight
        self._stopping = False
        self._drain_by: Optional[float] = None
        self._wake = asyncio.Event()
        self._seq = 0
        try:
            spec = engine.cfg.cim
            self._full_votes = int(spec.adc.mv_votes) if spec.cb else 1
        except AttributeError:
            self._full_votes = 6

    # ------------------------------------------------------------- intake
    @property
    def depth(self) -> int:
        """Admission backlog depth — the watermark signal."""
        return len(self._backlog)

    def submit(self, prompt: List[int], max_new: int,
               temperature: float = 0.0, rid: Optional[str] = None,
               timeout_s: Optional[float] = None,
               ttft_budget_s: Optional[float] = None) -> Ticket:
        """Accept or shed one request; always returns a Ticket.

        A shed ticket is already terminal (``outcome == "shed"``) with a
        structured reason — the caller never blocks and never loses the
        request silently.
        """
        now = self.clock()
        if rid is None:
            rid = f"req-{self._seq}"
        self._seq += 1
        rec = self.metrics.open(rid, now)
        budget = (ttft_budget_s if ttft_budget_s is not None
                  else self.default_ttft_budget_s)
        t = Ticket(rid, list(prompt), max_new, temperature,
                   deadline=(now + timeout_s if timeout_s is not None
                             else None),
                   ttft_deadline=(now + budget if budget is not None
                                  else None),
                   record=rec)
        if self._stopping:
            t._close("shed", now, "draining: front-end is shutting down")
            return t
        if len(self._backlog) >= self.queue_limit:
            t._close("shed", now,
                     f"admission queue full ({len(self._backlog)}"
                     f"/{self.queue_limit})")
            return t
        self._backlog.append(t)
        self._wake.set()
        return t

    def stop(self) -> None:
        """Begin graceful drain: no new admissions; accepted work finishes
        within ``drain_deadline_s`` of this call, then gets cancelled."""
        if not self._stopping:
            self._stopping = True
            self._drain_by = self.clock() + self.drain_deadline_s
        self._wake.set()

    def pending(self) -> int:
        """Requests not yet terminal (backlog + retries + in flight)."""
        return len(self._backlog) + len(self._retries) + len(self._live)

    # --------------------------------------------------------- scheduler
    def tick(self, now: Optional[float] = None) -> bool:
        """One synchronous scheduler iteration; returns True if the engine
        did work. Drives: drain enforcement -> front-end expiry -> ladder
        step -> admission -> engine step -> stream/outcome pump -> retry
        re-queue."""
        pinned = now is not None
        if now is None:
            now = self.clock()
        self._enforce_drain(now)
        self._expire_and_cancel(now)
        self._step_ladder(now)
        self._admit(now)
        did = self.engine.step(now=now)
        self.engine.drain_pending()
        if getattr(self.engine, "drift", None) is not None:
            for ev in self.engine.take_drift_events():
                self.metrics.note_calibration(
                    now if pinned else self.clock(), ev)
        # re-read the clock for outcome/TTFT stamps unless the caller pinned
        # ``now`` (tests): an engine step can hide seconds of compile/compute
        self._pump(now if pinned else self.clock())
        return did

    async def run(self, idle_sleep_s: float = 0.002) -> None:
        """Drive ``tick`` until stopped and fully drained."""
        while True:
            did = self.tick()
            if self._stopping and self.pending() == 0:
                return
            if did or self._backlog or self._retries:
                await asyncio.sleep(0)  # stay hot, let clients interleave
            else:
                # park until new work or stop; short timeout keeps
                # deadline/backoff clocks advancing while idle
                self._wake.clear()
                if self._live:
                    await asyncio.sleep(0)
                    continue
                try:
                    await asyncio.wait_for(self._wake.wait(), idle_sleep_s)
                except asyncio.TimeoutError:
                    pass

    # ----------------------------------------------------------- plumbing
    def _enforce_drain(self, now: float) -> None:
        if not self._stopping or self._drain_by is None or now < self._drain_by:
            return
        # drain deadline passed: everything still live is cancelled with a
        # terminal outcome (never wedged)
        for t in list(self._backlog) + list(self._retries):
            t._close("cancelled", now, "drain deadline exceeded")
        self._backlog.clear()
        self._retries.clear()
        for t in list(self._live):
            self.engine.cancel(t.request, outcome="cancelled")
            self._finish(t, "cancelled", now, "drain deadline exceeded")

    def _expire_and_cancel(self, now: float) -> None:
        # backlog + retries: front-end owns expiry (engine never saw them)
        for q in (self._backlog, self._retries):
            for t in list(q):
                if t._cancel_asked:
                    q.remove(t)
                    t._close("cancelled", now, "client cancellation")
                elif t.deadline is not None and now >= t.deadline:
                    q.remove(t)
                    t._close("deadline_expired", now,
                             "deadline passed while queued")
                elif t.ttft_deadline is not None and now >= t.ttft_deadline:
                    q.remove(t)
                    t._close("deadline_expired", now,
                             "TTFT budget exceeded while queued")
        # live: route through engine.cancel so the slot recycles token-clean
        for t in list(self._live):
            if t._cancel_asked:
                self.engine.cancel(t.request, outcome="cancelled")
                self._finish(t, "cancelled", now, "client cancellation")
            elif t.ttft_deadline is not None and t.cursor == 0 \
                    and now >= t.ttft_deadline:
                self.engine.cancel(t.request, outcome="deadline_expired")
                self._finish(t, "deadline_expired", now,
                             "TTFT budget exceeded")
            # hard deadlines on live requests are enforced by
            # engine.expire_deadlines inside step(now) — _pump picks the
            # status change up afterwards

    def _step_ladder(self, now: float) -> None:
        if self.ladder is None:
            return
        nxt = self.ladder.next_level(self.level, self.depth,
                                     self.high_watermark, self.low_watermark)
        if nxt != self.level:
            self.metrics.note_transition(now, self.level, nxt, self.depth)
            self.level = nxt

    def _admit(self, now: float) -> None:
        # retries first: they already waited once and hold a backoff stamp
        while self.engine.free_slots > 0 and self._retries \
                and self._retries[0].retry_at is not None \
                and self._retries[0].retry_at <= now:
            self._submit_to_engine(self._retries.popleft(), now, retry=True)
        while self.engine.free_slots > 0 and self._backlog:
            self._submit_to_engine(self._backlog.popleft(), now, retry=False)

    def _submit_to_engine(self, t: Ticket, now: float, retry: bool) -> None:
        # a retry replays at its original ladder level: sampling keys are
        # rid-stable, but the level feeds the noise model, so bit-identical
        # replay requires the level to match the first attempt
        lvl = t.level if (retry and t.level is not None) else self.level
        r = Request(prompt=np.asarray(t.prompt, np.int32),
                    max_new_tokens=t.max_new,
                    temperature=t.temperature, rid=t.rid,
                    degrade_level=lvl, deadline=t.deadline)
        try:
            self.engine.submit(r)
        except Exception as e:  # validation errors -> terminal, not raised
            t.error = RequestError(reason=f"submit rejected: {e}",
                                   phase="submit", retryable=False)
            self._record_admission(t, now, lvl)
            t._close("failed", now, str(t.error))
            return
        t.request = r
        t.level = lvl
        self._record_admission(t, now, lvl)
        self._live.append(t)

    def _record_admission(self, t: Ticket, now: float, lvl: int) -> None:
        if t.record.admitted_s is None:
            t.record.admitted_s = now
            t.record.queue_wait_s = now - t.record.submitted_s
            t.record.degrade_level = lvl
            t.record.votes_used = (
                self.ladder.votes_at(lvl, self._full_votes)
                if self.ladder is not None else self._full_votes)

    def _pump(self, now: float) -> None:
        """Deliver fresh tokens and resolve terminal engine statuses."""
        eng = self.engine
        for t in list(self._live):
            toks = t.request.out_tokens
            if len(toks) > t.cursor:
                if t.record.ttft_s is None:
                    t.record.ttft_s = now - t.record.submitted_s
                t._push(toks[t.cursor:])
                t.cursor = len(toks)
            st = eng.status_of(t.request)
            if st in ("queued", "running"):
                continue
            if st == "completed":
                self._finish(t, "completed", now)
            elif st == "deadline_expired":
                self._finish(t, "deadline_expired", now, "deadline passed")
            elif st == "cancelled":
                self._finish(t, "cancelled", now, "cancelled in engine")
            elif st == "failed":
                self._on_failure(t, eng.error_of(t.request), now)

    def _on_failure(self, t: Ticket, err: Optional[RequestError],
                    now: float) -> None:
        t.error = err
        retryable = bool(err is None or err.retryable)
        can_retry = (retryable and t.record.retries < self.max_retries
                     and not self._stopping)
        if not can_retry:
            self._finish(t, "failed", now, str(err) if err else None)
            return
        self._live.remove(t)
        t.record.retries += 1
        # exponential backoff, deterministic (no jitter: replay is exact)
        t.retry_at = now + self.retry_backoff_s * (2 ** (t.record.retries - 1))
        t.request = None
        self._retries.append(t)
        self._wake.set()

    def _finish(self, t: Ticket, outcome: str, now: float,
                reason: Optional[str] = None) -> None:
        if t in self._live:
            self._live.remove(t)
        if t.request is not None:
            rep = self.engine.guard_report_of(t.request)
            if rep is not None:
                t.record.guard_trips = rep["trips"]
                t.record.guard_hard = rep["hard"]
            # per-replica attribution: which replica served or failed the
            # request, and how many health-failover migrations it rode
            rep_of = getattr(self.engine, "replica_of", None)
            if rep_of is not None:
                t.record.replica = rep_of(t.request)
            mig_of = getattr(self.engine, "migrations_of", None)
            if mig_of is not None:
                t.record.migrations = mig_of(t.request)
        t._close(outcome, now, reason)
