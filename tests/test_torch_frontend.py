"""The port's asyncio front-end (``serving/frontend.py``), its metrics log
(``serving/metrics.py``) and the engine surface they drive, on the
reference tests' tiny qwen2 (2 layers, d 128, vocab 128; parameters from
the JAX init through ``params_from_jax``), on the CPU.

Part 1 ports the 18 scenarios of ``tests/test_frontend.py`` onto the
port's ``Frontend`` over the port's ``Engine(device="cpu")``: bounded
admission with shed reasons, deadlines and TTFT budgets (queued,
mid-prefill, mid-decode), client cancellation, deterministic retries (the
flaky engine patches the port's own ``_decode_forward``), the ladder
(climb, degrade, recover; rung 0 bit-identical to no ladder; its
exclusions), graceful drain, the asyncio path and the metrics.

Part 2 runs one scripted scenario on the JAX ``Frontend`` + ``Engine`` and
on the port's under the same fake clock and submissions (overflow;
deadlines queued, mid-decode and a TTFT budget mid-prefill; cancellation;
the ladder climbing and descending, in sim mode on the behavioural path
with host keys (``test_torch_ladder.py`` serves the seed-table path);
drain) and holds every ticket's outcome, reason, tokens, queue wait, TTFT,
ladder level, votes and retries, the ladder's transitions and
``MetricsLog.summary()`` equal. Greedy decoding (the reference's
``cancel`` of a queued request behind another raises, ROADMAP C7; the
front-end never cancels one); the JAX engine waits for its last step
before it writes a slot's host buffers (``_close_host_buffer_race``,
ROADMAP C8). Part 3:
``RequestError`` and ``Engine.cancel(outcome=)`` against the reference's,
the engine's option rules and the CLI's front-end flags."""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import sac as jsac
from repro.models.model import build as jbuild
from repro.serving import engine as jengine
from repro.serving import frontend as jfrontend
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import params_from_jax
from repro_torch.core.sac import DegradeLadder
from repro_torch.serving import engine as tengine
from repro_torch.serving import frontend as tfrontend
from repro_torch.serving.engine import OUTCOMES, Engine, Request, RequestError
from repro_torch.serving.frontend import Frontend
from repro_torch.serving.metrics import MetricsLog, percentile


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(get, use_kernel=False):
    cfg = get("qwen2-0.5b").reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=256,
                               vocab_size=128, n_heads=4, n_kv_heads=2,
                               head_dim=32, cim=dataclasses.replace(
                                   cfg.cim, use_kernel=use_kernel))


@pytest.fixture(scope="module")
def jparams():
    jp, _ = jbuild(_tiny(jget)).init(jax.random.PRNGKey(0))
    return jp


@pytest.fixture(scope="module")
def setup(jparams):
    return _tiny(get_config), params_from_jax(
        jax.tree.map(np.asarray, jparams))


class Clock:
    """Injectable fake clock; tests advance it explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _engine(cfg, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("cim_mode", "off")
    kw.setdefault("seed", 0)
    kw.setdefault("chunk_size", 0)
    kw.setdefault("device", "cpu")
    return Engine(cfg, params, **kw)


def _drive(fe, clock, dt=0.01, limit=1000):
    steps = 0
    while fe.pending():
        fe.tick(clock.t)
        clock.t += dt
        steps += 1
        assert steps < limit, "front-end wedged"


def _prompt(cfg, rng, n=6):
    return list(rng.integers(0, cfg.vocab_size, n))


# ================================================= part 1: the scenarios
# ------------------------------------------------------- admission bound


def test_overflow_shed_with_reason_and_all_terminal(setup):
    """Submissions past queue_limit shed at once with a structured reason;
    every request ends in exactly one terminal outcome and the sheds never
    touched a slot."""
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params), queue_limit=3, high_watermark=2,
                  low_watermark=1, clock=clock)
    rng = np.random.default_rng(0)
    tks = [fe.submit(_prompt(cfg, rng), 4, rid=f"r{i}") for i in range(5)]
    shed = [t for t in tks if t.outcome == "shed"]
    assert len(shed) == 2
    for t in shed:
        assert t.done.is_set()
        assert "admission queue full" in t.record.reason
        assert t.record.admitted_s is None
    _drive(fe, clock)
    assert all(t.done.is_set() for t in tks)
    assert all(t.outcome in OUTCOMES for t in tks)
    assert [t.outcome for t in tks].count("completed") == 3
    s = fe.metrics.summary()
    assert s["n_requests"] == 5 and s["open_requests"] == 0
    assert s["outcomes"] == {"completed": 3, "shed": 2}


def test_frontend_matches_plain_engine_tokens(setup):
    """Tokens served through the front-end equal ``engine.generate``'s for
    the same rids and prompts, sampled at temperature 0.7."""
    cfg, params = setup
    rng = np.random.default_rng(1)
    prompts = [np.asarray(_prompt(cfg, rng), np.int32) for _ in range(3)]
    ref = _engine(cfg, params).generate(
        [Request(prompt=p.copy(), max_new_tokens=5, temperature=0.7,
                 rid=f"m{i}") for i, p in enumerate(prompts)])
    clock = Clock()
    fe = Frontend(_engine(cfg, params), queue_limit=4, high_watermark=3,
                  low_watermark=1, clock=clock)
    tks = [fe.submit(list(p), 5, temperature=0.7, rid=f"m{i}")
           for i, p in enumerate(prompts)]
    _drive(fe, clock)
    assert [t.tokens for t in tks] == ref


# --------------------------------------------- deadlines and TTFT budgets


def test_deadline_expires_queued_request(setup):
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params, max_slots=1), queue_limit=4,
                  high_watermark=3, low_watermark=1, clock=clock)
    rng = np.random.default_rng(2)
    long = fe.submit(_prompt(cfg, rng), 20, rid="hog")
    late = fe.submit(_prompt(cfg, rng), 4, rid="late", timeout_s=0.5)
    fe.tick(clock.t)
    clock.t = 1.0
    _drive(fe, clock)
    assert long.outcome == "completed"
    assert late.outcome == "deadline_expired"
    assert "while queued" in late.record.reason
    assert late.tokens == []


def test_deadline_expires_mid_decode_with_partial_stream(setup):
    """A decoding request killed by its deadline keeps the tokens it
    already streamed; the slot's next occupant is unaffected."""
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params, max_slots=1), queue_limit=4,
                  high_watermark=3, low_watermark=1, clock=clock)
    rng = np.random.default_rng(3)
    t = fe.submit(_prompt(cfg, rng), 30, rid="dl", timeout_s=0.05)
    nxt = fe.submit(_prompt(cfg, rng), 4, rid="next")
    steps = 0
    while fe.pending() and steps < 500:
        fe.tick(clock.t)
        clock.t += 0.02
        steps += 1
    assert t.outcome == "deadline_expired"
    assert 0 < len(t.tokens) < 30
    assert nxt.outcome == "completed" and len(nxt.tokens) == 4


def test_ttft_budget_mid_prefill(setup):
    """A TTFT budget that expires cancels a request with no token yet,
    as deadline_expired."""
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params, max_slots=1), queue_limit=4,
                  high_watermark=3, low_watermark=1, clock=clock,
                  default_ttft_budget_s=0.5)
    rng = np.random.default_rng(4)
    hog = fe.submit(_prompt(cfg, rng), 25, rid="hog2",
                    ttft_budget_s=1000.0)
    starved = fe.submit(_prompt(cfg, rng), 4, rid="starved")
    fe.tick(clock.t)
    clock.t = 0.9
    _drive(fe, clock, dt=0.001)
    assert starved.outcome == "deadline_expired"
    assert "TTFT budget" in starved.record.reason
    assert hog.outcome == "completed"


# ----------------------------------------------------------- cancellation


def test_client_cancel_queued_and_running(setup):
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params, max_slots=1), queue_limit=4,
                  high_watermark=3, low_watermark=1, clock=clock)
    rng = np.random.default_rng(5)
    running = fe.submit(_prompt(cfg, rng), 30, rid="run")
    queued = fe.submit(_prompt(cfg, rng), 4, rid="park")
    fe.tick(clock.t)
    queued.cancel()
    fe.tick(clock.t)
    assert queued.outcome == "cancelled"
    assert "client" in queued.record.reason
    steps = 0
    while len(running.tokens) < 2 and steps < 200:
        fe.tick(clock.t)
        steps += 1
    running.cancel()
    _drive(fe, clock)
    assert running.outcome == "cancelled"
    assert 2 <= len(running.tokens) < 30


# ------------------------------------------------------------------ retry


def _flaky_engine(cfg, params, persistent=False):
    """An engine whose decode forward raises while slot 0 is active: until
    the first failure is recorded (a deterministic transient: the
    victim's isolation probe sees it, the retry runs clean), or always."""
    eng = _engine(cfg, params, max_slots=1, fused_step=False)
    real = eng._decode_forward

    def flaky(ctx, tokens):
        hit = persistent or not any(e is not None
                                    for e in eng.request_errors)
        if hit and bool(eng._inputs.act[0]):
            raise RuntimeError("persistent decode fault" if persistent
                               else "injected transient decode fault")
        return real(ctx, tokens)

    eng._decode_forward = flaky
    return eng


def test_retry_replays_bit_identical_stream(setup):
    """A retryable decode failure is retried under the same rid after
    backoff; the sampling keys derive from crc32(rid), so the stream
    equals a fault-free engine's at temperature 0.9, and the delivered
    prefix is never re-emitted."""
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_flaky_engine(cfg, params), queue_limit=4,
                  high_watermark=3, low_watermark=1, clock=clock,
                  max_retries=1, retry_backoff_s=0.1)
    rng = np.random.default_rng(6)
    prompt = np.asarray(_prompt(cfg, rng), np.int32)
    t = fe.submit(list(prompt), 6, temperature=0.9, rid="retry-me")
    _drive(fe, clock)
    assert t.outcome == "completed"
    assert t.record.retries == 1
    assert t.error is not None and t.error.retryable
    (ref,) = _engine(cfg, params, max_slots=1, fused_step=False).generate(
        [Request(prompt=prompt.copy(), max_new_tokens=6, temperature=0.9,
                 rid="retry-me")])
    assert t.tokens == ref
    assert len(t.tokens) == 6


def test_retries_exhausted_ends_failed(setup):
    """A fault that outlives max_retries ends in exactly one 'failed'
    outcome carrying the structured RequestError."""
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_flaky_engine(cfg, params, persistent=True),
                  queue_limit=4, high_watermark=3, low_watermark=1,
                  clock=clock, max_retries=2, retry_backoff_s=0.01)
    rng = np.random.default_rng(7)
    t = fe.submit(_prompt(cfg, rng), 4, rid="doomed")
    _drive(fe, clock)
    assert t.outcome == "failed"
    assert t.record.retries == 2
    assert isinstance(t.error, RequestError)
    assert "persistent decode fault" in t.error.reason


def test_oversize_prompt_fails_without_retry(setup):
    """Engine-submit validation failures are terminal and not retried:
    phase='submit', zero retries burned."""
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params, max_len=16), queue_limit=4,
                  high_watermark=3, low_watermark=1, clock=clock,
                  max_retries=3)
    t = fe.submit(list(range(64)), 4, rid="toolong")
    fe.tick(clock.t)
    assert t.outcome == "failed"
    assert t.error.phase == "submit" and t.error.retryable is False
    assert t.record.retries == 0


# ------------------------------------------------------------- the ladder


def test_ladder_climbs_degrades_and_recovers(setup):
    """A backlog at the high watermark climbs the ladder one rung a tick
    and admissions run at reduced votes; below the low watermark it walks
    back and a fresh admission is at full votes, both transitions
    logged."""
    cfg, params = setup
    eng = _engine(cfg, params, ladder=DegradeLadder(votes=(None, 3, 1)))
    clock = Clock()
    fe = Frontend(eng, queue_limit=8, high_watermark=4, low_watermark=2,
                  clock=clock)
    rng = np.random.default_rng(8)
    burst = [fe.submit(_prompt(cfg, rng), 3, rid=f"b{i}") for i in range(8)]
    _drive(fe, clock)
    full = fe._full_votes
    votes = [t.record.votes_used for t in burst]
    assert any(v < full for v in votes), votes
    assert all(t.outcome == "completed" for t in burst)
    for _ in range(eng.ladder.n_levels):
        fe.tick(clock.t)
    assert fe.level == 0
    late = fe.submit(_prompt(cfg, rng), 3, rid="late")
    _drive(fe, clock)
    assert late.record.votes_used == full
    assert late.record.degrade_level == 0
    ups = [tr for tr in fe.metrics.transitions if tr.level_to > tr.level_from]
    downs = [tr for tr in fe.metrics.transitions
             if tr.level_to < tr.level_from]
    assert ups and downs
    assert all(tr.queue_depth >= 4 for tr in ups)


def test_ladder_level0_rows_bit_identical_without_degraded_neighbors(setup):
    """A laddered engine with every request at rung 0 gives the tokens of
    a ladder-free engine in sim mode (the behavioural path, as in the
    reference's test, and the CIM kernel path)."""
    cfg, params = setup
    rng = np.random.default_rng(9)
    prompts = [np.asarray(_prompt(cfg, rng), np.int32) for _ in range(2)]

    def reqs():
        return [Request(prompt=p.copy(), max_new_tokens=4, rid=f"z{i}")
                for i, p in enumerate(prompts)]

    for c in (cfg, dataclasses.replace(cfg, cim=dataclasses.replace(
            cfg.cim, use_kernel=True))):
        plain = _engine(c, params, cim_mode="sim").generate(reqs())
        laddered = _engine(c, params, cim_mode="sim",
                           ladder=DegradeLadder()).generate(reqs())
        assert plain == laddered


def test_ladder_excludes_guard_and_fused_layer(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="guard"):
        _engine(cfg, params, cim_mode="sim", guard=True,
                ladder=DegradeLadder())
    fused_cfg = dataclasses.replace(cfg, fuse_layer=True)
    with pytest.raises(ValueError, match="fuse_layer"):
        Engine(fused_cfg, params, max_slots=2, max_len=48, cim_mode="sim",
               seed=0, chunk_size=0, ladder=DegradeLadder(), device="cpu")


def test_vote_drop_noise_monotonic():
    """Fewer CB votes give strictly more extra noise; full votes (rung 0,
    None) add exactly zero."""
    from repro_torch.core.cim import vote_drop_extra_std_int
    from repro_torch.core.sac import get_policy

    spec = get_policy("paper_sac").spec_for_role("mlp_in")
    assert vote_drop_extra_std_int(spec, 128, None) == 0.0
    s3 = vote_drop_extra_std_int(spec, 128, 3)
    s1 = vote_drop_extra_std_int(spec, 128, 1)
    assert 0.0 < s3 < s1
    with pytest.raises(ValueError):
        vote_drop_extra_std_int(spec, 128, 0)


# ---------------------------------------------------------- drain/shutdown


def test_stop_sheds_new_work_and_drains_accepted(setup):
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params), queue_limit=4, high_watermark=3,
                  low_watermark=1, clock=clock, drain_deadline_s=100.0)
    rng = np.random.default_rng(10)
    accepted = fe.submit(_prompt(cfg, rng), 4, rid="in")
    fe.stop()
    late = fe.submit(_prompt(cfg, rng), 4, rid="late")
    assert late.outcome == "shed" and "draining" in late.record.reason
    _drive(fe, clock)
    assert accepted.outcome == "completed" and len(accepted.tokens) == 4


def test_drain_deadline_cancels_stragglers(setup):
    """Work that outlives the drain deadline is cancelled, queued or in
    flight: terminal, not wedged."""
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params, max_slots=1), queue_limit=4,
                  high_watermark=3, low_watermark=1, clock=clock,
                  drain_deadline_s=0.5)
    rng = np.random.default_rng(11)
    flying = fe.submit(_prompt(cfg, rng), 25, rid="fly")
    parked = fe.submit(_prompt(cfg, rng), 4, rid="park")
    fe.tick(clock.t)
    fe.stop()
    clock.t = 1.0
    fe.tick(clock.t)
    assert flying.outcome == "cancelled"
    assert parked.outcome == "cancelled"
    assert "drain deadline" in flying.record.reason
    assert fe.pending() == 0


# ------------------------------------------------------- asyncio plumbing


def test_async_run_streams_and_drains(setup):
    """Through asyncio: submissions stream tokens as they decode, a client
    cancel resolves its waiter, stop() drains and run() returns."""
    cfg, params = setup
    fe = Frontend(_engine(cfg, params), queue_limit=4, high_watermark=3,
                  low_watermark=1)
    rng = np.random.default_rng(12)

    async def main():
        runner = asyncio.create_task(fe.run())
        a = fe.submit(_prompt(cfg, rng), 5, rid="a")
        b = fe.submit(_prompt(cfg, rng), 40, rid="b")
        streamed = [tok async for tok in a.stream()]
        b.cancel()
        await b.wait()
        fe.stop()
        await runner
        return a, b, streamed

    a, b, streamed = asyncio.run(asyncio.wait_for(main(), 300))
    assert a.outcome == "completed"
    assert streamed == a.tokens and len(streamed) == 5
    assert a.result() == streamed
    assert b.outcome == "cancelled"
    with pytest.raises(RuntimeError, match="cancelled"):
        b.result()


# ---------------------------------------------------------------- metrics


def test_metrics_records_and_percentiles(setup):
    cfg, params = setup
    clock = Clock()
    fe = Frontend(_engine(cfg, params), queue_limit=8, high_watermark=6,
                  low_watermark=2, clock=clock)
    rng = np.random.default_rng(13)
    tks = [fe.submit(_prompt(cfg, rng), 3, rid=f"m{i}") for i in range(4)]
    _drive(fe, clock)
    for t in tks:
        r = t.record
        assert r.outcome == "completed"
        assert r.queue_wait_s is not None and r.queue_wait_s >= 0
        assert r.ttft_s is not None and r.ttft_s >= r.queue_wait_s
        assert r.tokens_out == 3
        assert r.finished_s is not None
    s = fe.metrics.summary()
    assert s["queue_wait_p99_s"] >= s["queue_wait_p50_s"]
    assert s["open_requests"] == 0
    assert percentile([], 50) is None
    assert percentile([3.0], 99) == 3.0
    assert percentile([1.0, 2.0, 10.0], 99) == 10.0
    assert percentile([1.0, 2.0, 10.0], 50) == 2.0


def test_metrics_log_close_once_semantics():
    log = MetricsLog()
    rec = log.open("x", 1.0)
    rec.admitted_s = 2.0
    rec.tokens_out = 5
    rec.close("completed", 4.0)
    assert rec.tps == pytest.approx(4 / 2.0)
    assert log.summary()["outcomes"] == {"completed": 1}


# ===================================== part 2: the same script, JAX = port
SIDES = {"jax": (jengine, jfrontend, jsac.DegradeLadder),
         "torch": (tengine, tfrontend, DegradeLadder)}


def _same_prompts(n, length=6, seed=20):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 128, length)) for _ in range(n)]


def _script_overflow(fe, clock, prompts):
    tks = [fe.submit(p, 4, rid=f"o{i}") for i, p in enumerate(prompts[:5])]
    _drive(fe, clock)
    return tks


def _script_deadlines(fe, clock, prompts):
    """One slot: a hog, a request whose deadline passes while queued, then
    one whose deadline passes mid-decode."""
    hog = fe.submit(prompts[0], 6, rid="hog")
    queued = fe.submit(prompts[1], 4, rid="q", timeout_s=0.03)
    mid = fe.submit(prompts[2], 20, rid="mid", timeout_s=0.2)
    nxt = fe.submit(prompts[3], 3, rid="next")
    _drive(fe, clock, dt=0.02)
    return [hog, queued, mid, nxt]


def _script_ttft(fe, clock, prompts):
    """Chunked prefill of a long prompt, one slot: its TTFT budget expires
    after it was admitted and before its last chunk ran."""
    long = fe.submit(prompts[0] * 4, 4, rid="long", ttft_budget_s=0.025)
    after = fe.submit(prompts[1], 3, rid="after")
    _drive(fe, clock, dt=0.01)
    return [long, after]


def _script_cancel(fe, clock, prompts):
    run = fe.submit(prompts[0], 12, rid="run")
    park = fe.submit(prompts[1], 4, rid="park")
    other = fe.submit(prompts[2], 4, rid="other")
    fe.tick(clock.t)
    park.cancel()
    fe.tick(clock.t)
    while len(run.tokens) < 3:
        fe.tick(clock.t)
        clock.t += 0.01
    run.cancel()
    _drive(fe, clock)
    return [run, park, other]


def _script_ladder(fe, clock, prompts):
    burst = [fe.submit(p, 3, rid=f"b{i}") for i, p in enumerate(prompts[:8])]
    _drive(fe, clock)
    for _ in range(3):
        fe.tick(clock.t)
        clock.t += 0.01
    late = fe.submit(prompts[8], 3, rid="late")
    _drive(fe, clock)
    return burst + [late]


def _script_drain(fe, clock, prompts):
    done = fe.submit(prompts[0], 3, rid="done")
    fly = fe.submit(prompts[1], 20, rid="fly")
    park = fe.submit(prompts[2], 4, rid="park")
    for _ in range(4):
        fe.tick(clock.t)
        clock.t += 0.01
    fe.stop()
    shed = fe.submit(prompts[3], 4, rid="shed")
    _drive(fe, clock, dt=0.05)
    return [done, fly, park, shed]


SCENARIOS = {
    "overflow": (_script_overflow, dict(queue_limit=3, high_watermark=2,
                                        low_watermark=1), {}),
    "deadlines": (_script_deadlines, dict(queue_limit=4, high_watermark=3,
                                          low_watermark=1),
                  dict(max_slots=1)),
    "ttft_mid_prefill": (_script_ttft, dict(queue_limit=4, high_watermark=3,
                                            low_watermark=1),
                         dict(max_slots=1, chunk_size=4)),
    "cancel": (_script_cancel, dict(queue_limit=4, high_watermark=3,
                                    low_watermark=1), dict(max_slots=1)),
    "ladder": (_script_ladder, dict(queue_limit=8, high_watermark=4,
                                    low_watermark=2),
               dict(cim_mode="sim", chunk_size=4, ladder=True)),
    "drain": (_script_drain, dict(queue_limit=4, high_watermark=3,
                                  low_watermark=1, drain_deadline_s=0.1),
              dict(max_slots=1)),
}


def _close_host_buffer_race(eng):
    """The JAX engine hands its per-slot numpy buffers (levels, sampling
    keys) to computations that CPU dispatch may run later, and writes them
    in place when a slot is freed or admitted (ROADMAP C8): a laddered
    decode can then read a freed slot's level as 0. Wait for the engine's
    last dispatched step before each such write, as a synchronous
    dispatch would; the reference's code is not changed."""
    for name in ("_free_slot", "_admit"):
        real = getattr(eng, name)

        def synced(*a, _real=real, **k):
            jax.block_until_ready((eng.last_tok, eng.caches))
            return _real(*a, **k)

        setattr(eng, name, synced)


def _run_side(side, name, jparams, setup):
    eng_mod, fe_mod, ladder_cls = SIDES[side]
    script, fe_kw, eng_kw = SCENARIOS[name]
    eng_kw = dict(eng_kw)
    use_kernel = eng_kw.pop("use_kernel", False)
    if eng_kw.pop("ladder", False):
        eng_kw["ladder"] = ladder_cls(votes=(None, 3, 1))
    kw = dict(max_slots=2, max_len=48, cim_mode="off", seed=0,
              chunk_size=0)
    kw.update(eng_kw)
    if side == "jax":
        cfg, params = _tiny(jget, use_kernel), jparams
        kw["fused_step"] = False
    else:
        cfg, params = _tiny(get_config, use_kernel), setup[1]
        kw["device"] = "cpu"
    eng = eng_mod.Engine(cfg, params, **kw)
    if side == "jax":
        _close_host_buffer_race(eng)
    clock = Clock()
    fe = fe_mod.Frontend(eng, clock=clock, **fe_kw)
    tks = script(fe, clock, _same_prompts(9))
    recs = [(t.rid, t.outcome, t.record.reason, t.tokens,
             t.record.queue_wait_s, t.record.ttft_s, t.record.degrade_level,
             t.record.votes_used, t.record.retries, t.record.admitted_s,
             t.record.finished_s, t.record.tokens_out) for t in tks]
    trans = [dataclasses.astuple(tr) for tr in fe.metrics.transitions]
    return recs, trans, fe.metrics.summary()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_records_equal_jax_frontend(name, jparams, setup):
    """The JAX and the port's front-end run the same script under the same
    fake clock: every ticket's outcome, reason, tokens, queue wait, TTFT,
    ladder level, votes, retries and stamps, the ladder's transitions and
    the metrics summary are equal."""
    got = _run_side("torch", name, jparams, setup)
    ref = _run_side("jax", name, jparams, setup)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    outcomes = {r[1] for r in got[0]}
    want = {"overflow": {"shed", "completed"},
            "deadlines": {"completed", "deadline_expired"},
            "ttft_mid_prefill": {"deadline_expired", "completed"},
            "cancel": {"cancelled", "completed"},
            "ladder": {"completed"},
            "drain": {"completed", "cancelled", "shed"}}[name]
    assert outcomes == want, outcomes
    if name == "ladder":
        assert {r[6] for r in got[0]} == {0, 1, 2} and got[1]
        assert got[0][-1][6] == 0
    if name == "ttft_mid_prefill":
        assert got[0][0][2] == "TTFT budget exceeded"


# ================================== part 3: the engine's surface and rules


@pytest.mark.parametrize("fields", [
    dict(reason="boom"), dict(reason="boom", phase="prefill", slot=1),
    dict(reason="guard", phase="decode", slot=0, layer=3, retryable=False),
    dict(reason="x", phase="submit", retryable=False),
    dict(reason="lost", slot=2, replica="r1"),
    dict(reason="lost", replica="r0", layer=0)])
def test_request_error_str_equals_jax(fields):
    """``RequestError``'s defaults, fields and ``str()`` (the front-end
    writes it into its records) are the reference's."""
    got, ref = RequestError(**fields), jengine.RequestError(**fields)
    assert str(got) == str(ref)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)


def test_cancel_outcome_and_lifecycle_equal_jax(jparams, setup):
    """``cancel(r, outcome=)`` takes an outcome of ``OUTCOMES[1:]`` and
    raises on any other, as the reference's; ``status_of``, ``result_of``,
    ``error_of``, ``free_slots`` and ``step(now)`` (deadlines expired
    before admission) give the reference's answers along one session."""
    assert OUTCOMES == jengine.OUTCOMES

    def session(side):
        eng_mod = SIDES[side][0]
        if side == "jax":
            eng = eng_mod.Engine(_tiny(jget), jparams, max_slots=2,
                                 max_len=48, cim_mode="off", chunk_size=0,
                                 fused_step=False)
        else:
            eng = _engine(*setup)
        with pytest.raises(ValueError, match="cancel outcome"):
            eng.cancel(eng_mod.Request(prompt=np.arange(4)),
                       outcome="completed")
        prompts = _same_prompts(4)
        reqs = [eng_mod.Request(prompt=np.asarray(p, np.int32),
                                max_new_tokens=3, rid=f"c{i}",
                                deadline=0.5 if i == 3 else None)
                for i, p in enumerate(prompts)]
        log = [eng.free_slots]
        for r in reqs:
            eng.submit(r)
        log.append(eng.free_slots)
        # the queue's head: the reference's list.remove of a value-compared
        # Request meets no other prompt (ROADMAP C7)
        log.append(eng.cancel(reqs[0], outcome="failed"))
        log.append(eng.cancel(reqs[0]))
        eng.step(now=0.0)
        log.append(eng.free_slots)
        log.append(eng.cancel(reqs[1], outcome="deadline_expired"))
        eng.step(now=1.0)             # reqs[3]'s deadline passed, queued
        while eng.has_work():
            eng.step(now=1.0)
        eng.drain_pending()
        log.append(eng.free_slots)
        for r in reqs + [eng_mod.Request(prompt=np.arange(3))]:
            log.append((eng.status_of(r), eng.result_of(r),
                        eng.error_of(r)))
        return log

    assert session("torch") == session("jax")


def test_engine_options_raise_as_reference(setup):
    """``cim_mode="qat"`` serves per call on the float weights and
    ``replica=`` labels the engine, as the reference's; ``ladder`` with
    ``guard`` or ``fuse_layer`` raises the reference's ValueError; a
    laddered engine clamps a request's level to its rungs."""
    cfg, params = setup
    qat = _engine(cfg, params, cim_mode="qat")
    assert qat.mode == "qat" and not qat.deployed and not qat.fused_step
    assert _engine(cfg, params, replica="r0").replica_of(
        Request(prompt=np.arange(3))) == "r0"
    jcfg = _tiny(jget)
    for kw, c, jc in ((dict(guard=True), cfg, jcfg),
                      ({}, dataclasses.replace(cfg, fuse_layer=True),
                       dataclasses.replace(jcfg, fuse_layer=True))):
        msgs = []
        for side, conf in (("torch", c), ("jax", jc)):
            eng_mod, _, ladder_cls = SIDES[side]
            extra = {"device": "cpu"} if side == "torch" else {}
            with pytest.raises(ValueError) as e:
                eng_mod.Engine(conf, params if side == "torch" else {},
                               cim_mode="sim", ladder=ladder_cls(),
                               **kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    eng = _engine(cfg, params, ladder=DegradeLadder(votes=(None, 2)))
    for lvl, want in ((-3, 0), (0, 0), (1, 1), (7, 1)):
        eng.submit(Request(prompt=np.arange(4), max_new_tokens=2,
                           degrade_level=lvl))
        assert eng._levels[-1] == want


def test_serve_cli_frontend_ladder_on_cpu(capsys):
    """``--frontend --ladder`` on the reduced model on the CPU prints every
    ticket's record and the summary; the loop engine refuses both flags
    with the reference's messages."""
    from repro_torch.launch import serve
    tks = serve.main(["--reduced", "--device", "cpu", "--cim", "sim",
                      "--frontend", "--ladder", "--requests", "6",
                      "--queue-limit", "4", "--high-watermark", "2",
                      "--low-watermark", "1", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert [t.outcome for t in tks].count("shed") == 2
    assert all(t.outcome in OUTCOMES for t in tks)
    assert "summary: outcomes=" in out and out.count("req-") >= 6
    assert any(t.record.degrade_level > 0 for t in tks)
    with pytest.raises(SystemExit, match="--frontend needs the fused"):
        serve.main(["--reduced", "--device", "cpu", "--frontend",
                    "--engine", "loop"])
    with pytest.raises(SystemExit, match="no guard or ladder path"):
        serve.main(["--reduced", "--device", "cpu", "--ladder",
                    "--engine", "loop"])
