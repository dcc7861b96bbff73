"""The port's replica router (``serving/router.py``), ``ReplicaFaultSpec``
(``core/faults.py``) and the engine's replica surface (``replica=``,
``kill``, ``wedge``, ``unwedge``, ``replica_of``) against the JAX
package, on the reference tests' tiny qwen2 (2 layers, d 128, vocab 128,
f32; parameters from the JAX init through ``params_from_jax``), on the
CPU.

Every off-mode scenario of ``tests/test_router.py`` runs on the JAX
``ReplicaRouter`` and on the port's with the same requests: the outputs,
the whole ``events`` list (the dead replica's ``reason`` strings
included), ``replica_of``, ``migrations_of`` and ``replica_states()`` are
held equal, and the port's outputs equal the JAX single engine's streams
for the same rids exactly (f32 tokens; greedy and sampled at 0.7-0.8).
The scenarios: determinism across replicas, no faults, a kill
mid-decode, a kill mid-chunked-prefill, a total outage, a wedge caught by
the no-progress watchdog; then submit validation, cancel and status, the
replica tag of ``RequestError``, and
``ReplicaFaultSpec.victim_of`` for seeds 0-63 over 1-5 replicas. The JAX
engines wait for their last step before they write a slot's host buffers
(``_close_host_buffer_race``, ROADMAP C8); the reference's code is not
changed. ``test_torch_router_storm.py`` runs the drift storm and the
front-end over a killed pool."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.faults import ReplicaFaultSpec as JReplicaFaultSpec
from repro.models.model import build as jbuild
from repro.serving import engine as jengine
from repro.serving import router as jrouter
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import params_from_jax
from repro_torch.core.faults import ReplicaFaultSpec
from repro_torch.serving import engine as tengine
from repro_torch.serving import router as trouter


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(get):
    cfg = get("qwen2-0.5b").reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=256,
                               vocab_size=128, n_heads=4, n_kv_heads=2,
                               head_dim=32)


@pytest.fixture(scope="module")
def sides():
    """Per side: (cfg, params, engine module, router module, fault spec
    class, extra engine options)."""
    jp, _ = jbuild(_tiny(jget)).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return {"jax": (_tiny(jget), jp, jengine, jrouter, JReplicaFaultSpec,
                    {}),
            "torch": (_tiny(get_config), tp, tengine, trouter,
                      ReplicaFaultSpec, {"device": "cpu"})}


def _close_host_buffer_race(eng):
    """The JAX engine hands its per-slot numpy buffers (sampling keys,
    levels) to computations that CPU dispatch may run later, and writes
    them in place when a slot is freed or admitted (ROADMAP C8). Wait for
    the engine's last dispatched step before each such write, as a
    synchronous dispatch would."""
    for name in ("_free_slot", "_admit"):
        real = getattr(eng, name)

        def synced(*a, _real=real, **k):
            jax.block_until_ready((eng.last_tok, eng.caches))
            return _real(*a, **k)

        setattr(eng, name, synced)
    return eng


def _requests(mod, n, rng, max_new=8, temps=(0.0, 0.8), vocab=128):
    return [mod.Request(prompt=rng.integers(0, vocab, 5 + (i % 7),
                                            dtype=np.int32),
                        max_new_tokens=max_new,
                        temperature=temps[i % len(temps)], rid=f"req-{i}")
            for i in range(n)]


def _clones(mod, reqs):
    return [mod.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        temperature=r.temperature, rid=r.rid) for r in reqs]


def _reference_streams(sides, reqs, **kw):
    """The JAX single engine's streams for the same rids (seed 0)."""
    cfg, params, mod, _, _, extra = sides["jax"]
    kw.setdefault("max_slots", len(reqs))
    kw.setdefault("max_len", 48)
    kw.setdefault("cim_mode", "off")
    eng = _close_host_buffer_race(mod.Engine(cfg, params, seed=0, **kw))
    return eng.generate(_clones(mod, reqs))


def _pool(side, sides, n, fault=None, **kw):
    cfg, params, _, rmod, _, extra = sides[side]
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("cim_mode", "off")
    engines = rmod.build_pool(cfg, params, n, replica_fault=fault,
                              **extra, **kw)
    if side == "jax":
        for e in engines:
            _close_host_buffer_race(e)
    return engines


def _out(o):
    """An output a side-independent value: the tokens, or a failure's
    class name, text and fields."""
    if isinstance(o, list):
        return o
    return (type(o).__name__, str(o), o.phase, o.retryable, o.replica)


def _serve(side, sides, reqs_of, n, fault=None, health=None, **kw):
    """Run one router scenario on ``side``: (requests, router, its
    observables)."""
    _, _, mod, rmod, fcls, _ = sides[side]
    reqs = reqs_of(mod)
    spec = None if fault is None else fcls(**fault)
    hp = None if health is None else rmod.HealthPolicy(**health)
    router = rmod.ReplicaRouter(_pool(side, sides, n, **kw), health=hp,
                                replica_fault=spec)
    out = router.generate(reqs)
    seen = ([_out(o) for o in out], router.events,
            [router.replica_of(r) for r in reqs],
            [router.migrations_of(r) for r in reqs],
            router.replica_states(), router.free_slots, router.step_count)
    return reqs, router, seen


def _both(sides, reqs_of, n, **kw):
    """The port's router run, held against the JAX router's on the same
    requests."""
    _, _, want = _serve("jax", sides, reqs_of, n, **kw)
    reqs, router, got = _serve("torch", sides, reqs_of, n, **kw)
    assert got == want
    return reqs, router, got


# -------------------------------------------------- cross-replica determinism


def test_same_rid_bit_identical_across_replicas(sides):
    """Two replicas of one seed give every rid the same stream, greedy
    and sampled, and it is the JAX engine's."""
    def reqs_of(mod):
        return _requests(mod, 4, np.random.default_rng(0))

    e0, e1 = _pool("torch", sides, 2, max_slots=4)
    mod = tengine
    a = e0.generate(_clones(mod, reqs_of(mod)))
    b = e1.generate(_clones(mod, reqs_of(mod)))
    assert a == b
    assert a == _reference_streams(sides, reqs_of(jengine))
    assert (e0.replica, e1.replica) == ("r0", "r1")


def test_router_matches_single_engine(sides):
    """No faults: every rid's stream equals the single engine's, whichever
    replica served it, and the router's observables equal the JAX
    router's."""
    def reqs_of(mod):
        return _requests(mod, 6, np.random.default_rng(1))

    reqs, router, (out, events, reps, migs, *_) = _both(sides, reqs_of, 3)
    assert out == _reference_streams(sides, reqs_of(jengine))
    assert set(reps) <= {"r0", "r1", "r2"} and None not in reps
    assert migs == [0] * 6 and events == []


# -------------------------------------------------------------- kill failover


def test_kill_mid_decode_migrates_bit_identical(sides):
    """A replica killed mid-decode: its requests migrate and replay, the
    delivered streams equal the unkilled single engine's, no prefix
    re-emitted; the events (kill, dead with its reason, migrations with
    the delivered counts) equal the JAX router's."""
    def reqs_of(mod):
        return _requests(mod, 6, np.random.default_rng(2), max_new=10)

    reqs, router, (out, events, *_) = _both(
        sides, reqs_of, 3, fault=dict(mode="kill", at_step=4, victim=1))
    assert out == _reference_streams(sides, reqs_of(jengine))
    kinds = [e["kind"] for e in events]
    assert "kill" in kinds and "dead" in kinds and "migrate" in kinds
    assert any(router.migrations_of(r) > 0 for r in reqs)
    assert any(e["delivered"] > 0 for e in events if e["kind"] == "migrate")
    assert router.replica_states()[1]["state"] == "dead"
    dead = router.engines[1]
    assert dead.dead == "injected device loss" and not dead._pend
    with pytest.raises(RuntimeError, match="replica r1 dead"):
        dead.step()
    with pytest.raises(RuntimeError, match="replica r1 dead"):
        dead.drain_pending()


def test_kill_mid_chunked_prefill_migrates_bit_identical(sides):
    """A kill while the victim still chunk-prefills 24-token prompts
    (chunk 4): the replay reproduces the whole stream."""
    def reqs_of(mod):
        rng = np.random.default_rng(3)
        return [mod.Request(prompt=rng.integers(0, 128, 24, dtype=np.int32),
                            max_new_tokens=6, temperature=t, rid=f"long-{i}")
                for i, t in enumerate((0.0, 0.7))]

    reqs, router, (out, events, _, migs, *_) = _both(
        sides, reqs_of, 2, fault=dict(mode="kill", at_step=2, victim=0),
        max_slots=2, chunk_size=4)
    assert out == _reference_streams(sides, reqs_of(jengine), chunk_size=4)
    assert any(migs)
    assert all(e["delivered"] == 0 for e in events if e["kind"] == "migrate")


def test_total_outage_fails_fast(sides):
    """The only replica dead: pending requests fail with a route error at
    once instead of holding the pool open."""
    def reqs_of(mod):
        return _requests(mod, 2, np.random.default_rng(4))

    _, router, (out, *_) = _both(
        sides, reqs_of, 1, fault=dict(mode="kill", at_step=1, victim=0),
        max_slots=4)
    assert all(o[0] == "RequestError" and o[2] == "route" for o in out)
    assert "no live replicas" in out[0][1]
    assert router.free_slots == 0 and not router.has_work()


# ------------------------------------------------------------ wedge watchdog


def test_wedge_detected_and_migrated_bit_identical(sides):
    """A wedged replica raises nothing; after ``wedge_patience`` stalled
    ticks the watchdog marks it dead and its work migrates."""
    def reqs_of(mod):
        return _requests(mod, 4, np.random.default_rng(5), max_new=10)

    reqs, router, (out, events, *_) = _both(
        sides, reqs_of, 2, fault=dict(mode="wedge", at_step=3, victim=0),
        health=dict(wedge_patience=3), max_slots=2)
    assert out == _reference_streams(sides, reqs_of(jengine))
    dead = [e for e in events if e["kind"] == "dead"]
    assert dead and "wedged" in dead[0]["reason"]
    assert any(router.migrations_of(r) > 0 for r in reqs)
    # a wedged engine takes steps without work until unwedged
    e = router.engines[0]
    assert e.wedged and e.dead is not None
    w = _pool("torch", sides, 1)[0]
    r = _clones(tengine, reqs_of(tengine))[0]
    w.submit(r)
    w.wedge()
    assert w.step() and w.iter_count == 0 and w.status_of(r) == "queued"
    w.unwedge()
    assert w.step() and w.iter_count == 1


# -------------------------------------------------------- session API surface


def test_submit_validates_before_tracking(sides):
    """An invalid request raises at submit, as the reference's does, and
    leaves no pool work."""
    for side in ("jax", "torch"):
        _, _, mod, rmod, _, _ = sides[side]
        router = rmod.ReplicaRouter(_pool(side, sides, 2))
        bad = mod.Request(prompt=np.arange(100, dtype=np.int32),
                          max_new_tokens=10)
        with pytest.raises(ValueError, match="overflows"):
            router.submit(bad)
        assert not router.has_work()
    with pytest.raises(ValueError, match="at least one replica"):
        trouter.ReplicaRouter([])


def test_cancel_and_status(sides):
    """Submit, status, cancel, result and a second cancel give the JAX
    router's answers; a bad outcome raises its ValueError."""
    seen = {}
    for side in ("jax", "torch"):
        _, _, mod, rmod, _, _ = sides[side]
        router = rmod.ReplicaRouter(_pool(side, sides, 2))
        r = _requests(mod, 1, np.random.default_rng(7))[0]
        log = [router.submit(r), router.status_of(r), router.replica_of(r)]
        with pytest.raises(ValueError, match="cancel outcome"):
            router.cancel(r, outcome="completed")
        log += [router.cancel(r), router.status_of(r), router.result_of(r),
                router.cancel(r), router.has_work(), router.error_of(r),
                router.guard_report_of(r), router.free_slots]
        router.step()
        router.drain_pending()
        log += [router.status_of(mod.Request(prompt=np.arange(3))),
                router.replica_states()]
        seen[side] = log
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][3:5] == [True, "cancelled"]


def test_failed_request_carries_replica_tag():
    """``RequestError.replica`` names the replica a failure is attributed
    to and prints as the reference's (``test_torch_guard.py`` holds the
    engine's stamp of a guard-failed request against the JAX engine)."""
    for kw in (dict(replica="r2"), dict(replica="r2", slot=1, layer=3),
               dict(phase="route", retryable=False)):
        got = str(tengine.RequestError(reason="boom", **kw))
        assert got == str(jengine.RequestError(reason="boom", **kw))
    assert "r2:" in str(tengine.RequestError(reason="boom", replica="r2"))


def test_replica_fault_spec_equals_jax():
    """``victim_of`` for seeds 0-63 over 1-5 replicas, an explicit victim
    and its range check, the mode check, and ``storm_fault()``."""
    for n in range(1, 6):
        got = [ReplicaFaultSpec(seed=s).victim_of(n) for s in range(64)]
        assert got == [JReplicaFaultSpec(seed=s).victim_of(n)
                       for s in range(64)]
    assert len(set(ReplicaFaultSpec(seed=s).victim_of(5)
                   for s in range(64))) == 5
    assert ReplicaFaultSpec(victim=2).victim_of(3) == 2
    for cls in (ReplicaFaultSpec, JReplicaFaultSpec):
        with pytest.raises(ValueError, match="out of range"):
            cls(victim=3).victim_of(3)
        with pytest.raises(ValueError, match="unknown replica fault mode"):
            cls(mode="melt")
    f = ReplicaFaultSpec(seed=5, mode="storm", storm_transient_mag=32.0)
    jf = JReplicaFaultSpec(seed=5, mode="storm", storm_transient_mag=32.0)
    assert dataclasses.asdict(f.storm_fault()) == dataclasses.asdict(
        jf.storm_fault())
    assert dataclasses.asdict(f) == dataclasses.asdict(jf)


def test_serve_cli_replicas_on_cpu(capsys):
    """``--replicas 2`` serves the reduced model through the router, in a
    batch and through the front-end, whose records name each request's
    replica; the loop engine refuses it with the reference's message."""
    from repro_torch.launch import serve
    base = ["--reduced", "--device", "cpu", "--replicas", "2",
            "--requests", "3", "--prompt-len", "8", "--new-tokens", "3"]
    outs = serve.main(base)
    out = capsys.readouterr().out
    assert [len(o) for o in outs] == [3, 3, 3]
    assert "rep=r0" in out and "rep=r1" in out and "TTFT mean" in out
    tks = serve.main(base + ["--frontend"])
    out = capsys.readouterr().out
    assert [t.outcome for t in tks] == ["completed"] * 3
    assert {t.record.replica for t in tks} == {"r0", "r1"}
    recs = [ln for ln in out.splitlines() if ln.startswith("  req-")]
    assert len(recs) == 3 and all(" rep=r" in ln for ln in recs)
    with pytest.raises(SystemExit, match="--replicas needs the fused"):
        serve.main(["--reduced", "--device", "cpu", "--replicas", "2",
                    "--engine", "loop"])
