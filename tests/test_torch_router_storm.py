"""The port's replica router under a drift storm and behind the
front-end, against the JAX package (the reference tests' tiny qwen2,
parameters from the JAX init; helpers from ``test_torch_router.py``).

The storm victim serves sim mode under the guard on the behavioural path,
which matches the reference only statistically (ROADMAP C4: normals within
3 ulp), so its tokens are not compared: the events (drains of ``r1``
alone, at the same steps, with the same scores), every replica's guard
hard-trip counts, the replica states and each request's replica and
migration count are held equal to the JAX router's, and every request
completes with all its tokens. The front-end over a pool that loses
``r0`` at step 5 closes every record completed, with its replica and
migration count equal to the JAX front-end's over the JAX router and its
tokens equal to the JAX single engine's."""

import asyncio

import numpy as np

from repro.serving import engine as jengine
from repro.serving import frontend as jfrontend
from repro_torch.serving import engine as tengine
from repro_torch.serving import frontend as tfrontend
from test_torch_router import (_pool, _reference_streams, _requests,
                               one_thread, sides)  # noqa: F401 (fixtures)


def test_storm_drains_victim_and_completes(sides):
    """No router-injected event: the victim's guard hard trips drag its
    score below ``drain_below``, its work migrates, and every request
    completes; the victim is drained, never killed."""
    seen = {}
    for side in ("jax", "torch"):
        _, _, mod, rmod, fcls, _ = sides[side]
        reqs = _requests(mod, 6, np.random.default_rng(6), max_new=8,
                         temps=(0.0,))
        fault = fcls(mode="storm", victim=1, storm_transient_mag=64.0)
        router = rmod.ReplicaRouter(
            _pool(side, sides, 3, fault=fault, cim_mode="sim", guard=True),
            replica_fault=fault)
        out = router.generate(reqs)
        assert all(isinstance(o, list) and len(o) == r.max_new_tokens
                   for o, r in zip(out, reqs))
        seen[side] = (router.events, router.replica_states(),
                      [e.guard_hard_counts.tolist() for e in router.engines],
                      [router.replica_of(r) for r in reqs],
                      [router.migrations_of(r) for r in reqs])
    assert seen["torch"] == seen["jax"]
    events, states, hard, *_ = seen["torch"]
    drains = [e for e in events if e["kind"] == "drain"]
    assert drains and all(e["replica"] == "r1" for e in drains)
    assert states[1]["state"] in ("draining", "healthy")
    assert sum(hard[1]) > 0 and sum(hard[0]) == sum(hard[2]) == 0


def _frontend_run(side, sides):
    _, _, _, rmod, fcls, _ = sides[side]
    fe_mod = jfrontend if side == "jax" else tfrontend
    rng = np.random.default_rng(8)
    router = rmod.ReplicaRouter(
        _pool(side, sides, 2, max_slots=2),
        replica_fault=fcls(mode="kill", at_step=5, victim=0))
    fe = fe_mod.Frontend(router, queue_limit=16)

    async def run():
        runner = asyncio.create_task(fe.run())
        tickets = [fe.submit(list(rng.integers(0, 128, 6)), 8,
                             rid=f"fe-{i}") for i in range(4)]
        await asyncio.gather(*(t.wait() for t in tickets))
        fe.stop()
        await runner
        return tickets

    return asyncio.run(run()), router


def test_frontend_over_router_kill_failover(sides):
    """The front-end fronts a pool unchanged; a replica killed mid-run is
    absorbed by migration: every record completed, attributed to a
    replica, with at least one migration, and every stream the single
    engine's."""
    jt, _ = _frontend_run("jax", sides)
    tickets, router = _frontend_run("torch", sides)
    recs = [t.record for t in tickets]
    assert all(r.outcome == "completed" for r in recs)
    assert all(r.replica in ("r0", "r1") for r in recs)
    assert sum(r.migrations for r in recs) >= 1
    assert router.replica_states()[0]["state"] == "dead"
    assert [(t.rid, t.tokens, t.record.replica, t.record.migrations)
            for t in tickets] == [
        (t.rid, t.tokens, t.record.replica, t.record.migrations) for t in jt]
    ref = _reference_streams(
        sides, [jengine.Request(prompt=np.asarray(t.prompt, dtype=np.int32),
                                max_new_tokens=8, rid=t.rid)
                for t in tickets])
    assert [t.tokens for t in tickets] == ref
    assert isinstance(router.engines[0], tengine.Engine)
