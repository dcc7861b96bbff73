"""The port's ABFT checksum guard (``core/guard.py``), its routing in
``layers.dense`` and ``models.transformer``, and the engine's escalation
policy (``DegradePolicy``, pins, ``fail_after``, the guard report) against
the JAX package on the same numpy-seeded inputs.

Held exactly: ``checksum_trips`` decisions on quiet and on faulted rows,
whole-row and segmented; the guarded dense's ladder on a systematic
transient (every row hard, the output the digital product bit for bit)
and on pinned rows; and at the reference tests' engine scenarios (its
``tests/test_guard.py``: a quiet guard, a hard transient on slot 1 with
and without the pre-pinned twin, ``fail_after``, segmented checksums) the
greedy tokens, statuses, per-layer trip and hard counts and each
request's guard report, on the behavioural path (the reference tests')
and, quiet and faulted, on the CIM kernel path; the engine's option
validation by exception type (``deploy=`` included), and an undeployed
engine serving the deployed one's tokens. The JAX engine runs each
scenario once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import guard as jguard
from repro.core.faults import FaultSpec as JFaultSpec
from repro.models.model import build as jbuild
from repro.serving.engine import DegradePolicy as JDegradePolicy
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import guard, prng
from repro_torch.core.cim import CIMSpec
from repro_torch.core.deploy import checksum_plane, deploy, params_from_jax
from repro_torch.core.drift import DriftSpec
from repro_torch.core.faults import FaultSpec
from repro_torch.models.layers import Ctx, dense
from repro_torch.serving.engine import (DegradePolicy, Engine, LoopEngine,
                                        Request, RequestError)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(get, use_kernel=False):
    cfg = get("qwen2-0.5b").reduced()
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, d_ff=256, vocab_size=128, n_heads=4,
        n_kv_heads=2, head_dim=32,
        cim=dataclasses.replace(cfg.cim, use_kernel=use_kernel))


@pytest.fixture(scope="module")
def setup():
    jp, _ = jbuild(_tiny(jget)).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _reqs(cls):
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(1, 127, size=n).astype(np.int32),
                max_new_tokens=4) for n in (7, 12, 5)]


def _checksum_case(seed, g):
    rng = np.random.default_rng(seed)
    k, n = 96, 64
    xq = rng.integers(-31, 32, (2, 5, k)).astype(np.int32)
    wq = rng.integers(-31, 32, (k, n)).astype(np.int8)
    unit = np.float32(0.0123)
    y = (xq.astype(np.float64) @ wq).astype(np.float32) * unit
    y = y + rng.normal(0.0, 0.2, y.shape).astype(np.float32) * unit
    y[0, 2, 7] += 40.0 * unit          # one corrupted element
    y[1, 4, :] += 3.0 * unit           # a coherent shift of one row
    wc = checksum_plane(torch.from_numpy(wq), g)
    return xq, y, wc, unit


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("sigma", [0.2, 0.05])
def test_checksum_trips_exact(g, sigma):
    xq, y, wc, unit = _checksum_case(3, g)
    gs, jgs = guard.GuardSpec(segments=g), jguard.GuardSpec(segments=g)
    want = np.asarray(jguard.checksum_trips(
        jnp.asarray(y), jnp.asarray(xq), jnp.asarray(wc.numpy()),
        jnp.float32(unit), sigma * unit, jgs))
    got = guard.checksum_trips(torch.from_numpy(y), torch.from_numpy(xq),
                               wc, torch.tensor(unit), sigma * unit, gs)
    np.testing.assert_array_equal(got.numpy(), want)
    # the corrupted rows trip, a quiet row not at the noise's own sigma
    assert want[0, 2] and want[1, 4]
    assert sigma != 0.2 or not want[0, 0]
    rs = guard._retry_spec(CIMSpec(cb=False), gs)
    assert rs.cb and rs.adc.mv_votes == gs.retry_votes


def _layer0(tree, *names):
    p = tree["blocks"]
    for n in names:
        p = p[n]
    return {k: v[0] for k, v in p.items()}


def _jlayer0(tree, *names):
    p = tree["blocks"]
    for n in names:
        p = p[n]
    return jax.tree.map(lambda t: t[0], p)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_guarded_dense_quiet_transient_and_pinned(setup, use_kernel):
    from repro.core.deploy import deploy as jdeploy
    from repro.models.layers import Ctx as JCtx
    from repro.models.layers import dense as jdense
    jp, tp = setup
    cfg = _tiny(get_config, use_kernel)
    jcfg = _tiny(jget, use_kernel)
    p = _layer0(deploy(cfg, tp, guard=True), "attn", "q")
    jpl = _jlayer0(jdeploy(jcfg, jp, guard=True), "attn", "q")
    x = np.random.default_rng(3).normal(size=(1, 4, 128)).astype(np.float32)
    key = prng.PRNGKey(5)

    def run(fault=None, rows=None, pin=None):
        ctx = Ctx.make(cfg, key, mode="sim", deployed=True,
                       guard=guard.GuardSpec(), fault=fault)
        ctx.trip_log, ctx.hard_log = [], []
        ctx.fault_rows, ctx.pin_rows = rows, pin
        y = dense(ctx, p, torch.from_numpy(x), "attn_qkv")
        return (y, int(sum(t.sum() for t in ctx.trip_log)),
                int(sum(t.sum() for t in ctx.hard_log)))

    y_dig = (torch.from_numpy(x) @ p["w"]).numpy()
    # quiet: no trip, the unguarded output bit for bit
    y, trips, hard = run()
    y_u = dense(Ctx.make(cfg, key, mode="sim", deployed=True), p,
                torch.from_numpy(x), "attn_qkv")
    assert torch.equal(y, y_u) and trips == hard == 0
    # a 4-sigma transient on every element: every row hard, the digital
    # product exactly, as in the reference
    f = FaultSpec(transient_mag=4.0)
    y, trips, hard = run(f, torch.ones((1,), dtype=torch.bool))
    np.testing.assert_array_equal(y.numpy(), y_dig)
    jctx = JCtx.make(jcfg, jnp.asarray(np.array(key, np.uint32)),
                     mode="sim", deployed=True, guard=jguard.GuardSpec(),
                     fault=JFaultSpec(transient_mag=4.0))
    jctx.fault_rows = jnp.ones((1,), bool)
    jctx.trip_log, jctx.hard_log = [], []
    jdense(jctx, jpl, jnp.asarray(x), "attn_qkv")
    assert (trips, hard) == (int(sum(jnp.sum(t) for t in jctx.trip_log)),
                             int(sum(jnp.sum(t) for t in jctx.hard_log)))
    assert trips == hard == 4
    # pinned rows: the digital product, no counts
    y, trips, hard = run(f, torch.ones((1,), dtype=torch.bool),
                         torch.ones((1,), dtype=torch.bool))
    np.testing.assert_array_equal(y.numpy(), y_dig)
    assert trips == hard == 0


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The reference engine's outcome per scenario, once per module."""
    jp, _ = setup
    runs = {}

    def run(name, use_kernel, **kw):
        if (name, use_kernel) not in runs:
            e = JEngine(_tiny(jget, use_kernel), jp, max_slots=3,
                        max_len=64, seed=0, **kw)
            out = e.generate(_reqs(JRequest))
            runs[name, use_kernel] = (out, e)
        return runs[name, use_kernel]
    return run


def _outcome(out, e):
    return ([o if isinstance(o, list) else
             (type(o).__name__, o.phase, o.slot, o.layer, o.retryable,
              o.replica) for o in out], list(e.status), e.guard_trip_counts.tolist(),
            e.guard_hard_counts.tolist(), dict(e.guard_report))


SCENARIOS = {
    "quiet": ({"guard": True}, {"guard": True}),
    "transient": ({"guard": True, "fault": JFaultSpec(transient_mag=4.0),
                   "fault_slots": {1}},
                  {"guard": True, "fault": FaultSpec(transient_mag=4.0),
                   "fault_slots": {1}}),
    "pinned_twin": ({"guard": True, "pin_slots": {1}},
                    {"guard": True, "pin_slots": {1}}),
    "fail_after": ({"guard": True, "fault": JFaultSpec(transient_mag=4.0),
                    "fault_slots": {1}, "replica": "r0",
                    "degrade": JDegradePolicy(pin_after=None, fail_after=2)},
                   {"guard": True, "fault": FaultSpec(transient_mag=4.0),
                    "fault_slots": {1}, "replica": "r0",
                    "degrade": DegradePolicy(pin_after=None, fail_after=2)}),
    "segments": ({"guard": jguard.GuardSpec(segments=8),
                  "fault": JFaultSpec(transient_mag=4.0),
                  "fault_slots": {1}},
                 {"guard": guard.GuardSpec(segments=8),
                  "fault": FaultSpec(transient_mag=4.0),
                  "fault_slots": {1}}),
}


@pytest.mark.parametrize("name,use_kernel", [
    (name, False) for name in SCENARIOS] + [
    ("quiet", True), ("transient", True)])
def test_guarded_engine_equals_jax(setup, jax_runs, name, use_kernel):
    _, tp = setup
    jkw, tkw = SCENARIOS[name]
    want = _outcome(*jax_runs(name, use_kernel, cim_mode="sim", **jkw))
    e = Engine(_tiny(get_config, use_kernel), tp, max_slots=3, max_len=64,
               cim_mode="sim", seed=0, device="cpu", **tkw)
    out = e.generate(_reqs(Request))
    assert _outcome(out, e) == want
    assert not e.fused_step
    if name == "quiet":
        plain = Engine(_tiny(get_config, use_kernel), tp, max_slots=3,
                       max_len=64, cim_mode="sim", seed=0, device="cpu")
        assert out == plain.generate(_reqs(Request))
        assert e.guard_trip_counts.sum() == 0
    if name == "transient":
        off = Engine(_tiny(get_config, use_kernel), tp, max_slots=3,
                     max_len=64, cim_mode="off", seed=0, device="cpu")
        assert out[1] == off.generate(_reqs(Request))[1]
        assert e.guard_hard_counts.sum() > 0
    if name == "fail_after":
        assert isinstance(out[1], RequestError)
        assert out[1] is e.request_errors[1] and not out[1].retryable
        assert "hard-fail" in out[1].reason
        # the engine stamps its replica label on the failure, as the
        # reference's does
        assert out[1].replica == "r0" and str(out[1]).startswith("[r0:")


def test_engine_options_raise_as_the_reference(setup):
    jp, tp = setup
    jc, tc = _tiny(jget), _tiny(get_config)
    cases = [
        dict(cim_mode="off", guard=True),
        dict(cim_mode="sim", guard=True, fused_step=True),
        dict(cim_mode="sim", pin_slots={1}),
        dict(cim_mode="off", drift=DriftSpec(walk_gain_std=0.1)),
        dict(cim_mode="sim", calib=True),
        dict(cim_mode="sim", deploy=False, guard=True),
        dict(cim_mode="sim", deploy=False, calib=True,
             drift=DriftSpec(walk_gain_std=0.1)),
        dict(cim_mode="off", deploy=True),
    ]
    for kw in cases:
        jkw = dict(kw)
        if "drift" in jkw:
            from repro.core.drift import DriftSpec as JDriftSpec
            jkw["drift"] = JDriftSpec(walk_gain_std=0.1)
        with pytest.raises(Exception) as want:
            JEngine(jc, jp, max_len=64, **jkw)
        with pytest.raises(Exception) as got:
            Engine(tc, tp, max_len=64, device="cpu", **kw)
        assert got.type is want.type, (kw, got.value, want.value)
    with pytest.raises(ValueError, match="fuse_layer"):
        Engine(tc, tp, max_len=64, cim_mode="sim", fuse_layer=True,
               drift=DriftSpec(walk_gain_std=0.1), device="cpu")
    with pytest.raises(ValueError, match="not wired"):
        Engine(get_config("zamba2-7b").reduced(), None, cim_mode="sim",
               device="cpu", guard=True)
    with pytest.raises(ValueError, match="LoopEngine"):
        LoopEngine(tc, tp, drift=DriftSpec(walk_gain_std=0.1), device="cpu")
    # qat (ported) has no deployed planes, so a guard raises there too
    with pytest.raises(ValueError, match="guard requires cim_mode='sim'"):
        Engine(tc, tp, device="cpu", cim_mode="qat", guard=True)
    assert Engine(tc, tp, device="cpu", replica="r0").replica == JEngine(
        jc, jp, replica="r0").replica == "r0"
    # deploy=False serves sim mode on the float weights, quantized per
    # call: the deployed run's tokens, as in the reference
    kw = dict(max_slots=3, max_len=64, cim_mode="sim", seed=0,
              device="cpu")
    undeployed = Engine(tc, tp, deploy=False, drain_every=1, **kw)
    assert not undeployed.deployed and "wq6" not in \
        undeployed.params["blocks"]["mlp"]["up"]
    assert undeployed.generate(_reqs(Request)) == Engine(
        tc, tp, **kw).generate(_reqs(Request))
