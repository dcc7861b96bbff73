"""The port's temporal drift (``core/drift.py``), online calibration and
canary watchdog (``core/calibrate.py``) and the engine's drift clock
against the JAX package on the same numpy-seeded inputs.

Held within a tolerance: the drift fields against ``ref.drift_fields_ref``
at steps on both sides of a supply epoch, and ``apply_drift`` with trims
against ``ref.apply_drift_ref``, within 1e-6 relative (the same Threefry
draws; ``sin`` differs in ulps); ``estimate_trims`` and the installed
trims within 1e-4 relative. Held exactly: the controller's event kinds and
steps, ``calibrations`` and ``watchdog_trips`` (calibration, canary trip,
escalation), the engine's drift events and greedy tokens against the JAX
engine over ROADMAP's short horizon, on the CIM kernel path (the step and
the trims read from device tensors, as a CUDA graph reads them), and the
option validation; port against port, a zero
drift and a drift step given as a tensor are bit-identical to none and to
the int."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import calibrate as jcal
from repro.core import drift as jdrift
from repro.core.cim import CIMSpec as JCIMSpec
from repro.kernels import ref as kref
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import calibrate, cim, drift, prng, quant
from repro_torch.core.deploy import deploy, params_from_jax
from repro_torch.kernels import ops
from repro_torch.serving.engine import Engine, Request

FULL = drift.DriftSpec(seed=11, walk_gain_std=0.05, walk_offset_std=1.5,
                       temp_gain_amp=0.03, temp_offset_amp=0.8,
                       temp_period=512, supply_gain_mag=0.1,
                       supply_offset_mag=6.0, supply_every=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jspec_of(d):
    return jdrift.DriftSpec(**dataclasses.asdict(d))


def close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))
    assert err <= rel, err


@pytest.mark.parametrize("step", [0, 1, 63, 64, 137, 4095, 65536])
def test_drift_fields_match_oracle(step):
    n = 96
    gain, off = kref.drift_fields_ref(jspec_of(FULL), n, step)
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        close(drift.drift_gain(FULL, n, s).numpy(), gain, 1e-6)
        close(drift.drift_offset_z(FULL, n, s).numpy(), off, 1e-6)
    # epoch 0 carries no supply level; the step past it does
    if step == 63:
        assert float(drift._supply_level(FULL, drift.TAG_SUPPLY_GAIN,
                                         step)) == 0.0
    if step == 64:
        assert float(drift._supply_level(FULL, drift.TAG_SUPPLY_GAIN,
                                         step)) != 0.0


def test_apply_drift_with_trims_and_zero_drift_identity():
    rng = np.random.default_rng(1)
    y = rng.normal(size=(5, 80)).astype(np.float32)
    tg = (1.0 + 0.05 * rng.normal(size=96)).astype(np.float32)
    to = rng.normal(size=96).astype(np.float32)
    for trims in ((None, None), (tg, to)):
        want = kref.apply_drift_ref(
            jnp.asarray(y), jspec_of(FULL), 0.4,
            (jnp.int32(200),) + tuple(None if t is None else jnp.asarray(t)
                                      for t in trims))
        got = drift.apply_drift(
            torch.from_numpy(y), FULL, 0.4,
            (200,) + tuple(None if t is None else torch.from_numpy(t)
                           for t in trims))
        close(got.numpy(), want, 1e-6)
    yt = torch.from_numpy(y)
    for spec, st in ((None, (5, None, None)), (drift.DriftSpec(seed=3),
                                              (5, None, None)), (FULL, None)):
        assert drift.apply_drift(yt, spec, 0.4, st) is yt


def test_zero_drift_is_bit_identical_in_both_sim_paths():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-31, 32, (128, 64)).astype(np.int8))
    ws = torch.tensor(1.0 / 31)
    key = prng.PRNGKey(4)
    zero = dataclasses.replace(cim.CIMSpec(), drift=drift.DriftSpec(seed=5))
    for spec, st in ((zero, (9, None, None)), (cim.CIMSpec(), None)):
        a = ops.cim_matmul_deployed(x, wq, ws, spec, key, dstate=st)
        b = ops.cim_matmul_deployed(x, wq, ws, cim.CIMSpec(), key)
        assert torch.equal(a, b)
        a = cim.cim_dense(x, None, spec, key, mode="sim", w_scale=ws, wq=wq,
                          dstate=st)
        b = cim.cim_dense(x, None, cim.CIMSpec(), key, mode="sim",
                          w_scale=ws, wq=wq)
        assert torch.equal(a, b)
    # the deployed drift is the field the fields give, in dequant units
    spec = dataclasses.replace(cim.CIMSpec(), drift=FULL)
    xs = quant.abs_max_scale(x, spec.in_bits)
    d = ops.cim_matmul_deployed(x, wq, ws, spec, key, x_scale=xs,
                                dstate=(321, None, None))
    d0 = ops.cim_matmul_deployed(x, wq, ws, spec, key, x_scale=xs)
    g = drift.drift_gain(FULL, 64, 321)
    oz = drift.drift_offset_z(FULL, 64, 321)
    sig = cim.output_noise_std_int(spec, 128) * (xs * ws)
    close((d - d0).numpy(), (d0 * (g - 1.0) + sig * oz).numpy(), 1e-5)


def test_estimate_trims_matches_jax():
    rng = np.random.default_rng(0)
    m, n, sigma = 256, 48, 0.2
    d = rng.normal(size=(m, n)).astype(np.float32)
    gain = 1.0 + 0.1 * rng.normal(size=n).astype(np.float32)
    off_z = 2.0 * rng.normal(size=n).astype(np.float32)
    y = (gain * d + sigma * off_z + sigma * rng.normal(size=(m, n))).astype(
        np.float32)
    jg, jo, jq = jcal.estimate_trims(jnp.asarray(y), jnp.asarray(d), sigma)
    g, o, q = calibrate.estimate_trims(torch.from_numpy(y),
                                       torch.from_numpy(d), sigma)
    close(g.numpy(), jg, 1e-4)
    close(o.numpy(), jo, 1e-4)
    close(q, jq, 1e-4)
    assert calibrate.detection_bound(calibrate.CalibPolicy()) == \
        jcal.detection_bound(jcal.CalibPolicy())


def _controllers(d, policy, n_cols, use_kernel):
    jc = jcal.DriftController(JCIMSpec(), jspec_of(d),
                              jcal.CalibPolicy(**dataclasses.asdict(policy)),
                              n_cols, use_kernel=use_kernel)
    tc = calibrate.DriftController(cim.CIMSpec(), d, policy, n_cols,
                                   use_kernel=use_kernel)
    return jc, tc


def _kinds(events):
    return [(e["kind"], e["step"]) for e in events]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_controller_events_and_trims_equal_jax(use_kernel):
    """A supply step under a canary: the initial calibration, the
    watchdog trip within the detection bound and the recalibration, with
    the same kinds and steps as the reference's controller, and trims
    within 1e-4."""
    every = 30
    d = drift.DriftSpec(seed=7, walk_gain_std=0.1, supply_offset_mag=20.0,
                        supply_every=every)
    pol = calibrate.CalibPolicy(probe_rows=32, probe_chunk=16, probe_k=128,
                                every_steps=10 ** 6, canary_every=3)
    jc, tc = _controllers(d, pol, 64, use_kernel)
    je, te = [], []
    for step in range(every + calibrate.detection_bound(pol) + 4):
        je += jc.tick(step)
        te += tc.tick(step)
    assert _kinds(te) == _kinds(je)
    assert "watchdog_trip" in [k for k, _ in _kinds(te)]
    assert (tc.calibrations, tc.watchdog_trips) == (jc.calibrations,
                                                    jc.watchdog_trips)
    close(tc.trim_gain.numpy(), jc.trim_gain, 1e-4)
    close(tc.trim_off.numpy(), jc.trim_off, 1e-4)


def test_controller_escalates_as_jax():
    pol = calibrate.CalibPolicy(probe_rows=16, probe_chunk=16, probe_k=64,
                                every_steps=10 ** 6, max_recals=1)
    jc, tc = _controllers(drift.DriftSpec(seed=0, walk_gain_std=0.1), pol,
                          32, True)
    poison = 1e3 * np.sign(np.random.default_rng(0).normal(
        size=jc._digital.shape)).astype(np.float32)
    jc._digital = jc._digital + poison
    tc._digital = tc._digital + poison
    je, te = [], []
    for step in range(64):
        je += jc.tick(step)
        te += tc.tick(step)
    assert _kinds(te) == _kinds(je)
    assert [k for k, _ in _kinds(te)].count("escalate") == 1
    assert tc.escalated and tc.tick(1000) == []


def _tiny(get, use_kernel):
    cfg = get("qwen2-0.5b").reduced()
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, d_ff=256, vocab_size=128, n_heads=4,
        n_kv_heads=2, head_dim=32,
        cim=dataclasses.replace(cfg.cim, use_kernel=use_kernel))


@pytest.fixture(scope="module")
def lm():
    jp, _ = jbuild(_tiny(jget, True)).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _reqs(cls, toks=5):
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(1, 127, size=n).astype(np.int32),
                max_new_tokens=toks) for n in (7, 11)]


ENGINE_DRIFT = dict(seed=3, walk_gain_std=0.02, walk_offset_std=0.5,
                    supply_offset_mag=8.0, supply_every=16)
ENGINE_CALIB = dict(probe_rows=16, probe_chunk=16, probe_k=128,
                    every_steps=32, canary_every=4)


def test_engine_drift_tokens_and_events_equal_jax(lm):
    """Two sessions across the supply step at 16, on the CIM kernel path:
    tokens, the drift events' kinds and steps, calibrations, watchdog
    trips and the clock, port against the reference; a zero drift is
    bit-identical to none."""
    jp, tp = lm
    use_kernel = True
    kw = dict(max_slots=2, max_len=48, cim_mode="sim", seed=0, chunk_size=8)
    j = JEngine(_tiny(jget, use_kernel), jp, fused_step=False,
                drift=jdrift.DriftSpec(**ENGINE_DRIFT),
                calib=jcal.CalibPolicy(**ENGINE_CALIB), **kw)
    t = Engine(_tiny(get_config, use_kernel), tp, device="cpu",
               drift=drift.DriftSpec(**ENGINE_DRIFT),
               calib=calibrate.CalibPolicy(**ENGINE_CALIB), **kw)
    for toks in (5, 12):
        assert t.generate(_reqs(Request, toks)) == j.generate(
            _reqs(JRequest, toks))
    assert _kinds(t.take_drift_events()) == _kinds(j.take_drift_events())
    assert t.take_drift_events() == []
    assert (t.calibrations, t.watchdog_trips, t.drift_step) == (
        j.calibrations, j.watchdog_trips, j.drift_step)
    assert t.calibrations >= 1 and t.drift_step > 16
    assert t.fused_step == use_kernel     # captured on the card
    base = Engine(_tiny(get_config, use_kernel), tp, device="cpu", **kw)
    zero = Engine(_tiny(get_config, use_kernel), tp, device="cpu",
                  drift=drift.DriftSpec(seed=5), **kw)
    assert base.generate(_reqs(Request)) == zero.generate(_reqs(Request))


def test_max_plane_width_and_engine_validation(lm):
    jp, tp = lm
    cfg = _tiny(get_config, True)
    assert calibrate.max_plane_width(deploy(cfg, tp)) == cfg.d_ff
    with pytest.raises(ValueError, match="sim"):
        Engine(cfg, tp, cim_mode="off", drift=FULL, device="cpu")
    with pytest.raises(ValueError, match="drift"):
        Engine(cfg, tp, cim_mode="sim", calib=True, device="cpu")
    with pytest.raises(ValueError, match="must be"):
        drift.DriftSpec(temp_period=0)
    with pytest.raises(ValueError, match="every_steps"):
        calibrate.CalibPolicy(every_steps=0)
