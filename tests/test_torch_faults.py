"""The port's structural-fault layer (``core/faults.py`` and the fault
epilogues of ``core/adc.py``, ``core/cim.py``, ``kernels/ops.py`` and
``core/deploy.py``) against the JAX package on the same numpy-seeded
inputs.

Held exactly: the stuck-at planes (against ``faults.stuck_bit_plane`` and
the oracle ``ref.stuck_bit_plane_ref``, over rates, bit-widths and seeds,
and a stacked plane drawn a layer at a time), the stuck ADC columns and
the brownout bits, the ``sar_convert(fault=)`` codes (against the
reference and ``ref.sar_convert_fault_ref``), the deployed planes ``wq``,
``ws`` and the checksums ``wc`` of ``deploy(fault=, guard=)`` with one
and with G segments on the reduced qwen2 and mamba2, and the engine's
greedy tokens under runtime faults (the brownout keyed through the staged
fold table). Held within a tolerance: the output epilogues (the column
normals and the brownout normal are ``jax.random.normal``, replayed within
3 ulp, ROADMAP C4) within 1e-6 relative, and the bit-exact engine with
faults on at least 99.9 % of its outputs (ROADMAP C2). An empty
``FaultSpec`` is bit-identical to none, port against port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import adc as jadc
from repro.core import cim as jcim
from repro.core import faults as jfaults
from repro.core.deploy import deploy as jdeploy
from repro.core.guard import GuardSpec as JGuardSpec
from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import adc, cim, faults, prng, quant
from repro_torch.core.deploy import deploy, params_from_jax, stuck_plane
from repro_torch.core.guard import GuardSpec
from repro_torch.kernels import ops
from repro_torch.serving.engine import Engine, Request

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jfault(f: faults.FaultSpec) -> jfaults.FaultSpec:
    return jfaults.FaultSpec(**dataclasses.asdict(f))


def jkey(key):
    return jnp.asarray(np.array(key, np.uint32))


def close(a, b, rel=REL, atol=0.0):
    """Within ``rel`` of each value (of 1 below 1) plus ``atol``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    excess = np.abs(a - b) - atol - rel * np.maximum(np.abs(b), 1.0)
    assert excess.max() <= 0.0, excess.max()


RUNTIME = faults.FaultSpec(seed=5, col_gain_std=0.1, col_offset_std=2.0,
                           brownout_rate=0.3, brownout_votes=1,
                           adc_stuck_rate=0.2, adc_stuck_code=700)


@pytest.mark.parametrize("bits,rate,seed", [
    (4, 0.05, 0), (6, 0.3, 7), (6, 1e-3, 1), (8, 0.01, 3)])
def test_stuck_planes_exact(bits, rate, seed):
    rng = np.random.default_rng(seed)
    q = quant.qmax(bits)
    w = rng.integers(-q, q + 1, (3, 48, 40)).astype(np.int8)
    key = prng.PRNGKey(seed)
    want = np.asarray(jfaults.stuck_bit_plane(jnp.asarray(w), bits, rate,
                                              jkey(key)))
    np.testing.assert_array_equal(want, np.asarray(kref.stuck_bit_plane_ref(
        jnp.asarray(w), bits, rate, jkey(key))))
    got = faults.stuck_bit_plane(torch.from_numpy(w), bits, rate, key)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # the stacked plane a layer at a time (its flat offset into the draw)
    np.testing.assert_array_equal(stuck_plane(
        torch.from_numpy(w), bits, faults.FaultSpec(stuck_rate=rate),
        key).numpy(), want)
    assert faults.stuck_bit_plane(torch.from_numpy(w), bits, 0.0,
                                  key).numpy().tolist() == w.tolist()


def test_adc_stuck_columns_and_brownout_bits_exact():
    for seed, rate in ((5, 0.2), (11, 0.01)):
        f = dataclasses.replace(RUNTIME, seed=seed, adc_stuck_rate=rate)
        np.testing.assert_array_equal(
            faults.adc_stuck_cols(f, 300).numpy(),
            np.asarray(jfaults.adc_stuck_cols(jfault(f), 300)))
        idx = np.arange(5000, dtype=np.uint32)
        for k0, k1 in ((0x1234, 0xBEEF), (0xFFFFFFFF, 7)):
            want = jfaults.brownout_mask(jfault(f), jnp.uint32(k0),
                                         jnp.uint32(k1), jnp.asarray(idx))
            got = faults.brownout_mask(f, k0, k1,
                                       torch.from_numpy(idx.astype(np.int64)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert faults.adc_stuck_cols(faults.FaultSpec(), 8) is None


@pytest.mark.parametrize("cb", [False, True])
def test_sar_convert_fault_codes_exact(cb):
    rng = np.random.default_rng(3)
    v = rng.uniform(-2.0, 1030.0, (4, 12, 33)).astype(np.float32)
    key = prng.PRNGKey(17)
    for f in (RUNTIME, dataclasses.replace(RUNTIME, brownout_votes=3,
                                           adc_stuck_rate=0.0)):
        want = np.asarray(jadc.sar_convert(jnp.asarray(v), jkey(key),
                                           jadc.ADCSpec(), cb,
                                           fault=jfault(f)))
        np.testing.assert_array_equal(want, np.asarray(
            kref.sar_convert_fault_ref(jnp.asarray(v), jkey(key),
                                       jadc.ADCSpec(), cb, jfault(f))))
        got = adc.sar_convert(torch.from_numpy(v), key, adc.ADCSpec(), cb,
                              fault=f)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fault_values_and_output_epilogue():
    spec = dataclasses.replace(cim.CIMSpec(), fault=RUNTIME)
    jspec = dataclasses.replace(jcim.CIMSpec(), fault=jfault(RUNTIME))
    for k in (96, 1500):
        assert cim.adc_stuck_value_int(spec, k) == \
            jcim.adc_stuck_value_int(jspec, k)
        close(cim.brownout_extra_std_int(spec, k),
              jcim.brownout_extra_std_int(jspec, k))
    assert cim.brownout_extra_std_int(
        dataclasses.replace(spec, cb=False), 96) == 0.0
    rng = np.random.default_rng(4)
    y = rng.normal(size=(6, 50)).astype(np.float32)
    key = prng.PRNGKey(9)
    want = kref.apply_output_faults_ref(
        jnp.asarray(y), jfault(RUNTIME), 0.3, 5.0, 0.7,
        key=jax.random.fold_in(jkey(key), 0x0FA1))
    got = faults.apply_output_faults(torch.from_numpy(y), RUNTIME, 0.3, 5.0,
                                     0.7, key=prng.fold_in(key, 0x0FA1))
    close(got.numpy(), want)
    # stuck columns are replaced exactly; a key given as device words
    # (a seed-table row's fold) draws the same brownout normal
    stuck = faults.adc_stuck_cols(RUNTIME, 50).numpy()
    assert stuck.any() and (got.numpy()[:, stuck] == 5.0).all()
    k2 = prng.fold_in(key, 0x0FA1)
    table = torch.tensor([[k2[0], k2[1]]], dtype=torch.int64).to(
        torch.int32)
    row = prng.SeedRow(table, 0, {0x0FA1: table})
    assert prng.fold_seed(row, 0x0FA1)[0].dtype == torch.int64
    np.testing.assert_array_equal(
        prng.normal(prng.fold_seed(row, 0x0FA1), (6, 50)).numpy(),
        prng.normal(k2, (6, 50)).numpy())


def test_behavioural_deployed_and_bit_exact_fault_paths():
    rng = np.random.default_rng(5)
    k, n = 200, 48
    x = rng.normal(size=(5, k)).astype(np.float32)
    q = quant.qmax(6)
    wq = rng.integers(-q, q + 1, (k, n)).astype(np.int8)
    ws = np.float32(0.02)
    key = prng.PRNGKey(3)
    spec = dataclasses.replace(cim.CIMSpec(), fault=RUNTIME)
    jspec = dataclasses.replace(jcim.CIMSpec(), fault=jfault(RUNTIME))
    xs = quant.abs_max_scale(torch.from_numpy(x), 6)
    xq = quant.quantize(torch.from_numpy(x), xs, 6).to(torch.int32)
    got = cim.cim_matmul_behavioral(xq, torch.from_numpy(wq).to(torch.int32),
                                    key, spec)
    want = jcim.cim_matmul_behavioral(jnp.asarray(xq.numpy()),
                                      jnp.asarray(wq, jnp.int32), jkey(key),
                                      jspec)
    # the whole-K normals (healthy and brownout) within 3 ulp (C4): 4e-6
    # of their sigmas
    sig = cim.output_noise_std_int(spec, k) + cim.brownout_extra_std_int(
        spec, k)
    close(got.numpy(), want, atol=4e-6 * sig)
    got = ops.cim_matmul_deployed(torch.from_numpy(x), torch.from_numpy(wq),
                                  torch.tensor(ws), spec, key, x_scale=xs)
    want = jops.cim_matmul_deployed(jnp.asarray(x), jnp.asarray(wq),
                                    jnp.float32(ws), jspec, jkey(key),
                                    x_scale=jnp.asarray(xs.numpy()))
    close(got.numpy(), want)
    bspec = dataclasses.replace(spec, fault=dataclasses.replace(
        RUNTIME, brownout_votes=2))
    got = cim.cim_matmul_bit_exact(xq[:, :96], torch.from_numpy(
        wq[:96]).to(torch.int32), key, bspec).numpy()
    want = np.asarray(jcim.cim_matmul_bit_exact(
        jnp.asarray(xq[:, :96].numpy()), jnp.asarray(wq[:96], jnp.int32),
        jkey(key), dataclasses.replace(jspec, fault=jfault(bspec.fault))))
    assert np.mean(np.abs(got - want) <= 1e-3 * np.abs(want).max()) >= 0.999


def test_empty_faultspec_is_bit_identical_to_none():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 4, 96)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-31, 32, (96, 40)).astype(np.int8))
    key = prng.PRNGKey(2)
    for use in ("behavioural", "deployed"):
        outs = []
        for f in (None, faults.FaultSpec(seed=9)):
            spec = dataclasses.replace(cim.CIMSpec(), fault=f)
            if use == "deployed":
                outs.append(ops.cim_matmul_deployed(x, wq, torch.tensor(0.03),
                                                    spec, key))
            else:
                outs.append(cim.cim_dense(x, None, spec, key, mode="sim",
                                          w_scale=torch.tensor(0.03), wq=wq))
        assert torch.equal(outs[0], outs[1]), use


def _tiny(get, arch):
    cfg = get(arch).reduced()
    if arch == "qwen2-0.5b":
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=256,
                                  vocab_size=128, n_heads=4, n_kv_heads=2,
                                  head_dim=32)
    return cfg


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_deploy_fault_and_guard_planes_exact(arch):
    jc = _tiny(jget, arch)
    jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tc = _tiny(get_config, arch)
    f = faults.FaultSpec(seed=4, stuck_rate=0.02)
    for seg in (1, 8):
        jg = JGuardSpec(segments=seg) if seg > 1 else True
        tg = GuardSpec(segments=seg) if seg > 1 else True
        want = jdeploy(jc, jp, fault=jfault(f), guard=jg)
        got = deploy(tc, tp, fault=f, guard=tg)
        seen = 0

        def walk(a, b, path):
            nonlocal seen
            for name, leaf in a.items():
                if isinstance(leaf, dict):
                    walk(leaf, b[name], path + (name,))
                elif name[:2] in ("wq", "ws", "wc"):
                    seen += name.startswith("wc")
                    np.testing.assert_array_equal(
                        np.asarray(leaf.float() if leaf.dtype ==
                                   torch.bfloat16 else leaf),
                        np.asarray(b[name], np.float64 if name[:2] == "ws"
                                   else None), err_msg=str(path + (name,)))
        walk(got, want, ())
        assert seen >= 2
        # the clean checksum: the faulted plane's sums differ from it
        wc = got["blocks"]["mlp" if arch == "qwen2-0.5b" else "mamba"][
            "down" if arch == "qwen2-0.5b" else "in_proj"]
        assert not torch.equal(
            wc[[n for n in wc if n.startswith("wc")][0]].sum(-1)
            if seg > 1 else wc[[n for n in wc if n.startswith("wc")][0]],
            wc[[n for n in wc if n.startswith("wq")][0]].to(
                torch.int32).sum(-1))


def test_engine_runtime_faults_tokens_equal_jax():
    """Faults without a guard on the CIM kernel path: the port's engine
    (the brownout normal under the staged fold table) gives the JAX
    engine's greedy tokens."""
    spec = dict(seed=2, col_gain_std=0.02, col_offset_std=0.5,
                brownout_rate=0.05, adc_stuck_rate=0.01, adc_stuck_code=520)
    outs = []
    for get, cls, eng, fs in ((jget, JRequest, JEngine, jfaults.FaultSpec),
                              (get_config, Request, Engine,
                               faults.FaultSpec)):
        cfg = _tiny(get, "qwen2-0.5b")
        cfg = dataclasses.replace(cfg, cim=dataclasses.replace(
            cfg.cim, use_kernel=True))
        if get is jget:
            jp, _ = jbuild(cfg).init(jax.random.PRNGKey(0))
            params, kw = jp, {"fused_step": False}
        else:
            params = params_from_jax(jax.tree.map(np.asarray, jp))
            kw = {"device": "cpu"}
        e = eng(cfg, params, max_slots=2, max_len=48, cim_mode="sim",
                chunk_size=8, fault=fs(**spec), **kw)
        rng = np.random.default_rng(0)
        outs.append(e.generate([cls(prompt=rng.integers(1, 127, n)
                                    .astype(np.int32), max_new_tokens=5)
                                for n in (7, 11)]))
    assert outs[0] == outs[1]
    assert 0x0FA1 in e._folds and e._width   # the table path drew the
                                             # brownout
