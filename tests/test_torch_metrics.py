"""The port's paper-metrics path against the JAX package.

``prng.randint``, ``adc.sar_convert`` (for JAX's own analog values),
``quant.unsigned_bitplanes`` and the plane partial sums of
``cim.cim_matmul_bit_exact`` are held bit for bit or to f32 rounding; the
engine's output equals the reference's on at least 99.9 % of elements
(ROADMAP C2: an ulp of a partial sum can flip a comparator decision). The
five metric functions run at reduced sizes and agree within 0.02 dB and
1e-4 LSB; the energy model (pure Python) within 1e-9 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import cim as jcim
from repro.core import energy as jenergy
from repro.core import metrics as jmetrics
from repro.core import quant as jquant
from repro.core import sac as jsac
from repro_torch.core import adc, cim, energy, metrics, prng, quant, sac

SPECS = {  # the metrics' operating point and the attention class's
    "mlp6_cb": (jcim.CIMSpec(), cim.CIMSpec()),
    "attn4": (jcim.CIMSpec(in_bits=4, w_bits=4, cb=False),
              cim.CIMSpec(in_bits=4, w_bits=4, cb=False)),
}


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("seed", [0, 5])
def test_randint_bit_exact(bits, seed):
    q = 2 ** (bits - 1) - 1
    shape = (37, 129)
    for key in (prng.PRNGKey(seed), prng.split(prng.PRNGKey(seed), 3)[1]):
        jkey = jnp.asarray(np.array(key, np.uint32))
        for lo, hi in ((-q, q + 1), (0, 2 ** bits)):
            a = np.asarray(jax.random.randint(jkey, shape, lo, hi))
            b = prng.randint(key, shape, lo, hi).numpy()
            assert b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_unsigned_bitplanes_and_weights(bits):
    q = 2 ** (bits - 1) - 1
    xi = np.random.default_rng(bits).integers(-q, q + 1, (33, 17)).astype(
        np.int32)
    np.testing.assert_array_equal(
        quant.unsigned_bitplanes(torch.from_numpy(xi), bits).numpy(),
        np.asarray(jquant.unsigned_bitplanes(jnp.asarray(xi), bits)))
    np.testing.assert_array_equal(quant.plane_weights(bits).numpy(),
                                  np.asarray(jquant.plane_weights(bits)))
    assert quant.sum_sq_plane_weights(bits) == \
        jquant.sum_sq_plane_weights(bits)


@pytest.mark.parametrize("cb", [False, True])
def test_sar_convert_codes_exact_for_jax_v(cb):
    rng = np.random.default_rng(3)
    v = rng.uniform(-2.0, 1030.0, (6, 40, 33)).astype(np.float32)
    key = prng.PRNGKey(17)
    jkey = jnp.asarray(np.array(key, np.uint32))
    for spec_j, spec_t in ((jadc.ADCSpec(), adc.ADCSpec()),
                           (jcim.CIMSpec(scheme="conventional")
                            .effective_adc(),
                            cim.CIMSpec(scheme="conventional")
                            .effective_adc())):
        a = np.asarray(jadc.sar_convert(jnp.asarray(v), jkey, spec_j, cb))
        b = adc.sar_convert(torch.from_numpy(v), key, spec_t, cb)
        assert b.dtype == torch.int32 and b.shape == v.shape
        np.testing.assert_array_equal(a, b.numpy())


def test_adc_levels_and_noise_variances():
    spec_j, spec_t = jadc.ADCSpec(), adc.ADCSpec()
    codes = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(
        adc.dac_level(torch.from_numpy(codes), spec_t).numpy(),
        np.asarray(jadc.dac_level(jnp.asarray(codes), spec_j)))
    for cb in (False, True):
        a = jadc.adc_noise_error_var_lsb2(spec_j, cb)
        assert abs(adc.adc_noise_error_var_lsb2(spec_t, cb) - a) <= 1e-6 * a
    for name, (sj, st) in SPECS.items():
        for k in (384, 1024, 1536):
            for static in (False, True):
                a = jcim.output_noise_std_int(sj, k, include_static=static)
                b = cim.output_noise_std_int(st, k, include_static=static)
                assert abs(a - b) <= 1e-6 * a, (name, k, static)


@pytest.mark.parametrize("k", [640, 1024, 2048])
def test_bit_exact_engine_matches_jax(k):
    spec_j, spec_t = SPECS["mlp6_cb"]
    rng = np.random.default_rng(k)
    m, n = 48, 24
    xq = rng.integers(-31, 32, (m, k)).astype(np.int32)
    wq = rng.integers(-31, 32, (k, n)).astype(np.int32)
    # the plane partial sums: the reference's einsum over the same drive
    t = -(-k // 1024)
    xp = jnp.pad(jnp.asarray(xq), ((0, 0), (0, t * 1024 - k)))
    wp = jnp.pad(jnp.asarray(wq), ((0, t * 1024 - k), (0, 0)))
    s_j = np.asarray(jnp.einsum(
        "mtr,jtrn->tjmn", (xp.astype(jnp.float32) / 31).reshape(m, t, 1024),
        jquant.unsigned_bitplanes(wp, 6).reshape(6, t, 1024, n)
        .astype(jnp.float32)))
    s_t = cim.plane_sums(torch.from_numpy(xq), torch.from_numpy(wq),
                         spec_t).numpy()
    assert np.all(np.abs(s_t - s_j) <= 1e-5 * np.abs(s_j).max())
    key = prng.PRNGKey(3)
    y_j = np.asarray(jcim.cim_matmul_bit_exact(
        jnp.asarray(xq), jnp.asarray(wq),
        jnp.asarray(np.array(key, np.uint32)), spec_j))
    y_t = cim.cim_matmul_bit_exact(torch.from_numpy(xq),
                                   torch.from_numpy(wq), key, spec_t).numpy()
    assert np.mean(y_t == y_j) >= 0.999
    # an element that differs is a comparator decision flipped by an ulp
    # of its partial sum: one LSB of one conversion at most
    step = 2 ** 5 * 31 / spec_t.analog_gain(rows=k)
    assert np.abs(y_t - y_j).max() <= 1.01 * step


def test_bit_exact_engine_4bit_within_ulps():
    """The attention class (4-bit planes): XLA picks another summation
    order for a 4-long contraction, so the outputs agree to f32 rounding."""
    spec_j, spec_t = SPECS["attn4"]
    rng = np.random.default_rng(5)
    xq = rng.integers(-7, 8, (32, 640)).astype(np.int32)
    wq = rng.integers(-7, 8, (640, 16)).astype(np.int32)
    key = prng.PRNGKey(4)
    y_j = np.asarray(jcim.cim_matmul_bit_exact(
        jnp.asarray(xq), jnp.asarray(wq),
        jnp.asarray(np.array(key, np.uint32)), spec_j))
    y_t = cim.cim_matmul_bit_exact(torch.from_numpy(xq),
                                   torch.from_numpy(wq), key,
                                   spec_t).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=4e-6 * np.abs(y_j).max())


@pytest.mark.parametrize("name", ["mlp6_cb", "attn4"])
def test_metric_functions_match_jax(name):
    sj, st = SPECS[name]
    a = jmetrics.measure_sqnr_db(sj, n_samples=2048)
    assert abs(metrics.measure_sqnr_db(st, n_samples=2048, device="cpu")
               - a) <= 0.02
    a = jmetrics.measure_csnr_db(sj, m=16, n=8, reps=4)
    assert abs(metrics.measure_csnr_db(st, m=16, n=8, reps=4, device="cpu")
               - a) <= 0.02
    a = jmetrics.measure_total_csnr_db(sj, m=16, n=8)
    assert abs(metrics.measure_total_csnr_db(st, m=16, n=8, device="cpu")
               - a) <= 0.02
    cj = jmetrics.column_characteristics(sj, n_codes=32, reps=16)
    ct = metrics.column_characteristics(st, n_codes=32, reps=16,
                                        device="cpu")
    # jnp.linspace's grid as XLA folds it: equal to f32 rounding
    np.testing.assert_allclose(ct["v"], cj["v"], rtol=2e-7, atol=0)
    for f in ("mean_code", "noise_lsb", "inl"):
        np.testing.assert_allclose(ct[f], cj[f], rtol=0, atol=1e-4)
    nj, ij = jmetrics.noise_summary(sj)
    nt, it = metrics.noise_summary(st, device="cpu")
    assert abs(nt - nj) <= 1e-4 and abs(it - ij) <= 1e-4


def test_energy_summary_and_trace_energies():
    a, b = jenergy.summary(), energy.summary()
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-9 * abs(a[k]), k
    em_j, em_t = jenergy.calibrated_model(), energy.calibrated_model()
    for trace_args in ({}, {"seq": 17, "d": 128, "depth": 3}):
        tj = jenergy.vit_small_linear_trace(**trace_args)
        tt = energy.vit_small_linear_trace(**trace_args)
        assert tj == tt
        for pol in (p for p in jsac.POLICIES if p != "none"):
            ej = jenergy.trace_energy(tj, jsac.get_policy(pol), em_j)
            et = energy.trace_energy(tt, sac.get_policy(pol), em_t)
            assert abs(ej - et) <= 1e-9 * abs(ej), pol
    for spec_j, spec_t in list(SPECS.values()) + [
            (jcim.CIMSpec(comparator="lownoise", in_bits=8, w_bits=8),
             cim.CIMSpec(comparator="lownoise", in_bits=8, w_bits=8)),
            (dataclasses.replace(jcim.CIMSpec(), scheme="conventional"),
             dataclasses.replace(cim.CIMSpec(), scheme="conventional"))]:
        for f in ("tops_per_watt", "tops", "conversion_energy",
                  "output_tile_energy", "output_tile_time"):
            x, y = getattr(em_j, f)(spec_j), getattr(em_t, f)(spec_t)
            assert abs(x - y) <= 1e-9 * abs(x), f
    assert energy.snr_fom(818e12, 45.3) == jenergy.snr_fom(818e12, 45.3)
