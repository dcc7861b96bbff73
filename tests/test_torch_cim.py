"""The port's CIM noise figure and fused CIM matmul against the JAX package.

The plain version of the CUDA kernel (``cim_matmul_fused_plain``) must
equal ``cim_matmul_fused_pallas(interpret=True)`` and the oracle
``ref.cim_matmul_fused_ref`` exactly without noise, and within Box-Muller's
ulps with noise. The activation scale is fed in from JAX, so a rounding
flip at a quantization boundary is not counted as a kernel fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import cim as jcim
from repro.core import sac as jsac
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cim_matmul import cim_matmul_fused_pallas
from repro_torch.core import adc, cim, quant, sac
from repro_torch.kernels import ops
from repro_torch.kernels.cim_matmul import (cim_matmul_fused,
                                            cim_matmul_fused_plain)


@pytest.mark.parametrize("k", [256, 512, 896, 4864])
@pytest.mark.parametrize("role", ["attn", "mlp"])
def test_noise_std_per_tile_matches_jax(k, role):
    j = getattr(jsac.paper_sac(), role)
    t = getattr(sac.paper_sac(), role)
    a = jcim.output_noise_std_int_per_tile(j, k)
    b = cim.output_noise_std_int_per_tile(t, k)
    assert abs(a - b) <= 1e-5 * a


def test_adc_statistics_match_jax():
    spec_j, spec_t = jadc.ADCSpec(), adc.ADCSpec()
    np.testing.assert_allclose(adc.dac_bit_weights(spec_t).numpy(),
                               np.asarray(jadc.dac_bit_weights(spec_j)),
                               rtol=1e-6)
    np.testing.assert_allclose(adc.inl_curve(spec_t), jadc.inl_curve(spec_j),
                               rtol=0, atol=1e-5)
    for cb in (False, True):
        a = jadc.conversion_noise_lsb(spec_j, cb)
        b = adc.conversion_noise_lsb(spec_t, cb)
        assert abs(a - b) <= 1e-5 * a
    for cb in (False, True):
        d = np.linspace(-30, 30, 121).astype(np.float32)
        for votes in (1, 6):
            pj = jadc.majority_prob(jadc.decision_prob(
                jnp.asarray(d), 0.82, 0.18, 24.0), votes)
            pt = adc.majority_prob(adc.decision_prob(
                torch.from_numpy(d), 0.82, 0.18, 24.0), votes)
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj),
                                       rtol=1e-5, atol=1e-7)


def _operands(m, k, n, in_bits, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-31, 32, size=(k, n)).astype(np.int8)
    xs = np.float32(4.0 * np.sqrt(np.mean(x * x)) / quant.qmax(in_bits))
    return x, wq, xs


@pytest.mark.parametrize("m,k,n,in_bits", [(1, 256, 128, 4), (4, 896, 128, 4),
                                           (8, 1280, 96, 6), (32, 2100, 64, 6)])
def test_fused_plain_matches_pallas_and_ref(m, k, n, in_bits):
    x, wq, xs = _operands(m, k, n, in_bits)
    spec = sac.paper_sac().mlp if in_bits == 6 else sac.paper_sac().attn
    sigma = cim.output_noise_std_int_per_tile(spec, k)
    seed = (0x89ABCDEF, 0x01234567)
    jseed = jnp.asarray(np.array(seed, np.uint32).view(np.int32))
    qp = torch.tensor([xs, 0.0125], dtype=torch.float32)
    for s in (0.0, sigma):
        pal = np.asarray(cim_matmul_fused_pallas(
            jnp.asarray(x), jnp.asarray(wq), xs, jseed if s else None,
            sigma=s, in_bits=in_bits, scale=jnp.float32(0.0125),
            interpret=True))
        orc = np.asarray(jref.cim_matmul_fused_ref(
            jnp.asarray(x), jnp.asarray(wq), xs, jseed if s else None, s,
            1024, jnp.float32(0.0125), in_bits))
        pt = cim_matmul_fused_plain(torch.from_numpy(x), torch.from_numpy(wq),
                                    qp, seed if s else None, s,
                                    in_bits).numpy()
        if s == 0.0:
            np.testing.assert_array_equal(pt, pal)
            np.testing.assert_array_equal(pt, orc)
        else:
            # Box-Muller's log/cos ulps times sigma, per tile
            tol = 1e-6 * np.abs(orc).max() + 1e-5 * s * 0.0125
            np.testing.assert_allclose(pt, pal, rtol=0, atol=tol)
            np.testing.assert_allclose(pt, orc, rtol=0, atol=tol)


def test_deployed_matches_jax_ops():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 896)).astype(np.float32)
    wq = rng.integers(-7, 8, size=(896, 128)).astype(np.int8)
    ws = np.float32(0.031)
    xs = np.float32(4.0 * np.sqrt(np.mean(x * x)) / 7)
    for key in ((7, 11), None):
        jkey = None if key is None else jnp.asarray(np.array(key, np.uint32))
        j = np.asarray(jops.cim_matmul_deployed(
            jnp.asarray(x), jnp.asarray(wq), ws, jsac.paper_sac().attn,
            jkey, x_scale=jnp.asarray(xs), force="ref"))
        t = ops.cim_matmul_deployed(
            torch.from_numpy(x), torch.from_numpy(wq), torch.tensor(ws),
            sac.paper_sac().attn, key, x_scale=torch.tensor(xs)).numpy()
        assert t.shape == j.shape == (3, 5, 128)
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-6 * np.abs(j).max())


def test_wrapper_takes_plain_version_on_cpu():
    x, wq, xs = _operands(4, 256, 64, 4)
    before = cim_matmul_fused.launches
    qp = torch.tensor([xs, 1.0])
    a = cim_matmul_fused(torch.from_numpy(x), torch.from_numpy(wq), qp,
                         (1, 2), 3.0, 4)
    b = cim_matmul_fused_plain(torch.from_numpy(x), torch.from_numpy(wq), qp,
                               (1, 2), 3.0, 4)
    assert torch.equal(a, b)
    assert cim_matmul_fused.launches == before
