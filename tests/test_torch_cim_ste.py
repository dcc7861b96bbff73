"""The port's int8 CIM matmul and straight-through ops against the JAX package.

``cim_matmul_int8_plain`` (the plain version of the int8 CUDA kernel) must
equal ``ref.cim_matmul_prng_ref`` and ``cim_matmul_pallas(interpret=True)``
exactly without noise; with noise within rtol 5e-6 and atol 2e-3 * scale,
the slack of the JAX package's own kernel tests (Box-Muller's log/cos ulps
and fused multiply-adds in one lowering but not the other).
``ops.cim_matmul_int`` and ``ops.cim_matmul`` are held against their JAX
twins: the forward with a key, the straight-through gradients of ``.sum()``
within rtol 1e-6 (plus, where a gradient's sum cancels, the bound of f32
summation in another order: n * 2^-24 * sum of |terms| over its n terms;
torch's and XLA's CPU products add in different orders), batched input, and
operands above 8 bits raising. Against the dequantized products computed
with torch the gradients hold within rtol 1e-6 alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim as jcim
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cim_matmul import cim_matmul_pallas
from repro_torch.core import cim, prng, quant
from repro_torch.kernels import ops
from repro_torch.kernels._attn import SM_COUNT
from repro_torch.kernels.cim_matmul import (INT8_BLOCK_N, cim_int8_plan,
                                            cim_matmul_int8,
                                            cim_matmul_int8_plain,
                                            resolve_seed)

SHAPES = [(8, 512, 8), (64, 1024, 32), (100, 2048, 130), (1, 1024, 1),
          (5, 1024 + 61, 3)]
PAIR = (0x89ABCDEF, 0x01234567)


def _operands(m, k, n, lim=31, seed=0):
    rng = np.random.default_rng(seed + m * 7 + k + n)
    xq = rng.integers(-lim, lim + 1, size=(m, k)).astype(np.int8)
    wq = rng.integers(-lim, lim + 1, size=(k, n)).astype(np.int8)
    return xq, wq


def _jseed(seed):
    if isinstance(seed, tuple):
        return jnp.asarray(np.array(seed, np.uint32).view(np.int32))
    return jnp.int32(seed)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("seed", [1234, -7, PAIR])
def test_int8_plain_matches_ref_and_pallas(m, k, n, seed):
    xq, wq = _operands(m, k, n)
    scale = 0.0125
    txq, twq = torch.from_numpy(xq), torch.from_numpy(wq)
    # noiseless: exact against both
    y0 = cim_matmul_int8_plain(txq, twq, None, 0.0, scale).numpy()
    r0 = np.asarray(jref.cim_matmul_prng_ref(jnp.asarray(xq), jnp.asarray(wq),
                                             None, 0.0, 1024, scale))
    p0 = np.asarray(cim_matmul_pallas(jnp.asarray(xq), jnp.asarray(wq), None,
                                      sigma=0.0, scale=scale, interpret=True))
    np.testing.assert_array_equal(y0, r0)
    np.testing.assert_array_equal(y0, p0)
    sigma = 2.5
    y = cim_matmul_int8_plain(txq, twq, seed, sigma, scale).numpy()
    r = np.asarray(jref.cim_matmul_prng_ref(jnp.asarray(xq), jnp.asarray(wq),
                                            _jseed(seed), sigma, 1024, scale))
    p = np.asarray(cim_matmul_pallas(jnp.asarray(xq), jnp.asarray(wq),
                                     _jseed(seed), sigma=sigma, scale=scale,
                                     interpret=True))
    np.testing.assert_allclose(y, r, rtol=5e-6, atol=2e-3 * scale)
    np.testing.assert_allclose(y, p, rtol=5e-6, atol=2e-3 * scale)
    assert not np.array_equal(y, y0)        # the noise is there


@pytest.mark.parametrize("kt,s", [(1, 11), (2, 60), (3, 96)])
def test_int8_plain_ragged_k_full_range(kt, s):
    """K = kt * 512 + s (ragged last tile), operands over the whole int8
    range: the tile sums stay exact integers in f32."""
    m, k, n = 17, kt * 512 + s, 33
    xq, wq = _operands(m, k, n, lim=127, seed=s)
    y = cim_matmul_int8_plain(torch.from_numpy(xq), torch.from_numpy(wq),
                              s, 1.7).numpy()
    r = np.asarray(jref.cim_matmul_prng_ref(jnp.asarray(xq), jnp.asarray(wq),
                                            s, 1.7, 1024))
    np.testing.assert_allclose(y, r, rtol=5e-6, atol=2e-3)


def test_resolve_seed_words():
    assert resolve_seed(None) is None
    assert resolve_seed(5) == (5, 0)
    assert resolve_seed(-1) == (0xFFFFFFFF, 0)
    assert resolve_seed((3, -2)) == (3, 0xFFFFFFFE)
    assert resolve_seed(np.array([7, -8], np.int32)) == (7, 0xFFFFFFF8)
    with pytest.raises(ValueError):
        resolve_seed((1, 2, 3))


def test_cim_matmul_int_matches_jax_ref_dispatch():
    xq, wq = _operands(32, 1536, 24)
    sigma, scale = 2.5, 0.01
    y = ops.cim_matmul_int(torch.from_numpy(xq), torch.from_numpy(wq), 99,
                           sigma, scale=scale).numpy()
    r = np.asarray(jops.cim_matmul_int(jnp.asarray(xq), jnp.asarray(wq),
                                       jnp.int32(99), sigma, scale=scale,
                                       force="ref"))
    np.testing.assert_allclose(y, r, rtol=5e-6, atol=2e-3 * scale)
    # the CPU path is the plain version, by the tensor's device alone
    assert cim_matmul_int8.launches == 0


def _sum_close(actual, ref, abs_terms, n):
    """|actual - ref| <= 1e-6 |ref| + n * 2^-24 * abs_terms, elementwise."""
    bound = 1e-6 * np.abs(ref) + n * 2.0 ** -24 * abs_terms
    err = np.abs(actual - ref)
    assert np.all(err <= bound), float((err / bound).max())


def _specs():
    return {"default": (jcim.CIMSpec(), cim.CIMSpec()),
            "attn4b": (jcim.CIMSpec(in_bits=4, w_bits=4, cb=False),
                       cim.CIMSpec(in_bits=4, w_bits=4, cb=False))}


@pytest.mark.parametrize("name", ["default", "attn4b"])
def test_cim_matmul_forward_and_ste_grads_match_jax(name):
    jspec, tspec = _specs()[name]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 1024)).astype(np.float32)
    w = rng.normal(size=(1024, 8)).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    tkey = prng.fold_in(prng.PRNGKey(5), 2)
    assert tuple(int(v) for v in np.asarray(jax.random.key_data(jkey))) == tkey
    yj = np.asarray(jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), jspec,
                                    jkey))
    yt = ops.cim_matmul(torch.from_numpy(x), torch.from_numpy(w), tspec, tkey)
    assert yt.shape == (16, 8) and yt.dtype == torch.float32
    scale = float(quant.abs_max_scale(torch.from_numpy(x), tspec.in_bits)
                  * quant.abs_max_scale(torch.from_numpy(w), tspec.w_bits))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=5e-6, atol=2e-3 * scale)

    gxj, gwj = jax.grad(lambda a, b: jops.cim_matmul(a, b, jspec, jkey).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    ops.cim_matmul(xt, wt, tspec, tkey).sum().backward()
    xs = quant.abs_max_scale(torch.from_numpy(x), tspec.in_bits)
    ws = quant.abs_max_scale(torch.from_numpy(w), tspec.w_bits)
    fq_x = quant.dequantize(quant.quantize(torch.from_numpy(x), xs,
                                           tspec.in_bits), xs)
    fq_w = quant.dequantize(quant.quantize(torch.from_numpy(w), ws,
                                           tspec.w_bits), ws)
    g = torch.ones((16, 8))
    _sum_close(xt.grad.numpy(), np.asarray(gxj),
               (g @ fq_w.abs().T).numpy(), 8)
    _sum_close(wt.grad.numpy(), np.asarray(gwj),
               (fq_x.abs().T @ g).numpy(), 16)
    # and equal to the dequantized products, as the JAX test states them
    np.testing.assert_allclose(xt.grad.numpy(), (g @ fq_w.T).numpy(),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(wt.grad.numpy(), (fq_x.T @ g).numpy(),
                               rtol=1e-6, atol=0)


def test_cim_matmul_batched_input_and_dtypes():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 1024)).astype(np.float32)
    w = rng.normal(size=(1024, 12)).astype(np.float32)
    jspec, tspec = _specs()["default"]
    yj = np.asarray(jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), jspec,
                                    None))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    yt = ops.cim_matmul(xt, torch.from_numpy(w), tspec, None)
    assert yt.shape == (2, 5, 12)
    np.testing.assert_array_equal(yt.detach().numpy(), yj)
    rel = float(np.linalg.norm(yj - x @ w) / np.linalg.norm(x @ w))
    assert rel < 0.1              # noiseless: quantization error only
    ops.cim_matmul(xt, wt, tspec, None).sum().backward()
    assert xt.grad.shape == xt.shape and xt.grad.dtype == torch.float32
    assert wt.grad.shape == wt.shape and wt.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [(10, 6), (6, 9)])
def test_cim_matmul_raises_above_eight_bits(bits):
    spec = cim.CIMSpec(in_bits=bits[0], w_bits=bits[1])
    with pytest.raises(ValueError, match="8 bits"):
        ops.cim_matmul(torch.randn(4, 64), torch.randn(64, 8), spec, None)


@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("k,n,block_m,grid", [
    (896, 896, 64, (7, 16)),        # q, o: one wave at 64 rows
    (896, 128, 32, (1, 32)),        # k, v: 32-row blocks, twice the SMs
    (896, 4864, 128, (38, 8)),      # gate, up: more than a wave at any
    (4864, 896, 64, (7, 16)),       # down: five macro tiles
])
def test_int8_plan_at_the_qwen2_projections(k, n, block_m, grid, noise):
    """The int8 kernel's plan at qwen2-0.5b's projections (M = 1024): the
    smallest block height whose grid fits one wave of the SMs, else 128
    with noise and 64 without; the cp.async path; K stages of 128 bytes
    and its macro tiles."""
    if block_m == 128 and not noise:
        block_m, grid = 64, (grid[0], 16)
    plan = cim_int8_plan(1024, k, n, noise=noise)
    assert (plan["block_m"], plan["grid"]) == (block_m, grid)
    assert plan["block_n"] == INT8_BLOCK_N == 128
    assert plan["aligned"] and plan["stages"] == -(-k // 128)
    assert plan["tiles"] == -(-k // 1024)
    if grid[0] * grid[1] <= SM_COUNT:
        assert grid[0] * -(-1024 // (block_m // 2)) > SM_COUNT \
            or block_m == 32
    else:
        assert grid[0] * -(-1024 // 64) > SM_COUNT


@pytest.mark.parametrize("m,k,n,x_off,w_off,aligned", [
    (100, 2048, 130, 0, 0, False),  # N not a multiple of 16
    (1, 1024, 1, 0, 0, False),
    (8, 512, 8, 0, 0, False),
    (33, 2 * 512 + 61, 77, 0, 0, False),   # ragged K and N
    (64, 1040, 96, 1, 0, False),    # xq off 16 bytes
    (64, 1040, 96, 0, 8, False),    # wq off 16 bytes
    (64, 1040, 96, 32, 48, True),   # both on 16 bytes
])
def test_int8_plan_masks_ragged_or_unaligned(m, k, n, x_off, w_off,
                                             aligned):
    """The B2 ragged shapes and unaligned operands take the masked loads."""
    plan = cim_int8_plan(m, k, n, 4096 + x_off, 4096 + w_off)
    assert plan["aligned"] == aligned
    assert plan["grid"] == (-(-n // 128), -(-m // plan["block_m"]))
