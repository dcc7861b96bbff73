"""The PyTorch port's Threefry PRNG and quantizer against the JAX package.

Integer and bit-level values must match exactly: Threefry words, key
chains (``PRNGKey``/``fold_in``/``split``), uniform bits and round-half-even
quantization. Float transcendentals (Box-Muller's log/cos, erf_inv) are
held to a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prng as jprng
from repro.core import quant as jquant
from repro_torch.core import prng, quant

# Random123 known-answer vectors for Threefry-2x32-20: (key, counter, out)
KAT = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("key,ctr,out", KAT)
def test_threefry_kat(key, ctr, out):
    assert prng.threefry2x32(*key, *ctr) == out
    t = prng.threefry2x32(*key, torch.tensor([ctr[0]]), torch.tensor([ctr[1]]))
    assert (int(t[0][0]), int(t[1][0])) == out


def test_threefry_matches_jax_package_on_shared_counters():
    rng = np.random.default_rng(0)
    x0 = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    x1 = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    k0, k1 = 0xDEADBEEF, 0x01234567
    j0, j1 = jprng.threefry2x32(k0, k1, jnp.asarray(x0, jnp.uint32),
                                jnp.asarray(x1, jnp.uint32))
    t0, t1 = prng.threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                               torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(j0, np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1, np.int64), t1.numpy())


@pytest.mark.parametrize("seed", [0, 7, 1234, 0xC1, 2**31 - 1])
def test_key_chains_equal_jax_random(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert tuple(int(w) for w in np.asarray(jk)) == tk
    for d in (0, 1, 7, 0x5A17, 0x7FFFFFFF):
        assert tuple(int(w) for w in np.asarray(jax.random.fold_in(jk, d))) \
            == prng.fold_in(tk, d)
    for num in (2, 3):
        js = np.asarray(jax.random.split(jk, num))
        assert [tuple(int(w) for w in row) for row in js] == \
            prng.split(tk, num)
    # the engine's chain: key, k = split(key) repeated; fold_in per layer
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        assert tuple(int(w) for w in np.asarray(
            jax.random.fold_in(jsub, 3))) == prng.fold_in(tsub, 3)
    ws = jprng.seed_from_key(jk)
    assert tuple(int(w) & prng.M32 for w in np.asarray(ws)) == \
        prng.seed_from_key(tk)


def test_uniform_bits_and_normal_match_jax():
    jk = jax.random.PRNGKey(3)
    tk = prng.PRNGKey(3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (1000,)), np.int64),
        prng.random_bits(tk, (1000,)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (37, 5))),
        prng.uniform(tk, (37, 5)).numpy())
    # erf_inv's log1p/sqrt differ from XLA's by ulps
    np.testing.assert_allclose(
        np.asarray(jax.random.normal(jk, (4096,))),
        prng.normal(tk, (4096,)).numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(jax.random.gumbel(jk, (4096,))),
        prng.gumbel(tk, (4096,)).numpy(), rtol=1e-5, atol=1e-5)


def test_bf16_uniform_and_gumbel_match_jax_exactly():
    """The bf16 draws (``LoopEngine`` samples a bf16 model's logits in
    bf16, as the reference's does) equal ``jax.random`` bit for bit."""
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    tiny = float(jnp.finfo(jdt).tiny)
    for i in range(40):
        jk = jax.random.fold_in(jax.random.PRNGKey(7), i)
        tk = tuple(int(w) for w in np.asarray(jk))
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, (512,), jdt, tiny, 1.0),
                       np.float32),
            prng.uniform(tk, (512,), tiny, 1.0, dtype=tdt).float().numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.gumbel(jk, (512,), jdt), np.float32),
            prng.gumbel(tk, (512,), dtype=tdt).float().numpy())


def test_tile_gaussian_matches_jax_package():
    """Identical Threefry bits; Box-Muller within rel 3e-7 (torch's CPU
    log/cos against XLA's)."""
    rows = np.arange(64, dtype=np.int64)[:, None].repeat(96, 1)
    cols = np.arange(96, dtype=np.int64)[None, :].repeat(64, 0)
    for tile in (0, 1, 4):
        j = np.asarray(jprng.tile_gaussian(
            np.uint32(0x89ABCDEF), np.uint32(0x1234), np.uint32(tile),
            jnp.asarray(rows, jnp.uint32), jnp.asarray(cols, jnp.uint32)))
        t = prng.tile_gaussian(0x89ABCDEF, 0x1234, tile,
                               torch.from_numpy(rows),
                               torch.from_numpy(cols)).numpy()
        np.testing.assert_allclose(t, j, rtol=3e-7, atol=1e-7)
        assert np.isfinite(t).all() and abs(t.mean()) < 0.1


def test_quantize_bit_equal_including_ties():
    rng = np.random.default_rng(1)
    x = rng.normal(size=4096).astype(np.float32) * 3
    # exact .5 ties (half to even) and the clip edges
    x[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 40.0, -40.0]
    for bits in (4, 6, 8):
        scale = np.float32(0.25)
        j = np.asarray(jquant.quantize(jnp.asarray(x), scale, bits))
        t = quant.quantize(torch.from_numpy(x), torch.tensor(scale),
                           bits).numpy()
        np.testing.assert_array_equal(j, t)
        js = np.asarray(jquant.abs_max_scale(jnp.asarray(x), bits))
        ts = quant.abs_max_scale(torch.from_numpy(x), bits).numpy()
        assert js == ts
    assert quant.qmax(4) == jquant.qmax(4) == 7
    assert quant.storage_dtype(8) == torch.int8
    assert quant.storage_dtype(10) == torch.int16


def test_normal_of_the_expert_noise_matches_jax():
    """The MoE readout-noise draw: ``jax.random.normal`` of a (1, E, C, d)
    buffer under a folded key. The Threefry bits are equal; the values
    within 3 ulp (torch's log1p against XLA's, and XLA's fused multiply-adds
    in the erf_inv polynomial: 3 ulp was the largest of four million
    draws). A slab drawn with ``start`` is the same slice of the whole
    draw, bit for bit."""
    shape = (1, 8, 6, 128)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 2), 7)
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(9), 2), 7)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape), np.int64),
        prng.random_bits(tk, shape).numpy())
    j = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    t = prng.normal(tk, shape).numpy()
    ulp = np.spacing(np.abs(j).astype(np.float32))
    assert (np.abs(t - j) <= 3 * ulp).all(), np.abs(t - j).max()
    per_e = 6 * 128
    part = prng.normal(tk, (1, 3, 6, 128), start=5 * per_e)
    assert torch.equal(part, torch.from_numpy(t[:, 5:8]))
