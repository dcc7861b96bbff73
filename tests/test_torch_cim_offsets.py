"""Row 1 on a shard of a larger product (the tensor-parallel forward's CIM
linears), on the plain versions the CPU runs.

A column shard (a plane split over N, or a batch split over rows) passes
its place to the noise counter (``cim_matmul_fused(row0=, col0=)``): its
output must be bit-equal to its slice of the whole plane's call, with the
readout noise on. A row shard (a plane split over K) runs the int32 tile
partials (``cim_tile_partials``), their sum over the shards (exact: int32)
and the tile epilogue (``cim_tile_merge``): bit-equal to the whole call,
split inside a macro tile (qwen2's d_ff 4864 over two shards cuts at 2432,
inside tile 2) and on a tile boundary (2048), over two and over four
shards. The whole call is held against the JAX kernel
``cim_matmul_fused_pallas(interpret=True)``: bit-equal without noise, and
within 1e-6 of the output's largest value with it (XLA contracts the
kernel's ``s + sigma * N`` into one FMA, the port rounds the product and
the sum apart: ``test_torch_cim_plans.py``); the column shard with
offsets against its slice of the Pallas output alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cim_matmul import cim_matmul_fused_pallas
from repro_torch.core import quant
from repro_torch.core.cim import MACRO_ROWS
from repro_torch.kernels.cim_matmul import (cim_matmul_fused,
                                            cim_tile_merge,
                                            cim_tile_partials, tile_span)

SEED = (0x1234ABCD, 0x9E3779B9)
SIGMA = 3.25
IN_BITS = 6


def _operands(m, k, n, seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((m, k)).astype(np.float32)
    wq = g.integers(-31, 32, (k, n)).astype(np.int8)
    xs = np.float32(4 * np.sqrt(np.mean(x * x)) / quant.qmax(IN_BITS))
    qp = torch.tensor([xs, xs * np.float32(0.0125)], dtype=torch.float32)
    return torch.from_numpy(x), torch.from_numpy(wq), qp


def _whole(x, wq, qp, sigma):
    return cim_matmul_fused(x, wq, qp, SEED if sigma else None, sigma,
                            IN_BITS)


@pytest.mark.parametrize("m,k,n,parts", [(4, 896, 1152, 2), (128, 896, 896, 4),
                                         (4, 4864, 896, 2)])
def test_column_shards_bit_equal_to_slices(m, k, n, parts):
    """Each column block with ``col0`` and each row block with ``row0``
    equals its slice of the whole call, noise on (K over one and over
    several macro tiles)."""
    x, wq, qp = _operands(m, k, n)
    whole = _whole(x, wq, qp, SIGMA)
    cb = n // parts
    for r in range(parts):
        got = cim_matmul_fused(x, wq[:, r * cb:(r + 1) * cb].contiguous(),
                               qp, SEED, SIGMA, IN_BITS, col0=r * cb)
        assert torch.equal(got, whole[:, r * cb:(r + 1) * cb])
    if m % 2 == 0:
        rb = m // 2
        for r in range(2):
            got = cim_matmul_fused(x[r * rb:(r + 1) * rb], wq, qp, SEED,
                                   SIGMA, IN_BITS, row0=r * rb)
            assert torch.equal(got, whole[r * rb:(r + 1) * rb])
    # without the offsets the shard draws another block's noise
    off = cim_matmul_fused(x, wq[:, cb:2 * cb].contiguous(), qp, SEED,
                           SIGMA, IN_BITS)
    assert not torch.equal(off, whole[:, cb:2 * cb])


@pytest.mark.parametrize("k,cuts", [(4864, (2432,)), (4864, (2048,)),
                                    (4864, (1216, 2432, 3648)),
                                    (896, (448,))])
def test_row_shards_partials_then_merge_bit_equal(k, cuts):
    """The shards' int32 tile partials summed, then the tile epilogue:
    the whole call bit for bit, with and without noise; a shard cut
    inside a macro tile fills both tiles it touches."""
    m, n = 8, 256
    x, wq, qp = _operands(m, k, n, seed=1)
    bounds = (0,) + cuts + (k,)
    tiles = -(-k // MACRO_ROWS)
    total = torch.zeros((tiles, m, n), dtype=torch.int32)
    for a, b in zip(bounds[:-1], bounds[1:]):
        part = cim_tile_partials(x[:, a:b], wq[a:b], qp, IN_BITS, a, k)
        first, n_t = tile_span(a, b - a)
        touched = [t for t in range(tiles)
                   if bool(part[t].abs().sum())]
        assert set(touched) <= set(range(first, first + n_t))
        total += part
    for sigma in (0.0, SIGMA):
        got = cim_tile_merge(total, qp, SEED if sigma else None, sigma)
        assert torch.equal(got, _whole(x, wq, qp, sigma))
    # a tile's noise on another tile's index, or a shard's partial left
    # out, is not the whole call
    assert not torch.equal(cim_tile_merge(total - part, qp, SEED, SIGMA),
                           _whole(x, wq, qp, SIGMA))


def test_tile_span():
    assert tile_span(2432, 2432) == (2, 3)
    assert tile_span(0, 2432) == (0, 3)
    assert tile_span(2048, 2048) == (2, 2)
    assert tile_span(448, 448) == (0, 1)


@pytest.mark.parametrize("m,k,n", [(4, 2432, 128), (24, 1024, 256)])
def test_whole_call_against_pallas(m, k, n):
    x, wq, qp = _operands(m, k, n, seed=2)
    xs, out_scale = float(qp[0]), float(qp[1])
    jx, jw = jnp.asarray(x.numpy()), jnp.asarray(wq.numpy())
    seed = jnp.asarray(np.array(SEED, np.uint32).view(np.int32))
    for sigma in (0.0, SIGMA):
        pal = torch.from_numpy(np.array(cim_matmul_fused_pallas(
            jx, jw, jnp.float32(xs), seed if sigma else None, sigma=sigma,
            in_bits=IN_BITS, scale=jnp.float32(out_scale), interpret=True)))
        got = _whole(x, wq, qp, sigma)
        if not sigma:
            assert torch.equal(got, pal)
        else:
            assert float((got - pal).abs().max()) <= 1e-6 * float(
                pal.abs().max())
            half = n // 2
            shard = cim_matmul_fused(x, wq[:, half:].contiguous(), qp, SEED,
                                     sigma, IN_BITS, col0=half)
            assert float((shard - pal[:, half:]).abs().max()) <= 1e-6 * \
                float(pal.abs().max())
