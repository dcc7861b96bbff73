"""Launch plans of the split-K CIM kernels, and a CPU emulation of their
split arithmetic against the JAX package.

``cim_fused_plan`` (the fused CIM kernel) and ``fused_layer_plan`` (every
projection stage of the fused decode layer) cut K into splits that never
straddle a 1024-row macro tile and the columns into units; the plans are
pure Python, checked here at every CIM shape of the three served models
and at ragged edges: every (k, column) in exactly one split of one unit,
and at decode shapes at least ``SM_COUNT`` blocks.

The emulation follows the kernels' arithmetic step by step: int32
partials per split, the splits of each tile summed as integers, float +
the tile's noise, the tiles summed in f32 in tile order, times the output
scale. Fed the JAX package's activation scale and its Threefry normals, it
must equal ``cim_matmul_fused_pallas(interpret=True)`` bit for bit, with
and without noise; fed the port's normals, the port's plain version (the
card's reference). One rounding differs between the two sides and the
emulation follows each: XLA on the CPU contracts the Pallas kernel's
``s + sigma * N`` into one FMA, while the port (plain version and kernel)
rounds the product and the sum apart (``__fmul_rn``, ``__fadd_rn``).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prng as jprng
from repro.kernels.cim_matmul import cim_matmul_fused_pallas
from repro_torch.configs.registry import get_config
from repro_torch.core import cim, prng, quant, sac
from repro_torch.core.cim import MACRO_ROWS
from repro_torch.kernels._attn import SM_COUNT
from repro_torch.kernels import fused_step
from repro_torch.kernels.cim_matmul import (GEMV_ROWS, INT8_STAGE_K,
                                            cim_fused_plan,
                                            cim_matmul_fused_plain,
                                            split_geometry, split_range)
from repro_torch.kernels.fused_step import (COLS, fused_layer_plan,
                                            kernel_takes)

# (K, N) of the CIM linears each served model runs (chip_smoke.py's cells):
# qwen2-0.5b q, k/v, gate/up, down (o is q's shape); mamba2-130m in_proj
# and out_proj; deepseek-v2 dq, dkv, uq, o, uk/uv, the shared expert's
# gate/up and down
SERVED = {
    "qwen2-0.5b": ((896, 896), (896, 128), (896, 4864), (4864, 896)),
    "mamba2-130m": ((768, 3352), (1536, 768)),
    "deepseek-v2-236b": ((5120, 1536), (5120, 576), (1536, 24576),
                         (16384, 5120), (512, 16384), (5120, 3072),
                         (3072, 5120)),
}
SERVED_SHAPES = sorted({s for shapes in SERVED.values() for s in shapes})
EDGE_SHAPES = [(k, n) for k in (896, 4864, 1000) for n in (128, 4, 3352)]
ROWS = (1, 4, 8, 16, 17, 32, 33)


def _covers_once(k, klen):
    """Every row of [0, k) in exactly one split; no split straddles a
    macro tile."""
    spt, n_split, tiles = split_geometry(k, klen)
    hits = np.zeros(k, dtype=np.int64)
    for j in range(n_split):
        t, k0, k1 = split_range(k, klen, j)
        assert 0 <= k0 < k1 <= k and t == k0 // MACRO_ROWS
        assert (k1 - 1) // MACRO_ROWS == t
        hits[k0:k1] += 1
    assert (hits == 1).all()
    assert tiles == -(-k // MACRO_ROWS)
    return n_split


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", SERVED_SHAPES + EDGE_SHAPES)
def test_fused_plan_covers_every_element_once(m, k, n):
    p = cim_fused_plan(m, k, n)
    assert p["n_split"] == _covers_once(k, p["klen"])
    # every column in exactly one unit
    assert (p["units"] if p["path"] == "gemv" else p["grid"][0]) \
        == -(-n // p["nspan"])
    if m <= GEMV_ROWS:
        assert p["path"] == "gemv" and m <= p["block_m"] <= GEMV_ROWS
        assert p["klen"] % 16 == 0 and p["nspan"] in (32, 64, 128)
        assert n % p["vec"] == 0 and p["vec"] * p["block_m"] <= 64
        assert p["grid"] == (p["units"], p["n_split"])
        assert p["slot"] == m * p["nspan"]
    else:
        assert p["path"] == "mma" and p["klen"] % INT8_STAGE_K == 0
        assert p["nspan"] == 128 and p["block_m"] in (32, 64)
        spans, rb, ns = p["grid"]
        assert rb * p["block_m"] >= m > (rb - 1) * p["block_m"]
        assert p["units"] == spans * rb and ns == p["n_split"]
        assert p["aligned"] == (k % 16 == 0 and n % 16 == 0)
        assert p["slot"] == p["block_m"] * 128
    assert p["part_ints"] == p["units"] * p["n_split"] * p["slot"]
    assert p["noise_floats"] == p["units"] * p["tiles"] * p["slot"]


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("k,n", SERVED_SHAPES)
def test_decode_plans_fill_the_card(m, k, n):
    p = cim_fused_plan(m, k, n)
    assert p["units"] * p["n_split"] >= SM_COUNT


def test_fused_plan_vector_width_follows_alignment():
    assert cim_fused_plan(4, 896, 896)["vec"] == 16
    assert cim_fused_plan(4, 768, 3352)["vec"] == 8       # 3352 % 16 == 8
    assert cim_fused_plan(4, 896, 896, w_ptr=8)["vec"] == 8
    assert cim_fused_plan(4, 896, 4)["vec"] == 4
    assert cim_fused_plan(16, 896, 896)["vec"] == 4       # 16 x 4 int32 sums
    assert not cim_fused_plan(32, 896, 896, w_ptr=8)["aligned"]


@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("dims", [(896, 14, 2, 4864, 320),
                                  (256, 4, 2, 512, 128)])
def test_fused_layer_plan_splits(b, dims):
    d, h, kv, f, t = dims
    p = fused_layer_plan(b, d, h, kv, f, t)
    st = p["stages"]
    assert st["qkv"]["units"] == h + 2 * kv       # one head a unit
    for s in st.values():
        assert s["n_split"] == _covers_once(s["k"], s["klen"])
        assert s["klen"] % 16 == 0
        assert s["items"] == s["units"] * s["planes"] * s["n_split"]
        assert p["part"] >= s["items"] * b * COLS
        assert p["noise"] >= s["units"] * s["planes"] * s["tiles"] * b * COLS
        if d == 896:                              # full width fills the card
            assert s["items"] >= SM_COUNT
    assert p["counters"] == sum(s["units"] for s in st.values()) + b * kv
    assert p["attn_tiles"] == -(-t // 32)


# the fused layer's full-width shapes past head dim 64: phi3-mini (hd 96),
# zamba2-7b's shared block (hd 112), internlm2-1.8b, pixtral-12b and
# deepseek-67b (hd 128 at G 2, 4 and 8)
WIDE_ARCHS = ("phi3-mini-3.8b", "zamba2-7b", "internlm2-1.8b", "pixtral-12b",
              "deepseek-67b")


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_fused_layer_plan_wide_heads(arch):
    """A q/k/v unit is one head of hd columns: the units cover every
    column of q, k and v once, at the card's fill; the split scratch holds
    every stage's items at its own unit width."""
    cfg = get_config(arch)
    b, t, hd = 4, 320, cfg.hd
    d, h, kv, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    assert hd in (96, 112, 128) and kernel_takes(cfg, b)
    p = fused_layer_plan(b, d, h, kv, f, t, hd)
    st = p["stages"]
    assert st["qkv"]["cols"] == hd and len(p["qkv_units"]) == h + 2 * kv
    assert st["qkv"]["units"] == h + 2 * kv
    for plane, n in ((0, h * hd), (1, kv * hd), (2, kv * hd)):
        hits = np.zeros(n, dtype=np.int64)
        for pl, n0 in p["qkv_units"]:
            if pl == plane:
                assert 0 <= n0 and n0 + hd <= n
                hits[n0:n0 + hd] += 1
        assert (hits == 1).all(), (plane, hits.min(), hits.max())
    for s_ in st.values():
        assert s_["n_split"] == _covers_once(s_["k"], s_["klen"])
        assert s_["items"] >= SM_COUNT
        assert p["part"] >= s_["items"] * b * s_["cols"]
        assert p["noise"] >= s_["units"] * s_["planes"] * s_["tiles"] * b \
            * s_["cols"]
    assert st["o"]["k"] == h * hd
    assert p["counters"] == sum(s_["units"] for s_ in st.values()) + b * kv


def test_kernel_takes_head_dims_rows_and_groups():
    """The kernel's reach: head dims 64, 96, 112 and 128, B <= 8, H / KV
    <= 8; the wrapper's check names the reach when it refuses."""
    cfg = get_config("internlm2-1.8b")
    for hd in (64, 96, 112, 128):
        assert kernel_takes(dataclasses.replace(cfg, head_dim=hd), 8)
    for hd in (32, 80):
        assert not kernel_takes(dataclasses.replace(cfg, head_dim=hd), 4)
    assert not kernel_takes(cfg, 9)
    assert not kernel_takes(
        dataclasses.replace(cfg, n_heads=16, n_kv_heads=1), 4)    # G 16
    assert kernel_takes(dataclasses.replace(cfg, n_heads=16, n_kv_heads=2), 4)
    bad = dataclasses.replace(cfg, head_dim=80, d_model=256, n_heads=4,
                              n_kv_heads=2)
    cache = {"k": torch.zeros((4, 8, 2, 80))}
    with pytest.raises(ValueError, match=r"head_dim in \(64, 96, 112, 128\)"):
        fused_step._check(types.SimpleNamespace(cfg=bad), None,
                          torch.zeros((4, 1, 256)), cache)


def _emulate(x, wq, xs, out_scale, sigma, noise_of, plan, in_bits, fma):
    """The kernels' split arithmetic on the CPU: per split an int32
    partial, per tile the integer sum of its splits, float + sigma times
    the tile's normals (``noise_of(t)``: (M, N) f32 or None; ``fma``: one
    rounding, else two), f32 sum in tile order."""
    q = quant.qmax(in_bits)
    xq = torch.clamp(torch.round(x / xs), -q, q).to(torch.int64)
    w = wq.to(torch.int64)
    spt, n_split, tiles = split_geometry(x.shape[1], plan["klen"])
    parts = []
    for j in range(n_split):
        _, k0, k1 = split_range(x.shape[1], plan["klen"], j)
        p = xq[:, k0:k1] @ w[k0:k1]
        assert p.abs().max() < 2 ** 31
        parts.append(p.to(torch.int32))
    acc = torch.zeros((x.shape[0], wq.shape[1]), dtype=torch.float32)
    for t in range(tiles):
        s = torch.zeros_like(parts[0])
        for j in range(t * spt, min((t + 1) * spt, n_split)):
            s = s + parts[j]
        sf = s.to(torch.float32)
        g = noise_of(t)
        if g is not None and fma:
            # sigma * g is exact in f64 (two 24-bit significands)
            sf = (sigma * g.double() + sf.double()).to(torch.float32)
        elif g is not None:
            sf = sf + sigma * g
        acc = acc + sf
    return acc * out_scale


@pytest.mark.parametrize("m,k,n", [(1, 896, 128), (4, 896, 896),
                                   (4, 2100, 64), (8, 4864, 96),
                                   (16, 1000, 4), (32, 2100, 64),
                                   (33, 1280, 136)])
def test_split_emulation_matches_pallas_bit_for_bit(m, k, n):
    rng = np.random.default_rng(m + k)
    in_bits = 6
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-31, 32, size=(k, n)).astype(np.int8)
    xs = np.float32(4.0 * np.sqrt(np.mean(x * x)) / quant.qmax(in_bits))
    sigma = cim.output_noise_std_int_per_tile(sac.paper_sac().mlp, k)
    seed = (0x89ABCDEF, 0x01234567)
    jseed = jnp.asarray(np.array(seed, np.uint32).view(np.int32))
    plan = cim_fused_plan(m, k, n)
    rows = jnp.arange(m, dtype=jnp.uint32)[:, None] + jnp.zeros(
        (m, n), jnp.uint32)
    cols = jnp.arange(n, dtype=jnp.uint32)[None, :] + jnp.zeros(
        (m, n), jnp.uint32)
    tx, twq = torch.from_numpy(x), torch.from_numpy(wq)
    for s in (0.0, sigma):
        pal = np.asarray(cim_matmul_fused_pallas(
            jnp.asarray(x), jnp.asarray(wq), xs, jseed if s else None,
            sigma=s, in_bits=in_bits, scale=jnp.float32(0.0125),
            interpret=True))

        def jax_noise(t):
            if not s:
                return None
            return torch.from_numpy(np.array(jprng.tile_gaussian(
                np.uint32(seed[0]), np.uint32(seed[1]), np.uint32(t), rows,
                cols)))

        sig = float(np.float32(s))
        emu = _emulate(tx, twq, torch.tensor(xs), torch.tensor(0.0125), sig,
                       jax_noise, plan, in_bits, fma=True).numpy()
        np.testing.assert_array_equal(emu, pal)

        def port_noise(t):
            if not s:
                return None
            r = torch.arange(m)[:, None].expand(m, n)
            c = torch.arange(n)[None, :].expand(m, n)
            return prng.tile_gaussian(seed[0], seed[1], t, r, c)

        emu = _emulate(tx, twq, torch.tensor(xs), torch.tensor(0.0125), s,
                       port_noise, plan, in_bits, fma=False)
        plain = cim_matmul_fused_plain(
            tx, twq, torch.tensor([xs, 0.0125]), seed if s else None, s,
            in_bits)
        assert torch.equal(emu, plain)


@pytest.mark.parametrize("k,klen", [(896, 96), (4864, 512), (1000, 16),
                                    (2100, 128)])
def test_noise_shares_partition_each_tile(k, klen):
    """The splits of a tile draw disjoint, complete shares of its noise
    (``rt::Splits::noise_share``), at every unit size the kernels use."""
    spt, n_split, tiles = split_geometry(k, klen)
    for p_size in (4 * 32, 8 * 64, 32 * 128):
        for t in range(tiles):
            n = min(spt, n_split - t * spt)
            got = []
            for jj in range(n):
                got += range(jj * p_size // n, (jj + 1) * p_size // n)
            assert got == list(range(p_size))
