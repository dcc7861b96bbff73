"""The split-key launch plans of the f32-query GQA prefill
(``flash_gqa_plan`` with f32 queries) and of the MLA latent-cache decode
(``mla_decode_plan``), and CPU emulations of the two kernels' split-and-
merge arithmetic held against the JAX package's Pallas kernels in
interpret mode.

The plans, as pure Python: at the main path's shapes and at the edges
(G 1/2/7/8, head dims 64 and 128, S 1/32/33/64, T up to 4096, lens 0, 1
and T), the blocks of a work item visit every live key block exactly
once, never a block past the causal frontier (GQA) or the row's live keys
(MLA), over at most ``MAX_SPLITS`` splits. The kernels themselves run on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The emulations repeat, in plain PyTorch on the CPU, what the kernels'
blocks compute over the plan's splits: each split's running max m,
denominator l and accumulator acc (online softmax in f32 over its key
blocks), then the last block's merge, weights exp(m_i - m) / sum_j
exp(m_j - m) l_j applied to the accumulators in split order (one split:
acc / max(l, 1e-30)). The GQA f32 body keeps p in f32 (an int8 cache
dequantized as k * ks, as the reference does): held to 2e-5 + 2e-5 |ref|
(the MHA f32 slack: the same products summed in another order). The MLA
tensor-core body scores in log2 units and runs p as two bf16 halves, hi =
bf16(p) and lo = bf16(p - hi), against bf16 operands (here f32 holding
bf16 values, the same numbers both sides): p's relative error is at most
2^-17, so every output row is held to 2^-15 of its max |value|, with
headroom for the f32 sums' order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_gqa_attention as jflash
from repro.kernels.mla_decode import mla_decode_attention as jmla
from repro_torch.kernels._attn import SM_TARGET
from repro_torch.kernels.flash_attention import (BLOCK_ROWS, MAX_SPLITS,
                                                 flash_gqa_plan)
from repro_torch.kernels.mla_decode import MAX_SPLITS as MLA_MAX_SPLITS
from repro_torch.kernels.mla_decode import mla_decode_plan
from repro_torch.models.attention import _kv_quant

NEG_INF = -1e30
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _split_ranges(plan, nkb):
    """Key blocks each split of one work item visits, as the kernel's
    blocks walk them: split sp takes [sp * kbps, (sp + 1) * kbps) below
    ``nkb``; a split that starts at or past ``nkb`` exits at once."""
    kbps = plan["kbps"]
    return [range(sp * kbps, min(sp * kbps + kbps, nkb))
            for sp in range(plan["n_split"]) if sp * kbps < nkb]


def _gqa_frontiers(plan, s, t, start):
    """Per q block: the keys below its causal frontier, min(start + i0 +
    npos, T, start + S) (the _cached_mask contract)."""
    bq, kv_end = plan["block_q"], min(t, start + s)
    return [min(start + i * bq + min(bq, s - i * bq), kv_end)
            for i in range(plan["n_q"])]


def _check_split(plan, n_kb, blocks):
    """The split of ``n_kb`` key blocks over a grid of ``blocks`` blocks
    without the split: every key block in some group, the groups within
    the work item's share of ``SM_TARGET`` (at most ``MAX_SPLITS``), and
    the fewest key blocks a group that keeps them so."""
    n, kbps = plan["n_split"], plan["kbps"]
    want = min(-(-SM_TARGET // blocks), MAX_SPLITS)
    assert 1 <= n <= want <= MAX_SPLITS
    assert (n - 1) * kbps < n_kb <= n * kbps
    assert kbps == 1 or -(-n_kb // (kbps - 1)) > want


# ------------------------------------------------------------ plans

@pytest.mark.parametrize("s", [1, 32, 33, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 7, 8])
def test_gqa_f32_plan_visits_each_live_block_once(g, d, s):
    """f32 queries: 64 // G positions a block, 64-key blocks split over
    the grid; for each q block and start, the splits' key blocks are
    exactly those below the causal frontier, each once."""
    for b, t, kv in ((1, 320, 2), (4, 4096, 2), (2, 200, 1), (1, 64, 8)):
        h = g * kv
        plan = flash_gqa_plan(b, s, t, h, kv, d, tensor_cores=False)
        bq = plan["block_q"]
        assert bq == BLOCK_ROWS // g and bq * g <= BLOCK_ROWS
        assert plan["block_k"] == 64
        assert plan["n_q"] == -(-s // bq)
        assert plan["grid"] == (plan["n_split"], plan["n_q"], b * kv)
        assert plan["part_o"] == (b * kv * plan["n_q"] * plan["n_split"],
                                  BLOCK_ROWS, d)
        assert plan["counters"] == b * kv * plan["n_q"]
        _check_split(plan, -(-t // 64), plan["n_q"] * b * kv)
        for start in (0, 1, 128 % t, max(t - s, 0), t - 1, t + 5):
            for front in _gqa_frontiers(plan, s, t, start):
                nkb = -(-front // 64)
                seen = [kb for r in _split_ranges(plan, nkb) for kb in r]
                assert sorted(seen) == list(range(nkb))   # each block once
                # no key block starts at or past the frontier
                assert all(kb * 64 < front for kb in seen)


def test_gqa_f32_plan_at_cells_c_and_d():
    """Cells C and D's chunk (qwen2-0.5b: B 1, S 32, H 14, KV 2, D 64,
    start 128 of T 320): 4 q blocks of 9 positions (63 rows), 3 live 64-key
    blocks each, one a block: 24 blocks read keys (one a q block and KV
    head would be 8)."""
    plan = flash_gqa_plan(1, 32, 320, 14, 2, 64, tensor_cores=False)
    fronts = _gqa_frontiers(plan, 32, 320, 128)
    assert fronts == [137, 146, 155, 160]
    live = sum(len(_split_ranges(plan, -(-f // 64))) for f in fronts)
    assert 2 * live == 24
    assert plan["n_split"] == 5 and plan["kbps"] == 1
    with pytest.raises(ValueError, match="group"):
        flash_gqa_plan(1, 32, 320, 14, 4, 64, tensor_cores=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,t,lat,lens", [
    (4, 128, 320, 512, (301, 138, 96, 212)),     # cell F
    (4, 128, 512, 512, (0, 512, 1, 33)),
    (1, 128, 4096, 512, (4096,)),
    (8, 16, 4096, 96, (0, 1, 4096, 31, 32, 33, 2000, 4095)),
    (4, 4, 128, 64, (0, 128, 5, 70)),            # the reduced model
    (2, 20, 100, 32, (100, 1)),
])
def test_mla_plan_visits_each_live_tile_once(dtype, b, h, t, lat, lens):
    """bf16: 16 heads a block, 32-key tiles split over blocks toward
    SM_TARGET; f32: 4 heads a block, one block a (head group, row). The
    blocks of a row visit each tile below lens[b] once and none past it;
    a lens == 0 row has one block (split 0), which writes its zeros."""
    plan = mla_decode_plan(b, h, t, lat, dtype)
    heads = 16 if dtype == torch.bfloat16 else 4
    n_hg, n_kb = -(-h // heads), -(-t // 32)
    assert plan["heads"] == heads and plan["block_k"] == 32
    if dtype == torch.bfloat16:
        assert plan["grid"] == (plan["n_split"], n_hg, b)
        assert plan["n_split"] <= MLA_MAX_SPLITS
        _check_split(plan, n_kb, n_hg * b)
        assert plan["part_o"] == (b * n_hg * plan["n_split"], 16, lat)
        assert plan["part_ml"] == (b * n_hg * plan["n_split"], 16, 2)
        assert plan["counters"] == b * n_hg
    else:
        assert plan["grid"] == (n_hg, b) and plan["n_split"] == 1
        assert plan["kbps"] == n_kb
    for n in lens:
        nkb = -(-n // 32)
        ranges = _split_ranges(plan, nkb)
        seen = [kb for r in ranges for kb in r]
        assert sorted(seen) == list(range(nkb))
        assert all(kb * 32 < n for kb in seen)
        assert len(ranges) == (0 if n == 0 else -(-nkb // plan["kbps"]))


def test_mla_plan_at_cell_f():
    """Cell F (deepseek-v2, B 4, H 128, T 320, lens 301/138/96/212): 8
    head groups x 4 rows, 10 tiles a row in pairs over 5 splits: 112 of
    the 160 blocks read keys (one block a 4 heads and row, each walking
    every tile, would be 128)."""
    plan = mla_decode_plan(4, 128, 320, 512, torch.bfloat16)
    assert (plan["kbps"], plan["n_split"], plan["grid"]) == (2, 5, (5, 8, 4))
    live = sum(len(_split_ranges(plan, -(-n // 32)))
               for n in (301, 138, 96, 212))
    assert 8 * live == 112


# ------------------------------------------------------------ emulations

def _merge(parts):
    """The last block's merge of (m, l, acc) partials, as rt::merge_splits:
    w_i = exp(m_i - m) / max(sum_j exp(m_j - m) l_j, 1e-30), then the
    weighted accumulators summed in split order; one split divides by
    max(l, 1e-30)."""
    if len(parts) == 1:
        m, l, acc = parts[0]
        return acc / torch.clamp(l, min=1e-30)[:, None]
    m = torch.stack([p[0] for p in parts]).amax(0)
    e = [torch.exp(p[0] - m) for p in parts]
    den = sum(ei * p[1] for ei, p in zip(e, parts))
    inv = 1.0 / torch.clamp(den, min=1e-30)
    out = torch.zeros_like(parts[0][2])
    for ei, p in zip(e, parts):
        out = out + (ei * inv)[:, None] * p[2]
    return out


def gqa_f32_emulation(q, k, v, start, ks=None, vs=None):
    """The f32 body of the GQA prefill over ``flash_gqa_plan``'s blocks:
    q (B, S, H, D) f32, cache (B, T, KV, D) f32 or int8 with (B, T, KV, 1)
    scales, start (B,). Per (row, KV head, q block): rows r = position r
    // G, head r % G; each split's online softmax over its 64-key blocks
    (scores times 1/sqrt(D), -1e30 where masked, p = 0 there), then the
    merge."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    plan = flash_gqa_plan(b, s, t, h, kv, d, tensor_cores=False)
    bq, bk = plan["block_q"], plan["block_k"]
    kf, vf = k.float(), v.float()
    if ks is not None:
        kf, vf = kf * ks, vf * vs
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.zeros_like(q)
    for bi in range(b):
        st = int(start[bi])
        kv_end = min(t, st + s)
        for hh in range(kv):
            for qb, front in enumerate(_gqa_frontiers(plan, s, t, st)):
                r = torch.arange(min(bq, s - qb * bq) * g)
                pos_i = qb * bq + r // g
                heads = hh * g + r % g
                qr = q[bi, pos_i, heads]
                parts = []
                for keys in _split_ranges(plan, -(-front // bk)):
                    m = torch.full((len(r),), NEG_INF)
                    l = torch.zeros(len(r))
                    acc = torch.zeros(len(r), d)
                    for kb in keys:
                        j = torch.arange(kb * bk, kb * bk + bk)
                        ok = j < kv_end
                        jj = torch.clamp(j, max=t - 1)
                        kk = torch.where(ok[:, None], kf[bi, jj, hh], 0.0)
                        vv = torch.where(ok[:, None], vf[bi, jj, hh], 0.0)
                        sc = (qr @ kk.T) * scale
                        live = ok[None, :] & (j[None, :] <= st + pos_i[:, None])
                        sc = torch.where(live, sc, torch.tensor(NEG_INF))
                        m_new = torch.maximum(m, sc.amax(-1))
                        alpha = torch.exp(m - m_new)
                        p = torch.where(sc == NEG_INF, 0.0,
                                        torch.exp(sc - m_new[:, None]))
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + p @ vv
                        m = m_new
                    parts.append((m, l, acc))
                out[bi, pos_i, heads] = _merge(parts)
    return out


def mla_bf16_emulation(q_lat, q_rope, ckv, krope, lens, scale):
    """The tensor-core body of the MLA decode over ``mla_decode_plan``'s
    blocks (bf16 operands, given here as f32 holding bf16 values): per
    batch row and split, scores (q_lat . ckv + q_rope . krope) in f32 times
    scale log2(e), -1e30 past lens[b]; per 32-key tile p = exp2(s - m),
    l += sum(p), acc = acc alpha + bf16(p) @ ckv + bf16(p - bf16(p)) @ ckv;
    the running max leaves in natural units (m ln 2) for the merge. A row
    with no live key gives zeros."""
    b, h, lat = q_lat.shape
    t = ckv.shape[1]
    plan = mla_decode_plan(b, h, t, lat, torch.bfloat16)
    bk = plan["block_k"]
    s2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qc = torch.cat([q_lat, q_rope], -1).float()
    kc = torch.cat([ckv, krope], -1).float()
    out = torch.zeros((b, h, lat))
    for bi in range(b):
        live_n = min(max(int(lens[bi]), 0), t)
        parts = []
        for keys in _split_ranges(plan, -(-live_n // bk)):
            m = torch.full((h,), NEG_INF)
            l = torch.zeros(h)
            acc = torch.zeros(h, lat)
            for kb in keys:
                j = torch.arange(kb * bk, kb * bk + bk)
                ok = j < live_n
                jj = torch.clamp(j, max=t - 1)
                sc = torch.where(ok[None, :], (qc[bi] @ kc[bi, jj].T) * s2,
                                 torch.tensor(NEG_INF))
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.where(sc == NEG_INF, 0.0,
                                torch.exp2(sc - m_new[:, None]))
                l = l * alpha + p.sum(-1)
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float()
                vv = torch.where(ok[:, None], ckv[bi, jj].float(), 0.0)
                acc = acc * alpha[:, None] + hi @ vv + lo @ vv
                m = m_new
            parts.append((m * LN2, l, acc))
        if parts:
            out[bi] = _merge(parts)
    return out


def _cache(b, t, kv, d, int8, seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    if not int8:
        return k, v, None, None
    (kq, ks), (vq, vs) = (_kv_quant(torch.from_numpy(x)) for x in (k, v))
    return kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,g,s,t,starts", [
    (64, 7, 33, 320, (128, 0)),      # qwen2-0.5b's group, 5 splits
    (64, 7, 1, 1088, (1000, 0)),     # 17 key blocks: 2 a split
    (128, 2, 32, 200, (7, 168)),
])
def test_gqa_f32_split_merge_matches_pallas(int8, d, g, s, t, starts):
    b, kv = len(starts), 2
    h = g * kv
    k, v, ks, vs = _cache(b, t, kv, d, int8, seed=d + g + s)
    q = np.random.default_rng(s).normal(size=(b, s, h, d)).astype(np.float32)
    st = np.asarray(starts, np.int32)
    j = np.asarray(jflash(jnp.asarray(q), _j(k), _j(v), jnp.asarray(st),
                          ks=_j(ks), vs=_j(vs), block_q=16, block_k=64,
                          interpret=True))
    e = gqa_f32_emulation(_t(q), _t(k), _t(v), st, _t(ks), _t(vs)).numpy()
    assert flash_gqa_plan(b, s, t, h, kv, d, False)["n_split"] > 1
    np.testing.assert_allclose(e, j, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,lat,rope,t,lens", [
    (4, 64, 16, 640, (0, 640, 1, 333)),     # reduced widths, 2 tiles a split
    (128, 512, 64, 96, (96, 1, 0, 65)),     # deepseek-v2 widths, small T
])
def test_mla_split_merge_matches_pallas(h, lat, rope, t, lens):
    rng = np.random.default_rng(lat + t)

    def bf(*shape):     # bf16 values, held as f32 on both sides
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.bfloat16().float().numpy()

    b = len(lens)
    args = (bf(b, h, lat), bf(b, h, rope), bf(b, t, lat), bf(b, t, rope))
    ln = np.asarray(lens, np.int32)
    scale = 1.0 / (lat // 4 + rope) ** 0.5
    j = np.asarray(jmla(*map(jnp.asarray, args), jnp.asarray(ln),
                        scale=scale, block_k=32, interpret=True))
    e = mla_bf16_emulation(*map(_t, args), ln, scale).numpy()
    assert mla_decode_plan(b, h, t, lat, torch.bfloat16)["n_split"] > 1
    row = np.abs(j).max(-1, keepdims=True)
    assert (np.abs(e - j) <= 2 ** -15 * row).all()
    for i, n in enumerate(lens):
        if n == 0:
            assert not e[i].any()
