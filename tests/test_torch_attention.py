"""The port's attention (plain kernel versions and ``gqa_attention``)
against the JAX package's Pallas kernels in interpret mode and its einsum
reference, for f32 and int8 caches, ``lens == 0`` rows and ``start``
offsets, at head dims 64 and 128 (G 2, 4 and 8). Float sums run in
another order: tolerance 2e-5 absolute on outputs of unit scale. Then the
two CUDA kernels' launch plans (split sizes, grids, scratch shapes and the
block-count closed form) at the main path's shapes and at edge lengths,
as pure Python: the kernels themselves run on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_gqa_attention as jflash
from repro.models import attention as jattn
from repro.models.layers import Ctx as JCtx
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import params_from_jax
from repro_torch.kernels._attn import SM_TARGET
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  decode_plan)
from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                 flash_gqa_plain,
                                                 flash_gqa_plan)
from repro_torch.models import attention as attn
from repro_torch.models.layers import Ctx

ATOL = 2e-5


def _cache(b, t, kv, d, int8, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    if not int8:
        return k, v, None, None
    kq, ks = attn._kv_quant(torch.from_numpy(k))
    vq, vs = attn._kv_quant(torch.from_numpy(v))
    return kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_kv_quant_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 5, 2, 64)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]
    jq, js = jattn._kv_quant(jnp.asarray(x))
    tq, ts = attn._kv_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_decode_plain_matches_pallas(int8):
    b, t, h, kv, d = 4, 96, 8, 2, 64
    k, v, ks, vs = _cache(b, t, kv, d, int8)
    q = np.random.default_rng(1).normal(size=(b, h, d)).astype(np.float32)
    lens = np.array([0, 1, 50, 96], np.int32)
    j = np.asarray(jdecode(jnp.asarray(q), _j(k), _j(v), jnp.asarray(lens),
                           ks=_j(ks), vs=_j(vs), block_k=32, interpret=True))
    p = decode_attention_plain(_t(q), _t(k), _t(v), _t(lens), _t(ks), _t(vs))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=ATOL)
    assert np.all(p.numpy()[0] == 0.0)
    w = decode_attention(_t(q), _t(k), _t(v), _t(lens), _t(ks), _t(vs))
    assert torch.equal(w, p)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_plain_matches_pallas(int8):
    b, s, t, h, kv, d = 3, 16, 64, 4, 2, 64
    k, v, ks, vs = _cache(b, t, kv, d, int8, seed=2)
    q = np.random.default_rng(4).normal(size=(b, s, h, d)).astype(np.float32)
    start = np.array([0, 16, 40], np.int32)
    j = np.asarray(jflash(jnp.asarray(q), _j(k), _j(v), jnp.asarray(start),
                          ks=_j(ks), vs=_j(vs), block_q=8, block_k=16,
                          interpret=True))
    p = flash_gqa_plain(_t(q), _t(k), _t(v), _t(start), _t(ks), _t(vs))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=ATOL)
    w = flash_gqa_attention(_t(q), _t(k), _t(v), _t(start), _t(ks), _t(vs))
    assert torch.equal(w, p)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g", [2, 4, 8])
def test_plain_versions_match_pallas_at_head_dim_128(g, int8):
    """Head dim 128 (internlm2-1.8b G 2, pixtral-12b G 4, deepseek-67b
    G 8): decode and flash plain versions against the Pallas kernels."""
    b, t, kv, d, s = 2, 64, 2, 128, 16
    h = g * kv
    k, v, ks, vs = _cache(b, t, kv, d, int8, seed=10 + g)
    rng = np.random.default_rng(20 + g)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lens = np.array([0, 45], np.int32) if g != 4 else np.array([64, 1],
                                                               np.int32)
    j = np.asarray(jdecode(jnp.asarray(q), _j(k), _j(v), jnp.asarray(lens),
                           ks=_j(ks), vs=_j(vs), block_k=32, interpret=True))
    p = decode_attention_plain(_t(q), _t(k), _t(v), _t(lens), _t(ks), _t(vs))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=ATOL)
    qf = rng.normal(size=(b, s, h, d)).astype(np.float32)
    start = np.array([0, 37], np.int32)
    j = np.asarray(jflash(jnp.asarray(qf), _j(k), _j(v), jnp.asarray(start),
                          ks=_j(ks), vs=_j(vs), block_q=8, block_k=16,
                          interpret=True))
    p = flash_gqa_plain(_t(qf), _t(k), _t(v), _t(start), _t(ks), _t(vs))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=ATOL)


def _flash_counts(plan, s, t, start):
    """Closed form of the kernel's block counts: q block i visits the key
    blocks up to its causal frontier start + min((i + 1) bq, S), clipped
    to the written prefix min(T, start + S)."""
    bq, bk = plan["block_q"], plan["block_k"]
    end = min(t, start + s)
    return [-(-min(start + min((i + 1) * bq, s), end) // bk)
            for i in range(plan["n_q"])]


def _live_splits(lens, split):
    """Blocks of each row that read keys (the kernel's others exit at
    once): one merges nothing, a ``lens == 0`` row has none."""
    return [-(-max(n, 0) // split) for n in lens]


def test_decode_plan_at_the_main_path_and_edges():
    """qwen2-0.5b decode (B 4, T 320, KV 2, D 64): 16-key splits, 20 per
    (row, head); the session's lengths give 96 blocks that read keys,
    against 8 before the split. Edge lengths 0 (no block), 1 (one block,
    no merge), the split width +- 1 and T."""
    plan = decode_plan(4, 320, 2, 64)
    assert plan == {"split": 16, "n_split": 20, "grid": (20, 2, 4),
                    "part_acc": (8, 20, 8, 64), "part_ml": (8, 20, 8, 2),
                    "counters": 8}
    assert 2 * sum(_live_splits([300, 137, 95, 211], plan["split"])) == 96
    assert _live_splits([0, 1, 15, 16, 17, 320], 16) == [0, 1, 1, 1, 2, 20]
    for b, t, kv in ((4, 320, 2), (1, 4096, 2), (8, 2048, 8), (1, 17, 1),
                     (64, 128, 8)):
        p = decode_plan(b, t, kv, 128)
        split, n = p["split"], p["n_split"]
        assert split % 16 == 0 and n == -(-t // split)
        assert (n - 1) * split < t <= n * split          # every key once
        # the fewest 16-key tiles a split that keep the splits of a
        # (row, head) within the target's share
        want = min(-(-SM_TARGET // (kv * b)), 64)
        assert n <= want
        assert split == 16 or -(-t // (split - 16)) > want
    long = decode_plan(1, 4096, 2, 64)                # capped at 64
    assert (long["split"], long["n_split"]) == (64, 64)


def test_flash_plan_at_the_main_path_and_edges():
    """qwen2-0.5b prefill chunk (B 1, S 32, start 128 of T 320, G 7):
    bf16 queries take 64-row blocks of 9 positions, each of the 5 key
    blocks below the frontier in its own block (80 in the grid, 40 that
    read keys, against 8 before); f32 queries the same 64-row blocks over
    64-key blocks, each of the 3 below the frontier in its own block (40
    in the grid, 24 that read keys, against 8 before)."""
    plan = flash_gqa_plan(1, 32, 320, 14, 2, 64, tensor_cores=True)
    assert (plan["block_q"], plan["block_k"], plan["n_q"], plan["kbps"],
            plan["n_split"], plan["grid"]) == (9, 32, 4, 1, 10, (10, 4, 2))
    assert plan["part_o"] == (80, 64, 64) and plan["counters"] == 8
    assert _flash_counts(plan, 32, 320, 128) == [5, 5, 5, 5]
    assert _flash_counts(plan, 32, 320, 0) == [1, 1, 1, 1]
    assert _flash_counts(plan, 32, 320, 300) == [10, 10, 10, 10]
    live = sum(-(-c // plan["kbps"]) for c in _flash_counts(plan, 32, 320,
                                                            128))
    assert 2 * live == 40
    f32 = flash_gqa_plan(1, 32, 320, 14, 2, 64, tensor_cores=False)
    assert (f32["block_q"], f32["block_k"], f32["n_q"], f32["kbps"],
            f32["n_split"], f32["grid"]) == (9, 64, 4, 1, 5, (5, 4, 2))
    assert f32["part_o"] == (40, 64, 64) and f32["counters"] == 8
    assert _flash_counts(f32, 32, 320, 128) == [3, 3, 3, 3]
    assert 2 * sum(_flash_counts(f32, 32, 320, 128)) == 24
    for g, d, bq in ((2, 128, 32), (4, 128, 16), (8, 128, 8), (8, 64, 8)):
        for tc in (True, False):
            assert flash_gqa_plan(1, 32, 320, 2 * g, 2, d, tc)[
                "block_q"] == bq
    long = flash_gqa_plan(1, 32, 4096, 14, 2, 64, True)
    assert (long["kbps"], long["n_split"]) == (8, 16)     # capped at 16
    big = flash_gqa_plan(64, 512, 512, 14, 2, 64, True)
    assert big["n_split"] == 1 and big["kbps"] == 16
    with pytest.raises(ValueError, match="group"):
        flash_gqa_plan(1, 32, 320, 130, 2, 128, False)


def test_row_update_clamps_like_dynamic_update_slice():
    cache = torch.zeros((2, 8, 1, 1))
    upd = torch.arange(1, 7, dtype=torch.float32).reshape(2, 3, 1, 1)
    attn.row_update(cache, upd, torch.tensor([2, 7]))
    j = jattn.row_update(jnp.zeros((2, 8, 1, 1)), jnp.asarray(upd.numpy()),
                         jnp.asarray([2, 7]))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(j))


def _cfgs(impl, int8):
    jc = dataclasses.replace(jget("qwen2-0.5b").reduced(), attn_impl=impl,
                             kv_cache_int8=int8)
    tc = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                             attn_impl=impl, kv_cache_int8=int8)
    return jc, tc


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("int8", [False, True])
def test_gqa_attention_prefill_then_decode(impl, int8):
    """Prefill of 12 tokens into a ragged cache, then one decode token:
    outputs and written caches match the reference."""
    jc, tc = _cfgs(impl, int8)
    jp, _ = jattn.init_gqa(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    b, s, t = 2, 12, 32
    rng = np.random.default_rng(5)
    jcache = jattn.init_gqa_cache(jc, b, t, jnp.float32)
    tcache = attn.init_gqa_cache(tc, b, t, torch.float32)
    jcache["len"] = jnp.asarray([0, 5], jnp.int32)
    tcache["len"].copy_(torch.tensor([0, 5]))
    for step_s in (s, 1):
        x = rng.normal(size=(b, step_s, jc.d_model)).astype(np.float32)
        pos = np.asarray(jcache["len"])[:, None] + np.arange(step_s)[None]
        jo, jcache = jattn.gqa_attention(JCtx.make(jc), jp, jnp.asarray(x),
                                         jnp.asarray(pos), jcache)
        to, tcache = attn.gqa_attention(Ctx.make(tc), tp, torch.from_numpy(x),
                                        torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-4)
        for name in jcache:
            a, c = np.asarray(jcache[name]), tcache[name].numpy()
            if a.dtype.kind in "iu":
                # int8 keys may flip by one at a rounding boundary of the
                # f32 projection
                assert np.abs(a.astype(np.int64) - c).max() <= 1, name
            else:
                np.testing.assert_allclose(c, a, rtol=0, atol=1e-5)
