"""The port's attention (plain kernel versions and ``gqa_attention``)
against the JAX package's Pallas kernels in interpret mode and its einsum
reference, for f32 and int8 caches, ``lens == 0`` rows and ``start``
offsets. Float sums run in another order: tolerance 2e-5 absolute on
outputs of unit scale."""

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
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                 flash_gqa_plain)
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
