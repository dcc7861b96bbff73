"""The port's per-layer decode megakernel (``kernels/fused_step.py``, its
plain version on the CPU) against the JAX ``fused_dense_layer`` (Pallas,
interpret mode on the CPU) at the tiny dense shape of
``tests/test_megakernel.py`` (d 128, 4 heads, 2 KV heads, head dim 32,
float32): one layer on a ragged 4-row cache (lens 1, 38, 101, 151 after the
write) in off-f32, off-int8-KV and sim modes, one case with d_ff 1280 so
that ``down`` spans two macro tiles; then greedy engine tokens with
``fuse_layer=True`` against the JAX engine and the port's unfused engine,
and a config the fused route never takes served unfused, as in the
reference.

Tolerances, from float32 summation order alone (the noise, the quantized
activations and the int8 codes replay the reference): each output row
within 2^-16 of that row's largest |value|; the written f32 cache rows
within 1e-6 relative; int8 codes equal or one apart and their scales within
1e-6 relative; every other cache entry untouched (exactly equal)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.deploy import deploy as jdeploy
from repro.kernels.fused_step import fused_dense_layer as jfused
from repro.models.layers import Ctx as JCtx
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.core.deploy import params_from_jax
from repro_torch.kernels import fused_step
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import Engine, Request

B, T = 4, 160
OLD_LENS = np.array([0, 37, 100, 150], np.int32)


def _cfgs(int8=False, d_ff=256):
    def tiny(base):
        c = base.reduced()
        return dataclasses.replace(
            c, n_layers=2, d_model=128, d_ff=d_ff, vocab_size=128, n_heads=4,
            n_kv_heads=2, head_dim=32, kv_cache_int8=int8,
            cim=dataclasses.replace(c.cim, use_kernel=True))
    return tiny(jget("qwen2-0.5b")), tiny(get_config("qwen2-0.5b"))


def _cache(cfg, int8, rng):
    shape = (B, T, cfg.n_kv_heads, cfg.hd)
    kf = rng.normal(size=shape).astype(np.float32)
    vf = rng.normal(size=shape).astype(np.float32)
    if int8:
        ks = (np.abs(kf).max(-1, keepdims=True) / 127).astype(np.float32)
        vs = (np.abs(vf).max(-1, keepdims=True) / 127).astype(np.float32)
        cache = {"k": np.round(kf / ks).astype(np.int8),
                 "v": np.round(vf / vs).astype(np.int8), "ks": ks, "vs": vs}
    else:
        cache = {"k": kf, "v": vf}
    cache["len"] = OLD_LENS.copy()
    return cache


@pytest.mark.parametrize("mode,int8,d_ff", [
    ("off", False, 256), ("off", True, 256), ("sim", False, 256),
    ("sim", True, 1280)])
def test_layer_matches_jax_fused_dense_layer(mode, int8, d_ff):
    jc, tc = _cfgs(int8, d_ff)
    jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    if mode == "sim":
        jp = jdeploy(jc, jp)
    layer = jax.tree.map(lambda a: a[0], jp["blocks"])
    tp = params_from_jax(jax.tree.map(np.asarray, layer))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
    cache = _cache(jc, int8, rng)
    jctx = JCtx.make(jc, key=jax.random.PRNGKey(5), mode=mode,
                     deployed=mode == "sim")
    jo, jcache = jfused(jctx, layer, jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tctx = Ctx.make(tc, key=prng.PRNGKey(5), mode=mode)
    to, same = fused_step.fused_dense_layer(tctx, tp, torch.from_numpy(x),
                                            tcache)
    assert same is tcache                       # updated in place
    to, jo = to.numpy()[:, 0], np.asarray(jo)[:, 0]
    assert to.shape == jo.shape and np.isfinite(to).all()
    assert (np.abs(to - jo).max(-1)
            <= 2 ** -16 * np.abs(jo).max(-1)).all(), np.abs(to - jo).max(-1)
    assert tcache["len"].tolist() == (OLD_LENS + 1).tolist()
    rows = np.zeros((B, T), bool)
    rows[np.arange(B), OLD_LENS] = True
    for name in cache:
        if name == "len":
            continue
        got, want = tcache[name].numpy(), np.asarray(jcache[name])
        np.testing.assert_array_equal(got[~rows], cache[name][~rows])
        g, w = got[rows].astype(np.float64), want[rows].astype(np.float64)
        if name in ("k", "v") and int8:
            assert np.abs(g - w).max() <= 1, name
        else:
            assert (np.abs(g - w) <= 1e-6 * np.abs(w).max()).all(), name


@pytest.fixture(scope="module")
def engine_setup():
    jc, _ = _cfgs()
    params, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n, dtype=np.int32) for n in (3, 11, 6, 17)]


@pytest.mark.parametrize("mode,int8", [("off", False), ("off", True),
                                       ("sim", False)])
def test_engine_tokens_equal_jax_fused_and_port_unfused(engine_setup,
                                                        monkeypatch, mode,
                                                        int8):
    jparams, tparams = engine_setup
    jc, tc = _cfgs(int8)
    prompts = _prompts(10 + int8)
    kw = dict(max_slots=2, max_len=48, cim_mode=mode)
    ja = JEngine(jc, jparams, fuse_layer=True, **kw).generate(
        [JRequest(prompt=p, max_new_tokens=5) for p in prompts])
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return fused_step.fused_dense_layer(*args, **kwargs)

    monkeypatch.setattr(tf, "fused_dense_layer", counted)
    runs = {}
    for fuse in (True, False):
        calls.clear()
        eng = Engine(tc, tparams, fuse_layer=fuse, device="cpu",
                     record_steps=True, **kw)
        runs[fuse] = eng.generate(
            [Request(prompt=p, max_new_tokens=5) for p in prompts])
        n_decode = sum(e["decode"] for e in eng.step_log)
        assert len(calls) == (tc.n_layers * n_decode if fuse else 0)
    assert runs[True] == ja, (runs[True], ja)
    assert runs[True] == runs[False]


def test_deployed_params_carry_every_fused_leaf(engine_setup):
    """The engine's deployed tree (from ``params_from_jax``) holds every
    leaf the fused route reads, and the route is taken for its ctx."""
    _, tparams = engine_setup
    _, tc = _cfgs()
    eng = Engine(tc, tparams, cim_mode="sim", fuse_layer=True, device="cpu")
    layer = tf._index(eng.params["blocks"], 0)
    ctx = Ctx.make(eng.cfg, prng.PRNGKey(0), mode="sim")
    for grp, name in fused_step._LEAVES:
        spec = ctx.spec_for(fused_step._ROLES[
            fused_step._LEAVES.index((grp, name))])
        leaf = layer[grp][name]
        assert leaf[f"wq{spec.w_bits}"].dtype == torch.int8
        assert leaf[f"ws{spec.w_bits}"].shape == ()
    for name in ("q", "k", "v"):
        assert layer["attn"][name]["b"].dtype == torch.float32
    assert layer["n1"]["g"].shape == layer["n2"]["g"].shape == (128,)
    cache = tf._index(eng.caches, 0)
    x = torch.zeros((2, 1, 128))
    assert tf._use_fused_layer(ctx, layer, x, cache)
    assert not tf._use_fused_layer(ctx, layer, torch.zeros((2, 4, 128)),
                                   cache)


def test_fuse_layer_needs_a_float32_model_with_rope(engine_setup,
                                                    monkeypatch):
    """The fused route needs a float32 model with rope. As in the
    reference, ``fuse_layer=True`` on a config the route never takes (bf16,
    no rope) serves unfused: the same tokens as ``fuse_layer=False`` and no
    fused layer call (its launch count stays 0)."""
    _, tparams = engine_setup
    _, tc = _cfgs()
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return fused_step.fused_dense_layer(*args, **kwargs)

    monkeypatch.setattr(tf, "fused_dense_layer", counted)
    before = fused_step.fused_dense_layer.launches
    prompts = _prompts(12)
    for bad in (dataclasses.replace(tc, dtype="bfloat16"),
                dataclasses.replace(tc, use_rope=False)):
        runs = {}
        for fuse in (True, False):
            eng = Engine(bad, tparams, max_slots=2, max_len=48,
                         cim_mode="off", fuse_layer=fuse, device="cpu")
            assert eng.cfg.fuse_layer == fuse
            runs[fuse] = eng.generate(
                [Request(prompt=p, max_new_tokens=4) for p in prompts])
        assert runs[True] == runs[False]
        assert all(len(o) == 4 for o in runs[True])
    assert calls == []
    assert fused_step.fused_dense_layer.launches == before
