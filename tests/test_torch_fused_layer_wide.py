"""The port's per-layer decode megakernel (``kernels/fused_step.py``, its
plain version on the CPU) at head dims 96, 112 and 128 against the JAX
``fused_dense_layer`` (Pallas, interpret mode on the CPU), at reduced widths
(d 128, d_ff 256) on the registry archs the kernel now fuses on the card:
phi3-mini (hd 96, G = H / KV = 1), zamba2-7b's shared block (hd 112, G 1),
internlm2-1.8b (hd 128, G 2), pixtral-12b (hd 128, G 4) and deepseek-67b
(hd 128, G 8). One layer on a ragged 4-row cache (lens 1, 38, 101, 151
after the write) in sim mode with f32 and int8 caches and in off mode at
one shape; then greedy engine tokens with ``fuse_layer=True`` against the
JAX engine (and the port's unfused engine) for a reduced hd-96 dense model
and a reduced zamba2 with hd 112.

Tolerances are ``tests/test_torch_fused_layer.py``'s, from float32
summation order alone (the noise, the quantized activations and the int8
codes replay the reference): each output row within 2^-16 of that row's
largest |value|; the written f32 cache rows within 1e-6 relative; int8
codes equal or one apart and their scales within 1e-6 relative; every
other cache entry untouched (exactly equal). The module's torch work runs
on one CPU thread (``one_thread``)."""

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
# (arch, head dim, heads, KV heads): every new head dim and every G of 1-8
SHAPES = [("phi3-mini-3.8b", 96, 2, 2), ("zamba2-7b", 112, 2, 2),
          ("internlm2-1.8b", 128, 4, 2), ("pixtral-12b", 128, 4, 1),
          ("deepseek-67b", 128, 8, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, hd, h, kv, int8=False):
    def tiny(base):
        c = base.reduced()
        return dataclasses.replace(
            c, d_model=128, d_ff=256, vocab_size=128, n_heads=h,
            n_kv_heads=kv, head_dim=hd, kv_cache_int8=int8,
            cim=dataclasses.replace(c.cim, use_kernel=True))
    return tiny(jget(arch)), tiny(get_config(arch))


def _layer(cfg, params):
    """The dense layer the fused route takes: layer 0 of a dense or vlm
    model, zamba2's shared block."""
    if cfg.family == "hybrid":
        return params["shared_attn"]
    return jax.tree.map(lambda a: a[0], params["blocks"])


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


@pytest.mark.parametrize("mode,int8,shape", [
    *[("sim", i, s) for s in SHAPES for i in (False, True)],
    ("off", False, SHAPES[1])])
def test_layer_matches_jax_fused_dense_layer(mode, int8, shape):
    arch, hd, h, kv = shape
    jc, tc = _cfgs(arch, hd, h, kv, int8)
    assert tc.hd == hd and fused_step.kernel_takes(tc, B)
    jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    if mode == "sim":
        jp = jdeploy(jc, jp)
    layer = _layer(jc, jp)
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


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n, dtype=np.int32) for n in (3, 11, 6, 17)]


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1]])
def test_engine_tokens_equal_jax_fused_and_port_unfused(monkeypatch, shape):
    """Sim mode, 2 slots, chunk 8: the JAX engine with ``fuse_layer=True``
    against the port's engine fused (one fused call a layer a decode step;
    zamba2: one a super-block) and unfused."""
    arch, hd, h, kv = shape
    jc, tc = _cfgs(arch, hd, h, kv)
    jparams, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompts = _prompts(20)
    kw = dict(max_slots=2, max_len=48, cim_mode="sim", chunk_size=8)
    # the reference's hybrid engine on einsum attention, as in
    # tests/test_torch_hybrid.py
    jkw = dict(attn_impl="einsum") if jc.family == "hybrid" else {}
    ja = JEngine(jc, jparams, fuse_layer=True, **kw, **jkw).generate(
        [JRequest(prompt=p, max_new_tokens=5) for p in prompts])
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return fused_step.fused_dense_layer(*args, **kwargs)

    monkeypatch.setattr(tf, "fused_dense_layer", counted)
    per_step = (tf.hybrid_dims(tc)[0] if tc.family == "hybrid"
                else tc.n_layers)
    runs = {}
    for fuse in (True, False):
        calls.clear()
        eng = Engine(tc, tparams, fuse_layer=fuse, device="cpu",
                     record_steps=True, **kw)
        runs[fuse] = eng.generate(
            [Request(prompt=p, max_new_tokens=5) for p in prompts])
        n_decode = sum(e["decode"] for e in eng.step_log)
        assert n_decode > 0
        assert len(calls) == (per_step * n_decode if fuse else 0)
    assert runs[True] == ja, (runs[True], ja)
    assert runs[True] == runs[False]
