"""The port's mamba2 (ssm family) against the JAX package on the reduced
mamba2-130m (float32; parameters carried over by ``params_from_jax``):
the plain selective-scan decode step against the Pallas kernel (interpret
mode) and its oracle, the chunked SSD, the block's three branches, the
deployed planes, whole-model logits, and greedy engine tokens against the
JAX ``Engine`` on ragged prompts with 1-token prompts and recycled slots.

Tolerances: the decode step's new window is exact; its y and state within
rtol = atol = 1e-5 (the JAX package's own kernel test). The SSD and the
block within rtol = atol = 1e-5 (einsum and cumsum summation order). Logits
as in ``test_torch_model.py``: off mode 1e-4 absolute; sim mode 1e-4 on at
least 15 of every 16 token rows and 5e-2 on every row (a batch-mean
activation scale an ulp apart can flip a quantized activation). Engine
tokens are equal exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.deploy import deploy as jdeploy
from repro.kernels.ref import ssm_decode_step_ref
from repro.kernels.ssm_scan import ssm_decode_step as jax_ssm_decode_step
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import deploy, prng
from repro_torch.kernels.ssm_scan import ssm_decode_step
from repro_torch.launch import serve
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import Engine, Request

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(mode="off", impl="einsum"):
    def of(base):
        return dataclasses.replace(
            base.reduced(), attn_impl=impl,
            cim=dataclasses.replace(base.cim, mode=mode, use_kernel=True))
    return of(jget("mamba2-130m")), of(get_config("mamba2-130m"))


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs()
    jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    return jp, deploy.params_from_jax(jax.tree.map(np.asarray, jp))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# --------------------------------------------------- decode step kernel

@pytest.mark.parametrize("shape", ["kernel_test", "reduced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_step_matches_jax_kernel_and_oracle(shape, dtype):
    if shape == "kernel_test":          # tests/test_megakernel.py's shapes
        b, d_inner, g, n, h = 2, 64, 1, 16, 2
    else:                               # the reduced mamba2-130m's
        s = get_config("mamba2-130m").reduced().ssm
        b, d_inner, g, n = 3, 2 * 256, s.ngroups, s.d_state
        h = d_inner // s.headdim
    win, conv_dim = 3, d_inner + 2 * g * n
    rng = np.random.default_rng(11)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)  # noqa: E731
    conv, xbc = f(b, win, conv_dim), f(b, 1, conv_dim)
    conv_w, conv_b = f(win + 1, conv_dim), f(conv_dim)
    dt1 = np.log1p(np.exp(f(b, h)))
    a, d = -np.exp(f(h)), f(h)
    state = f(b, h, d_inner // h, n)
    jdt = jnp.dtype(dtype)
    jargs = (jnp.asarray(conv).astype(jdt), jnp.asarray(xbc).astype(jdt),
             *map(jnp.asarray, (conv_w, conv_b, dt1, a, d, state)))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    targs = (_t(conv).to(tdt), _t(xbc).to(tdt),
             *map(_t, (conv_w, conv_b, dt1, a, d, state)))
    y, new_conv, new_state = ssm_decode_step(*targs, d_inner, g, n)
    assert new_conv.dtype == tdt
    for want in (jax_ssm_decode_step(*jargs, d_inner, g, n, interpret=True),
                 ssm_decode_step_ref(*jargs, d_inner, g, n)):
        wy, wconv, wstate = (np.asarray(w.astype(jnp.float32)) for w in want)
        np.testing.assert_array_equal(_np(new_conv), wconv)
        np.testing.assert_allclose(y.numpy(), wy, **TOL)
        np.testing.assert_allclose(new_state.numpy(), wstate, **TOL)
    # state_out: the same result written in place
    st = targs[-1].clone()
    y2, _, st2 = ssm_decode_step(*targs[:-1], st, d_inner, g, n, state_out=st)
    assert st2 is st and torch.equal(st, new_state) and torch.equal(y2, y)


# ------------------------------------------------------------- SSD

@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(with_h0):
    b, l, h, p, n, chunk = 2, 64, 4, 8, 16, 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    dt[1, 40:] = 0.0                      # a masked tail: state no-ops
    A = -np.linspace(1.0, 8.0, h).astype(np.float32)
    B = rng.normal(size=(b, l, 1, n)).astype(np.float32)
    C = rng.normal(size=(b, l, 1, n)).astype(np.float32)
    h0 = (rng.normal(size=(b, h, p, n)).astype(np.float32) if with_h0
          else None)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk,
                             h0=None if h0 is None else _t(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


# ------------------------------------------------------------ block

@pytest.mark.parametrize("branch", ["train", "prefill", "kernel", "einsum"])
def test_mamba2_block_matches_jax(params, branch):
    impl = "kernel" if branch == "kernel" else "einsum"
    jc, tc = _cfgs("off", impl)
    jp = jax.tree.map(lambda t: t[0], params[0]["blocks"]["mamba"])
    tp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in
                                                    v.items()})
          for k, v in params[1]["blocks"]["mamba"].items()}
    b = 2
    l = 1 if branch in ("kernel", "einsum") else 20
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, l, jc.d_model)).astype(np.float32)
    jcache = tcache = None
    jctx, tctx = JCtx.make(jc), Ctx.make(tc)
    if branch != "train":
        # a nonzero incoming window and state (a slot mid-prompt)
        tcache = {k: _t(rng.normal(size=tuple(v.shape)).astype(np.float32))
                  for k, v in ssm.init_ssm_cache(tc, b, torch.float32).items()}
        jcache = {k: jnp.asarray(v.numpy()) for k, v in tcache.items()}
    if branch == "prefill":
        valid = np.array([13, 20], np.int32)          # row 0: 7 pad tokens
        jctx.prefill_valid = jnp.asarray(valid)
        tctx.prefill_valid = _t(valid)
    jy, jnew = jssm.mamba2_block(jctx, jp, jnp.asarray(x), jcache)
    ty, tnew = ssm.mamba2_block(tctx, tp, _t(x), tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    if branch != "train":
        for k in ("conv", "state"):
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                       **TOL)


# ------------------------------------------------- deploy and params

def test_deployed_ssm_planes_equal_jax_deploy(params):
    jc, tc = _cfgs("sim")
    jd = jdeploy(jc, params[0])["blocks"]["mamba"]
    td = deploy.deploy(tc, params[1])["blocks"]["mamba"]
    n = 0
    for proj in ("in_proj", "out_proj"):
        keys = sorted(k for k in jd[proj] if k != "w")
        assert keys == sorted(k for k in td[proj] if k != "w") and keys
        for k in keys:
            np.testing.assert_array_equal(np.asarray(jd[proj][k]),
                                          td[proj][k].numpy())
            n += 1
    assert n == 4


def test_init_params_matches_jax_ssm_tree_in_law(params):
    tc = get_config("mamba2-130m").reduced()
    jm = jax.tree.map(np.asarray, params[0]["blocks"]["mamba"])
    tp = deploy.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(params[1])
    tm = tp["blocks"]["mamba"]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        a = jm[k]["w"] if isinstance(jm[k], dict) else jm[k]
        t = (tm[k]["w"] if isinstance(tm[k], dict) else tm[k]).numpy()
        assert a.shape == t.shape and str(a.dtype) == str(t.dtype), k
        if k in ("conv_b", "dt_bias"):
            assert not t.any()
        elif k in ("D", "norm_g"):
            assert (t == 1).all()
        elif k == "A_log":
            np.testing.assert_allclose(t, a, rtol=1e-6)
        else:            # N(0, 1/d_in) projections, N(0, 0.2^2) conv
            assert abs(a.std() / t.std() - 1) < 0.05, k


# ---------------------------------------------------------- model

def _close(t, j, mode):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape and np.isfinite(t).all()
    rows = np.abs(t - j).reshape(-1, t.shape[-1]).max(axis=1)
    if mode == "off":
        assert rows.max() <= 1e-4, rows.max()
    else:
        assert (rows > 1e-4).mean() <= 1 / 16 and rows.max() <= 5e-2, rows


@pytest.mark.parametrize("mode", ["off", "sim"])
def test_model_logits_match_jax(params, mode):
    """No-cache forward, then a right-padded prefill chunk and two kernel
    decode steps on a two-row cache."""
    jc, tc = _cfgs(mode, "kernel")
    jp, tp = params
    if mode == "sim":
        jp = jdeploy(jc, jp)
        tp = deploy.deploy(tc, tp)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (2, 16), dtype=np.int32)
    key = prng.PRNGKey(5)

    def ctxs(k, valid=None):
        jctx = JCtx.make(jc, jnp.asarray(np.array(k, np.uint32)),
                         deployed=mode == "sim")
        tctx = Ctx.make(tc, k)
        if valid is not None:
            jctx.prefill_valid = jnp.asarray(valid)
            tctx.prefill_valid = _t(valid)
        return jctx, tctx

    jctx, tctx = ctxs(key)
    jl, _ = jtf.forward(jp, {"tokens": jnp.asarray(toks)}, jc, jctx)
    tl, _ = tf.forward(tp, {"tokens": _t(toks)}, tc, tctx)
    _close(tl, jl, mode)
    jcache, tcache = jtf.init_caches(jc, 2, 64), tf.init_caches(tc, 2, 64)
    valid = np.array([16, 9], np.int32)
    for width in (16, 1, 1):
        key, sub = prng.split(key)
        jctx, tctx = ctxs(sub, valid if width > 1 else None)
        step = toks if width > 1 else rng.integers(
            0, jc.vocab_size, (2, 1), dtype=np.int32)
        jl, jcache = jtf.forward(jp, {"tokens": jnp.asarray(step)}, jc, jctx,
                                 jcache)
        tl, tcache = tf.forward(tp, {"tokens": _t(step)}, tc, tctx, tcache)
        _close(tl, jl, mode)
        for k in ("conv", "state"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=1e-4,
                                       atol=1e-4 if mode == "off" else 5e-2)
    assert not tf.cache_len(tcache).any()


# --------------------------------------------------------- engine

def _prompts(jc):
    rng = np.random.default_rng(4)
    return [rng.integers(0, jc.vocab_size, n, dtype=np.int32)
            for n in (7, 19, 1, 12, 1)]


@pytest.fixture(scope="module")
def jax_ref(params):
    """The reference engine's greedy tokens, one JAX run per mode, on its
    einsum path (the same tokens as on its kernels, which
    ``test_torch_engine_step.py`` and ``test_torch_loop_engine.py`` check
    for the reduced mamba2): both port implementations compare against the
    one run."""
    runs = {}

    def run(mode):
        if mode not in runs:
            jc, _ = _cfgs()
            runs[mode] = JEngine(
                jc, params[0], max_slots=2, max_len=64, chunk_size=8,
                cim_mode=mode, attn_impl="einsum").generate(
                [JRequest(prompt=p, max_new_tokens=5, rid=f"r{i}")
                 for i, p in enumerate(_prompts(jc))])
        return runs[mode]
    return run


@pytest.mark.parametrize("mode,impl", [
    ("off", "kernel"), ("off", "einsum"), ("sim", "kernel"),
    ("sim", "einsum")])
def test_greedy_tokens_equal_jax_engine(params, jax_ref, mode, impl):
    """Ragged prompts with 1-token prompts through 2 slots at chunk 8:
    later occupants ride slots their predecessors dirtied."""
    _, tc = _cfgs()
    ja = jax_ref(mode)
    ta = Engine(tc, params[1], device="cpu", max_slots=2, max_len=64,
                chunk_size=8, cim_mode=mode, attn_impl=impl).generate(
        [Request(prompt=p, max_new_tokens=5, rid=f"r{i}")
         for i, p in enumerate(_prompts(tc))])
    assert ta == ja, (ta, ja)


def test_ssm_engine_options_and_cli():
    _, tc = _cfgs()
    p = deploy.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    # fuse_layer=True on a family the fused route never takes serves
    # unfused, as in the reference: the same tokens as fuse_layer=False
    prompt = np.arange(1, 12) % tc.vocab_size
    runs = [Engine(tc, p, max_len=32, fuse_layer=fuse, device="cpu")
            .generate([Request(prompt=prompt, max_new_tokens=3)])
            for fuse in (True, False)]
    assert runs[0] == runs[1] and len(runs[0][0]) == 3
    outs = serve.main(["--arch", "mamba2-130m", "--reduced", "--cim", "sim",
                       "--attn-impl", "kernel", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20",
                       "--new-tokens", "3", "--kv-int8"])
    assert [len(o) for o in outs] == [3, 3, 3]
