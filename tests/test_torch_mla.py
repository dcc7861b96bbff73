"""The port's multi-head latent attention (deepseek-v2) against the JAX
package, on the reduced deepseek-v2 (float32; parameters carried over by
``params_from_jax``): the plain latent-cache decode kernel against the
Pallas kernel in interpret mode and its oracle, ``mla_attention`` prefill
then decode through both decode branches in off and deployed sim mode,
and a ragged batched decode against decoding each sequence alone.

Tolerances: the decode kernel's plain version within 1e-5 of each output
row's max |value| (the row is one (slot, head) over the latent width;
float sums run in another order). ``mla_attention`` outputs and written
latent rows within 1e-4 absolute on outputs of unit scale in off mode; in
sim mode JAX's activation scales are fed to the port (a batch-mean scale
an ulp apart would move a quantized activation into the next bucket) and
outputs are held to 1e-4 on at least 15 of every 16 rows and 5e-2 on
every row (the CIM noise's Box-Muller ulps can still flip an activation
at a bucket edge)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.deploy import deploy as jdeploy
from repro.kernels.mla_decode import mla_decode_attention as jmla
from repro.kernels.ref import mla_decode_attention_ref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.layers import Ctx as JCtx
from repro.models.model import build as jbuild
from repro_torch.configs.registry import get_config
from repro_torch.core import deploy, prng
from repro_torch.kernels.mla_decode import (mla_decode_attention,
                                            mla_decode_attention_plain)
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.layers import Ctx


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows_within(t, j, tol):
    err = np.abs(t - j).max(-1)
    return err <= tol * np.abs(j).max(-1)


# ------------------------------------------------------ decode kernel

@pytest.mark.parametrize("h,lat,rope,t", [(4, 64, 16, 40),     # reduced
                                          (8, 512, 64, 64)])
def test_plain_mla_decode_matches_jax_kernel_and_oracle(h, lat, rope, t):
    rng = np.random.default_rng(lat)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)  # noqa: E731
    lens = np.array([0, t, 1, 23], np.int32)
    args = (f(4, h, lat), f(4, h, rope), f(4, t, lat), f(4, t, rope))
    scale = 1.0 / (lat // 2 + rope) ** 0.5
    p = mla_decode_attention_plain(*map(_t, args), _t(lens), scale).numpy()
    jargs = tuple(map(jnp.asarray, args)) + (jnp.asarray(lens),)
    for j in (jmla(*jargs, scale=scale, block_k=16, interpret=True),
              mla_decode_attention_ref(*jargs, scale)):
        assert _rows_within(p, np.asarray(j), 1e-5).all()
    assert not p[0].any()
    w = mla_decode_attention(*map(_t, args), _t(lens), scale)
    assert torch.equal(w, _t(p))


# ------------------------------------------------- mla_attention

def _cfgs(impl):
    def of(base):
        return dataclasses.replace(
            base.reduced(), attn_impl=impl,
            cim=dataclasses.replace(base.cim, use_kernel=True))
    return of(jget("deepseek-v2-236b")), of(get_config("deepseek-v2-236b"))


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs("einsum")
    jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    sim = dataclasses.replace(tc, cim=dataclasses.replace(tc.cim, mode="sim"))
    jd = jdeploy(jc, jp)
    td = deploy.deploy(sim, deploy.params_from_jax(
        jax.tree.map(np.asarray, jp)))
    return ({"off": jp, "sim": jd}, {"off": deploy.params_from_jax(
        jax.tree.map(np.asarray, jp)), "sim": td})


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


@pytest.fixture
def fed_scales(monkeypatch):
    """JAX's per-call activation scales, replayed in call order by the
    port's dense (both draw them in the same order)."""
    seen = []
    real = jlayers._act_scale

    def record(ctx, x, spec):
        s = real(ctx, x, spec)
        seen.append(None if s is None else np.asarray(s))
        return s

    def replay(ctx, x, spec):
        s = seen.pop(0)
        return None if s is None else torch.tensor(s)

    monkeypatch.setattr(jlayers, "_act_scale", record)
    monkeypatch.setattr(layers, "_act_scale", replay)
    return seen


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("mode", ["off", "sim"])
def test_mla_attention_prefill_then_decode(params, fed_scales, impl, mode):
    """A 12-token prefill into a ragged cache (rows at 0 and 5), then two
    decode tokens: outputs, written latent rows and lengths match."""
    jc, tc = _cfgs(impl)
    jp = _layer0(params[0][mode]["blocks"]["attn"])
    tp = _layer0(params[1][mode]["blocks"]["attn"])
    b, t = 2, 32
    rng = np.random.default_rng(5)
    jcache = jattn.init_mla_cache(jc, b, t, jnp.float32)
    tcache = attn.init_mla_cache(tc, b, t, torch.float32)
    jcache["len"] = jnp.asarray([0, 5], jnp.int32)
    tcache["len"].copy_(torch.tensor([0, 5]))
    key = prng.PRNGKey(3)
    for step_s in (12, 1, 1):
        key, sub = prng.split(key)
        jctx = JCtx.make(jc, jnp.asarray(np.array(sub, np.uint32)),
                         mode=mode, deployed=mode == "sim")
        tctx = Ctx.make(tc, sub, mode=mode)
        x = rng.normal(size=(b, step_s, jc.d_model)).astype(np.float32)
        pos = np.asarray(jcache["len"])[:, None] + np.arange(step_s)[None]
        jo, jcache = jattn.mla_attention(jctx, jp, jnp.asarray(x),
                                         jnp.asarray(pos), jcache)
        to, tcache = attn.mla_attention(tctx, tp, _t(x), _t(pos), tcache)
        assert not fed_scales
        assert tctx.counter == jctx.counter == (
            0 if mode == "off" else 6 if step_s > 1 else 4)
        j, o = np.asarray(jo).reshape(-1, jc.d_model), to.numpy().reshape(
            -1, jc.d_model)
        if mode == "off":
            np.testing.assert_allclose(o, j, rtol=0, atol=1e-4)
        else:
            rows = np.abs(o - j).max(-1)
            assert (rows > 1e-4).mean() <= 1 / 16 and rows.max() <= 5e-2
        assert tcache["len"].tolist() == np.asarray(jcache["len"]).tolist()
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), rtol=0,
                                       atol=1e-4 if mode == "off" else 5e-2)


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
def test_ragged_batched_decode_equals_per_sequence(params, impl):
    """One batched decode step against ragged per-sequence lengths equals
    decoding each sequence alone (the port's twin of
    ``test_serving_fused.py::test_ragged_batched_decode_equals_per_sequence``
    for MLA), within 1e-5 of each output's scale."""
    _, tc = _cfgs(impl)
    tp = _layer0(params[1]["off"]["blocks"]["attn"])
    ctx = Ctx.make(tc)
    lens = [5, 11, 2]
    rng = np.random.default_rng(8)
    rows = []
    for n in lens:
        c = attn.init_mla_cache(tc, 1, 24, torch.float32)
        x = _t(rng.normal(size=(1, n, tc.d_model)).astype(np.float32))
        attn.mla_attention(ctx, tp, x, torch.arange(n)[None], c)
        rows.append(c)
    batched = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    assert batched["len"].tolist() == lens
    x_new = _t(rng.normal(size=(3, 1, tc.d_model)).astype(np.float32))
    out_b, new_b = attn.mla_attention(ctx, tp, x_new,
                                      torch.tensor(lens)[:, None], batched)
    assert new_b["len"].tolist() == [n + 1 for n in lens]
    for i, n in enumerate(lens):
        out_1, _ = attn.mla_attention(ctx, tp, x_new[i:i + 1],
                                      torch.tensor([[n]]), rows[i])
        scale = max(out_1.abs().max().item(), 1.0)
        assert (out_b[i] - out_1[0]).abs().max().item() <= 1e-5 * scale
