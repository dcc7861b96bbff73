"""The port's mixture-of-experts block and the deepseek-v2 serving path
against the JAX package, on the reduced deepseek-v2 (float32, 8 experts,
top-2, 2 shared; parameters carried over by ``params_from_jax``): routing
indices, the deployed expert planes, ``moe_block`` in off and deployed sim
mode, the torch-native initialiser in law, and greedy engine tokens
against the JAX ``Engine`` with recycled slots.

Tolerances: routing (top-k ids, dispatch positions, keep mask) and the
expert planes and scales are exact. ``moe_block`` in off mode within 2e-6
of each token row's max |value| (the f32 router, expert and shared
products sum in another order; 9.6e-7 measured). In sim mode JAX's
activation scales are fed to the shared expert's CIM linears and the
expert noise is the ``jax.random.normal`` twin, 3 ulp of a standard normal
apart: outputs within 1e-4 on at least 15 of every 16 token rows and 5e-2
on every row (an ulp can still move a quantized activation into the next
bucket). Engine tokens are equal exactly.

The JAX reference runs are made once per module and shared: the params,
their deployed planes (``deployed``) and the engine's token runs
(``jax_ref``). The module's torch work runs on one CPU thread
(``one_thread``): the suite runs several test processes side by side,
and a torch thread pool per process oversubscribes the cores."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core.deploy import deploy as jdeploy
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.layers import Ctx as JCtx
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import deploy, prng
from repro_torch.launch import serve
from repro_torch.models import layers, moe
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import Engine, Request


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(mode="off", impl="einsum"):
    def of(base):
        return dataclasses.replace(
            base.reduced(), attn_impl=impl,
            cim=dataclasses.replace(base.cim, mode=mode, use_kernel=True))
    return of(jget("deepseek-v2-236b")), of(get_config("deepseek-v2-236b"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs()
    jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    return jp, deploy.params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def deployed(params):
    """The sim-mode deploy of both trees, made once: (JAX, port)."""
    jc, tc = _cfgs("sim")
    return jdeploy(jc, params[0]), deploy.deploy(tc, params[1])


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("tl,capacity", [(16, 32), (16, 5), (3, 6)])
def test_topk_and_dispatch_indices_equal_jax(tl, capacity):
    """Top-k ids (descending, ties to the lower id: every fourth row holds
    exact ties) and each assignment's slot and keep mask, as integers."""
    rng = np.random.default_rng(tl + capacity)
    probs = rng.random((tl, 8)).astype(np.float32)
    probs[::4, 2] = probs[::4, 5] = probs[::4, 7] = 2.0
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = torch.sort(_t(probs), dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(ti[:, :2].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv[:, :2].numpy(), np.asarray(jv))
    flat = np.asarray(ji).reshape(-1)
    jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(flat), 8, capacity)
    tpos, tkeep = moe._dispatch_indices(_t(flat.astype(np.int64)), 8,
                                        capacity)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


def test_router_ids_equal_jax(params):
    """The block's router on real activations: the same experts, exactly."""
    jc, tc = _cfgs()
    jp = _layer0(params[0]["blocks"]["moe"])
    tp = _layer0(params[1]["blocks"]["moe"])
    x = np.random.default_rng(2).normal(size=(64, jc.d_model)).astype(
        np.float32)
    logits = jlayers.dense(JCtx.make(jc), jp["router"], jnp.asarray(x),
                           "router")
    _, ji = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jc.moe.top_k)
    _, ti = moe.route(Ctx.make(tc), tp, _t(x), tc.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------- planes and params

def test_deployed_expert_planes_equal_jax(deployed):
    jd, td = (d["blocks"]["moe"] for d in deployed)
    planes = sorted(k for k in jd if k.startswith("w_") and "_" in k[2:])
    assert planes == sorted(k for k in td if k.startswith("w_")
                            and "_" in k[2:])
    assert len(planes) == 6
    for k in planes:
        a, b = np.asarray(jd[k]), td[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for name in ("gate", "up", "down"):
        for k in ("wq6", "ws6"):
            np.testing.assert_array_equal(np.asarray(jd["shared"][name][k]),
                                          td["shared"][name][k].numpy())
    ja, ta = (d["blocks"]["attn"] for d in deployed)
    for name in ("dq", "uq", "dkv", "uk", "uv", "o"):
        for k in ("wq4", "ws4"):
            np.testing.assert_array_equal(np.asarray(ja[name][k]),
                                          ta[name][k].numpy())


def test_init_params_matches_jax_moe_tree_in_law(params):
    tc = get_config("deepseek-v2-236b").reduced()
    jp = jax.tree.map(np.asarray, params[0])
    tp = deploy.init_params(tc, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {pre + k: v})
        return out

    jf, tf_ = flat(jp), flat(tp)
    assert sorted(jf) == sorted(tf_)
    for k, a in jf.items():
        t = tf_[k].numpy()
        assert a.shape == t.shape and str(a.dtype) == str(t.dtype), k
        if k.endswith("/g"):
            assert (t == 1).all(), k
        elif "/w_" in k:        # U(-1/sqrt(d), 1/sqrt(d)) expert banks
            lim = tc.d_model ** -0.5
            assert np.abs(t).max() <= lim and np.abs(a).max() <= lim, k
            assert abs(a.std() / t.std() - 1) < 0.05, k
        else:                   # N(0, 1/d_in) weights, N(0, 0.02^2) embed
            assert abs(a.std() / t.std() - 1) < 0.05, k


# ------------------------------------------------------------ block

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


@pytest.mark.parametrize("mode", ["off", "sim"])
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_block_matches_jax(params, deployed, fed_scales, mode,
                              dropless):
    jc, tc = _cfgs(mode)
    jp, tp = deployed if mode == "sim" else params
    jp, tp = _layer0(jp["blocks"]["moe"]), _layer0(tp["blocks"]["moe"])
    x = np.random.default_rng(6).normal(size=(2, 24, jc.d_model)).astype(
        np.float32)
    key = prng.fold_in(prng.PRNGKey(7), 1)
    jctx = JCtx.make(jc, jnp.asarray(np.array(key, np.uint32)), mode=mode,
                     deployed=mode == "sim")
    tctx = Ctx.make(tc, key, mode=mode)
    j = np.asarray(jmoe.moe_block(jctx, jp, jnp.asarray(x),
                                  dropless=dropless)).reshape(-1, jc.d_model)
    t = moe.moe_block(tctx, tp, _t(x), dropless=dropless).numpy().reshape(
        -1, jc.d_model)
    assert not fed_scales and tctx.counter == jctx.counter
    rows = np.abs(t - j).max(-1)
    if mode == "off":
        assert (rows <= 2e-6 * np.abs(j).max(-1)).all(), rows.max()
    else:
        assert tctx.counter == 6
        assert (rows > 1e-4).mean() <= 1 / 16 and rows.max() <= 5e-2, rows


# --------------------------------------------------------- engine

def _prompts(jc):
    rng = np.random.default_rng(4)
    return [rng.integers(0, jc.vocab_size, n, dtype=np.int32)
            for n in (7, 19, 1, 12, 40)]


@pytest.fixture(scope="module")
def jax_ref(params):
    """The reference engine's greedy tokens, one JAX run per mode, on its
    einsum path (the same tokens as on its kernels,
    ``test_reference_on_its_kernels_equals_its_einsum_run``): both port
    implementations compare against the one run."""
    runs = {}

    def run(mode, impl="einsum"):
        if (mode, impl) not in runs:
            jc, _ = _cfgs(impl=impl)
            runs[mode, impl] = JEngine(
                jc, params[0], max_slots=2, max_len=64, chunk_size=8,
                cim_mode=mode, attn_impl=impl).generate(
                [JRequest(prompt=p, max_new_tokens=5, rid=f"r{i}")
                 for i, p in enumerate(_prompts(jc))])
        return runs[mode, impl]
    return run


def test_reference_on_its_kernels_equals_its_einsum_run(jax_ref):
    """The shared reference runs on its einsum path; on its kernels
    (interpret mode) it gives the same greedy tokens in sim mode."""
    assert jax_ref("sim", "kernel") == jax_ref("sim")


@pytest.mark.parametrize("mode,impl", [
    ("off", "kernel"), ("off", "einsum"), ("sim", "kernel"),
    ("sim", "einsum")])
def test_greedy_tokens_equal_jax_engine(params, jax_ref, mode, impl):
    """Five ragged prompts (a 1-token one among them) through 2 slots at
    chunk 8: later occupants ride slots their predecessors dirtied."""
    _, tc = _cfgs()
    ja = jax_ref(mode)
    ta = Engine(tc, params[1], device="cpu", max_slots=2, max_len=64,
                chunk_size=8, cim_mode=mode, attn_impl=impl).generate(
        [Request(prompt=p, max_new_tokens=5, rid=f"r{i}")
         for i, p in enumerate(_prompts(tc))])
    assert ta == ja, (ta, ja)


def test_moe_engine_options_and_cli():
    _, tc = _cfgs()
    p = deploy.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    # fuse_layer=True on a family the fused route never takes serves
    # unfused, as in the reference: the same tokens as fuse_layer=False
    prompt = np.arange(1, 12) % tc.vocab_size
    runs = [Engine(tc, p, max_len=32, fuse_layer=fuse, device="cpu")
            .generate([Request(prompt=prompt, max_new_tokens=3)])
            for fuse in (True, False)]
    assert runs[0] == runs[1] and len(runs[0][0]) == 3
    # moe with GQA attention (olmoe) serves per call: its expert noise is
    # keyed on the host, so fused_step=True raises as for MLA
    gqa_moe = dataclasses.replace(tc, name="moe-gqa", mla=None)
    with pytest.raises(NotImplementedError, match="capture"):
        Engine(gqa_moe, p, fused_step=True, device="cpu")
    outs = serve.main(["--arch", "deepseek-v2-236b", "--reduced", "--cim",
                       "sim", "--attn-impl", "kernel", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20",
                       "--new-tokens", "3"])
    assert [len(o) for o in outs] == [3, 3, 3]
