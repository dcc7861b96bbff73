"""The hybrid family on the port against the JAX package: reduced zamba2-7b
(float32, 2 super-blocks of 2 mamba2 layers and the shared attention+MLP
block, d_model 256).

Parameters come from the JAX initialiser through ``params_from_jax``. The
port runs attention and the selective scan through the kernels' routes,
which on the CPU take their plain versions; the reference runs its einsum
attention. Forward logits in off mode within 1e-5 of each row's max
|logit|; ``lm_loss`` within 1e-5 relative; the engines' greedy tokens
equal exactly in off mode and over 5 tokens in sim mode, where they hold
the order in which a super-block draws its 11 CIM keys (in_proj, out_proj
of each mamba layer, then the shared block's q, k, v, o, gate, up, down).

The JAX reference runs (init, engine) are module-scoped and made once;
the module's torch work runs on one CPU thread (``one_thread``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import deploy, prng
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import Engine, Request

ARCH = "zamba2-7b"
LENS = (7, 19, 1, 12, 1)


def _cfgs(mode="off"):
    def of(base):
        return dataclasses.replace(
            base.reduced(), attn_impl="kernel",
            cim=dataclasses.replace(base.cim, mode=mode, use_kernel=True))
    return (dataclasses.replace(of(jget(ARCH)), attn_impl="einsum"),
            of(get_config(ARCH)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc, _ = _cfgs()
    jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    return jp, deploy.params_from_jax(jax.tree.map(np.asarray, jp))


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 512, n, dtype=np.int32) for n in LENS]


@pytest.fixture(scope="module")
def jax_ref(model):
    """The reference engine's greedy tokens, one run per mode (2 slots,
    chunk 8, einsum attention, the CIM kernel path in sim)."""
    runs = {}

    def run(mode):
        if mode not in runs:
            jc, _ = _cfgs(mode)
            runs[mode] = JEngine(
                jc, model[0], max_slots=2, max_len=64, chunk_size=8,
                cim_mode=mode, attn_impl="einsum").generate(
                [JRequest(prompt=p, max_new_tokens=5, rid=f"r{i}")
                 for i, p in enumerate(_prompts())])
        return runs[mode]
    return run


def _rows_close(t, j, rel=1e-5):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape and np.isfinite(t).all()
    t, j = t.reshape(-1, t.shape[-1]), j.reshape(-1, j.shape[-1])
    err = np.abs(t - j).max(-1) / np.abs(j).max(-1)
    assert err.max() <= rel, err.max()


def _tokens(width, seed):
    return np.random.default_rng(seed).integers(0, 512, (2, width),
                                                dtype=np.int32)


def test_forward_logits_match_jax(model):
    """Uncached forward, off mode: the super-blocks in order, the shared
    block's weights in each."""
    jp, tp = model
    jc, tc = _cfgs()
    toks = _tokens(12, 1)
    j = jtf.forward(jp, {"tokens": jnp.asarray(toks)}, jc, JCtx.make(jc))[0]
    t = tf.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                   Ctx.make(tc))[0]
    _rows_close(t, j)


@pytest.mark.parametrize("mode", ["off", "sim"])
def test_cached_prefill_and_decode_match_jax(model, mode):
    """11 tokens prefilled into the cache, then 2 decode steps, each keyed
    alike on both sides: every step's logits, and the cache, leaf for leaf
    through ``hybrid_nested`` (the reference's nested layout, slot on axis
    2 of the mamba leaves)."""
    jp, tp = model
    jc, tc = _cfgs(mode)
    jcache = jtf.init_caches(jc, 2, 32)
    tcache = tf.init_caches(tc, 2, 32)
    nested = tf.hybrid_nested(tc, tcache)
    assert jax.tree.map(lambda a: a.shape, jcache) == jax.tree.map(
        lambda a: tuple(a.shape), nested)
    assert tcache["conv"].shape[:2] == (4, 2)
    assert tcache["k"].shape[:2] == (2, 2)
    for step, width in enumerate((11, 1, 1)):
        toks = _tokens(width, 10 + step)
        jkey = jax.random.PRNGKey(40 + step) if mode == "sim" else None
        tkey = prng.PRNGKey(40 + step) if mode == "sim" else None
        j, jcache = jtf.forward(jp, {"tokens": jnp.asarray(toks)}, jc,
                                JCtx.make(jc, jkey), jcache)
        t, tcache = tf.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                               Ctx.make(tc, tkey), tcache)
        if mode == "off":
            _rows_close(t, j)
        else:       # sim: the greedy token of every row
            assert (t[:, -1].argmax(-1).numpy()
                    == np.asarray(j[:, -1]).argmax(-1)).all()
    nested = tf.hybrid_nested(tc, tcache)
    assert tf.cache_len(tcache).tolist() == [13, 13]
    for part in ("mamba", "attn"):
        for k, v in jcache[part].items():
            a, b = np.asarray(v), nested[part][k].numpy()
            if k == "len" or mode == "off":
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * max(
                    1.0, float(np.abs(a).max())), err_msg=(part, k))


@pytest.mark.parametrize("mode", ["off", "sim"])
def test_engine_tokens_equal_jax_engine(model, jax_ref, mode):
    """5 prompts (two of 1 token) through 2 slots at chunk 8, per call on
    the CPU; in sim the CIM noise seeds come from the device seed table
    (11 rows a super-block)."""
    _, tp = model
    _, tc = _cfgs(mode)
    eng = Engine(tc, tp, device="cpu", max_slots=2, max_len=64,
                 chunk_size=8, cim_mode=mode, attn_impl="kernel")
    assert eng.fused_step and eng._width == (11 if mode == "sim" else 0)
    out = eng.generate([Request(prompt=p, max_new_tokens=5, rid=f"r{i}")
                        for i, p in enumerate(_prompts())])
    assert out == jax_ref(mode), (out, jax_ref(mode))


def test_chunked_equals_whole_prompt(model, jax_ref):
    """Off mode: the whole-prompt path (exact-length prefill: a recurrent
    state would absorb a bucket's pad) gives the chunked run's tokens."""
    _, tp = model
    _, tc = _cfgs()
    reqs = [Request(prompt=p, max_new_tokens=5, rid=f"r{i}")
            for i, p in enumerate(_prompts())]
    eng = Engine(tc, tp, device="cpu", max_slots=2, max_len=64,
                 chunk_size=0, attn_impl="kernel")
    assert not eng.fused_step
    assert eng.generate(reqs) == jax_ref("off")


def test_seed_table_forward_equals_host_keys(model):
    """A sim forward whose CIM seeds come from the seed table (the path a
    CUDA graph replays: one table row per draw, 11 a super-block) equals
    the forward keyed on the host, bit for bit; a 12th draw of a
    super-block raises."""
    _, tp = model
    _, tc = _cfgs("sim")
    tp = deploy.deploy(tc, tp)
    key = prng.PRNGKey(5)
    n_super, n_mamba = tf.hybrid_dims(tc)
    assert (n_super, n_mamba) == (2, 2)
    toks = torch.from_numpy(_tokens(3, 6))
    host = tf.forward(tp, {"tokens": toks}, tc,
                      Ctx.make(tc, key, deployed=True))[0]
    ctx = Ctx.make(tc, key, deployed=True)
    ctx.seeds = torch.from_numpy(prng.seed_table(key, n_super, 11))
    ctx.seed_width = 11
    table = tf.forward(tp, {"tokens": toks}, tc, ctx)[0]
    assert torch.equal(host, table)
    lctx = ctx.for_layer(1)
    for _ in range(11):
        lctx.next_key()
    with pytest.raises(ValueError):
        lctx.next_key()


def test_slot_round_trip_and_frozen_leaves(model):
    """``take_slot``/``put_slot`` on the flat hybrid cache: a slot's views
    carry every leaf with the slot on axis 1, a write lands in its row
    only; the frozen leaves (len, conv, state) go back under a mask."""
    _, tc = _cfgs()
    caches = tf.init_caches(tc, 3, 16)
    sl = tf.take_slot(caches, 1)
    assert set(sl) == {"conv", "state", "k", "v", "len"}
    assert all(v.shape[1] == 1 for v in sl.values())
    g = torch.Generator().manual_seed(0)
    new = {k: torch.randn(v.shape, generator=g).to(v.dtype)
           for k, v in sl.items()}
    tf.put_slot(caches, new, 2)
    for k, v in caches.items():
        assert torch.equal(v[:, 2:3], new[k]), k
        assert not v[:, :2].any(), k
    frozen = tf.freeze_all(caches)
    assert set(frozen) == {"conv", "state", "len"}
    for v in caches.values():
        v.add_(1)
    tf.mask_cache_advance_by(caches, frozen,
                             torch.tensor([True, False, False]))
    for k, v in caches.items():
        if k in frozen:
            assert torch.equal(v[:, 1:], frozen[k][:, 1:]), k
            assert torch.equal(v[:, 0], frozen[k][:, 0] + 1), k


def test_lm_loss_matches_jax(model):
    jp, tp = model
    jc, tc = _cfgs()
    toks = _tokens(10, 3)
    labels = np.random.default_rng(4).integers(-1, 512, (2, 10),
                                               dtype=np.int32)
    j = float(jtf.lm_loss(jp, {"tokens": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)}, jc,
                          JCtx.make(jc)))
    t = tf.lm_loss(tp, {"tokens": torch.from_numpy(toks),
                        "labels": torch.from_numpy(labels)}, tc,
                   Ctx.make(tc)).item()
    assert abs(t - j) <= 1e-5 * abs(j), (t, j)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: v})
    return out


@pytest.mark.parametrize("reduced", [True, False])
def test_init_params_tree_equals_jax(reduced):
    """``init_params``' tree, paths, shapes and dtypes, against the
    reference initialiser's ``eval_shape`` tree: reduced, and at full
    width on the meta device (nothing allocated). The mamba blocks stack
    over (super-block, layer), the shared block is unstacked. zamba2-7b's
    full tree is 4.53 B parameters, not ``param_count()``'s 12.97 B."""
    jc, tc = jget(ARCH), get_config(ARCH)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    got, want = tree_and_reference(jc, tc, "cpu" if reduced else "meta")
    assert got == want
    assert got["mamba_blocks/mamba/in_proj/w"][0][:2] == (
        tf.hybrid_dims(tc))
    assert len(got["shared_attn/attn/q/w"][0]) == 2
    if not reduced:
        n = sum(int(np.prod(s)) for s, _ in got.values())
        assert abs(n / 1e9 - 4.53) < 0.005 and n < tc.param_count(), n


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: v})
    return out


def tree_and_reference(jc, tc, device):
    """(path: (shape, dtype)) of the port's ``init_params`` tree on
    ``device`` and of the reference initialiser's ``eval_shape`` tree."""
    shapes = jax.eval_shape(lambda k: jbuild(jc).init(k)[0],
                            jax.random.PRNGKey(0))
    tree = deploy.init_params(tc, torch.Generator().manual_seed(0), device)
    return ({k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for k, v in _flat(tree).items()},
            {k: (tuple(v.shape), str(v.dtype))
             for k, v in _flat(shapes).items()})


def test_serve_cli_serves_zamba2_reduced():
    """``launch.serve --arch zamba2-7b`` on the CPU: deployed planes, the
    behavioural sim path (the config's ``use_kernel=False``) and the
    kernel routes' plain versions."""
    from repro_torch.launch import serve
    outs = serve.main(["--arch", ARCH, "--reduced", "--cim", "sim",
                       "--attn-impl", "kernel", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "9",
                       "--new-tokens", "2"])
    assert [len(o) for o in outs] == [2, 2, 2]
