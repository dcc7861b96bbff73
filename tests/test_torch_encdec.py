"""The encdec family on the port against the JAX package: reduced
whisper-medium (float32, 2 encoder and 2 decoder layers, d_model 256, 32
stub frames), its frames and tokens seeded with numpy.

Parameters come from the JAX initialiser through ``params_from_jax``. The
port runs the decoder's cached self-attention through the kernels' routes
(plain versions on the CPU); the reference runs its einsum attention.
Logits in off mode within 1e-5 of each row's max |logit|; ``lm_loss``
within 1e-5 relative; greedy tokens of a cached prefill and 5 decode steps
equal in sim mode, which holds the two draw orders of a decoder layer: on
the prefill q, k, v, o, cross k, v, cross q, o, up, down; on a decode step
the cross K/V come from the cache (q, k, v, o, cross q, o, up, down).
``sinusoidal_positions`` within 1e-6. The engines are token-only and
raise on encdec, as the reference's ``Engine`` does.

The module's torch work runs on one CPU thread (``one_thread``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.models.layers import sinusoidal_positions as jsinusoidal
from repro.models.model import build as jbuild
from repro_torch.configs.registry import get_config
from repro_torch.core import deploy, prng
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx, sinusoidal_positions
from repro_torch.serving.engine import Engine, LoopEngine
from test_torch_hybrid import tree_and_reference

ARCH = "whisper-medium"


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


def _batch(width, seed, frames=True):
    jc, _ = _cfgs()
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, jc.vocab_size, (2, width),
                                dtype=np.int32)}
    if frames:
        b["frames"] = rng.normal(size=(2, jc.n_frames, jc.d_model)).astype(
            np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _rows_close(t, j, rel=1e-5):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape and np.isfinite(t).all()
    t, j = t.reshape(-1, t.shape[-1]), j.reshape(-1, j.shape[-1])
    err = np.abs(t - j).max(-1) / np.abs(j).max(-1)
    assert err.max() <= rel, err.max()


def test_forward_logits_match_jax(model):
    """Uncached forward, off mode: the encoder over seeded frames, the
    decoder with cross-attention."""
    jp, tp = model
    jc, tc = _cfgs()
    b = _batch(12, 1)
    j = jtf.forward(jp, _j(b), jc, JCtx.make(jc))[0]
    t = tf.forward(tp, _t(b), tc, Ctx.make(tc))[0]
    _rows_close(t, j)


def test_cached_prefill_and_decode_match_jax(model):
    """Off mode: 12 decoder tokens prefilled with the frames, then 3 decode
    steps from the cache; every step's logits, the self-attention cache
    and the cross K/V the prefill stored, against the reference's."""
    jp, tp = model
    jc, tc = _cfgs()
    jcache = jtf.init_caches(jc, 2, 32)
    tcache = tf.init_caches(tc, 2, 32)
    for step in range(4):
        b = _batch(12 if step == 0 else 1, 10 + step, frames=step == 0)
        j, jcache = jtf.forward(jp, _j(b), jc, JCtx.make(jc), jcache)
        t, tcache = tf.forward(tp, _t(b), tc, Ctx.make(tc), tcache)
        _rows_close(t, j)
    assert tf.cache_len(tcache).tolist() == [15, 15]
    for ours, theirs in (("k", jcache["self"]["k"]),
                         ("v", jcache["self"]["v"]),
                         ("xk", jcache["cross"]["k"]),
                         ("xv", jcache["cross"]["v"])):
        a = np.asarray(theirs)
        np.testing.assert_allclose(tcache[ours].numpy(), a, rtol=0,
                                   atol=1e-5 * np.abs(a).max(), err_msg=ours)


def test_cross_cache_shapes_and_slots(model):
    """The prefill adds ``xk``/``xv`` (L, B, n_frames, KV, D) to the flat
    cache, slot on axis 1 like the self-attention leaves; a decode step
    reads them and leaves them as they are."""
    _, tp = model
    _, tc = _cfgs()
    caches = tf.init_caches(tc, 2, 32)
    assert set(caches) == {"k", "v", "len"}
    tf.forward(tp, _t(_batch(5, 2)), tc, Ctx.make(tc), caches)
    want = (tc.n_layers, 2, tc.n_frames, tc.n_kv_heads, tc.hd)
    assert tuple(caches["xk"].shape) == tuple(caches["xv"].shape) == want
    xk = caches["xk"].clone()
    tf.forward(tp, _t(_batch(1, 3, frames=False)), tc, Ctx.make(tc), caches)
    assert torch.equal(caches["xk"], xk)
    sl = tf.take_slot(caches, 1)
    assert tuple(sl["xk"].shape) == (tc.n_layers, 1) + want[2:]
    assert torch.equal(sl["xk"][:, 0], xk[:, 1])


def test_cached_greedy_sim_tokens_match_jax(model):
    """Sim mode on deployed planes: a keyed prefill, then 5 greedy decode
    steps, each keyed ``fold_in(PRNGKey(21), step)`` on both sides; the
    greedy tokens equal at every step."""
    jp, tp = model
    jc, tc = _cfgs("sim")
    from repro.core.deploy import deploy as jdeploy
    jd, td = jdeploy(jc, jp), deploy.deploy(tc, tp)
    jcache = jtf.init_caches(jc, 2, 32)
    tcache = tf.init_caches(tc, 2, 32)
    b = _batch(12, 4)
    jb, tb = _j(b), _t(b)
    jtoks, ttoks = [], []
    for step in range(6):
        jk = jax.random.fold_in(jax.random.PRNGKey(21), step)
        tk = prng.fold_in(prng.PRNGKey(21), step)
        j, jcache = jtf.forward(jd, jb, jc, JCtx.make(jc, jk, deployed=True),
                                jcache)
        t, tcache = tf.forward(td, tb, tc, Ctx.make(tc, tk, deployed=True),
                               tcache)
        jn = np.asarray(j[:, -1]).argmax(-1)
        tn = t[:, -1].argmax(-1)
        jtoks.append(jn.tolist())
        ttoks.append(tn.tolist())
        jb = {"tokens": jnp.asarray(jn[:, None].astype(np.int32))}
        tb = {"tokens": tn[:, None]}
    assert ttoks == jtoks, (ttoks, jtoks)


def test_sinusoidal_positions_match_jax():
    """An int count and a (B, S) tensor of positions (the decoder's,
    offset by the cache length), d 256 and 1024."""
    for d in (256, 1024):
        np.testing.assert_allclose(sinusoidal_positions(448, d).numpy(),
                                   np.asarray(jsinusoidal(448, d)),
                                   rtol=0, atol=1e-6)
    pos = np.array([[0, 1, 2], [300, 301, 302]], np.int32)
    want = jax.vmap(lambda p: jsinusoidal(p, 256))(jnp.asarray(pos))
    np.testing.assert_allclose(
        sinusoidal_positions(torch.from_numpy(pos), 256).numpy(),
        np.asarray(want), rtol=0, atol=1e-6)


def test_lm_loss_matches_jax(model):
    jp, tp = model
    jc, tc = _cfgs()
    b = _batch(10, 3)
    b["labels"] = np.random.default_rng(4).integers(
        -1, jc.vocab_size, (2, 10), dtype=np.int32)
    j = float(jtf.lm_loss(jp, _j(b), jc, JCtx.make(jc)))
    t = tf.lm_loss(tp, _t(b), tc, Ctx.make(tc)).item()
    assert abs(t - j) <= 1e-5 * abs(j), (t, j)


@pytest.mark.parametrize("reduced", [True, False])
def test_init_params_tree_equals_jax(reduced):
    """``init_params``' tree (encoder and decoder blocks, the decoder's
    cross-attention, layernorms with biases, the GELU MLP's biases,
    ``enc_norm``) against the reference initialiser's ``eval_shape``
    tree: reduced, and at full width on the meta device. 0.758 B
    parameters at full width, not ``param_count()``'s 1.11 B."""
    jc, tc = jget(ARCH), get_config(ARCH)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    got, want = tree_and_reference(jc, tc, "cpu" if reduced else "meta")
    assert got == want
    assert "dec_blocks/cross/k/w" in got and "enc_norm/b" in got
    if not reduced:
        n = sum(int(np.prod(s)) for s, _ in got.values())
        assert abs(n / 1e9 - 0.758) < 0.001 and n < tc.param_count(), n


def test_engines_raise_on_encdec(model):
    """The token-only engines and the serve CLI raise ``ValueError``
    naming encdec, as the reference's ``Engine`` does."""
    _, tp = model
    _, tc = _cfgs()
    for cls in (Engine, LoopEngine):
        with pytest.raises(ValueError, match="encdec"):
            cls(tc, tp, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
