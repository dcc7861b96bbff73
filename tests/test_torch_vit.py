"""The port's ViT, noise-aware QAT and CIFAR-shaped data against the JAX
package.

``fake_quant`` is held elementwise, its gradients with respect to x and
to the scale too, ties at the abs-max included (``jnp.clip`` splits the
cotangent evenly there). The ViT forward runs on ``params_from_jax`` in
off, qat, behavioural sim and kernel sim (row 1's plain version, on
deployed planes). Where an activation is fake-quantized, an ulp of its
input (an einsum's summation order, C4's normal draws) can flip it across
a rounding boundary, and the flip then moves that image's logits by a
whole quantization step: such images are counted, not hidden.

The JAX params, the eval batch and the deploy of both trees are made once
per module (``model``, ``deployed``) and shared by the cases. The module's
torch work runs on one CPU thread (``one_thread``): the suite runs
several test processes side by side, and a torch thread pool per process
oversubscribes the cores.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import cim as jcim
from repro.core import quant as jquant
from repro.core.deploy import deploy as jdeploy
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import image_batch as jimage_batch
from repro.models import vit as jvit
from repro.models.layers import Ctx as JCtx
from repro.models.model import build as jbuild
from repro_torch.configs.registry import get_config
from repro_torch.core import cim, quant
from repro_torch.core.sac import get_policy
from repro_torch.core.deploy import deploy, init_params, params_from_jax
from repro_torch.data.pipeline import DataConfig, image_batch
from repro_torch.kernels.cim_matmul import cim_matmul_fused
from repro_torch.models import vit
from repro_torch.models.layers import Ctx
from repro_torch.models.model import build
from repro_torch.serving.engine import Engine
from repro_torch.training.optimizer import tree_leaves

SMALL = dict(n_layers=2, d_model=128, d_ff=256, n_heads=4, n_kv_heads=4,
             head_dim=32)
KEYS = [(0, 3), (0, 7), (5, 11)]


def _cfgs(use_kernel=False):
    jc = dataclasses.replace(jget("vit-small-cifar").reduced(), **SMALL)
    tc = dataclasses.replace(get_config("vit-small-cifar").reduced(), **SMALL)
    jc = dataclasses.replace(jc, cim=dataclasses.replace(
        jc.cim, use_kernel=use_kernel))
    tc = dataclasses.replace(tc, cim=dataclasses.replace(
        tc.cim, use_kernel=use_kernel))
    return jc, tc


def _jkey(key):
    return None if key is None else jnp.asarray(np.array(key, np.uint32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    params, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    x, y = jimage_batch(JData(seed=5, global_batch=100), 3, split="eval")
    return jc, tc, params, params_from_jax(jax.tree.map(np.asarray, params)), \
        x, y


@pytest.fixture(scope="module")
def deployed(model):
    """The sim-mode deploy on the kernel path, made once: (JAX, port)."""
    _, _, params, tp, _, _ = model
    jc, tc = _cfgs(use_kernel=True)
    return jdeploy(jc, params), deploy(tc, tp)


def _no_noise(policy):
    return dataclasses.replace(
        policy, attn=dataclasses.replace(policy.attn, noise_scale=0.0),
        mlp=dataclasses.replace(policy.mlp, noise_scale=0.0))


def test_image_batch_exact():
    for split in ("train", "eval"):
        for step in (0, 7):
            a = jimage_batch(JData(seed=5, global_batch=6), step, split)
            b = image_batch(DataConfig(seed=5, global_batch=6), step, split)
            for u, v in zip(a, b):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_fake_quant_values_and_gradients(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(9, 31)).astype(np.float32)
    x[2, 5] = -np.abs(x).max() - 0.25           # a tied abs-max pair
    x[6, 1] = -x[2, 5]
    c = rng.normal(size=x.shape).astype(np.float32)
    s = np.asarray(jquant.abs_max_scale(jnp.asarray(x), bits))
    # elementwise: the scale as a full array, one cotangent per element
    sf = np.full(x.shape, s, np.float32)

    def jf(x, s):
        return jnp.sum(jquant.fake_quant(x, s, bits) * c)

    val = np.asarray(jquant.fake_quant(jnp.asarray(x), jnp.asarray(s), bits))
    gx, gs = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(sf))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(sf).requires_grad_()
    out = quant.fake_quant(tx, ts, bits)
    (out * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(
        quant.fake_quant(torch.from_numpy(x), torch.tensor(s), bits).numpy(),
        val)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=1e-6)
    # the scale's gradient round(x/s) - x/s cancels terms of size |x/s|
    # (up to qmax): within 1e-6 of that size
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=0,
                               atol=1e-6 * quant.qmax(bits) * np.abs(c).max())
    # the tied elements sit on the clip bound: half the cotangent each way
    assert tx.grad[2, 5] == 0.5 * c[2, 5] and tx.grad[6, 1] == 0.5 * c[6, 1]
    # through the abs-max scale (amax spreads over the tie, as jnp.max):
    # a sum over elements, so within f32 rounding of that sum
    g2 = np.asarray(jax.grad(lambda x: jf(
        x, jquant.abs_max_scale(x, bits)))(jnp.asarray(x)))
    tx2 = torch.from_numpy(x).requires_grad_()
    (quant.fake_quant(tx2, quant.abs_max_scale(tx2, bits), bits)
     * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(tx2.grad.numpy(), g2, rtol=0,
                               atol=1e-6 * np.abs(c).sum())


@pytest.mark.parametrize("key", [None, (0, 9)])
def test_cim_dense_qat_matches_jax(key):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 384)).astype(np.float32)
    w = (0.05 * rng.normal(size=(384, 96))).astype(np.float32)
    for spec_j, spec_t in ((jcim.CIMSpec(), cim.CIMSpec()),
                           (jcim.CIMSpec(in_bits=4, w_bits=4, cb=False),
                            cim.CIMSpec(in_bits=4, w_bits=4, cb=False))):
        xs = np.float32(4.0 * np.sqrt(np.mean(x * x))
                        / quant.qmax(spec_t.in_bits))
        j = np.asarray(jcim.cim_dense(jnp.asarray(x), jnp.asarray(w), spec_j,
                                      _jkey(key), mode="qat",
                                      x_scale=jnp.asarray(xs)))
        t = cim.cim_dense(torch.from_numpy(x), torch.from_numpy(w), spec_t,
                          key, mode="qat", x_scale=torch.tensor(xs)).numpy()
        # without a key exact but for the einsum's order; the noise is
        # within C4's ulps
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


def _image_rel(a, b):
    """Per-image max error relative to the image's largest logit."""
    return np.abs(a - b).max(-1) / np.abs(a).max(-1)


@pytest.mark.parametrize("mode,key", [("off", None), ("qat", None),
                                      ("qat", KEYS[1]), ("sim", KEYS[1])])
def test_vit_forward_matches_jax(model, mode, key):
    """off: every image's logits within 1e-4 of the largest; qat with the
    noise off: 98 % of the images so; with the macro's noise (qat and sim,
    C4's ulps): the greedy class of at least 99 % of the images."""
    jc, tc, params, tp, x, _ = model
    noisy = mode == "sim" or (mode == "qat" and key is not None)
    jctx = JCtx.make(jc, _jkey(key), mode=mode)
    tctx = Ctx.make(tc, key, mode=mode)
    if mode == "qat" and not noisy:
        # no key still keys the layers (fold_in(PRNGKey(0), i)): zero the
        # noise instead
        jctx.policy, tctx.policy = (_no_noise(jctx.policy),
                                    _no_noise(tctx.policy))
    a = np.asarray(jvit.vit_forward(params, jnp.asarray(x), jc, jctx))
    b = vit.vit_forward(tp, torch.from_numpy(x), tc, tctx).numpy()
    if noisy:
        assert np.mean(a.argmax(-1) == b.argmax(-1)) >= 0.99
    elif mode == "off":
        assert _image_rel(a, b).max() <= 1e-4
    else:
        # even without noise an einsum's ulp can flip a fake-quant rounding
        # (one image of these 100 in the recorded run)
        assert np.mean(_image_rel(a, b) <= 1e-4) >= 0.98


def test_vit_forward_kernel_path_on_deployed_planes(model, deployed):
    """sim with ``cim.use_kernel`` on deployed planes: the patch embedding
    and every block linear run row 1 (its plain version on the CPU)."""
    x = model[4]
    jc, tc = _cfgs(use_kernel=True)
    jd, td = deployed
    for name in ("wq6", "ws6"):
        np.testing.assert_array_equal(
            td["patch"][name].float().numpy(),
            np.asarray(jd["patch"][name]).astype(np.float32))
    np.testing.assert_array_equal(
        td["blocks"]["attn"]["q"]["wq4"].numpy(),
        np.asarray(jd["blocks"]["attn"]["q"]["wq4"]))
    assert not any(k.startswith("wq") for k in td["head"])
    before = cim_matmul_fused.launches
    a = np.asarray(jvit.vit_forward(jd, jnp.asarray(x), jc, JCtx.make(
        jc, _jkey(KEYS[0]), mode="sim", deployed=True)))
    b = vit.vit_forward(td, torch.from_numpy(x), tc,
                        Ctx.make(tc, KEYS[0], mode="sim",
                                 deployed=True)).numpy()
    assert cim_matmul_fused.launches == before     # plain version on the CPU
    assert np.mean(a.argmax(-1) == b.argmax(-1)) >= 0.99


def test_sim_dense_without_its_plane_raises_on_a_deployed_tree(model,
                                                              deployed):
    """Sim on an undeployed tree quantizes per call (the reference's
    rule). A deployed context, or a weight that carries a plane of another
    width, raises instead of bypassing row 1 silently; the engine's sim
    context says its tree is deployed."""
    _, _, _, tp, x, _ = model
    _, tc = _cfgs(use_kernel=True)
    xs = torch.from_numpy(x[:2])
    assert torch.isfinite(vit.vit_forward(
        tp, xs, tc, Ctx.make(tc, KEYS[0], mode="sim"))).all()
    with pytest.raises(ValueError, match="no pre-quantized weight plane"):
        vit.vit_forward(tp, xs, tc, Ctx.make(tc, KEYS[0], mode="sim",
                                             deployed=True))
    ctx = Ctx.make(tc, KEYS[0], mode="sim")
    ctx.policy = get_policy("uniform_8b")        # planes of 4 and 6 bits
    with pytest.raises(ValueError, match="at w_bits=8"):
        vit.vit_forward(deployed[1], xs, tc, ctx)
    lm = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=1)
    eng = Engine(lm, init_params(lm, torch.Generator().manual_seed(0),
                                 "cpu"), max_slots=1, max_len=16,
                 cim_mode="sim", device="cpu")
    assert eng._ctx((0, 1)).deployed


def _port_loss_and_grads(tp, tc, x, y, key, noise):
    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        return t.clone().requires_grad_()

    p = req(tp)
    ctx = Ctx.make(tc, key, mode="qat")
    if not noise:
        ctx.policy = _no_noise(ctx.policy)
    loss = vit.vit_loss(p, torch.from_numpy(x), torch.from_numpy(y), tc, ctx)
    loss.backward()
    return loss.item(), [t.grad.numpy() for t in tree_leaves(p)]


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_loss_and_grads(params, x, y, key, jc, noise):
    def loss(p):
        ctx = JCtx.make(jc, key, mode="qat")
        if not noise:
            ctx.policy = _no_noise(ctx.policy)
        return jvit.vit_loss(p, x, y, jc, ctx)

    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("noise", [False, True])
def test_qat_loss_and_gradients_match_jax(model, noise):
    jc, tc, params, tp, x, y = model
    x, y = x[:4], y[:4]
    for key in (KEYS[:2] if noise else KEYS[:1]):
        lj, gj = _jax_loss_and_grads(params, jnp.asarray(x), jnp.asarray(y),
                                     _jkey(key), jc, noise)
        gj = [np.asarray(g) for g in jax.tree.leaves(gj)]
        lt, gt = _port_loss_and_grads(tp, tc, x, y, key, noise)
        lj = float(lj)
        l2 = np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(gj, gt))
                     / sum((a ** 2).sum() for a in gj))
        if not noise:
            assert abs(lt - lj) <= 1e-5 * abs(lj)
            for a, b in zip(gj, gt):
                assert (np.linalg.norm(a - b)
                        <= 1e-5 * np.linalg.norm(a)), a.shape
        else:
            # C4: the noise within 3 ulp (recorded: every leaf within
            # 2.1e-6, the whole gradient within 8.8e-7)
            assert abs(lt - lj) <= 1e-3 * abs(lj)
            assert l2 <= 1e-3, (key, l2)
            for a, b in zip(gj, gt):
                assert (np.linalg.norm(a - b)
                        <= 1e-3 * np.linalg.norm(a)), a.shape


def test_vit_init_params_tree_and_statistics():
    jc, tc = _cfgs()
    jp = jax.eval_shape(lambda k: jbuild(jc).init(k)[0],
                        jax.random.PRNGKey(0))
    tp = init_params(tc, torch.Generator().manual_seed(0), "cpu")

    def paths(t, pre=""):
        if isinstance(t, dict):
            return {q for k, v in t.items() for q in paths(v, f"{pre}/{k}")}
        return {(pre, tuple(t.shape), str(t.dtype).split(".")[-1])}

    assert paths(jp) == paths(tp)
    assert abs(float(tp["blocks"]["mlp"]["up"]["w"].std())
               * np.sqrt(tc.d_model) - 1) < 0.05
    assert abs(float(tp["pos"].std()) / 0.02 - 1) < 0.1
    loss = build(tc).loss(tp, {"images": torch.rand(4, 32, 32, 3),
                               "labels": torch.arange(4)}, (0, 1))
    assert torch.isfinite(loss)
