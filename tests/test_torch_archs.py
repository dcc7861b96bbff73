"""The registry's GQA-block archs on the port against the JAX package:
internlm2-1.8b and phi3-mini-3.8b (dense), deepseek-67b (dense), pixtral-12b
(vlm: the dense blocks behind a stub patch prefix) and olmoe-1b-7b (moe
with GQA attention), at their reduced sizes (float32, 2 layers, d_model
256; phi3 and pixtral also at head dim 96, phi3's published one).

Parameters come from the JAX initialiser through ``params_from_jax``. The
port runs attention through the kernels' routes, which on the CPU take
their plain versions; the reference runs its einsum attention. Forward
logits in off mode within 1e-5 of each row's max |logit| (the f32 products
sum in another order); ``lm_loss`` within 1e-5 relative; olmoe's greedy
engine tokens equal exactly, in off mode and in sim mode over the moe
tests' short horizon (5 tokens). The deploy pass's layer-at-a-time
quantizer equals the whole-tensor one bit for bit.

The JAX reference runs (init, forward, engine) are module-scoped and each
made once, shared by the cases that compare against them. The module's
torch work runs on one CPU thread (``one_thread``), as in
``test_torch_moe.py``."""

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
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import deploy, quant
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx
from repro_torch.serving.engine import Engine, Request

NEW_ARCHS = ("internlm2-1.8b", "phi3-mini-3.8b", "deepseek-67b",
             "pixtral-12b", "olmoe-1b-7b")
# the forward cases: arch and the reduced config's head dim
FORWARD = {"internlm2": ("internlm2-1.8b", 64),
           "phi3-d96": ("phi3-mini-3.8b", 96),
           "pixtral-d96": ("pixtral-12b", 96),
           "olmoe": ("olmoe-1b-7b", 64)}


def _cfgs(arch, head_dim=64, mode="off", impl="kernel"):
    def of(base):
        return dataclasses.replace(
            base.reduced(), head_dim=head_dim, attn_impl=impl,
            cim=dataclasses.replace(base.cim, mode=mode, use_kernel=True))
    return (dataclasses.replace(of(jget(arch)), attn_impl="einsum"),
            of(get_config(arch)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, port cfg, jax params, port params) per forward case, the
    JAX params drawn once."""
    cache = {}

    def get(case):
        if case not in cache:
            jc, tc = _cfgs(*FORWARD[case])
            jp, _ = jbuild(jc).init(jax.random.PRNGKey(0))
            cache[case] = (jc, tc, jp, deploy.params_from_jax(
                jax.tree.map(np.asarray, jp)))
        return cache[case]
    return get


def _rows_close(t, j, rel=1e-5):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape and np.isfinite(t).all()
    t, j = t.reshape(-1, t.shape[-1]), j.reshape(-1, j.shape[-1])
    err = np.abs(t - j).max(-1) / np.abs(j).max(-1)
    assert err.max() <= rel, err.max()


def _batch(cfg, width, seed, patches=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, width),
                                dtype=np.int32)}
    if patches:
        b["patch_embeds"] = rng.normal(
            size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_jax(arch):
    """Every field the port has, full and reduced, and param_count()."""
    assert arch in list_archs()
    for ours, theirs in ((get_config(arch), jget(arch)),
                         (get_config(arch).reduced(), jget(arch).reduced())):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name in ("cim", "moe", "ssm", "mla") and a is not None:
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name)
        assert ours.param_count() == theirs.param_count()


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_logits_match_jax(models, case):
    """Uncached forward logits, off mode, f32."""
    jc, tc, jp, tp = models(case)
    b = _batch(jc, 12, 1, patches=jc.family == "vlm")
    j = jtf.forward(jp, {k: jnp.asarray(v) for k, v in b.items()}, jc,
                    JCtx.make(jc))[0]
    t = tf.forward(tp, _t(b), tc, Ctx.make(tc))[0]
    assert t.shape[1] == 12 + (tc.n_patches if tc.family == "vlm" else 0)
    _rows_close(t, j)


def test_vlm_cached_prefill_and_decode_match_jax(models):
    """Pixtral at head dim 96: the patch prefix and 6 tokens prefilled into
    the cache, then 2 decode steps, each step's logits and lengths."""
    jc, tc, jp, tp = models("pixtral-d96")
    jcache = jtf.init_caches(jc, 2, 32)
    tcache = tf.init_caches(tc, 2, 32)
    for step, width in enumerate((6, 1, 1)):
        b = _batch(jc, width, 10 + step, patches=step == 0)
        j, jcache = jtf.forward(jp, {k: jnp.asarray(v) for k, v in b.items()},
                                jc, JCtx.make(jc), jcache)
        t, tcache = tf.forward(tp, _t(b), tc, Ctx.make(tc), tcache)
        _rows_close(t, j)
        np.testing.assert_array_equal(tf.cache_len(tcache).numpy(),
                                      np.asarray(jcache["len"][0]))
    assert tf.cache_len(tcache).tolist() == [tc.n_patches + 8] * 2


def test_vlm_lm_loss_matches_jax(models):
    """The image prefix carries no labels: the loss reads the token
    positions' logits only."""
    jc, tc, jp, tp = models("pixtral-d96")
    b = _batch(jc, 10, 3, patches=True)
    b["labels"] = np.random.default_rng(4).integers(
        -1, jc.vocab_size, (2, 10), dtype=np.int32)
    j = float(jtf.lm_loss(jp, {k: jnp.asarray(v) for k, v in b.items()}, jc,
                          JCtx.make(jc)))
    t = tf.lm_loss(tp, _t(b), tc, Ctx.make(tc)).item()
    assert abs(t - j) <= 1e-5 * abs(j), (t, j)


def test_moe_gqa_tree_from_jax_and_native_init(models):
    """olmoe's params tree (GQA attention, expert banks, no shared
    experts) carried over by ``params_from_jax`` leaf for leaf, and drawn
    natively with the same paths, shapes and dtypes."""
    jc, tc, jp, tp = models("olmoe")

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {pre + k: v})
        return out

    jf, tf_ = flat(jax.tree.map(np.asarray, jp)), flat(tp)
    assert sorted(jf) == sorted(tf_)
    assert "blocks/attn/q/w" in jf and not any("shared" in k for k in jf)
    for k, a in jf.items():
        np.testing.assert_array_equal(tf_[k].numpy(), a, err_msg=k)
    native = flat(deploy.init_params(tc, torch.Generator().manual_seed(0),
                                     "cpu"))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in native.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in tf_.items()}


# -------------------------------------------------------------- engine

def _prompts(cfg):
    rng = np.random.default_rng(4)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in (7, 19, 1)]


@pytest.fixture(scope="module")
def olmoe_ref(models):
    """The reference engine's greedy tokens on reduced olmoe, one run per
    mode (einsum attention, the CIM kernel path in sim)."""
    runs = {}

    def run(mode):
        if mode not in runs:
            jc, _, jp, _ = models("olmoe")
            runs[mode] = JEngine(
                jc, jp, max_slots=2, max_len=64, chunk_size=8,
                cim_mode=mode, attn_impl="einsum").generate(
                [JRequest(prompt=p, max_new_tokens=5, rid=f"r{i}")
                 for i, p in enumerate(_prompts(jc))])
        return runs[mode]
    return run


@pytest.mark.parametrize("mode", ["off", "sim"])
def test_olmoe_greedy_tokens_equal_jax_engine(models, olmoe_ref, mode):
    """Three ragged prompts (a 1-token one among them) through 2 slots at
    chunk 8, the third riding a slot the first dirtied; the port on the
    kernel routes (plain versions on the CPU), per call."""
    _, tc, _, tp = models("olmoe")
    eng = Engine(tc, tp, device="cpu", max_slots=2, max_len=64,
                 chunk_size=8, cim_mode=mode, attn_impl="kernel")
    assert not eng.fused_step
    out = eng.generate([Request(prompt=p, max_new_tokens=5, rid=f"r{i}")
                        for i, p in enumerate(_prompts(tc))])
    assert out == olmoe_ref(mode), (out, olmoe_ref(mode))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_cli_builds_each_new_arch_reduced(arch):
    """``launch.serve --arch`` builds and serves each arch at its reduced
    size on the CPU, deployed planes and kernel attention routes."""
    outs = serve.main(["--arch", arch, "--reduced", "--cim", "sim",
                       "--attn-impl", "kernel", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "9",
                       "--new-tokens", "2"])
    assert [len(o) for o in outs] == [2, 2]


@pytest.mark.parametrize("arch", ["pixtral-12b", "olmoe-1b-7b"])
def test_train_cli_trains_the_new_families_reduced(arch, tmp_path):
    """``launch.train --arch`` on the CPU: two steps of the vlm family
    (``lm_loss`` on a token-only batch) and of moe with GQA attention,
    finite losses and gradients."""
    out = train.main(["--arch", arch, "--reduced", "--steps", "2",
                      "--batch", "2", "--seq", "8", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    m = out["metrics"]
    assert out["last_step"] == 2
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


# -------------------------------------------------- deploy and init

def test_layer_slab_quantizer_equals_whole_tensor():
    """``quantize_plane`` quantizes a stacked weight one layer at a time:
    planes and scales bit for bit those of one whole-tensor quantization
    (the abs-max scale over the trailing axes), in f32 and bf16, and
    through ``deploy`` for a whole params tree."""

    def whole(w, bits):
        ws = quant.abs_max_scale(w, bits, axis=(w.ndim - 2, w.ndim - 1))
        wq = quant.quantize(w.to(torch.float32), ws, bits)
        return wq.to(quant.storage_dtype(bits)), ws.reshape(w.shape[:-2])

    rng = np.random.default_rng(0)
    w32 = torch.from_numpy(rng.normal(size=(3, 96, 40)).astype(np.float32))
    for w in (w32, w32.to(torch.bfloat16)):
        wq, ws = whole(w, 6)
        sq, ss = deploy.quantize_plane(w, 6, 2)
        assert sq.dtype == wq.dtype and ss.dtype == ws.dtype
        assert torch.equal(sq, wq) and torch.equal(ss, ws)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                              cim=dataclasses.replace(
                                  get_config("phi3-mini-3.8b").cim,
                                  mode="sim", use_kernel=True))
    tree = deploy.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    got = deploy.deploy(cfg, tree)["blocks"]
    for part, name, bits in (("attn", "q", 4), ("attn", "o", 4),
                             ("mlp", "gate", 6), ("mlp", "down", 6)):
        wq, ws = whole(tree["blocks"][part][name]["w"].to(
            deploy.dtype_of(cfg)), bits)
        assert torch.equal(got[part][name][f"wq{bits}"], wq)
        assert torch.equal(got[part][name][f"ws{bits}"], ws)


def test_init_draws_by_layer_only_above_the_slab(monkeypatch):
    """Under ``SLAB_ELEMS`` a stacked weight is one draw, as before: the
    first tensor init_params draws (attn q) equals the single draw of its
    whole shape. Above it the weights are drawn a layer at a time (no
    draw of a stacked shape is above the slab), still N(0, 1/d_in) in mean
    and std."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              n_layers=4)
    d, n = cfg.d_model, cfg.n_heads * cfg.hd
    g = torch.Generator().manual_seed(3)
    one = (torch.randn((4, d, n), generator=g) * d ** -0.5)
    got = deploy.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(got["blocks"]["attn"]["q"]["w"], one)
    shapes, randn = [], torch.randn

    def recorded(*shape, **kw):
        shapes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", recorded)
    slab = 4 * d * n - 1        # q, o and the MLP above it; k, v under
    monkeypatch.setattr(deploy, "SLAB_ELEMS", slab)
    by_layer = deploy.init_params(cfg, torch.Generator().manual_seed(3),
                                  "cpu")
    stacked = [s for s in shapes if len(s) == 3]
    assert stacked == [(4, d, cfg.n_kv_heads * cfg.hd)] * 2, stacked
    assert shapes.count((d, n)) == 8 and shapes.count((d, cfg.d_ff)) == 8
    up = by_layer["blocks"]["mlp"]["up"]["w"].double()
    se = up.std().item() / up.numel() ** 0.5
    assert abs(up.mean().item()) <= 5 * se
    assert abs(up.std().item() * d ** 0.5 - 1) < 0.01
