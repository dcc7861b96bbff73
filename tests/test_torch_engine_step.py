"""The port's ``fused_step`` engine against the JAX ``Engine`` on the
reduced qwen2-0.5b and mamba2-130m: greedy tokens with ``fused_step`` None,
True and False equal the reference's, in off mode and on the CIM kernel
path in sim mode, with bf16, float32 and int8 caches; the per-call
dispatch witnesses (``launch_count``, ``iter_count``) count as the
reference's; a bf16 model serves alike under each ``fused_step``. On the
CPU every ``fused_step`` runs the per-call path (CUDA
graphs are captured on the card only, ``tests/test_torch_gpu.py``). Also
the pieces a graph needs: the vectorized seed table against
``jax.random.fold_in`` chained call by call, the masked freeze against
``index_copy_``, the fused layer's reach (``kernel_takes``), the options
that raise, the fallback when a replay raises, and a decode failure
isolated to its slot as the reference isolates it.

Tokens are compared exactly. A bf16 model is compared here port to port,
under each ``fused_step``; ``test_torch_engine_bf16.py`` holds it against
the reference to a limit of the size of bf16 rounding, since XLA and
torch round bf16 at other places (ROADMAP C11)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.core.cim import CIMSpec
from repro_torch.core.deploy import init_params, params_from_jax
from repro_torch.kernels.fused_step import kernel_takes
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Ctx
from repro_torch.serving import engine
from repro_torch.serving.engine import Engine, Request, RequestError

LENS = {"qwen2-0.5b": (17, 5, 11, 1), "mamba2-130m": (11, 1, 17, 6)}


def _cfg(get, arch, mode="off", dtype="float32", int8=False,
         use_kernel=True):
    base = get(arch)
    return dataclasses.replace(
        base.reduced(), dtype=dtype, kv_cache_int8=int8,
        cim=dataclasses.replace(base.cim, mode=mode, use_kernel=use_kernel))


@pytest.fixture(scope="module", params=["qwen2-0.5b", "mamba2-130m"])
def model(request):
    arch = request.param
    jp, _ = jbuild(_cfg(jget, arch)).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in LENS[arch]]
    return arch, jp, params_from_jax(jax.tree.map(np.asarray, jp)), prompts


def _requests(cls, prompts, new=3):
    return [cls(prompt=p, max_new_tokens=new, rid=f"r{i}")
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("mode,dtype,int8", [
    ("off", "float32", True), ("sim", "float32", False),
    ("sim", "float32", True)])
def test_tokens_and_witnesses_equal_jax_under_fused_step(model, mode, dtype,
                                                         int8):
    arch, jp, tp, prompts = model
    kw = dict(max_slots=2, max_len=32, chunk_size=8, cim_mode=mode,
              attn_impl="kernel")
    jeng = JEngine(_cfg(jget, arch, mode, dtype, int8), jp, fused_step=False,
                   **kw)
    ja = jeng.generate(_requests(JRequest, prompts))
    tc = _cfg(get_config, arch, mode, dtype, int8)
    for fused in (None, True, False) if not int8 else (None, False):
        teng = Engine(tc, tp, fused_step=fused, device="cpu", **kw)
        ta = teng.generate(_requests(Request, prompts))
        assert ta == ja, (fused, ta, ja)
        assert (teng.launch_count, teng.iter_count) == (
            jeng.launch_count, jeng.iter_count), fused
        assert teng.fused_step == (fused is not False)
        assert teng.replay_count == 0 and teng.fused_ok


@pytest.mark.parametrize("mode", ["off", "sim"])
def test_bf16_model_serves_alike_under_every_fused_step(model, mode):
    arch, _, tp, prompts = model
    cfg = _cfg(get_config, arch, mode, "bfloat16")
    runs = [Engine(cfg, tp, max_slots=2, max_len=32, chunk_size=8,
                   attn_impl="kernel", fused_step=fused,
                   device="cpu").generate(_requests(Request, prompts))
            for fused in (None, True, False)]
    assert runs[0] == runs[1] == runs[2]
    assert [len(t) for t in runs[0]] == [3] * len(prompts)


def test_seed_table_equals_fold_in_chain():
    """168 rows (qwen2-0.5b: 24 layers x 7 CIM linears), bit for bit
    against ``jax.random.fold_in`` chained as the reference's layer scan and
    ``Ctx.next_key`` draw; and a table-mode ``Ctx`` hands out rows whose
    words are the host-mode keys'."""
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 77))[0]
    host = tuple(int(w) for w in np.asarray(key))
    table = prng.seed_table(host, 24, 7)
    want = np.array([np.asarray(jax.random.fold_in(
        jax.random.fold_in(key, layer), c), np.uint32)
        for layer in range(24) for c in range(1, 8)])
    assert table.shape == (168, 2) and table.dtype == np.int32
    assert np.array_equal(table.view(np.uint32), want)

    cfg = get_config("qwen2-0.5b")
    ref = Ctx.make(cfg, host)
    tab = Ctx.make(cfg, host)
    tab.seeds, tab.seed_width = torch.from_numpy(table), 7
    for layer in (0, 5, 23):
        lr, lt = ref.for_layer(layer), tab.for_layer(layer)
        for _ in range(7):
            row = lt.next_key()
            assert isinstance(row, prng.SeedRow)
            assert prng.seed_words(row) == prng.seed_from_key(lr.next_key())
        with pytest.raises(ValueError):
            lt.next_key()                  # an eighth draw of the layer
    with pytest.raises(ValueError):
        tab.for_layer(24)


@pytest.mark.parametrize("arch,int8", [("qwen2-0.5b", False),
                                       ("qwen2-0.5b", True),
                                       ("mamba2-130m", False)])
def test_masked_freeze_equals_index_copy(arch, int8):
    cfg = _cfg(get_config, arch, int8=int8)
    g = torch.Generator().manual_seed(5)
    base = {k: (torch.randint(-100, 100, v.shape, generator=g).to(v.dtype)
                if not v.is_floating_point()
                else torch.randn(v.shape, generator=g).to(v.dtype))
            for k, v in tf.init_caches(cfg, 4, 16).items()}
    moved = {k: v + 3 if not v.is_floating_point() else v * 1.5 - 0.25
             for k, v in base.items()}
    for act in ([True, False, True, False], [False] * 4, [True] * 4):
        inactive = [s for s, a in enumerate(act) if not a]
        a = {k: v.clone() for k, v in base.items()}
        b = {k: v.clone() for k, v in base.items()}
        fa, fb = tf.freeze_rows(a, inactive), tf.freeze_all(b)
        for k in a:
            a[k].copy_(moved[k])
            b[k].copy_(moved[k])
        tf.mask_cache_advance(a, fa, inactive)
        tf.mask_cache_advance_by(b, fb, torch.tensor(act))
        for k in a:
            assert torch.equal(a[k], b[k]), (k, act)


def test_kernel_takes_the_fused_kernels_reach():
    cfg = get_config("qwen2-0.5b")
    spec = CIMSpec(in_bits=6, w_bits=6)
    assert kernel_takes(cfg, 8, [spec] * 7)
    assert kernel_takes(cfg, 1)
    assert not kernel_takes(cfg, 9)
    assert not kernel_takes(dataclasses.replace(cfg, head_dim=128), 4)
    assert not kernel_takes(dataclasses.replace(cfg, n_heads=32,
                                                n_kv_heads=2), 4)
    assert not kernel_takes(cfg, 4, [spec] * 6
                            + [dataclasses.replace(spec, in_bits=10)])
    assert not kernel_takes(dataclasses.replace(cfg, d_ff=4900), 4)
    # on the CPU the route stays the reference's: the plain version takes
    # B 9 (the card serves it unfused, tests/test_torch_gpu.py)
    small = dataclasses.replace(cfg.reduced(), fuse_layer=True)
    params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    cache = tf._index(tf.init_caches(small, 9, 16), 0)
    x = torch.zeros((9, 1, small.d_model))
    assert tf._use_fused_layer(Ctx.make(small, mode="off"),
                               tf._index(params["blocks"], 0), x, cache)


def test_fused_step_options_that_raise():
    qwen = _cfg(get_config, "qwen2-0.5b", mode="sim")
    params = init_params(qwen, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        Engine(qwen, params, chunk_size=0, fused_step=True, device="cpu")
    with pytest.raises(ValueError):
        Engine(qwen, params, chunk_size=-1, device="cpu")
    behavioural = _cfg(get_config, "qwen2-0.5b", mode="sim",
                       use_kernel=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(behavioural, params, fused_step=True, device="cpu")
    moe = _cfg(get_config, "deepseek-v2-236b", mode="sim")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(moe, {}, fused_step=True, device="cpu")
    # auto: the behavioural path and whole-prompt prefill serve per call
    assert not Engine(behavioural, params, device="cpu").fused_step
    assert not Engine(qwen, params, chunk_size=0, device="cpu").fused_step
    assert Engine(qwen, params, device="cpu").fused_step


class _RaisingGraph:
    def replay(self):
        raise RuntimeError("replay failed")


def test_a_replay_that_raises_falls_back_per_call(model):
    """Graphs whose replay raises (stand-ins: the CPU has none): the first
    replay turns them off for the engine's lifetime, visibly, and the
    forward runs per call with the same tokens."""
    arch, _, tp, prompts = model
    cfg = _cfg(get_config, arch)
    kw = dict(max_slots=2, max_len=32, chunk_size=8, device="cpu")
    want = Engine(cfg, tp, fused_step=False, **kw).generate(
        _requests(Request, prompts))
    eng = Engine(cfg, tp, **kw)
    eng._graphs = {"decode": _RaisingGraph(),
                   "chunk": [_RaisingGraph()] * 2}
    assert eng.generate(_requests(Request, prompts)) == want
    assert not eng.fused_ok and eng.fallbacks == 1
    assert eng.replay_count == 0


class _PerCallChunk:
    """A chunk graph stand-in that runs slot ``s``'s chunk forward (off
    mode: the key is not read)."""

    def __init__(self, eng, s):
        self.eng, self.s = eng, s

    def replay(self):
        return self.eng._chunk_forward(self.s,
                                       self.eng._ctx(prng.PRNGKey(0)))


class _RanThenRaised(_PerCallChunk):
    """A decode graph stand-in whose replay runs the whole step (every row
    advanced) and then raises."""

    def replay(self):
        self.eng._decode_forward(self.eng._ctx(prng.PRNGKey(0)),
                                 self.eng._tok_in)
        raise RuntimeError("replay failed after it ran")


def test_a_replay_that_raises_after_running_is_undone(model):
    """The per-call step that follows a failed replay starts from the
    caches as they were before the replay: the same tokens as an engine
    that never replayed."""
    arch, _, tp, prompts = model
    cfg = _cfg(get_config, arch)
    kw = dict(max_slots=2, max_len=32, chunk_size=8, device="cpu")
    want = Engine(cfg, tp, fused_step=False, **kw).generate(
        _requests(Request, prompts))
    eng = Engine(cfg, tp, **kw)
    eng._tok_in = torch.zeros((2,), dtype=torch.int64)   # the capture's
    eng._graphs = {"decode": _RanThenRaised(eng, None),
                   "chunk": [_PerCallChunk(eng, s) for s in range(2)]}
    assert eng.generate(_requests(Request, prompts)) == want
    assert not eng.fused_ok and eng.fallbacks == 1
    assert eng.replay_count > 0             # the chunks before it replayed


def test_decode_failure_fails_only_its_request(model, monkeypatch):
    """A batch decode that raises whenever slot 1 is active: every request
    served in slot 1 fails at its first decode with a decode RequestError,
    the others complete with the reference's tokens (the reference's solo
    re-probing, injected the same way into its decode program)."""
    arch, jp, tp, prompts = model
    kw = dict(max_slots=2, max_len=32, chunk_size=8, cim_mode="off",
              attn_impl="kernel")
    jeng = JEngine(_cfg(jget, arch), jp, fused_step=False, **kw)
    real = jeng._decode

    def jdecode(params, caches, last_tok, active, *a, **k):
        if bool(np.asarray(active)[1]):
            raise RuntimeError("injected")
        return real(params, caches, last_tok, active, *a, **k)

    jeng._decode = jdecode
    ja = jeng.generate(_requests(JRequest, prompts))
    teng = Engine(_cfg(get_config, arch), tp, fused_step=False,
                  device="cpu", **kw)
    treal = teng._decode_forward

    def tdecode(ctx, tokens):
        if bool(teng._inputs.act[1]):
            raise RuntimeError("injected")
        return treal(ctx, tokens)

    monkeypatch.setattr(teng, "_decode_forward", tdecode)
    ta = teng.generate(_requests(Request, prompts))
    failed = [isinstance(o, RequestError) for o in ta]
    assert failed == [not isinstance(o, list) for o in ja] and any(failed)
    assert not all(failed)
    for t, j in zip(ta, ja):
        if isinstance(t, RequestError):
            assert (t.phase, t.slot) == (j.phase, j.slot) == ("decode", 1)
        else:
            assert t == j
    assert (teng.launch_count, teng.iter_count) == (jeng.launch_count,
                                                    jeng.iter_count)


def test_decode_failure_at_the_last_layer_leaves_the_others_intact(
        model, monkeypatch):
    """A batch decode that raises at its LAST layer whenever slot 1 is
    active: every earlier layer has already advanced each row's length and
    ssm window and state in place. The survivors' tokens must still equal
    the reference's, whose decode program is functional (a failed step
    changes nothing): the caches go back to their state before the step
    ahead of each probe, and after a probe that raises."""
    arch, jp, tp, prompts = model
    kw = dict(max_slots=2, max_len=32, chunk_size=8, cim_mode="off",
              attn_impl="kernel")
    jeng = JEngine(_cfg(jget, arch), jp, fused_step=False, **kw)
    real = jeng._decode

    def jdecode(params, caches, last_tok, active, *a, **k):
        if bool(np.asarray(active)[1]):
            raise RuntimeError("injected")
        return real(params, caches, last_tok, active, *a, **k)

    jeng._decode = jdecode
    ja = jeng.generate(_requests(JRequest, prompts))
    cfg = _cfg(get_config, arch)
    teng = Engine(cfg, tp, fused_step=False, device="cpu", **kw)
    block, calls = tf._BLOCKS[cfg.family], [0]

    def last_layer_raises(ctx, p, x, positions, cache):
        layer = calls[0] % cfg.n_layers
        calls[0] += 1
        out = block(ctx, p, x, positions, cache)
        if (x.shape[1] == 1 and layer == cfg.n_layers - 1
                and bool(teng._inputs.act[1])):
            raise RuntimeError("injected")
        return out

    monkeypatch.setitem(tf._BLOCKS, cfg.family, last_layer_raises)
    ta = teng.generate(_requests(Request, prompts))
    assert [isinstance(o, RequestError) for o in ta] == \
        [not isinstance(o, list) for o in ja]
    assert any(isinstance(o, list) for o in ta)
    assert any(isinstance(o, RequestError) for o in ta)
    for t, j in zip(ta, ja):
        if isinstance(t, RequestError):
            assert (t.phase, t.slot) == (j.phase, j.slot) == ("decode", 1)
        else:
            assert t == j


def test_sampled_streams_do_not_depend_on_fused_step(model):
    arch, _, tp, prompts = model
    cfg = _cfg(get_config, arch)
    runs = [Engine(cfg, tp, max_slots=2, max_len=32, chunk_size=8,
                   fused_step=fused, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=4, temperature=0.8, rid=f"s{i}")
         for i, p in enumerate(prompts)]) for fused in (None, False)]
    assert runs[0] == runs[1]
    assert engine._row_sample_keys([(1, 2), (3, 4)], [0, 5], [0.0, 0.7])[0] \
        is None
