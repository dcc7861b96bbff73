"""bf16 models of the port's engines against the JAX engines, on the
reduced qwen2-0.5b and mamba2-130m: the chunked ``Engine`` (``fused_step``
auto, per call on the CPU), the whole-prompt path (``chunk_size=0``) and
``LoopEngine``, with bf16 and int8 caches, in off mode here and on the CIM
kernel path in sim mode in ``test_torch_engine_bf16_sim.py`` (which takes
its helpers from this file).

XLA and torch round bf16 at other places, so greedy tokens may part where
the reference's two best logits are a rounding apart (ROADMAP C11: on the
reduced bf16 qwen2, the second prompt's fifth token is a one-ulp tie
between tokens 72 and 135 under both attention implementations, broken
one way by XLA and the other by torch). Each sampled step's logits are
recorded on both sides and held to a limit of the size of bf16 rounding:

  * off mode: every step up to the first token that differs lies within
    4 bf16 ulps of a unit-scale logit of the reference's (2^-5 times the
    larger of 1 and the row's largest |logit|), and at most half the
    prompts see a token differ;
  * sim mode, where an ulp of an activation flips its quantization level
    (the reference's own bf16 and float32 models part by 0.07-0.32 on the
    first step), the first step's logits lie no further from the
    reference's than the reference's bf16 model lies from its float32
    model on that step."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as jengine
from repro.configs.registry import get_config as jget
from repro.models.model import build as jbuild
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import params_from_jax
from repro_torch.serving import engine

LENS = {"qwen2-0.5b": (17, 5, 11, 1), "mamba2-130m": (11, 1, 17, 6)}
NEW = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread for the module: the suite runs several test
    processes side by side, and a thread pool each oversubscribes the
    cores (small eager ops then wait on thread barriers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, arch, mode, dtype="bfloat16", int8=False, impl="kernel"):
    base = get(arch)
    return dataclasses.replace(
        base.reduced(), dtype=dtype, kv_cache_int8=int8, attn_impl=impl,
        cim=dataclasses.replace(base.cim, mode=mode, use_kernel=True))


def _model(arch):
    jp, _ = jbuild(_cfg(jget, arch, "off", "float32")).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in LENS[arch]]
    return arch, jp, params_from_jax(jax.tree.map(np.asarray, jp)), prompts


@pytest.fixture(scope="module", params=["qwen2-0.5b", "mamba2-130m"])
def model(request):
    return _model(request.param)


def _kwargs(path, mode):
    kw = dict(max_slots=1, max_len=32, cim_mode=mode)
    if path != "loop":
        kw["chunk_size"] = 8 if path == "chunked" else 0
    return kw


def _jax_steps(monkeypatch, path, cfg, jp, mode, prompts, new=NEW):
    """Per prompt: the reference's tokens and the logits of the steps
    that sampled them."""
    log = []
    if path == "loop":
        eng = jengine.LoopEngine(cfg, jp, **_kwargs(path, mode))
        real = eng._sample

        def sample(logits, temperature):
            log.append(np.asarray(logits, np.float32).reshape(-1))
            return real(logits, temperature)

        eng._sample = sample
    else:
        real = jengine._sample_tokens

        def sample_tokens(logits, temps, keys):
            jax.debug.callback(lambda l: log.append(
                np.asarray(l, np.float32).reshape(-1)), logits, ordered=True)
            return real(logits, temps, keys)

        monkeypatch.setattr(jengine, "_sample_tokens", sample_tokens)
        eng = jengine.Engine(cfg, jp, **_kwargs(path, mode))
    out = []
    for i, p in enumerate(prompts):
        log.clear()
        toks = eng.generate([jengine.Request(prompt=p, max_new_tokens=new,
                                             rid=f"b{i}")])[0]
        jax.effects_barrier()
        out.append((toks, list(log[-len(toks):])))
    monkeypatch.undo()
    return out


def _port_steps(monkeypatch, path, cfg, tp, mode, prompts, new=NEW):
    log = []
    if path == "loop":
        eng = engine.LoopEngine(cfg, tp, device="cpu", **_kwargs(path, mode))
        real = eng._sample

        def sample(logits, temperature):
            log.append(logits.float().reshape(-1).numpy().copy())
            return real(logits, temperature)

        eng._sample = sample
    else:
        real = engine._sample_tokens

        def sample_tokens(logits, temps, keys):
            log.append(logits.float().reshape(-1).numpy().copy())
            return real(logits, temps, keys)

        monkeypatch.setattr(engine, "_sample_tokens", sample_tokens)
        eng = engine.Engine(cfg, tp, device="cpu", **_kwargs(path, mode))
    out = []
    for i, p in enumerate(prompts):
        log.clear()
        toks = eng.generate([engine.Request(prompt=p, max_new_tokens=new,
                                            rid=f"b{i}")])[0]
        out.append((toks, list(log[-len(toks):])))
    monkeypatch.undo()
    return out


def _ulp(row):
    """One bf16 ulp of a unit-scale logit: 2^-7 times the largest power
    of two at most max(1, max |row|)."""
    return 2.0 ** (np.floor(np.log2(max(1.0, np.abs(row).max()))) - 7)


@pytest.mark.parametrize("path,int8", [
    ("chunked", False), ("chunked", True), ("whole", False),
    ("loop", False)])
def test_bf16_tokens_and_logits_against_jax(model, monkeypatch, path, int8):
    arch, jp, tp, prompts = model
    ref = _jax_steps(monkeypatch, path, _cfg(jget, arch, "off", int8=int8),
                     jp, "off", prompts)
    got = _port_steps(monkeypatch, path,
                      _cfg(get_config, arch, "off", int8=int8), tp, "off",
                      prompts)
    diverged = 0
    for i, ((jt, jl), (tt, tl)) in enumerate(zip(ref, got)):
        assert len(jt) == len(tt) == len(jl) == len(tl) == NEW, i
        for k in range(NEW):
            assert np.abs(tl[k] - jl[k]).max() <= 4 * _ulp(jl[k]), (i, k)
            if tt[k] != jt[k]:
                # a tie of the reference's, to within two ulps
                assert jl[k][jt[k]] - jl[k][tt[k]] <= 2 * _ulp(jl[k]), (i, k)
                diverged += 1
                break
    assert diverged <= len(prompts) // 2, diverged


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_c11_is_a_one_ulp_tie_under_both_attention_implementations(
        monkeypatch, impl):
    """The divergence of ROADMAP C11, recorded: the reduced bf16 qwen2's
    second prompt (5 tokens), off mode, chunked. The first four tokens are
    equal; the fifth is a tie between tokens 72 and 135 whose two logits
    lie at most one ulp apart on either side, and each side picks one of
    them: under kernel attention the reference's two are equal (its
    arg-max takes 72) and the port's 135 leads by an ulp; under einsum
    attention the reference's 135 leads by an ulp and the port's two are
    equal."""
    _, jp, tp, prompts = _model("qwen2-0.5b")
    prompt = prompts[1:2]
    (jt, jl), = _jax_steps(monkeypatch, "chunked",
                           _cfg(jget, "qwen2-0.5b", "off", impl=impl), jp,
                           "off", prompt)
    (tt, tl), = _port_steps(monkeypatch, "chunked",
                            _cfg(get_config, "qwen2-0.5b", "off", impl=impl),
                            tp, "off", prompt)
    assert jt[:4] == tt[:4] and jt[4] != tt[4]
    assert {jt[4], tt[4]} == {72, 135}
    for logits in (jl[4], tl[4]):
        pair = logits[[72, 135]]
        assert np.sort(logits)[-2] == pair.min()      # the top two
        assert abs(pair[0] - pair[1]) <= _ulp(logits)
    assert (jl[4][72] == jl[4][135]) == (impl == "kernel")
    assert (tl[4][72] == tl[4][135]) == (impl == "einsum")
