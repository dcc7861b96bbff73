"""The port's whole-prompt path (``Engine(chunk_size=0)``) and
``LoopEngine`` against the JAX package's on the reduced qwen2-0.5b and
mamba2-130m: greedy tokens equal exactly, in off mode and on the CIM
kernel path in sim mode, with float32 and int8 caches (a dense prompt
padded to its power-of-two bucket, an ssm prompt at its true length,
1-token prompts and recycled slots; a bf16 model is held to a limit of the
size of bf16 rounding in ``test_torch_engine_bf16.py``), the dispatch
witnesses of the whole-prompt path, the ``LoopEngine``'s frozen quirk (a
``max_new_tokens == 1`` request emits two tokens), its sampled draws in
the logits' dtype against the reference's, a failure isolated to
its request, and the serving CLI's ``--engine loop`` and
``--chunk-size 0``. On the CPU the kernels run their plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import LoopEngine as JLoopEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import params_from_jax
from repro_torch.launch import serve
from repro_torch.serving.engine import (Engine, LoopEngine, Request,
                                        RequestError)

LENS = {"qwen2-0.5b": (13, 1, 9, 20), "mamba2-130m": (9, 1, 14, 6)}
NEW = (3, 2, 1, 3)      # the third request asks for one token


def _cfg(get, arch, mode="off", dtype="float32", int8=False):
    base = get(arch)
    return dataclasses.replace(
        base.reduced(), dtype=dtype, kv_cache_int8=int8,
        cim=dataclasses.replace(base.cim, mode=mode, use_kernel=True))


@pytest.fixture(scope="module", params=["qwen2-0.5b", "mamba2-130m"])
def model(request):
    arch = request.param
    jp, _ = jbuild(_cfg(jget, arch)).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in LENS[arch]]
    return arch, jp, params_from_jax(jax.tree.map(np.asarray, jp)), prompts


def _requests(cls, prompts):
    return [cls(prompt=p, max_new_tokens=n, rid=f"w{i}")
            for i, (p, n) in enumerate(zip(prompts, NEW))]


@pytest.mark.parametrize("mode,dtype,int8", [
    ("off", "float32", True), ("sim", "float32", False),
    ("sim", "float32", True)])
def test_whole_prompt_tokens_equal_jax_engine(model, mode, dtype, int8):
    arch, jp, tp, prompts = model
    kw = dict(max_slots=2, max_len=32, chunk_size=0, cim_mode=mode,
              attn_impl="kernel")
    jeng = JEngine(_cfg(jget, arch, mode, dtype, int8), jp, **kw)
    ja = jeng.generate(_requests(JRequest, prompts))
    teng = Engine(_cfg(get_config, arch, mode, dtype, int8), tp,
                  device="cpu", **kw)
    ta = teng.generate(_requests(Request, prompts))
    assert ta == ja, (ta, ja)
    assert [len(t) for t in ta] == list(NEW)
    assert not teng.fused_step
    assert (teng.launch_count, teng.iter_count) == (jeng.launch_count,
                                                    jeng.iter_count)


@pytest.mark.parametrize("mode,dtype", [("off", "float32"),
                                        ("sim", "float32")])
def test_loop_engine_equals_jax_loop_engine(model, mode, dtype):
    arch, jp, tp, prompts = model
    kw = dict(max_slots=2, max_len=32, cim_mode=mode, attn_impl="kernel")
    ja = JLoopEngine(_cfg(jget, arch, mode, dtype), jp, **kw).generate(
        _requests(JRequest, prompts))
    ta = LoopEngine(_cfg(get_config, arch, mode, dtype), tp, device="cpu",
                    **kw).generate(_requests(Request, prompts))
    assert ta == ja, (ta, ja)
    # the frozen quirk: max_new_tokens == 1 emits 2 tokens
    assert [len(t) for t in ta] == [3, 2, 2, 3]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_loop_engine_samples_as_the_jax_loop_engine(model, dtype):
    """``LoopEngine._sample`` on the same logits in the model's dtype and
    the same engine key draws the reference's tokens (the reference draws
    ``categorical(k, logits / t)`` in the logits' dtype), for 64 draws."""
    arch, jp, tp, _ = model
    kw = dict(max_slots=1, max_len=32, seed=4)
    jl = JLoopEngine(_cfg(jget, arch, dtype=dtype), jp, **kw)
    tl = LoopEngine(_cfg(get_config, arch, dtype=dtype), tp, device="cpu",
                    **kw)
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for i in range(64):
        lg = jnp.asarray(rng.standard_normal(512) * 3, jnp.float32).astype(
            jdt)
        t = (0.7, 1.3, 0.33, 1.0)[i % 4]
        want = jl._sample(lg, t)
        got = tl._sample(torch.from_numpy(np.array(
            lg.astype(jnp.float32))).to(getattr(torch, dtype)), t)
        assert got == want, (i, t)
    assert tl.key == tuple(int(w) for w in np.asarray(jl.key))


def test_failures_fail_only_their_request(model, monkeypatch):
    """A whole-prompt prefill that raises for one prompt length, and a
    LoopEngine decode that raises for one slot's cache: those requests
    fail with the phase the reference names, the others complete with the
    tokens of an engine without the fault."""
    arch, _, tp, prompts = model
    cfg = _cfg(get_config, arch)
    kw = dict(max_slots=2, max_len=32, device="cpu")
    want = Engine(cfg, tp, chunk_size=0, **kw).generate(
        _requests(Request, prompts))
    eng = Engine(cfg, tp, chunk_size=0, **kw)
    real = eng._prefill

    def prefill(s, r):
        if len(r.prompt) == LENS[arch][2]:
            raise RuntimeError("injected")
        return real(s, r)

    monkeypatch.setattr(eng, "_prefill", prefill)
    out = eng.generate(_requests(Request, prompts))
    assert isinstance(out[2], RequestError) and out[2].phase == "prefill"
    assert [o for i, o in enumerate(out) if i != 2] == \
        [o for i, o in enumerate(want) if i != 2]

    want = LoopEngine(cfg, tp, **kw).generate(_requests(Request, prompts))
    loop = LoopEngine(cfg, tp, **kw)
    real_fwd, first = loop._forward, []

    def forward(tokens, cache):
        if tokens.shape[1] == LENS[arch][0]:
            first.append(cache)            # the first request's cache
        if tokens.shape[1] == 1 and any(cache is c for c in first):
            raise RuntimeError("injected")
        return real_fwd(tokens, cache)

    monkeypatch.setattr(loop, "_forward", forward)
    out = loop.generate(_requests(Request, prompts))
    assert isinstance(out[0], RequestError) and out[0].phase == "decode"
    assert out[1:] == want[1:]


def test_serve_cli_loop_engine_and_whole_prompt(capsys):
    common = ["--reduced", "--cim", "sim", "--attn-impl", "kernel",
              "--device", "cpu", "--requests", "3", "--prompt-len", "10",
              "--new-tokens", "3"]
    loop = serve.main(common + ["--engine", "loop"])
    assert [len(o) for o in loop] == [3, 3, 3]
    assert "loop" in capsys.readouterr().out
    whole = serve.main(common + ["--chunk-size", "0"])
    assert [len(o) for o in whole] == [3, 3, 3]
    assert "chunk=0" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(common + ["--engine", "bogus"])
