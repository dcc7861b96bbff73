"""The engines' ``cim_mode="qat"`` against the JAX package's: the tiny
qwen2 of ``test_torch_ladder.py`` (the CIM kernel flag on, which qat does
not read) served on the float weights, every CIM linear through
``core.cim.cim_dense(mode="qat")`` with the layer key's readout noise.
The first 4 greedy tokens of every request equal the JAX engines' (the
short horizon of a noisy mode, ROADMAP C4), chunked on 2 slots (the JAX
engine's host buffers synchronised, ROADMAP C8) and on the
``LoopEngine``; ``deploy=True`` raises the reference's ``ValueError``,
``fused_step=True`` raises, and the serving CLI's ``--cim qat`` runs."""

import dataclasses

import jax
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
from repro_torch.serving.engine import Engine, LoopEngine, Request

HORIZON = 4
LENS = (12, 9, 12, 7)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(get):
    cfg = get("qwen2-0.5b").reduced()
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, d_ff=256, vocab_size=128, n_heads=4,
        n_kv_heads=2, head_dim=32,
        cim=dataclasses.replace(cfg.cim, use_kernel=True))


def _close_host_buffer_race(eng):
    """The JAX engine hands its per-slot numpy buffers (levels, sampling
    keys) to computations that CPU dispatch may run later, and writes them
    in place when a slot is freed or admitted (ROADMAP C8). Wait for the
    engine's last dispatched step before each such write, as a synchronous
    dispatch would; the reference's code is not changed."""
    for name in ("_free_slot", "_admit"):
        real = getattr(eng, name)

        def synced(*a, _real=real, **k):
            jax.block_until_ready((eng.last_tok, eng.caches))
            return _real(*a, **k)

        setattr(eng, name, synced)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _tiny(jget), _tiny(get_config)
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 127, n).astype(np.int32) for n in LENS]
    return jcfg, cfg, jp, params, prompts


def _reqs(cls, prompts):
    return [cls(prompt=p, max_new_tokens=HORIZON, rid=f"q{i}")
            for i, p in enumerate(prompts)]


def test_qat_engine_tokens_equal_jax(setup):
    """Chunked on 2 slots (admissions between steps): the port's first 4
    greedy tokens of every request equal the JAX ``Engine``'s, the engine
    serves per call on undeployed weights, and the qat noise moves the
    tokens off the off-mode run's somewhere."""
    jcfg, cfg, jp, params, prompts = setup
    kw = dict(max_slots=2, max_len=32, cim_mode="qat", chunk_size=8)
    jeng = JEngine(jcfg, jp, fused_step=False, **kw)
    _close_host_buffer_race(jeng)
    ref = jeng.generate(_reqs(JRequest, prompts))
    eng = Engine(cfg, params, device="cpu", **kw)
    assert not eng.deployed and not eng.fused_step and eng._width == 0
    got = eng.generate(_reqs(Request, prompts))
    assert [o[:HORIZON] for o in got] == [o[:HORIZON] for o in ref]
    off = Engine(cfg, params, device="cpu",
                 **dict(kw, cim_mode="off")).generate(_reqs(Request, prompts))
    assert off != got


def test_qat_loop_engine_tokens_equal_jax(setup):
    jcfg, cfg, jp, params, prompts = setup
    kw = dict(max_slots=2, max_len=32, cim_mode="qat")
    ref = JLoopEngine(jcfg, jp, **kw).generate(_reqs(JRequest, prompts))
    eng = LoopEngine(cfg, params, device="cpu", **kw)
    assert not eng.deployed
    got = eng.generate(_reqs(Request, prompts))
    assert [o[:HORIZON] for o in got] == [o[:HORIZON] for o in ref]


def test_qat_options_that_raise(setup):
    """``deploy=True`` in qat raises the reference's ``ValueError``, word
    for word, on both engines; ``fused_step=True`` raises the capture
    message, which names qat."""
    jcfg, cfg, jp, params, _ = setup
    for eng_cls, jeng_cls in ((Engine, JEngine), (LoopEngine, JLoopEngine)):
        with pytest.raises(ValueError) as want:
            jeng_cls(jcfg, jp, cim_mode="qat", deploy=True)
        with pytest.raises(ValueError) as got:
            eng_cls(cfg, params, cim_mode="qat", deploy=True, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="qat") as e:
        Engine(cfg, params, cim_mode="qat", fused_step=True, device="cpu")
    assert "capture" in str(e.value) and "deploy=False" in str(e.value)
    with pytest.raises(ValueError, match="cim_mode"):
        Engine(cfg, params, cim_mode="analog", device="cpu")


def test_serve_cli_cim_qat(capsys):
    outs = serve.main(["--reduced", "--cim", "qat", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "9",
                       "--new-tokens", "3"])
    assert [len(o) for o in outs] == [3, 3]
    assert "tok/s" in capsys.readouterr().out
