"""The port's serving engine against the JAX ``Engine`` on the reduced
qwen2-0.5b (ragged prompts longer than one chunk, more requests than
slots): greedy tokens equal exactly in off mode and in sim mode with the
CIM kernel path and kernel attention; temperature sampling equals
``jax.random.categorical`` under the same per-request keys. Also the port's own rules: no JAX
and nothing of the JAX package inside it, and no silent CPU fallback."""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models.model import build as jbuild
from repro.serving import engine as jax_engine
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import cim, prng
from repro_torch.core.deploy import params_from_jax
from repro_torch.kernels.cim_matmul import cim_matmul_fused
from repro_torch.launch import serve
from repro_torch.serving import engine
from repro_torch.serving.engine import Engine, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
LENS = (40, 70, 35, 90)


@pytest.fixture(scope="module")
def setup():
    def cfg_of(base, int8):
        return dataclasses.replace(
            base.reduced(), kv_cache_int8=int8,
            cim=dataclasses.replace(base.cim, use_kernel=True))
    jc = cfg_of(jget("qwen2-0.5b"), False)
    params, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, n, dtype=np.int32)
               for n in LENS]
    return cfg_of, params, tp, prompts


@pytest.mark.parametrize("mode,impl,int8", [
    ("off", "einsum", False), ("off", "kernel", True),
    ("sim", "kernel", False), ("sim", "kernel", True)])
def test_greedy_tokens_equal_jax_engine(setup, mode, impl, int8):
    cfg_of, params, tp, prompts = setup
    jc, tc = cfg_of(jget("qwen2-0.5b"), int8), cfg_of(
        get_config("qwen2-0.5b"), int8)
    kw = dict(max_slots=2, max_len=128, cim_mode=mode, attn_impl=impl)
    ja = JEngine(jc, params, **kw).generate(
        [JRequest(prompt=p, max_new_tokens=8, rid=f"r{i}")
         for i, p in enumerate(prompts)])
    ta = Engine(tc, tp, device="cpu", **kw).generate(
        [Request(prompt=p, max_new_tokens=8, rid=f"r{i}")
         for i, p in enumerate(prompts)])
    assert ta == ja, (ta, ja)


def test_sampling_equals_jax_categorical():
    """Temperature sampling under the per-request key contract: the row
    keys are fold_in(request key, token index) and the draw is the arg-max
    of the scaled logits plus the Threefry twin's Gumbel noise."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 512)).astype(np.float32) * 3
    temps = np.array([0.0, 0.5, 0.9, 1.3], np.float32)
    rkeys = [prng.fold_in(prng.fold_in(prng.PRNGKey(0), 0x5A17), u)
             for u in (3, 77, 1234, 0x7FFFFFFF)]
    tok_idx = [0, 1, 5, 9]
    jkeys = jax_engine._row_sample_keys(
        jnp.asarray(np.array(rkeys, np.uint32)), jnp.asarray(tok_idx))
    j = jax_engine._sample_tokens(jnp.asarray(logits), jnp.asarray(temps),
                                  jkeys)
    keys = engine._row_sample_keys(rkeys, tok_idx)
    assert keys == [tuple(int(w) for w in k) for k in np.asarray(jkeys)]
    t = engine._sample_tokens(torch.from_numpy(logits), temps.tolist(), keys)
    assert t.tolist() == np.asarray(j).tolist()


def test_sampled_stream_replays_by_request_id(setup):
    """A request's sampled tokens depend only on its id and position: the
    same rid gives the same stream alone and beside other requests."""
    cfg_of, _, tp, prompts = setup
    cfg = cfg_of(get_config("qwen2-0.5b"), False)
    busy = Engine(cfg, tp, max_slots=2, max_len=128, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=6, temperature=0.9, rid=f"r{i}")
         for i, p in enumerate(prompts)])
    solo = Engine(cfg, tp, max_slots=2, max_len=128, device="cpu").generate(
        [Request(prompt=prompts[3], max_new_tokens=6, temperature=0.9,
                 rid="r3")])
    assert solo[0] == busy[3]
    assert busy[0] != Engine(cfg, tp, max_slots=2, max_len=128,
                             device="cpu").generate(
        [Request(prompt=prompts[0], max_new_tokens=6)])[0]


def test_session_api_cancel_and_slot_reuse(setup):
    cfg_of, _, tp, prompts = setup
    cfg = cfg_of(get_config("qwen2-0.5b"), False)
    eng = Engine(cfg, tp, max_slots=2, max_len=128, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
    for r in reqs:
        eng.submit(r)
    assert eng.step() and eng.cancel(reqs[1]) and eng.cancel(reqs[3])
    assert not eng.cancel(reqs[3])
    while eng.has_work():
        eng.step()
    eng.drain_pending()
    assert eng.status == ["completed", "cancelled", "completed", "cancelled"]
    # a recycled slot is token-clean: the same request alone gives the
    # same tokens as in the busy session
    solo = Engine(cfg, tp, max_slots=2, max_len=128, device="cpu").generate(
        [Request(prompt=prompts[2], max_new_tokens=4)])
    assert reqs[2].out_tokens == solo[0]
    assert reqs[1].out_tokens == []       # cancelled mid-prefill


def test_unported_options_and_bad_requests_raise(setup, monkeypatch):
    cfg_of, _, tp, _ = setup
    cfg = cfg_of(get_config("qwen2-0.5b"), False)
    for kw in ({"guard": True}, {"ladder": object()}, {"cim_mode": "qat"}):
        with pytest.raises(NotImplementedError):
            Engine(cfg, tp, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        Engine(dataclasses.replace(cfg, family="moe"), tp, device="cpu")
    # the behavioural sim path (use_kernel=False) is ported: it serves,
    # through cim_matmul_behavioral and not the CIM kernel's plain version
    behavioural = dataclasses.replace(cfg, cim=dataclasses.replace(
        cfg.cim, use_kernel=False))
    calls = []
    real = cim.cim_matmul_behavioral

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(cim, "cim_matmul_behavioral", counted)
    before = cim_matmul_fused.launches
    out = Engine(behavioural, tp, cim_mode="sim", max_len=64,
                 device="cpu").generate(
        [Request(prompt=np.arange(5), max_new_tokens=2)])
    assert len(out[0]) == 2 and calls
    assert cim_matmul_fused.launches == before
    eng = Engine(cfg, tp, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=np.arange(12), max_new_tokens=8))


def test_entry_points_raise_on_cpu_host_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced"])


def test_serve_cli_on_cpu(capsys):
    outs = serve.main(["--reduced", "--cim", "sim", "--attn-impl", "kernel",
                       "--device", "cpu", "--requests", "3",
                       "--prompt-len", "40", "--new-tokens", "3"])
    assert [len(o) for o in outs] == [3, 3, 3]
    assert "tok/s" in capsys.readouterr().out


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)
