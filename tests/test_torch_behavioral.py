"""The port's behavioural sim path (``core.cim.cim_matmul_behavioral`` and
``cim_dense``, taken by ``layers.dense`` when ``cim.use_kernel`` is False)
against the JAX package on the same numpy inputs and the same key.

The integer part is exact: every product sum is an integer, exact in f32
below 2^24 and in f64 above. The noise is ``jax.random.normal``, replayed
by ``prng.normal`` with equal Threefry bits and values within 3 ulp
(``tests/test_torch_prng.py``); the noisy output is held to 3 ulp of
``sigma * normal`` plus one rounding of the sum (``cim_dense`` adds the
two roundings of its ``* xs * ws`` rescale). Then the engine: greedy
tokens of the reduced qwen2 in sim mode on the behavioural path equal the
JAX engine's over 8 tokens, and the serving CLI's ``--cim sim`` takes that
path, as ``repro.launch.serve --cim sim`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import cim as jcim
from repro.core import sac as jsac
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import cim, prng, sac
from repro_torch.core.deploy import params_from_jax
from repro_torch.kernels import cim_matmul as kcim
from repro_torch.launch import serve
from repro_torch.serving.engine import Engine, Request

KEY = (0x1234ABCD, 0x0BADF00D)


def _specs(role, noise_scale=1.0, bits=None):
    j = getattr(jsac.paper_sac(), role)
    t = getattr(sac.paper_sac(), role)
    kw = dict(noise_scale=noise_scale)
    if bits is not None:
        kw.update(in_bits=bits, w_bits=bits)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _int_operands(shape, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    q = 2 ** (bits - 1) - 1
    xq = rng.integers(-q, q + 1, size=shape + (k,)).astype(np.int32)
    wq = rng.integers(-q, q + 1, size=(k, n)).astype(np.int32)
    return xq, wq


def _noisy_close(t, j, noise_j, noise_ulps=3, roundings=1):
    """|t - j| within ``noise_ulps`` ulp of the noise term plus
    ``roundings`` roundings of the result."""
    tol = (noise_ulps * np.spacing(np.abs(noise_j).astype(np.float32))
           + roundings * np.spacing(np.abs(j).astype(np.float32)))
    assert np.all(np.abs(t - j) <= tol), np.max(np.abs(t - j) - tol)


@pytest.mark.parametrize("role,bits,shape,k,n", [
    ("attn", None, (3,), 896, 128),          # f32 dot, 1 tile
    ("mlp", None, (2, 5), 4864, 96),         # f32 dot, 5 tiles
    ("mlp", 8, (4,), 2048, 64),              # 127^2 * 2048 >= 2^24: f64 dot
])
def test_behavioral_matmul_matches_jax(role, bits, shape, k, n):
    jspec, tspec = _specs(role, bits=bits)
    xq, wq = _int_operands(shape, k, n, jspec.in_bits, seed=k + n)
    jkey = jnp.asarray(np.array(KEY, np.uint32))
    # the integer part: noise off, exact
    j0 = np.asarray(jcim.cim_matmul_behavioral(
        jnp.asarray(xq), jnp.asarray(wq), jkey,
        dataclasses.replace(jspec, noise_scale=0.0)))
    t0 = cim.cim_matmul_behavioral(
        torch.from_numpy(xq), torch.from_numpy(wq), KEY,
        dataclasses.replace(tspec, noise_scale=0.0)).numpy()
    np.testing.assert_array_equal(t0, j0)
    np.testing.assert_array_equal(t0, (xq.astype(np.int64) @ wq).astype(
        np.float32))
    # with the readout noise under the same key
    j = np.asarray(jcim.cim_matmul_behavioral(
        jnp.asarray(xq), jnp.asarray(wq), jkey, jspec))
    t = cim.cim_matmul_behavioral(torch.from_numpy(xq), torch.from_numpy(wq),
                                  KEY, tspec).numpy()
    sigma = cim.output_noise_std_int(tspec, k)
    assert abs(sigma - jcim.output_noise_std_int(jspec, k)) <= 1e-5 * sigma
    assert t.shape == j.shape == shape + (n,)
    _noisy_close(t, j, j - j0)
    assert np.std(j - j0) == pytest.approx(sigma, rel=0.1)


@pytest.mark.parametrize("deployed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cim_dense_matches_jax(deployed, dtype):
    jspec, tspec = _specs("mlp")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 896)).astype(np.float32)
    w = (0.05 * rng.normal(size=(896, 160))).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jw, tw = jnp.asarray(w).astype(dtype), torch.from_numpy(w).to(tx.dtype)
    # digital: the plain product
    np.testing.assert_allclose(
        cim.cim_dense(tx.float(), tw.float(), tspec, None).numpy(),
        np.asarray(jcim.cim_dense(jx.astype(jnp.float32),
                                  jw.astype(jnp.float32), jspec, None)),
        rtol=1e-5, atol=1e-5)
    xs = np.float32(4.0 * np.sqrt(np.mean(x * x)) / 31)
    kw_j, kw_t = dict(x_scale=jnp.asarray(xs)), dict(x_scale=torch.tensor(xs))
    if deployed:
        ws = np.float32(np.abs(w).max() / 31)
        wq = np.clip(np.round(w / ws), -31, 31).astype(np.int8)
        kw_j.update(w_scale=jnp.asarray(ws).astype(dtype),
                    wq=jnp.asarray(wq))
        kw_t.update(w_scale=torch.tensor(ws).to(tx.dtype),
                    wq=torch.from_numpy(wq))
    for key in (KEY, None):
        jkey = None if key is None else jnp.asarray(np.array(key, np.uint32))
        j = np.asarray(jcim.cim_dense(jx, None if deployed else jw, jspec,
                                      jkey, mode="sim", **kw_j)
                       .astype(jnp.float32))
        j0 = np.asarray(jcim.cim_dense(
            jx, None if deployed else jw,
            dataclasses.replace(jspec, noise_scale=0.0), jkey, mode="sim",
            **kw_j).astype(jnp.float32))
        t = cim.cim_dense(tx, None if deployed else tw, tspec, key,
                          mode="sim", **kw_t)
        assert t.dtype == tx.dtype and t.shape == (2, 3, 160)
        t = t.float().numpy()
        if dtype == "float32":
            # y * xs * ws: the 3 ulp of the integer-domain noise scale to at
            # most 6 ulp of the scaled noise (a binade apart), and the two
            # products add a rounding each
            _noisy_close(t, j, j - j0, noise_ulps=6, roundings=3)
        else:
            # one bf16 rounding of values within f32 ulps of each other:
            # equal or one bf16 step apart
            step = np.abs(j) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(t - j) <= step)
            assert np.mean(t == j) > 0.99
    # qat (noise-aware fake-quant, ported since): without a key the
    # reference's fake-quant product
    jq = np.asarray(jcim.cim_dense(jx, jw, jspec, None, mode="qat",
                                   x_scale=jnp.asarray(xs))
                    .astype(jnp.float32))
    tq = cim.cim_dense(tx, tw, tspec, None, mode="qat",
                       x_scale=torch.tensor(xs))
    assert tq.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(tq.float().numpy(), jq, rtol=0,
                               atol=tol * np.abs(jq).max())


@pytest.fixture(scope="module")
def reduced():
    jc = jget("qwen2-0.5b").reduced()
    tc = get_config("qwen2-0.5b").reduced()
    assert not jc.cim.use_kernel and not tc.cim.use_kernel
    params, _ = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jc.vocab_size, n, dtype=np.int32)
               for n in (40, 70, 35)]
    return jc, tc, params, tp, prompts


def test_engine_behavioral_sim_tokens_equal_jax(reduced, monkeypatch):
    """Sim mode on the config default (use_kernel=False): the behavioural
    path in both packages, greedy tokens equal over 8 tokens; the port
    never calls the fused CIM kernel's plain version on that path."""
    jc, tc, params, tp, prompts = reduced
    kw = dict(max_slots=2, max_len=128, cim_mode="sim", attn_impl="kernel")
    ja = JEngine(jc, params, **kw).generate(
        [JRequest(prompt=p, max_new_tokens=8, rid=f"b{i}")
         for i, p in enumerate(prompts)])
    calls = []
    monkeypatch.setattr(kcim, "cim_matmul_fused_plain",
                        lambda *a, **k: calls.append(1))
    ta = Engine(tc, tp, device="cpu", **kw).generate(
        [Request(prompt=p, max_new_tokens=8, rid=f"b{i}")
         for i, p in enumerate(prompts)])
    assert ta == ja, (ta, ja)
    assert calls == []


def test_serve_cli_sim_runs_the_behavioral_path(monkeypatch, capsys):
    """``--cim sim`` leaves ``use_kernel`` at the config's False: every CIM
    linear goes through ``cim_matmul_behavioral``, none through the fused
    kernel or its plain version."""
    calls = {"behavioral": 0, "fused": 0}
    real = cim.cim_matmul_behavioral

    def behavioral(*a, **k):
        calls["behavioral"] += 1
        return real(*a, **k)

    def fused(*a, **k):
        calls["fused"] += 1
        raise AssertionError("the fused CIM path ran")

    monkeypatch.setattr(cim, "cim_matmul_behavioral", behavioral)
    monkeypatch.setattr(kcim, "cim_matmul_fused_plain", fused)
    before = kcim.cim_matmul_fused.launches
    outs = serve.main(["--reduced", "--cim", "sim", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "20",
                       "--new-tokens", "3"])
    assert [len(o) for o in outs] == [3, 3]
    assert kcim.cim_matmul_fused.launches == before
    assert calls["fused"] == 0
    # 7 linears x 2 layers per chunk and per decode step
    assert calls["behavioral"] > 0 and calls["behavioral"] % 14 == 0
    assert "tok/s" in capsys.readouterr().out
