"""The four examples of the port (``examples/torch_*.py``) run in-process
through their ``main(argv)`` on the CPU at tiny sizes. The quickstart's
metrics fall in the reference's bands (SQNR and CSNR within 2 dB of the
paper's 45.3 and 31.3 dB, 818 TOPS/W within 1, the SAC gain within 0.05
of 2.1: tests/test_cim.py, test_energy.py) and its two relative errors
equal the JAX functions' on the same operands within 1e-4; the serving
example's engine, handed a tree its caller deployed (``deploy=False``),
serves on the CIM kernel path with the seed table and gives the tokens of
an engine that deploys itself."""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CIMSpec as JCIMSpec
from repro.core import cim_dense as jcim_dense
from repro.core.cim import cim_matmul_bit_exact as jbit_exact
from repro_torch.configs.registry import get_config
from repro_torch.core.deploy import init_params
from repro_torch.serving.engine import Engine, Request

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def test_quickstart_metrics_in_the_reference_bands(capsys):
    got = _example("quickstart").main(["--device", "cpu"])
    assert abs(got["sqnr_db"] - 45.3) < 2.0
    assert abs(got["csnr_db"] - 31.3) < 2.0
    assert abs(got["peak_tops_w"] - 818.0) < 1.0
    assert abs(got["sac_gain"] - 2.1) < 0.05
    assert "SQNR  (paper 45.3 dB)" in capsys.readouterr().out
    # the reference quickstart's first two numbers, on its own operands
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (8, 1024))
    w = jax.random.normal(jax.random.fold_in(key, 1), (1024, 64))
    spec = JCIMSpec()
    y_cim = jcim_dense(x, w, spec, jax.random.fold_in(key, 2), mode="sim")
    assert abs(got["rel_gaussian"] - _rel(y_cim, x @ w)) <= 1e-4
    xq = jax.random.randint(key, (8, 1024), -31, 32)
    wq = jax.random.randint(jax.random.fold_in(key, 1), (1024, 64), -31, 32)
    y_bit = jbit_exact(xq, wq, jax.random.fold_in(key, 3), spec)
    assert abs(got["rel_peak"] - _rel(y_bit, xq @ wq)) <= 1e-4


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serve_lm_cim_example(use_kernel, capsys):
    argv = ["--device", "cpu", "--requests", "3", "--new-tokens", "4"]
    got = _example("serve_lm_cim").main(
        argv + (["--use-kernel"] if use_kernel else []))
    assert [len(o) for o in got["outs"]] == [4, 4, 4]
    assert got["e_base"] / got["e_sac"] > 2.0
    assert "deployed" in capsys.readouterr().out
    eng = got["engine"]
    assert not eng.deployed and bool(eng._width) == use_kernel
    # the engine's own deploy serves the same tokens
    cfg = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(
        cfg, cim=dataclasses.replace(cfg.cim, use_kernel=use_kernel))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 12,
                                        dtype=np.int32), max_new_tokens=4)
            for _ in range(3)]
    own = Engine(cfg, params, max_slots=2, max_len=64, cim_mode="sim",
                 device="cpu")
    assert own._width == eng._width
    assert own.generate(reqs) == got["outs"]


def test_train_vit_cim_example():
    got = _example("train_vit_cim").main(
        ["--device", "cpu", "--steps", "3", "--batch", "8",
         "--eval-batches", "1"])
    assert np.isfinite(got["loss"])
    assert 0.0 <= got["ideal"] <= 1.0 and 0.0 <= got["cim"] <= 1.0


def test_train_lm_100m_example(tmp_path):
    out = _example("train_lm_100m").main(
        ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
         "--dim", "64", "--layers", "2", "--vocab", "256", "--qat",
         "--ckpt-dir", str(tmp_path)])
    assert out["last_step"] == 3
    assert np.isfinite(float(out["metrics"]["loss"]))
