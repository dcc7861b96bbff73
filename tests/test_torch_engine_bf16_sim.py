"""bf16 models of the port's engines against the JAX engines in sim mode
on the CIM kernel path, on the reduced qwen2-0.5b and mamba2-130m: the
chunked ``Engine``, with bf16 and int8 caches, and the whole-prompt path
(which runs ``LoopEngine``'s batch-1 whole-prompt forward; ``LoopEngine``
itself is held in bf16 in off mode, and in sim mode in float32, exactly,
in ``test_torch_loop_engine.py``). An ulp of a bf16 activation flips its quantization level,
so the reference's own bf16 and float32 models part by 0.07-0.32 on the
first step; the port's first-step logits must lie no further from the
reference's bf16 model than that (the bound of the size of bf16 rounding
in sim mode; off mode is held to 4 ulps in ``test_torch_engine_bf16.py``,
whose helpers this file takes)."""

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro_torch.configs.registry import get_config
from test_torch_engine_bf16 import _cfg, _jax_steps, _port_steps
from test_torch_engine_bf16 import model  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread for the module: the suite runs several test
    processes side by side, and a thread pool each oversubscribes the
    cores (small eager ops then wait on thread barriers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path,int8", [
    ("chunked", False), ("chunked", True), ("whole", False)])
def test_bf16_sim_first_step_against_jax(model, monkeypatch, path,  # noqa
                                         int8):
    arch, jp, tp, prompts = model
    ref, got, f32 = (
        steps(monkeypatch, path, _cfg(get, arch, "sim", dtype, int8), params,
              "sim", prompts, new=2)
        for steps, get, dtype, params in (
            (_jax_steps, jget, "bfloat16", jp),
            (_port_steps, get_config, "bfloat16", tp),
            (_jax_steps, jget, "float32", jp)))
    for i, ((_, jl), (_, tl), (_, fl)) in enumerate(zip(ref, got, f32)):
        own = np.abs(fl[0] - jl[0]).max()
        assert np.abs(tl[0] - jl[0]).max() <= own, (i, own)
