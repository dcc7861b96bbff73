"""The port's int8 gradient compression against the JAX package:
``simulate_compression`` equals the reference's bit for bit on the same
gradient tree and key (f32 and bf16 leaves; the keys of
``jax.random.split`` and the draws of ``jax.random.uniform`` replayed by
``core.prng``); ``compressed_dp_grads`` on 4 gloo ranks equals the
reference's on 4 forced host devices within one f32 ulp (the gradient of
the reference's own test, with a second leaf), equals the same formula
reckoned in one process bit for bit, and is the same on every rank; and
three train steps of the tiny qwen2 with ``compress_grads=True`` give the
JAX trainer's losses within 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.distributed.compression import \
    simulate_compression as jsimulate_compression
from repro.models.model import build as jbuild
from repro.training import optimizer as jopt
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.core.deploy import params_from_jax
from repro_torch.data.pipeline import DataConfig, lm_batch
from repro_torch.distributed.compression import simulate_compression
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import make_train_step
from torch_dist_helpers import run_ranks, run_jax

TINY = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=256, n_heads=4,
            n_kv_heads=2, head_dim=32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("key", [(0, 0), (0, 5), (0x9E3779B9, 0x7F4A7C15)])
def test_simulate_compression_exact_jax(key):
    rng = np.random.default_rng(sum(key) % 997)
    tree = {"w": rng.normal(size=(33, 17)).astype(np.float32) * 1e-3,
            "b": {"z": np.zeros(5, np.float32),
                  "h": rng.normal(size=(4, 3, 8)).astype(np.float32)},
            "e": rng.standard_cauchy(size=(64,)).astype(np.float32)}
    want = jsimulate_compression(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(np.array(key, np.uint32)))
    got = simulate_compression(opt.tree_map(torch.from_numpy, tree), key)
    for a, b in zip(jax.tree.leaves(want), opt.tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # a bf16 leaf comes back in bf16, its values the reference's
    bf = rng.normal(size=(16, 9)).astype(np.float32)
    want = jsimulate_compression({"g": jnp.asarray(bf, jnp.bfloat16)},
                                 jnp.asarray(np.array(key, np.uint32)))
    got = simulate_compression(
        {"g": torch.from_numpy(bf).to(torch.bfloat16)}, key)
    assert got["g"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["g"].float().numpy(),
                                  np.asarray(want["g"], np.float32))


def test_compressed_dp_grads_four_ranks_equal_jax(tmp_path):
    inp = {"w": np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8),
           "b": np.linspace(-0.3, 0.5, 8, dtype=np.float32),
           "x": np.arange(32, dtype=np.float32).reshape(8, 4) / 32.0,
           "key": np.array([0, 7], np.uint32)}
    ranks = run_ranks("compress", 4, tmp_path, inp)
    want = run_jax("compress", 4, tmp_path, inp)
    for k in ("b", "w"):
        got = ranks[0][f"g_{k}"]
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want[f"g_{k}"].view(np.int32))
        assert ulps.max() <= 1, (k, ulps.max())
        np.testing.assert_array_equal(got, ranks[0][f"one_{k}"])
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"g_{k}"], got)
        # near the plain mean of the shards (the reference test's bound)
        mean = ranks[0][f"mean_{k}"]
        assert np.linalg.norm(got - mean) <= 0.02 * np.linalg.norm(mean)


def test_compress_grads_train_steps_match_jax():
    jc = dataclasses.replace(jget("qwen2-0.5b").reduced(), **TINY)
    tc = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **TINY)
    params = jbuild(jc).init(jax.random.PRNGKey(0))[0]
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    jo = jopt.OptConfig(lr=2e-3, warmup_steps=1, total_steps=10)
    to = opt.OptConfig(lr=2e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_train_step(jc, jo, compress_grads=True))
    tstep = make_train_step(tc, to, compress_grads=True)
    plain = make_train_step(tc, to)
    js, ts = jopt.init_opt_state(params), opt.init_opt_state(tp)
    dcfg = DataConfig(vocab_size=jc.vocab_size, seq_len=16, global_batch=4)
    for s in range(3):
        batch = lm_batch(dcfg, s)
        key = prng.fold_in(prng.PRNGKey(1), s)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        if s == 1:      # the compressed update differs from the plain one
            p_plain = plain(tp, opt.init_opt_state(tp), tb, key)[0]
            p_comp = tstep(tp, opt.init_opt_state(tp), tb, key)[0]
            assert any(not torch.equal(a, b) for a, b in zip(
                opt.tree_leaves(p_plain), opt.tree_leaves(p_comp)))
        params, js, jm = jstep(params, js, jax.tree.map(jnp.asarray, batch),
                               jnp.asarray(np.array(key, np.uint32)))
        tp, ts, tm = tstep(tp, ts, tb, key)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * float(jm["loss"]), (s, float(tm["loss"]), float(jm["loss"]))
