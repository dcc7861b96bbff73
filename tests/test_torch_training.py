"""The port's training substrate against the JAX package: the LM data,
AdamW, the microbatched train step, checkpoints and the training CLI.

The train step runs on params copied from the JAX tree, in off mode (no
noise), so the losses of three steps agree within 1e-4 relative, with one
and with four microbatches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import lm_batch as jlm_batch
from repro.models.model import build as jbuild
from repro.training import optimizer as jopt
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.core.deploy import params_from_jax
from repro_torch.data.pipeline import (DataConfig, PipelineState, lm_batch,
                                       lm_stream)
from repro_torch.launch import train as train_cli
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                          make_train_step)

TINY = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=256, n_heads=4,
            n_kv_heads=2, head_dim=32)


def _tiny(cfg):
    return dataclasses.replace(cfg.reduced(), **TINY)


def test_lm_batch_and_stream_exact():
    for seed, step in ((1234, 0), (7, 13)):
        a = jlm_batch(JData(seed=seed, vocab_size=300, seq_len=40,
                            global_batch=6), step, host_id=1, n_hosts=2)
        b = lm_batch(DataConfig(seed=seed, vocab_size=300, seq_len=40,
                                global_batch=6), step, host_id=1, n_hosts=2)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    s = lm_stream(DataConfig(), start_step=3)
    np.testing.assert_array_equal(next(s)["tokens"],
                                  lm_batch(DataConfig(), 3)["tokens"])
    st = PipelineState.from_dict(PipelineState(step=9).to_dict())
    assert st.step == 9


def test_optimizer_three_steps_match_jax():
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(6, 5)).astype(np.float32),
         "b": {"w": rng.normal(size=(7,)).astype(np.float32),
               "c": rng.normal(size=(2, 3)).astype(np.float32)}}
    jc = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        clip_norm=0.5)
    tc = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                       clip_norm=0.5)
    jp = jax.tree.map(jnp.asarray, p)
    js = jopt.init_opt_state(jp)
    tp = opt.tree_map(torch.from_numpy, p)
    ts = opt.init_opt_state(tp)
    for _ in range(3):
        g = jax.tree.map(lambda t: rng.normal(size=t.shape).astype(
            np.float32), p)
        jp, js, ji = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g), js,
                                        jc)
        tp, ts, ti = opt.apply_updates(tp, opt.tree_map(torch.from_numpy, g),
                                       ts, tc)
        assert abs(float(ji["grad_norm"]) - float(ti["grad_norm"])) <= \
            1e-6 * float(ji["grad_norm"])
    for a, b in zip(jax.tree.leaves(jp), opt.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    for a, b in zip(jax.tree.leaves(js["master"]),
                    opt.tree_leaves(ts["master"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for s in (0, 1, 2, 5, 10, 12):
        assert abs(float(jopt.schedule(jc, jnp.asarray(s)))
                   - float(opt.schedule(tc, torch.tensor(s)))) <= 1e-9


@pytest.fixture(scope="module")
def lm_params():
    """The reduced qwen2's JAX params (drawn once for both microbatch
    counts)."""
    jc = jget("qwen2-0.5b").reduced()
    return jc, jbuild(jc).init(jax.random.PRNGKey(0))[0]


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_three_steps_match_jax(lm_params, microbatches):
    jc, params = lm_params
    tc = get_config("qwen2-0.5b").reduced()
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    jo = jopt.OptConfig(lr=2e-3, warmup_steps=1, total_steps=10)
    to = opt.OptConfig(lr=2e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_train_step(jc, jo, microbatches))
    tstep = make_train_step(tc, to, microbatches)
    js, ts = jopt.init_opt_state(params), opt.init_opt_state(tp)
    dcfg = DataConfig(vocab_size=jc.vocab_size, seq_len=24, global_batch=8)
    for s in range(3):
        batch = lm_batch(dcfg, s)
        key = prng.fold_in(prng.PRNGKey(1), s)
        params, js, jm = jstep(params, js, jax.tree.map(jnp.asarray, batch),
                               jnp.asarray(np.array(key, np.uint32)))
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, key)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * float(jm["loss"])
    # Adam normalizes each step, so an element whose gradient is nothing
    # but rounding (the k bias: softmax ignores a shift shared by all keys)
    # moves by up to 2 lr a step either way: hold the bulk of the elements
    # to 1e-5 and every element to that bound
    d = np.concatenate([np.abs(b.numpy() - np.asarray(a)).ravel() for a, b in
                        zip(jax.tree.leaves(params), opt.tree_leaves(tp))])
    assert np.mean(d > 1e-5) <= 1e-2 and d.max() <= 6 * to.lr


def _trainer(tmp_path, name, total, cfg=None, **kw):
    cfg = cfg or _tiny(get_config("qwen2-0.5b"))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    tcfg = TrainerConfig(total_steps=total, checkpoint_every=3,
                         checkpoint_dir=str(tmp_path / name), **kw)
    return Trainer(cfg, opt.OptConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=8), tcfg,
                   lambda s: lm_batch(dcfg, s), device="cpu")


def test_checkpoint_resume_exact(tmp_path):
    """Killed after step 3 and resumed: the end state equals the
    uninterrupted run's bit for bit (bf16 parameters included)."""
    cfg = dataclasses.replace(_tiny(get_config("qwen2-0.5b")),
                              dtype="bfloat16")
    key = prng.PRNGKey(0)
    full = _trainer(tmp_path, "a", 6, cfg).run(key, resume=False)
    _trainer(tmp_path, "b", 3, cfg).run(key, resume=False)
    resumed = _trainer(tmp_path, "b", 6, cfg).run(key, resume=True)
    assert resumed["last_step"] == 6
    for a, b in zip(opt.tree_leaves(full["params"]),
                    opt.tree_leaves(resumed["params"])):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert float(full["metrics"]["loss"]) == float(resumed["metrics"]["loss"])


def test_checkpoint_keep_k_and_restore(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    state = ({"w": torch.arange(6.0).reshape(2, 3),
              "h": torch.ones(3, dtype=torch.bfloat16) / 3},
             {"step": torch.tensor(4, dtype=torch.int32)})
    for s in (1, 2, 3, 4):
        ckpt.save(s, state, extra={"data_step": s})
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    template = ({"w": torch.zeros(2, 3),
                 "h": torch.zeros(3, dtype=torch.bfloat16)},
                {"step": torch.tensor(0, dtype=torch.int32)})
    got, meta = ckpt.restore_latest(template)
    assert meta["step"] == 4 and meta["extra"]["data_step"] == 4
    assert torch.equal(got[0]["w"], state[0]["w"])
    assert torch.equal(got[0]["h"], state[0]["h"])
    assert got[1]["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(4, ({"w": torch.zeros(3, 2), "h": template[0]["h"]},
                         template[1]))


def test_straggler_log_and_unported_compression(tmp_path):
    """Slow steps are logged; int8 gradient compression, ported since,
    builds a step (its numbers: test_torch_compression.py)."""
    out = _trainer(tmp_path, "s", 2, step_deadline_s=1e-9).run(
        prng.PRNGKey(0), resume=False)
    assert [s for s, _ in out["slow_steps"]] == [0, 1]
    assert callable(make_train_step(_tiny(get_config("qwen2-0.5b")),
                                    opt.OptConfig(), compress_grads=True))


def test_train_cli_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(["--reduced", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--cim", "qat", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert out["last_step"] == 2
    assert np.isfinite(float(out["metrics"]["loss"]))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    assert "done: steps=2" in capsys.readouterr().out
    out = train_cli.main(["--reduced", "--steps", "1", "--batch", "2",
                          "--seq", "16", "--device", "cpu",
                          "--compress-grads",
                          "--ckpt-dir", str(tmp_path / "c")])
    assert out["last_step"] == 1
    assert np.isfinite(float(out["metrics"]["loss"]))
