"""The models' tensor-parallel forward on gloo ranks against the JAX
package's forward on a mesh.

Reduced qwen2 (float32, 2 layers, 4 / 2 heads, d_ff 512, vocab 512) on two
ranks, mesh (data 1, model 2), in off mode and in sim mode on the CIM
kernel path (``cim.use_kernel``; the plain versions on the CPU): a 2 x 12
prefill and 2 decode steps through ``forward`` with the ranks' caches.
Each rank gets the global logits (``parallel.gather_logits``); they must
equal across ranks and sit within 1e-5 of a row's largest |logit| of the
reference's ``forward`` on a forced 2-device mesh of Auto axis types
(C9), under ``use_rules(default_rules(mesh))``, whose own sharded and
unsharded runs differ by float order only. In sim the prefill must
equal the port's one-rank forward bit for bit (row 1's column shards
carry their noise offsets, its row shards run the int32 partials; the
activation scale is the all-gathered activation's); the decode steps
part from it by ulps, within 1e-6 of a row's largest: the plain decode
attention's einsum over one KV head sums in another blocking than over
two (torch's einsum), which the card's kernel, split by the whole
model's plan, does not do.

The reference's C9 scenario (``tests/test_sharding.py:96``: reduced
internlm2's ``loss`` on a (data, model) mesh, off mode) at (2, 2) on four
ranks: the port's vocab-parallel loss within 1e-5 relative of the JAX
mesh loss. Every family and mode outside the slice raises
``NotImplementedError`` naming ROADMAP A7.3 on a live mesh. The ranks run
one torch thread each (``torch_dist_helpers``)."""

import numpy as np
import pytest

from torch_dist_helpers import run_jax, run_ranks

TOL = 1e-5          # logits: times a row's largest |logit|
ONE_RANK_TOL = 1e-6  # the sim decode steps against the one-rank forward
RUNS = ("off:1x2", "sim:1x2")


def _rel(a, b):
    return float((np.abs(a - b) / np.abs(a).max(-1, keepdims=True)).max())


@pytest.fixture(scope="module")
def qwen2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    g = np.random.default_rng(0)
    inp = {"arch": np.array("qwen2-0.5b"), "runs": np.array(RUNS),
           "key": np.array(7), "max_len": np.array(16),
           "tokens": g.integers(0, 512, (2, 12)).astype(np.int32),
           "decode": g.integers(0, 512, (2, 2)).astype(np.int32)}
    jax = run_jax("forward", 2, tmp, inp)
    inp.update({k: v for k, v in jax.items() if k.startswith("p/")})
    return jax, run_ranks("forward", 2, tmp, inp)


@pytest.mark.parametrize("run", [r.replace(":", "_") for r in RUNS])
def test_tp_logits_against_jax_mesh(qwen2, run):
    jax, ranks = qwen2
    for i in range(3):
        got = ranks[0][f"{run}/logits{i}"]
        assert got.shape == (2, 12 if i == 0 else 1, 512)
        assert np.isfinite(got).all()
        assert np.array_equal(got, ranks[1][f"{run}/logits{i}"])
        assert _rel(jax[f"{run}/logits{i}"], got) <= TOL, (run, i)
    for r in ranks:   # embed, o and down all-reduce; the logits gathered
        assert int(r[f"{run}/coll_all_reduce"]) > 0
        assert int(r[f"{run}/coll_all_gather"]) >= 3


def test_tp_sim_against_one_rank(qwen2):
    _, ranks = qwen2
    r0 = ranks[0]
    assert np.array_equal(r0["sim_1x2/logits0"], r0["sim_1x2/one/logits0"])
    for i in (1, 2):
        assert _rel(r0[f"sim_1x2/one/logits{i}"],
                    r0[f"sim_1x2/logits{i}"]) <= ONE_RANK_TOL
    # the noise is on: sim parts from off far beyond the tolerances
    assert _rel(r0["off_1x2/logits0"], r0["sim_1x2/logits0"]) > 100 * TOL


def test_c9_internlm2_loss_2x2(tmp_path):
    """The reference's multi-device scenario on Auto axes, (data 2, model
    2), against the port's loss on four ranks."""
    g = np.random.default_rng(3)
    inp = {"arch": np.array("internlm2-1.8b"), "runs": np.array(["off:2x2"]),
           "key": np.array(0), "max_len": np.array(32),
           "tokens": g.integers(0, 512, (8, 32)).astype(np.int32),
           "labels": g.integers(-1, 512, (8, 32)).astype(np.int32),
           "decode": np.zeros((0, 8), np.int32)}
    jax = run_jax("forward", 4, tmp_path, inp)
    inp.update({k: v for k, v in jax.items() if k.startswith("p/")})
    ranks = run_ranks("forward", 4, tmp_path, inp)
    want = float(jax["off_2x2/loss"])
    assert 0 < want < 20
    for r in ranks:
        assert abs(float(r["off_2x2/loss"]) - want) <= 1e-5 * want
        assert int(r["off_2x2/coll_all_reduce"]) > 0
    assert abs(float(ranks[0]["off_2x2/one/loss"]) - want) <= 1e-5 * want


def test_outside_the_slice_raises_on_a_live_mesh(tmp_path):
    """ssm, hybrid, MLA, encdec and ViT forwards, the behavioural sim
    linears (``use_kernel=False``) and qat mode raise
    ``NotImplementedError`` naming ROADMAP A7.3 on two live ranks, as does
    an ssm cache; none runs unsharded numbers."""
    ranks = run_ranks("outside", 2, tmp_path, {"unused": np.zeros(1)})
    for r in ranks:
        assert len(r) == 8 and all(int(v) == 1 for v in r.values()), r
