"""The port's GPipe pipeline (``distributed.pipeline.pipeline_apply``) on
4 gloo ranks against the JAX package's on 4 forced host devices, with 4
and with 2 microbatches: a residual stage ``x + tanh(x @ w)``, the
outputs within 1e-6 relative of the reference's and of the sequential
stack, the gradients of ``sum(y ** 2)`` by the stacked stage weights and
by the input within 1e-5 relative of the reference's (summed over the
ranks: each rank holds its own stage's); every rank returns the same
outputs."""

import numpy as np
import pytest

from torch_dist_helpers import run_jax, run_ranks


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_micro", [4, 2])
def test_pipeline_four_ranks_equal_jax(tmp_path, n_micro):
    rng = np.random.default_rng(n_micro)
    inp = {"ws": (rng.normal(size=(4, 16, 16)) / 4).astype(np.float32),
           "x": rng.normal(size=(8, 16)).astype(np.float32),
           "n_micro": np.array(n_micro)}
    ranks = run_ranks("pipeline", 4, tmp_path, inp)
    want = run_jax("pipeline", 4, tmp_path, inp)
    got = ranks[0]
    assert _rel(got["y"], want["y"]) <= 1e-6
    assert _rel(got["y"], want["seq"]) <= 1e-6
    assert _rel(got["gw"], want["gw"]) <= 1e-5
    assert _rel(got["gx"], want["gx"]) <= 1e-5
    for s, r in enumerate(ranks):
        np.testing.assert_array_equal(r["y"], got["y"])
        # stage s's weights get their gradient on rank s alone
        assert _rel(r["own_gw"], want["gw"][s]) <= 1e-5
