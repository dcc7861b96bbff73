"""The grouped and expert-parallel MoE dispatch against the JAX package.

Reduced olmoe (float32, 2 layers, 8 experts, top 2, sim on the CIM
kernel path; the plain versions on the CPU), a 4 x 128 prefill through
``forward`` with caches (dropless) and one decode step. Under rules of a
(data 2, ...) mesh the reference dispatches the 512 prefill tokens in 2
groups of 256 (``src/repro/models/moe.py:110-113``): capacity, the
expert buffer's abs-max and its noise draw are per ``(G, E, C, d)``
buffer, which changes the numbers (the ungrouped one-rank forward parts
from the grouped reference by about 0.4 of a row's largest logit). The
decode step's 4 tokens dispatch in one group.

  * The port's grouped forward in one process (rules on a ``VirtualMesh``
    of (data 2, model 2): no collective) against the reference's forward
    on a forced (data 2, model 1) mesh: within ``TOL`` of a row's largest
    |logit|, the ungrouped forward beyond ``1000 * TOL``.
  * The expert-parallel forward on four gloo ranks, (data 2, model 2):
    each rank holds 4 of the 8 experts' planes a layer and its data
    group's 256 tokens; its logits equal across ranks, and the prefill's
    equal the grouped one-process forward's bit for bit (the combine
    all-reduces each assignment's output, which one rank holds, and adds
    a token's k outputs in one device's order); the decode step's within
    ``EP_TOL`` of a row's largest (the plain decode attention's einsum
    over the rank's KV heads may sum in another blocking than over all of
    them, as in ``test_torch_tp.py``).
  * The same against the reference's (2, 2) mesh forward. The reference's
    activation scale is a batch mean its mesh sums in another order than
    one device (ROADMAP C2): at this key its (2, 2) run flips activations
    across a rounding boundary that its (2, 1) run does not, and the two
    part by 0.13 of a row's largest logit. The port sums the scale in one
    device's order (an all-gather of the activation), as the (2, 1) run
    does here, so each row is held within its (2, 1)-vs-(2, 2) spread plus
    ``TOL`` of the reference's (2, 2) logits.
"""

import numpy as np
import pytest

from torch_dist_helpers import run_jax, run_ranks

TOL = 1e-5
EP_TOL = 1e-6


def _rows(a, b):
    return (np.abs(a - b) / np.abs(a).max(-1, keepdims=True)).max(-1)


@pytest.fixture(scope="module")
def olmoe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    g = np.random.default_rng(1)
    inp = {"arch": np.array("olmoe-1b-7b"),
           "runs": np.array(["sim:2x2", "sim:2x1"]), "key": np.array(5),
           "max_len": np.array(130),
           "tokens": g.integers(0, 512, (4, 128)).astype(np.int32),
           "decode": g.integers(0, 512, (1, 4)).astype(np.int32)}
    jax = run_jax("forward", 4, tmp, inp)
    inp.update({k: v for k, v in jax.items() if k.startswith("p/")})
    inp["runs"] = np.array(["sim:2x2"])
    return jax, run_ranks("forward", 4, tmp, inp)


def test_grouped_one_process_against_jax(olmoe):
    jax, ranks = olmoe
    r0 = ranks[0]
    for i in range(2):
        want = jax[f"sim_2x1/logits{i}"]
        assert _rows(want, r0[f"sim_2x2/grouped/logits{i}"]).max() <= TOL
    # the grouping changes the prefill's numbers
    assert _rows(jax["sim_2x1/logits0"],
                 r0["sim_2x2/one/logits0"]).max() > 1000 * TOL


def test_expert_parallel_four_ranks(olmoe):
    jax, ranks = olmoe
    for i in range(2):
        got = ranks[0][f"sim_2x2/logits{i}"]
        assert np.isfinite(got).all()
        for r in ranks[1:]:
            assert np.array_equal(r[f"sim_2x2/logits{i}"], got)
        grouped = ranks[0][f"sim_2x2/grouped/logits{i}"]
        if i == 0:
            assert np.array_equal(grouped, got)
        assert _rows(grouped, got).max() <= EP_TOL
        spread = _rows(jax[f"sim_2x2/logits{i}"], jax[f"sim_2x1/logits{i}"])
        assert (_rows(jax[f"sim_2x2/logits{i}"], got)
                <= spread + TOL).all()
    for r in ranks:
        assert int(r["sim_2x2/local_experts"]) == 4
        assert int(r["sim_2x2/coll_all_reduce"]) > 0
