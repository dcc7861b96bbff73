"""The port's MHA flash attention against the JAX package.

``flash_attention_plain`` (the plain version of the CUDA kernel, which
follows the kernel's arithmetic) is held against
``flash_attention(interpret=True)`` of the JAX package and the oracle
``ref.flash_attention_ref``: in float32 within rtol 2e-5 and atol 2e-5, the
JAX package's own slack (the online softmax over other blocks sums in
another order). In bfloat16 the kernels round p to bf16 against the
running max of their own key blocks (the port's 32 keys, the Pallas
kernel's 128) and the output to bf16: every output row (one query over D)
within 2^-6 of its largest |value| against the Pallas kernel. A flip of
one output rounding moves an element by one bf16 ulp, up to 2^-7 of the
row scale (seen here: 2^-7.03), and p's roundings against other block
maxima add less.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels._attn import SM_TARGET
from repro_torch.kernels.flash_attention import (MAX_SPLITS, MHA_BLOCK_K,
                                                 MHA_BLOCK_Q,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 flash_mha_plan)

FLASH_SHAPES = [
    (4, 256, 256, 64, True),    # square causal, block-aligned
    (2, 200, 200, 64, True),    # ragged causal
    (3, 128, 384, 128, False),  # cross-attention (non-causal, t > s)
    (1, 130, 257, 64, True),    # ragged both dims
]


def _qkv(bh, s, t, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((bh, s, d), (bh, t, d), (bh, t, d)))


@pytest.mark.parametrize("bh,s,t,d,causal", FLASH_SHAPES)
def test_plain_matches_pallas_and_ref_f32(bh, s, t, d, causal):
    q, k, v = _qkv(bh, s, t, d, s + t)
    y = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal).numpy()
    yp = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, interpret=True))
    yr = np.asarray(flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(y, yp, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y, yr, rtol=2e-5, atol=2e-5)
    # the CPU entry point is the plain version
    ye = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_array_equal(ye, y)


@pytest.mark.parametrize("starts", [[0, 7, 20], [54, 1, 33], [0, 0, 0]])
def test_plain_start_offsets(starts):
    s, t, d = 10, 64, 64
    q, k, v = _qkv(3, s, t, d, sum(starts))
    st = np.asarray(starts, np.int32)
    y = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), True,
                              torch.from_numpy(st)).numpy()
    yp = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, start=jnp.asarray(st), block_q=8,
                           block_k=8, interpret=True))
    yr = np.asarray(flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        start=jnp.asarray(st)))
    np.testing.assert_allclose(y, yp, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y, yr, rtol=2e-5, atol=2e-5)


def test_plain_start_past_the_keys():
    """A row whose start + S runs past T: keys stop at T (the Pallas
    kernel's padded-key mask), as in the oracle."""
    s, t, d = 12, 40, 64
    q, k, v = _qkv(2, s, t, d, 3)
    st = np.asarray([33, 5], np.int32)
    y = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), True,
                              torch.from_numpy(st)).numpy()
    yp = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, start=jnp.asarray(st), block_q=8,
                           block_k=8, interpret=True))
    np.testing.assert_allclose(y, yp, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bh,s,t,d,causal", [(2, 100, 100, 64, True),
                                             (2, 65, 65, 64, False),
                                             (2, 48, 160, 128, False)])
def test_plain_bf16_matches_pallas(bh, s, t, d, causal):
    q, k, v = _qkv(bh, s, t, d, 11 + s)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    y = flash_attention_plain(tq, tk, tv, causal)
    assert y.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    yp = np.asarray(jflash(jq, jk, jv, causal=causal, interpret=True)
                    .astype(jnp.float32))
    yf = y.to(torch.float32).numpy()
    row = np.abs(yp).max(-1, keepdims=True)
    assert np.all(np.abs(yf - yp) <= 2.0 ** -6 * row)


def test_plain_is_block_invariant_in_f32():
    """Fully masked blocks past a causal frontier add nothing: the plain
    version equals a one-block softmax within f32 summation order."""
    q, k, v = _qkv(2, 70, 70, 64, 4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    y = flash_attention_plain(tq, tk, tv, True)
    sc = torch.einsum("bsd,btd->bst", tq, tk) / 8.0
    mask = torch.arange(70)[None, :] <= torch.arange(70)[:, None]
    p = torch.softmax(torch.where(mask, sc, torch.tensor(-1e30)), -1)
    torch.testing.assert_close(y, p @ tv, rtol=2e-5, atol=2e-5)
    assert MHA_BLOCK_K[torch.float32] < 70   # more than one key block walked


def test_start_without_causal_raises():
    q = torch.zeros((2, 4, 64))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False,
                        start=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="causal"):
        flash_attention_plain(q, q, q, False,
                              torch.zeros(2, dtype=torch.int32))


def test_block_counts_on_cpu_raise():
    q = torch.zeros((2, 4, 64))
    with pytest.raises(ValueError, match="block counts"):
        flash_attention(q, q, q, return_block_counts=True)


# the chip smoke test's five MHA shapes (BH, S, T, D, causal, starts per
# row or None) and, for bf16, the key blocks a q block splits over
B5_SHAPES = [
    ((112, 128, 128, 64, True, None), 2),
    ((56, 32, 320, 64, True, [0, 96, 160, 288] * 14), 5),
    ((384, 65, 65, 64, False, None), 1),
    ((16, 512, 1536, 128, False, None), 3),
    ((16, 2048, 2048, 128, True, None), 1),
]


def _visited(plan, bh, s, t, causal, starts):
    """Key blocks each q block visits, summed over its splits, as the
    kernel's blocks walk them: split sp takes key blocks [sp * kbps,
    (sp + 1) * kbps) below the q block's frontier."""
    bq, bk, kbps = plan["block_q"], plan["block_k"], plan["kbps"]
    out = []
    for b in range(bh):
        st = 0 if starts is None else starts[b]
        kv_end = min(t, st + s) if causal else t
        row = []
        for i in range(plan["n_q"]):
            npos = min(bq, s - i * bq)
            front = min(st + i * bq + npos, kv_end) if causal else kv_end
            nkb = -(-front // bk)
            row.append(sum(min(sp * kbps + kbps, nkb) - sp * kbps
                           for sp in range(plan["n_split"])
                           if sp * kbps < nkb))
        out.append(row)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,splits", B5_SHAPES)
def test_mha_plan_at_the_b5_shapes(dtype, shape, splits):
    """The launch plan at the main shapes: 64-row q blocks, the dtype's key
    block, bf16 key ranges split until the grid reaches SM_TARGET blocks
    (at most MAX_SPLITS), f32 unsplit; the splits cover every key block
    once, so the summed counts equal the closed form the card checks."""
    bh, s, t, d, causal, starts = shape
    plan = flash_mha_plan(bh, s, t, d, dtype)
    n_q = -(-s // MHA_BLOCK_Q)
    n_kb = -(-t // MHA_BLOCK_K[dtype])
    assert plan["block_q"] == MHA_BLOCK_Q == 64
    assert plan["block_k"] == MHA_BLOCK_K[dtype] and plan["n_q"] == n_q
    if dtype == torch.float32:
        assert plan["n_split"] == 1 and plan["grid"] == (1, n_q, bh)
    else:
        assert plan["n_split"] == splits <= MAX_SPLITS
        assert plan["grid"] == (splits, n_q, bh)
        assert (splits - 1) * plan["kbps"] < n_kb <= splits * plan["kbps"]
        assert splits == 1 or splits * n_q * bh >= SM_TARGET \
            or splits == MAX_SPLITS or plan["kbps"] == 1
        assert plan["part_o"] == (bh * n_q * splits, 64, d)
    st = [0] * bh if starts is None else starts
    bk = plan["block_k"]
    closed = [[-(-min(st[b] + min((i + 1) * 64, s), t) // bk) if causal
               else -(-t // bk) for i in range(n_q)] for b in range(bh)]
    assert _visited(plan, bh, s, t, causal, starts) == closed


@pytest.mark.parametrize("bh,s,t,d,want", [
    (2, 64, 1000, 128, (16, 2)),     # capped at MAX_SPLITS
    (1, 1, 1, 64, (1, 1)),           # one key
    (300, 64, 4096, 64, (1, 128)),   # a full grid: no split
])
def test_mha_plan_split_edges(bh, s, t, d, want):
    plan = flash_mha_plan(bh, s, t, d, torch.bfloat16)
    assert (plan["n_split"], plan["kbps"]) == want
    with pytest.raises(ValueError, match="64, 96, 112, 128"):
        flash_mha_plan(bh, s, t, 80, torch.bfloat16)
    f32 = flash_mha_plan(bh, s, t, d, torch.float32)   # never split
    assert (f32["block_k"], f32["n_split"]) == (64, 1)
