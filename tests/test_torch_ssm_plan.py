"""Launch plan of the selective-scan decode kernel, a CPU emulation of its
per-block arithmetic against the JAX package, and the wrapper's conv-weight
contract.

``ssm_decode_plan`` cuts every (slot row, head) into blocks of state rows;
it is pure Python, checked here at the served shapes (mamba2-130m at B 4, 1
and 3, the reduced mamba2, zamba2-7b's mamba layers) and at d_state values
that take the kernel's chunked body: every (b, h, p) in exactly one block
and one thread, and at mamba2-130m's width at least ``SM_COUNT`` blocks.

The emulation follows ``csrc/ssm_scan.cu`` block by block in float32 numpy
(each operation rounded on its own, as the kernel's explicit-rounding
intrinsics do): the conv taps summed in window order plus the bias, SiLU as
x / (1 + exp(-x)) * x, the state row ``state * da + (dt * x) * B``, and y
as the kernel sums it: lane l of a row owns n = l, l + lanes, ... and adds
them in ascending order, then the xor shuffle tree (offsets lanes/2 .. 1),
then ``+ D * x``. The rolled window is written by the block that owns each
x channel and, for the B and C channels, by block 0 of the slot row: every
element exactly once. It is held against the Pallas kernel
in interpret mode and against ``ref.ssm_decode_step_ref``: the window bit
for bit; y and the state within rtol = atol = 1e-5 (the JAX package's own
kernel test; the two sides sum y over N in different orders, and XLA may
contract a product and a sum into one FMA).

The wrapper takes ``conv_w``/``conv_b`` in float32 or in the window's dtype
and widens them before the conv, as the TPU kernel does: on the CPU path a
bf16 pair gives exactly what its float32 widening gives, and agrees with
the Pallas kernel fed the bf16 pair.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssm_decode_step_ref
from repro.kernels.ssm_scan import ssm_decode_step as jax_ssm_decode_step
from repro_torch.kernels._attn import SM_COUNT
from repro_torch.kernels.ssm_scan import (MAX_ROWS_PER_THREAD, TEMPLATED_N,
                                          THREADS, ssm_decode_plan,
                                          ssm_decode_step,
                                          ssm_decode_step_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
        / "ssm_scan.cu")

# (B, H, P, N): mamba2-130m's decode step (cell E) at B 4, 1 and 3, the
# reduced mamba2-130m, zamba2-7b's mamba layers (d_inner 7168), and d_state
# values that take the chunked body (no template of their own)
SHAPES = {"cell_e": (4, 24, 64, 128), "cell_e_b1": (1, 24, 64, 128),
          "cell_e_b3": (3, 24, 64, 128), "reduced": (4, 16, 32, 16),
          "zamba2_7b": (4, 112, 64, 64), "n40": (2, 3, 24, 40),
          "n8": (1, 2, 20, 8), "n200": (2, 5, 7, 200)}


def _thread_rows(plan, p):
    """{(block x, p): [(slice, r)]}: which thread and row slot of each block
    touches each state row p, as the kernel indexes them."""
    slices = plan["threads"] // plan["lanes"]
    hits = {}
    for bx in range(plan["grid"][0]):
        p0 = (bx % plan["groups"]) * plan["rows"]
        for r in range(plan["rows_per_thread"]):
            for sl in range(slices):
                row = p0 + r * slices + sl
                if row < p:
                    hits.setdefault((bx // plan["groups"], row), []).append(
                        (bx, sl, r))
    return hits


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_every_row_once(shape):
    b, h, p, n = SHAPES[shape]
    plan = ssm_decode_plan(b, h, p, n)
    lanes, rpt = plan["lanes"], plan["rows_per_thread"]
    assert plan["threads"] == THREADS and THREADS % lanes == 0
    assert lanes == (min(32, n) if n in TEMPLATED_N else 32)
    assert 1 <= rpt <= MAX_ROWS_PER_THREAD
    assert plan["rows"] == rpt * (THREADS // lanes)
    assert plan["grid"] == (h * plan["groups"], b)
    assert plan["groups"] * plan["rows"] >= p > (plan["groups"] - 1) \
        * plan["rows"]
    hits = _thread_rows(plan, p)
    # every (head, p) once; the slot-row axis is the grid's y
    assert sorted(hits) == [(hh, row) for hh in range(h) for row in range(p)]
    assert all(len(v) == 1 for v in hits.values())


@pytest.mark.parametrize("shape", ["cell_e", "cell_e_b1", "cell_e_b3",
                                   "zamba2_7b"])
def test_plan_fills_the_card(shape):
    plan = ssm_decode_plan(*SHAPES[shape])
    assert plan["grid"][0] * plan["grid"][1] >= SM_COUNT


def test_plan_at_cell_e():
    """16 rows a block at mamba2-130m's decode step: 384 blocks, 8 state
    floats a thread in flight; one row a thread at B 1 (192 blocks)."""
    plan = ssm_decode_plan(4, 24, 64, 128)
    assert (plan["rows"], plan["lanes"], plan["grid"]) == (16, 32, (96, 4))
    assert ssm_decode_plan(1, 24, 64, 128)["grid"] == (192, 1)


def test_plan_constants_match_the_source():
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int THREADS = (\d+);", src)[1]) \
        == THREADS
    assert int(re.search(r"constexpr int MAX_RPT = (\d+);", src)[1]) \
        == MAX_ROWS_PER_THREAD
    cases = tuple(int(c) for c in re.findall(r"case (\d+): return run<", src))
    assert cases == TEMPLATED_N


# ------------------------------------------------------------ emulation

def _silu_conv(convf, xbcf, wf, bf, bi, c):
    """The kernel's conv + SiLU of channels ``c`` of slot row ``bi``."""
    win = convf.shape[1]
    taps = [convf[bi, w, c] for w in range(win)] + [xbcf[bi, 0, c]]
    acc = taps[0] * wf[0, c]
    for w in range(1, win + 1):
        acc = acc + taps[w] * wf[w, c]
    acc = acc + bf[c]
    sig = np.float32(1.0) / (np.float32(1.0) + np.exp(-acc))
    return acc * sig


def emulate(conv, xbc, conv_w, conv_b, dt1, a, d, state, d_inner, ngroups,
            n):
    """csrc/ssm_scan.cu's arithmetic, block by block, under the plan."""
    f = np.float32
    b, win, cd = conv.shape
    h = a.shape[0]
    p = d_inner // h
    plan = ssm_decode_plan(b, h, p, n)
    groups, rows, lanes = plan["groups"], plan["rows"], plan["lanes"]
    convf, xbcf = conv.astype(f), xbc.astype(f)
    wf, bf = conv_w.astype(f), conv_b.astype(f)
    y = np.full((b, d_inner), np.nan, f)
    new_state = np.full(state.shape, np.nan, f)
    new_conv = np.zeros_like(conv)
    written = np.zeros((b, win, cd), np.int64)
    rest = cd - d_inner
    for bi in range(b):
        bm = _silu_conv(convf, xbcf, wf, bf, bi, d_inner + np.arange(n))
        cm = _silu_conv(convf, xbcf, wf, bf, bi,
                        d_inner + ngroups * n + np.arange(n))
        for bx in range(plan["grid"][0]):
            hh, p0 = bx // groups, (bx % groups) * rows
            prow = np.arange(p0, min(p0 + rows, p))
            xc = hh * p + prow
            xs = _silu_conv(convf, xbcf, wf, bf, bi, xc)
            # the block's x channels of the rolled window
            rolled = np.concatenate([conv[bi, 1:], xbc[bi]], axis=0)
            new_conv[bi][:, xc] = rolled[:, xc]
            written[bi][:, xc] += 1
            dt, dsk = f(dt1[bi, hh]), f(d[hh])
            da = np.exp(dt * f(a[hh]))
            st = state[bi, hh, prow] * da + (dt * xs)[:, None] * bm[None, :]
            new_state[bi, hh, prow] = st
            prod = st * cm[None, :]
            acc = np.zeros((len(prow), lanes), f)
            for k0 in range(0, n, lanes):
                m = min(lanes, n - k0)
                acc[:, :m] = acc[:, :m] + prod[:, k0:k0 + m]
            off = lanes // 2
            while off:
                acc = acc + acc[:, np.arange(lanes) ^ off]
                off //= 2
            y[bi, xc] = acc[:, 0] + dsk * xs
        # the B/C channels' rolled window: block 0 of the slot row
        bc = d_inner + np.arange(rest)
        rolled = np.concatenate([conv[bi, 1:], xbc[bi]], axis=0)
        new_conv[bi][:, bc] = rolled[:, bc]
        written[bi][:, bc] += 1
    assert (written == 1).all()
    return y, new_conv, new_state


def _inputs(b, h, p, n, seed, win=3, g=1):
    rng = np.random.default_rng(seed)
    d_inner = h * p
    cd = d_inner + 2 * g * n
    r = lambda *sh: rng.normal(size=sh).astype(np.float32)  # noqa: E731
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, h))).astype(
        np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    return ((r(b, win, cd), r(b, 1, cd), 0.2 * r(win + 1, cd), 0.1 * r(cd),
             dt, a, r(h), r(b, h, p, n)), (d_inner, g, n))


def _bf16(x):
    """Round float32 numpy values to bf16 (kept as float32 values)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("shape", ["reduced", "n40", "n8"])
@pytest.mark.parametrize("window", ["float32", "bfloat16"])
def test_emulation_matches_jax_kernel_and_oracle(shape, window):
    b, h, p, n = SHAPES[shape]
    args, dims = _inputs(b, h, p, n, 7)
    conv, xbc = args[:2]
    if window == "bfloat16":
        conv, xbc = _bf16(conv), _bf16(xbc)
    y, new_conv, new_state = emulate(conv, xbc, *args[2:], *dims)
    jdt = jnp.dtype(window)
    jargs = (jnp.asarray(conv).astype(jdt), jnp.asarray(xbc).astype(jdt),
             *map(jnp.asarray, args[2:]))
    for want in (jax_ssm_decode_step(*jargs, *dims, interpret=True),
                 ssm_decode_step_ref(*jargs, *dims)):
        wy, wconv, wstate = (np.asarray(w.astype(jnp.float32)) for w in want)
        np.testing.assert_array_equal(new_conv, wconv)
        np.testing.assert_allclose(y, wy, **TOL)
        np.testing.assert_allclose(new_state, wstate, **TOL)


@pytest.mark.parametrize("shape", ["cell_e_b3", "zamba2_7b"])
def test_emulation_matches_plain_at_served_widths(shape):
    """At mamba2-130m's and zamba2-7b's widths, against the port's plain
    version (the card's yardstick), with a bf16 window."""
    b, h, p, n = SHAPES[shape]
    args, dims = _inputs(b, h, p, n, 8)
    conv, xbc = _bf16(args[0]), _bf16(args[1])
    y, new_conv, new_state = emulate(conv, xbc, *args[2:], *dims)
    targs = [torch.from_numpy(x) for x in (conv, xbc) + args[2:]]
    targs[0], targs[1] = targs[0].bfloat16(), targs[1].bfloat16()
    py, pconv, pstate = ssm_decode_step_plain(*targs, *dims)
    np.testing.assert_array_equal(new_conv, pconv.float().numpy())
    np.testing.assert_allclose(y, py.numpy(), **TOL)
    np.testing.assert_allclose(new_state, pstate.numpy(), **TOL)


# --------------------------------------------- conv weights, widened

@pytest.mark.parametrize("shape", ["reduced", "n40"])
def test_wrapper_widens_conv_weights(shape):
    """A bf16 window with bf16 conv_w / conv_b: the wrapper's CPU path
    equals its float32 widening exactly and the Pallas kernel (which widens
    inside) within the tolerance; the window exact."""
    b, h, p, n = SHAPES[shape]
    args, dims = _inputs(b, h, p, n, 9)
    t = [torch.from_numpy(x) for x in args]
    t[0], t[1], t[2], t[3] = (x.bfloat16() for x in t[:4])
    got = ssm_decode_step(*t, *dims)
    wide = ssm_decode_step(*t[:2], t[2].float(), t[3].float(), *t[4:], *dims)
    assert got[1].dtype == torch.bfloat16
    for g, w in zip(got, wide):
        assert torch.equal(g, w)
    jargs = (*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
               for x in t[:4]), *map(jnp.asarray, args[4:]))
    wy, wconv, wstate = jax_ssm_decode_step(*jargs, *dims, interpret=True)
    np.testing.assert_array_equal(got[1].float().numpy(),
                                  np.asarray(wconv.astype(jnp.float32)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(wstate), **TOL)
    # in place, as the serving path calls it
    st = t[7].clone()
    y2, _, st2 = ssm_decode_step(*t[:7], st, *dims, state_out=st)
    assert st2 is st and torch.equal(st, got[2]) and torch.equal(y2, got[0])
