"""The port's load ladder against the JAX package on the same inputs:
``core.sac.DegradeLadder`` (validation, ``votes_at``, ``next_level``),
``core.cim.vote_drop_extra_std_int`` (every ``paper_sac`` role, within
1e-12 relative on the same conversion noise, 1e-5 on each side's own),
``models.layers._degrade_noise`` (the normal's Threefry
bits exactly, its values within 3 ulp, level-0 rows bit for bit, the
output within 1e-6 of a row's largest value; keyed by a host key and by a
seed-table row's staged fold alike) and a laddered sim session on the
seed-table path with mixed levels: the port's engine gives the JAX
engine's first 4 greedy tokens (the short sim horizon, ROADMAP C4)."""

import contextlib
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import adc as jadc
from repro.core import cim as jcim
from repro.core import sac as jsac
from repro.models import layers as jlayers
from repro.models.model import build as jbuild
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core import adc, cim, prng, sac
from repro_torch.core.deploy import params_from_jax
from repro_torch.models import layers
from repro_torch.serving.engine import Engine, Request

LEVELS = (0, 1, 2, 0)
OUT_TOL = 1e-6      # laddered rows: times the row's largest |value|
ULP_LIMIT = 3       # the normal's values (ROADMAP C4)
NOISE_REL = 1e-5    # vote_drop_extra_std_int on each side's own Monte-Carlo
                    # conversion noise: an f32 ulp of it (ROADMAP C17),
                    # magnified by the variance difference near full votes
                    # (1.5e-6 at 5 of 6 votes)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError:
        return ("ValueError", None)


@pytest.mark.parametrize("votes", [
    (None, 3, 1), (None,), (None, 5), (None, 6, 4, 2, 1), (), (3, 1),
    (None, 3, 3), (None, 1, 3), (None, 0), (None, 2.0), (None, None)])
def test_ladder_validation_and_levels_equal_jax(votes):
    """The same votes raise in both or in neither; a valid ladder gives
    the same ``n_levels``, ``votes_at`` and ``next_level`` over a grid."""
    got = _outcome(lambda: sac.DegradeLadder(votes=votes))
    ref = _outcome(lambda: jsac.DegradeLadder(votes=votes))
    assert got[0] == ref[0]
    if got[0] != "ok":
        return
    lad, jlad = got[1], ref[1]
    assert lad.n_levels == jlad.n_levels
    for level, full in itertools.product(range(-1, 6), (1, 3, 6, 12)):
        assert lad.votes_at(level, full) == jlad.votes_at(level, full)
    for cur, depth, (hi, lo) in itertools.product(
            range(lad.n_levels), range(0, 9), ((4, 2), (3, 1), (6, 0))):
        assert (lad.next_level(cur, depth, hi, lo)
                == jlad.next_level(cur, depth, hi, lo))


@pytest.mark.parametrize("same_noise", [True, False])
def test_vote_drop_extra_std_equal_jax(same_noise, monkeypatch):
    """Every ``paper_sac`` role's operating point, K at a tile's edges and
    qwen2's widths, every vote count around the full 6 (exactly 0.0 where
    the reference gives 0.0; a count below 1 raises in both). On the
    reference's conversion noise (``same_noise``) within 1e-12 relative:
    the function's own float math. On the port's own within
    ``NOISE_REL``: the conversion noise is a Monte-Carlo std that torch
    and XLA reduce in f32 in other orders, an ulp apart at some vote
    counts (ROADMAP C17)."""
    if same_noise:
        monkeypatch.setattr(adc, "conversion_noise_lsb", lambda spec, cb:
                            jadc.conversion_noise_lsb(jadc.ADCSpec(
                                **dataclasses.asdict(spec)), cb))
    rel = 1e-12 if same_noise else NOISE_REL
    pol, jpol = sac.get_policy("paper_sac"), jsac.get_policy("paper_sac")
    n = 0
    for role in sac.ROLE_CLASS:
        spec, jspec = pol.spec_for_role(role), jpol.spec_for_role(role)
        assert (spec is None) == (jspec is None)
        if spec is None:
            continue
        for k, v in itertools.product((64, 896, 1024, 1025, 4864),
                                      (None, 1, 2, 3, 5, 6, 7)):
            got = cim.vote_drop_extra_std_int(spec, k, v)
            ref = jcim.vote_drop_extra_std_int(jspec, k, v)
            assert (got == 0.0) == (ref == 0.0), (role, k, v)
            assert abs(got - ref) <= rel * abs(ref), (role, k, v, got, ref)
            n += got > 0.0
        for fn, sp in ((cim.vote_drop_extra_std_int, spec),
                       (jcim.vote_drop_extra_std_int, jspec)):
            with (pytest.raises(ValueError) if sp.cb
                  else contextlib.nullcontext()):
                fn(sp, 128, 0)
    assert n > 0


def _noise_case(seed=0, k=896, n=4864):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 1, k)).astype(np.float32)
    y = (rng.normal(size=(4, 1, n)) * 3.0).astype(np.float32)
    xs = np.float32(0.0371)
    ws = np.float32(0.0123)
    return x, y, xs, ws


def _ulps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


def test_degrade_noise_equal_jax():
    """``_degrade_noise`` on one operand at levels [0, 1, 2, 0]: level-0
    rows are the input bit for bit (as the reference's); the others agree
    within ``OUT_TOL`` of the row's largest value, their normal's Threefry
    bits exactly and its values within ``ULP_LIMIT`` ulp; a seed-table row
    carrying the staged ``0xD364`` fold gives the host key's result bit
    for bit."""
    x, y, xs, ws = _noise_case()
    spec = sac.paper_sac().mlp
    jspec = jsac.paper_sac().mlp
    votes = (None, 3, 1)
    jctx = jlayers.Ctx(cfg=None, mode="sim", degrade_levels=votes,
                       degrade_rows=jnp.asarray(LEVELS, jnp.int32))
    jkey = jax.random.PRNGKey(11)
    ref = np.asarray(jlayers._degrade_noise(
        jctx, {"ws6": jnp.asarray(ws)}, jnp.asarray(x), jnp.asarray(y),
        jspec, jkey, jnp.asarray(xs)))
    key = prng.PRNGKey(11)

    def port(k, width=0):
        ctx = layers.Ctx(cfg=None, mode="sim", degrade_levels=votes,
                         degrade_rows=torch.tensor(LEVELS, dtype=torch.int32),
                         seed_width=width)
        return layers._degrade_noise(
            ctx, {"ws6": torch.tensor(ws)}, torch.from_numpy(x),
            torch.from_numpy(y), spec, k, torch.tensor(xs)).numpy()

    got = port(key)
    for r, lvl in enumerate(LEVELS):
        if lvl == 0:
            assert np.array_equal(got[r], y[r]) and np.array_equal(ref[r],
                                                                    y[r])
        else:
            err = np.abs(got[r] - ref[r]).max() / np.abs(ref[r]).max()
            assert err <= OUT_TOL, (r, err)
            assert not np.array_equal(got[r], y[r])
    fk = jax.random.fold_in(jkey, layers.DEGRADE_FOLD)
    assert np.array_equal(
        prng.random_bits(prng.fold_in(key, layers.DEGRADE_FOLD),
                         y.shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(fk, y.shape)))
    normal = prng.normal(prng.fold_in(key, layers.DEGRADE_FOLD), y.shape)
    assert _ulps(normal.numpy(), np.asarray(
        jax.random.normal(fk, y.shape, jnp.float32))).max() <= ULP_LIMIT
    # the same draw from a seed-table row and its staged fold table: one
    # row, and (``seed_width`` 7) row 11 of a 3-layer table, drawn with
    # its column (rows 4, 11 and 18) at once
    words = np.zeros((21, 2), np.uint32)
    words[:, 0] = np.arange(21)
    words[11] = prng.key_words(key)
    table = torch.from_numpy(words.view(np.int32))
    folds = torch.from_numpy(prng.fold_table(table.numpy(),
                                             layers.DEGRADE_FOLD))
    for r, width in ((11, 0), (11, 7)):
        row = prng.SeedRow(table, r, {layers.DEGRADE_FOLD: folds})
        assert np.array_equal(port(row, width), got)
    for width in (0, 7):
        with pytest.raises(ValueError, match="fold"):
            port(prng.SeedRow(table, 11, {0x0FA1: folds}), width)


def test_degrade_noise_static_skips_equal_jax():
    """Where the reference adds nothing (an operating point without CB,
    off mode, no key, a ladder of full votes only), the port returns its
    input itself."""
    x, y, xs, ws = _noise_case(1, 128, 64)
    yt = torch.from_numpy(y)
    pol = sac.paper_sac()
    cases = ((pol.attn, "sim", prng.PRNGKey(1), (None, 3, 1)),
             (pol.mlp, "off", prng.PRNGKey(1), (None, 3, 1)),
             (pol.mlp, "sim", None, (None, 3, 1)),
             (pol.mlp, "sim", prng.PRNGKey(1), (None, 6)))
    for spec, mode, key, votes in cases:
        ctx = layers.Ctx(cfg=None, mode=mode, degrade_levels=votes,
                         degrade_rows=torch.tensor(LEVELS, dtype=torch.int32))
        out = layers._degrade_noise(ctx, {"ws6": torch.tensor(ws)},
                                    torch.from_numpy(x), yt, spec, key,
                                    torch.tensor(xs))
        assert out is yt


def _tiny(get):
    cfg = get("qwen2-0.5b").reduced()
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, d_ff=256, vocab_size=128, n_heads=4,
        n_kv_heads=2, head_dim=32,
        cim=dataclasses.replace(cfg.cim, use_kernel=True))


def _close_host_buffer_race(eng):
    """The JAX engine hands its per-slot numpy buffers (levels, sampling
    keys) to computations that CPU dispatch may run later, and writes them
    in place when a slot is freed or admitted (ROADMAP C8): a laddered
    decode can then read a freed slot's level as 0. Wait for the engine's
    last dispatched step before each such write, as a synchronous
    dispatch would; the reference's code is not changed."""
    for name in ("_free_slot", "_admit"):
        real = getattr(eng, name)

        def synced(*a, _real=real, **k):
            jax.block_until_ready((eng.last_tok, eng.caches))
            return _real(*a, **k)

        setattr(eng, name, synced)


def test_laddered_sim_session_equal_jax():
    """A laddered engine (sim, the CIM kernel path: the ladder's draw reads
    the staged ``0xD364`` fold table) serving requests at levels 0, 1, 2
    and 1, chunked, on 2 slots so that levels change between admissions:
    the port's first 4 greedy tokens of every request equal the JAX
    engine's, and differ from the ladder-free run's somewhere."""
    jcfg, cfg = _tiny(jget), _tiny(get_config)
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 127, n).astype(np.int32)
               for n in (12, 9, 12, 7)]
    lvls = (0, 1, 2, 1)

    def reqs(cls):
        return [cls(prompt=p, max_new_tokens=4, rid=f"l{i}",
                    degrade_level=lv)
                for i, (p, lv) in enumerate(zip(prompts, lvls))]

    kw = dict(max_slots=2, max_len=32, cim_mode="sim", chunk_size=8)
    jeng = JEngine(jcfg, jp, fused_step=False, ladder=jsac.DegradeLadder(),
                   **kw)
    _close_host_buffer_race(jeng)
    ref = jeng.generate(reqs(JRequest))
    eng = Engine(cfg, params, device="cpu", ladder=sac.DegradeLadder(), **kw)
    got = eng.generate(reqs(Request))
    assert layers.DEGRADE_FOLD in eng._folds and eng._width
    assert [o[:4] for o in got] == [o[:4] for o in ref]
    plain = Engine(cfg, params, device="cpu", **kw).generate(reqs(Request))
    assert plain != got
