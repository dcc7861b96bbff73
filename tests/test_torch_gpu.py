"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the reduced model's greedy tokens on the card against the CPU.

Every test here needs a CUDA card and skips elsewhere; the file imports
nothing of JAX, so it runs on the card as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerances: the CIM kernel's integer part (sigma = 0) is exact; with
noise, 1e-6 * tiles * max|y| + 1e-5 * sigma (Box-Muller's logf/cosf
ulps). Attention on a bf16 cache or with bf16 queries writes bf16 and
rounds p to bf16 before p @ V as the reference kernel does (against the
running max of a split's own keys): 2^-6 of the output's scale, or of
each query head's row max in every dtype combination at head dims 64,
96, 112 and 128. The fused layer against its plain version on the kernel's
activation scales: each output row within 2^-10 of its max |value| (a
quantized activation that float order puts in the next bucket moves it by
less), each attention-output row within 2^-12, the written f32 cache rows
within 1e-6 relative, int8 codes equal or one apart. The mamba2 decode
step against its plain version: the new conv window bit for bit; every
state row (one (slot, head, p) over N) and every y row (one (slot, head)
over P) within 1e-5 of its max |value|, at the reduced and the served widths
(mamba2-130m, zamba2-7b's mamba layers). The MLA latent-cache decode kernel
against its plain version: every output row (one (slot, head) over the
latent width) within 1e-5 of its max |value| in f32 and 2^-7 in bf16 (one
bf16 rounding of an output); lens == 0 rows exactly zero. The int8 CIM
kernel against its plain version: exact without noise, within rtol 5e-6
and atol 2e-3 * scale with noise (the JAX package's slack); the
straight-through ops.cim_matmul's gradients equal the f32 dequantized
products within rtol 1e-6. The MHA flash kernel against its plain version
(same blocks, same roundings): f32 within 2e-5 + 2e-5 |ref|, bf16 every
output row within 2^-7 of its max |value| (one output rounding).

The engine's CUDA graphs (``fused_step``): replayed and per-call serving
give equal tokens and equal kernel launch counts, exactly, for the dense
and ssm families in off and sim mode, bf16 and f32, both caches and the
fused layer; a config past the fused layer's reach serves unfused with the
unfused tokens (C10); the whole-prompt path and ``LoopEngine`` give the
CPU's tokens; a replay that raises falls back visibly, a capture that
fails raises. A laddered engine (levels that change between admissions)
replays as it runs per call and gives the CPU's tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import cim, quant, sac
from repro_torch.core.deploy import init_params
from repro_torch.kernels import ops
from repro_torch.kernels.cim_matmul import (cim_int8_plan,
                                            cim_matmul_fused,
                                            cim_matmul_fused_plain,
                                            cim_matmul_int8,
                                            cim_matmul_int8_plain)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  decode_plan)
from repro_torch.kernels.flash_attention import (MHA_BLOCK_K, MHA_BLOCK_Q,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 flash_mha_plan,
                                                 flash_gqa_attention,
                                                 flash_gqa_plain,
                                                 flash_gqa_plan)
from repro_torch.core import prng
from repro_torch.core.deploy import deploy
from repro_torch.kernels import fused_step
from repro_torch.kernels.fused_step import (fused_dense_layer,
                                            fused_dense_layer_plain)
from repro_torch.kernels.mla_decode import (mla_decode_attention,
                                            mla_decode_plan,
                                            mla_decode_attention_plain)
from repro_torch.kernels.ssm_scan import (ssm_decode_step,
                                          ssm_decode_step_plain)
from repro_torch.models import transformer as tf
from repro_torch.models.attention import _kv_quant
from repro_torch.models.layers import Ctx
from repro_torch.serving import engine
from repro_torch.serving.engine import (Engine, LoopEngine, Request,
                                        RequestError)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cim_fused_check(dev, m, k, n, seed=0, sigma=None):
    """The fused CIM kernel against its plain version on a random bf16
    input: (integer part equal, noisy max error, tolerance); ``sigma``
    defaults to the paper_sac MLP figure at this K."""
    g = torch.Generator(device=dev).manual_seed(m + seed)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    wq = torch.randint(-31, 32, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(6)
    qp = torch.stack([xs, torch.ones_like(xs)])
    exact = torch.equal(cim_matmul_fused(x, wq, qp, None, 0.0, 6),
                        cim_matmul_fused_plain(x, wq, qp, None, 0.0, 6))
    if sigma is None:
        sigma = cim.output_noise_std_int_per_tile(sac.paper_sac().mlp, k)
    yk = cim_matmul_fused(x, wq, qp, (5, 6), sigma, 6)
    yp = cim_matmul_fused_plain(x, wq, qp, (5, 6), sigma, 6)
    tol = 1e-6 * -(-k // 1024) * yp.abs().max().item() + 1e-5 * sigma
    return exact, (yk - yp).abs().max().item(), tol


# qwen2-0.5b, mamba2-130m (in_proj 768 x 3352, out_proj 1536 x 768) and
# deepseek-v2 (dq, dkv, uq, o, the shared expert's down) shapes, decode
# (split-K GEMV) and prefill (tensor-core tile) row counts, ragged edges
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 32, 33])
@pytest.mark.parametrize("k,n", [(896, 128), (896, 4864), (4864, 896),
                                 (768, 3352), (1536, 768), (5120, 1536),
                                 (5120, 576), (1536, 24576), (16384, 5120),
                                 (3072, 5120), (1000, 4), (1000, 3352)])
def test_cim_kernel_matches_plain(cuda, m, k, n):
    exact, err, tol = _cim_fused_check(cuda, m, k, n)
    assert exact
    assert err <= tol


@pytest.mark.parametrize("flag", ["-DCIM_DROP_SPLIT", "-DCIM_TILE0_NOISE"])
def test_cim_kernel_check_catches_wrong_builds(cuda, monkeypatch, tmp_path,
                                               flag):
    """A build whose merge drops each tile's last split fails the exact
    integer check; one that gives every tile's sum the first tile's noise
    fails the noisy tolerance; on both bodies (M 4 and 32). The
    noise check runs at sigma = 100 LSB: at the paper_sac figure the noise
    is about 1e-7 of max|y|, below the tolerance's 1e-6 * tiles * max|y|
    term; the right build passes at that sigma too."""
    from repro_torch.kernels import _build
    for m in (4, 32):
        exact, err, tol = _cim_fused_check(cuda, m, 4864, 896, sigma=100.0)
        assert exact and err <= tol
    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + [flag])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIB", None)
    for m in (4, 32):
        exact, err, tol = _cim_fused_check(cuda, m, 4864, 896, sigma=100.0)
        if flag == "-DCIM_DROP_SPLIT":
            assert not exact
        else:
            assert exact and err > tol


@pytest.mark.parametrize("int8", [False, True])
def test_attention_kernels_match_plain(cuda, int8):
    b, t, h, kv, d = 4, 320, 14, 2, 64
    g = torch.Generator(device=cuda).manual_seed(int(int8))
    kf = torch.randn((b, t, kv, d), generator=g, device=cuda)
    vf = torch.randn((b, t, kv, d), generator=g, device=cuda)
    if int8:
        (kc, ks), (vc, vs) = _kv_quant(kf), _kv_quant(vf)
    else:
        kc, vc, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
    q = torch.randn((b, h, d), generator=g, device=cuda).bfloat16()
    lens = torch.tensor([0, 1, 77, t], dtype=torch.int32, device=cuda)
    a = decode_attention(q, kc, vc, lens, ks, vs).float()
    p = decode_attention_plain(q, kc, vc, lens, ks, vs).float()
    assert (a - p).abs().max().item() <= 2 ** -6 * p.abs().max().item()
    assert a[0].abs().max().item() == 0.0
    qf = torch.randn((1, 32, h, d), generator=g, device=cuda).bfloat16()
    one = [None if x is None else x[:1] for x in (ks, vs)]
    for start in (0, 32, 256):
        st = torch.tensor([start], dtype=torch.int32, device=cuda)
        a, counts = flash_gqa_attention(qf, kc[:1], vc[:1], st, *one,
                                        return_block_counts=True)
        p = flash_gqa_plain(qf, kc[:1], vc[:1], st, *one).float()
        assert (a.float() - p).abs().max().item() <= \
            2 ** -6 * p.abs().max().item()
        assert counts[0].tolist() == [_gqa_counts(qf, start)] * kv


def _gqa_counts(q, start, t=320):
    """flash_gqa's block counts in closed form from the wrapper's plan:
    q block i visits the key blocks up to start + min((i + 1) bq, S),
    within the written prefix min(T, start + S)."""
    b, s, h, d = q.shape
    plan = flash_gqa_plan(b, s, t, h, 2, d, q.dtype == torch.bfloat16)
    bq, bk, end = plan["block_q"], plan["block_k"], min(t, start + s)
    return [-(-min(start + min((i + 1) * bq, s), end) // bk)
            for i in range(plan["n_q"])]


@pytest.mark.parametrize("qdt,kvdt", [("f32", "f32"), ("f32", "int8"),
                                      ("bf16", "bf16"), ("bf16", "int8")])
@pytest.mark.parametrize("d,g", [(64, 7), (128, 1), (128, 2), (128, 4),
                                 (128, 8), (96, 1), (96, 4), (112, 1)])
def test_gqa_kernels_match_plain_all_dtypes(cuda, d, g, qdt, kvdt):
    """The split-key decode and flash kernels against their plain versions
    in every dtype combination they take, at head dims 64, 128 (G 1 is
    olmoe-1b-7b's), 96 (phi3)
    and 112 (zamba2-7b, whose key rows span a lane count that does not
    divide a warp): each
    query head's row within 2^-6 of its max |value|, lens == 0 rows zero,
    decode lengths on the split edges, flash block counts in closed form.
    With f32 queries the flash kernel is also held at the f32 limit, 2e-5
    + 2e-5 |ref| per element, at S 1, 32 and 33."""
    b, t, kv = 4, 320, 2
    h = g * kv
    gen = torch.Generator(device=cuda).manual_seed(d + g)
    kf = torch.randn((b, t, kv, d), generator=gen, device=cuda)
    vf = torch.randn((b, t, kv, d), generator=gen, device=cuda)
    if kvdt == "int8":
        (kc, ks), (vc, vs) = _kv_quant(kf), _kv_quant(vf)
    else:
        dt = torch.float32 if kvdt == "f32" else torch.bfloat16
        kc, vc, ks, vs = kf.to(dt), vf.to(dt), None, None
    qd = torch.float32 if qdt == "f32" else torch.bfloat16
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(qd)
    sp = decode_plan(b, t, kv, d)["split"]
    for lens in ([0, 1, sp - 1, t], [sp + 1, 2 * sp, 137, 95]):
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        decode_attention.launches = 0
        a = decode_attention(q, kc, vc, ln, ks, vs)
        assert decode_attention.launches == 1 and a.dtype == qd
        p = decode_attention_plain(q, kc, vc, ln, ks, vs).float()
        a = a.float()
        assert ((a - p).abs() <= 2 ** -6 * p.abs().amax(-1, keepdim=True)
                ).all()
        for i, n in enumerate(lens):
            if n == 0:
                assert a[i].abs().max().item() == 0.0
    one = [None if x is None else x[:1] for x in (kc, vc, ks, vs)]
    for s in ((1, 32, 33) if qdt == "f32" else (32,)):
        qf = torch.randn((1, s, h, d), generator=gen, device=cuda).to(qd)
        for start in (0, 128, 300):
            st = torch.tensor([start], dtype=torch.int32, device=cuda)
            a, counts = flash_gqa_attention(qf, one[0], one[1], st, one[2],
                                            one[3], return_block_counts=True)
            p = flash_gqa_plain(qf, one[0], one[1], st, one[2],
                                one[3]).float()
            a = a.float()
            assert ((a - p).abs() <= 2 ** -6 * p.abs().amax(-1, keepdim=True)
                    ).all()
            if qdt == "f32":
                assert ((a - p).abs() <= 2e-5 + 2e-5 * p.abs()).all()
            assert counts[0].tolist() == [_gqa_counts(qf, start)] * kv


def test_reduced_model_tokens_card_equal_cpu(cuda):
    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
    outs = [Engine(cfg, params, max_slots=2, max_len=128, attn_impl="kernel",
                   device=dev).generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
        for dev in (cuda, "cpu")]
    assert outs[0] == outs[1]


OLD_LENS = (0, 5, 60, 100)
LENS_BY_ROWS = {1: (60,), 4: OLD_LENS, 8: OLD_LENS + (127, 31, 32, 33)}


def _fused_case(dev, mode, int8, lens=OLD_LENS, hd=64, kv=2):
    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, kv_cache_int8=int8, head_dim=hd,
                              n_kv_heads=kv, cim=dataclasses.replace(
                                  base.cim, mode=mode, use_kernel=True))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(2), dev)
    if mode == "sim":
        params = deploy(cfg, params)
    layer = tf._index(params["blocks"], 1)
    g = torch.Generator(device=dev).manual_seed(3)
    b, t, kv, hd = len(lens), 128, cfg.n_kv_heads, cfg.hd
    x = torch.randn((b, 1, cfg.d_model), generator=g, device=dev)
    kf = torch.randn((b, t, kv, hd), generator=g, device=dev)
    vf = torch.randn((b, t, kv, hd), generator=g, device=dev)
    if int8:
        (kq, ks), (vq, vs) = _kv_quant(kf), _kv_quant(vf)
        cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    else:
        cache = {"k": kf, "v": vf}
    cache["len"] = torch.tensor(lens, dtype=torch.int32, device=dev)
    kc, kp = {k: v.clone() for k, v in cache.items()}, {}
    ko, _ = fused_dense_layer(Ctx.make(cfg, prng.PRNGKey(4), mode=mode),
                              layer, x, kc, probe=kp)
    torch.cuda.synchronize()

    def plain():
        pc, pp = {k: v.clone() for k, v in cache.items()}, {}
        po, _ = fused_dense_layer_plain(
            Ctx.make(cfg, prng.PRNGKey(4), mode=mode), layer, x, pc,
            scales=kp["scales"], probe=pp)
        return po, pc, pp
    return (ko, kc, kp), plain


def _rows_off(a, b, tol):
    return ((a - b).abs() > tol * b.abs().amax(-1, keepdim=True)).any(-1)


def _written(cache, name, lens=OLD_LENS):
    at = torch.arange(len(lens), device=cache[name].device)
    pos = torch.tensor(lens, device=cache[name].device)
    return cache[name][at, pos].float()


def _fused_rows_hold(case, int8, lens, hd):
    (ko, kc, kp), plain = case
    po, pc, pp = plain()
    assert not _rows_off(ko[:, 0], po[:, 0], 2 ** -10).any()
    b = ko.shape[0]
    assert not _rows_off(kp["attn"].view(b, -1, hd),
                         pp["attn"].view(b, -1, hd), 2 ** -12).any()
    assert torch.equal(kc["len"], pc["len"])
    for name in ("k", "v"):
        a, r = _written(kc, name, lens), _written(pc, name, lens)
        if int8:
            assert (a - r).abs().max().item() <= 1
            assert not _rows_off(_written(kc, name + "s", lens),
                                 _written(pc, name + "s", lens), 1e-6).any()
        else:
            assert not _rows_off(a, r, 1e-6).any()


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("mode", ["off", "sim"])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_layer_kernel_matches_plain(cuda, mode, int8, rows):
    lens = LENS_BY_ROWS[rows]
    _fused_rows_hold(_fused_case(cuda, mode, int8, lens), int8, lens, 64)


@pytest.mark.parametrize("hd,kv", [(96, 4), (112, 4), (128, 2)])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_layer_kernel_matches_plain_wide_heads(cuda, int8, hd, kv):
    """Head dims 96 and 112 (G 1: a q/k/v unit on the 128-column span,
    its lanes past the head idle; the attention tiles loaded in bounded
    rounds) and 128 (G 2), sim mode, four rows."""
    case = _fused_case(cuda, "sim", int8, OLD_LENS, hd=hd, kv=kv)
    _fused_rows_hold(case, int8, OLD_LENS, hd)


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_layer_tolerance_catches_wrong_variants(cuda, monkeypatch,
                                                      int8, rows):
    """Attention without the current token fails the attention check in
    every row; k and v noise seeds swapped fail the cache-row check in
    every written row."""
    lens = LENS_BY_ROWS[rows]
    (ko, kc, kp), plain = _fused_case(cuda, "sim", int8, lens)
    attend, layer_cls = (fused_step.decode_attention_plain,
                         fused_step._Layer)
    monkeypatch.setattr(fused_step, "decode_attention_plain",
                        lambda q, k, v, lens, ks=None, vs=None:
                        attend(q, k, v, lens - 1, ks, vs))
    _, _, pp = plain()
    b = ko.shape[0]
    assert _rows_off(kp["attn"].view(b, -1, 64), pp["attn"].view(b, -1, 64),
                     2 ** -12).all()
    monkeypatch.setattr(fused_step, "decode_attention_plain", attend)

    class Swapped(layer_cls):
        def __init__(self, ctx, p):
            super().__init__(ctx, p)
            self.seeds[1], self.seeds[2] = self.seeds[2], self.seeds[1]

    monkeypatch.setattr(fused_step, "_Layer", Swapped)
    _, pc, _ = plain()
    for name in ("k", "v"):
        a, r = _written(kc, name, lens), _written(pc, name, lens)
        if int8:
            assert ((a - r).abs() > 1).any(-1).all()
        else:
            assert _rows_off(a, r, 1e-6).all()


def test_fused_engine_tokens_equal_unfused_on_card(cuda):
    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
    fused_dense_layer.launches = 0
    outs = [Engine(cfg, params, max_slots=2, max_len=128, attn_impl="kernel",
                   fuse_layer=fuse, device=cuda).generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
        for fuse in (True, False)]
    assert fused_dense_layer.launches > 0
    assert outs[0] == outs[1]


def _ssm_case(dev, window_dtype):
    """Reduced mamba2-130m shapes (H = 16, P = 32, N = 16, conv_dim 544),
    B = 4, a random window and f32 state, ragged dt log-uniform in
    [1e-3, 1e-1] (mamba2's dt range: every row keeps part of its state)."""
    s = get_config("mamba2-130m").reduced().ssm
    b, d_inner, n, g = 4, 512, s.d_state, s.ngroups
    h, win, cd = d_inner // s.headdim, s.conv_width - 1, 512 + 2 * 16
    gen = torch.Generator(device=dev).manual_seed(9)
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
    conv, xbc = r(b, win, cd).to(window_dtype), r(b, 1, cd).to(window_dtype)
    dt = torch.exp(torch.rand((b, h), generator=gen, device=dev)
                   * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    args = [conv, xbc, 0.2 * r(win + 1, cd), 0.1 * r(cd), dt, a, r(h),
            r(b, h, s.headdim, n)]
    return args, (d_inner, g, n)


def _ssm_rows_off(out, ref, tol=1e-5):
    """(state rows off, y rows off) of out = (y, window, state)."""
    b, h = ref[2].shape[:2]
    return (_rows_off(out[2], ref[2], tol),
            _rows_off(out[0].view(b, h, -1), ref[0].view(b, h, -1), tol))


@pytest.mark.parametrize("window_dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernel_matches_plain(cuda, window_dtype):
    args, dims = _ssm_case(cuda, window_dtype)
    ssm_decode_step.launches = 0
    out = ssm_decode_step(*args, *dims)
    ref = ssm_decode_step_plain(*args, *dims)
    assert ssm_decode_step.launches == 1
    assert out[1].dtype == window_dtype and torch.equal(out[1], ref[1])
    assert not any(m.any() for m in _ssm_rows_off(out, ref))
    st = args[-1].clone()
    y2, _, st2 = ssm_decode_step(*args[:-1], st, *dims, state_out=st)
    assert st2 is st and torch.equal(st, out[2]) and torch.equal(y2, out[0])


def test_ssm_tolerance_catches_wrong_variants(cuda):
    """A step without the decay (A = 0, so exp(dt * A) = 1) and a step on
    the state of the wrong slot fail the check in every state and y row."""
    args, dims = _ssm_case(cuda, torch.bfloat16)
    out = ssm_decode_step(*args, *dims)
    no_decay = list(args)
    no_decay[5] = torch.zeros_like(args[5])
    wrong_slot = list(args)
    wrong_slot[7] = args[7].roll(1, dims=0)
    for variant in (no_decay, wrong_slot):
        ref = ssm_decode_step_plain(*variant, *dims)
        assert all(m.all() for m in _ssm_rows_off(out, ref))


# (B, H, P, N, window dtype, conv_w / conv_b dtype, window rows): mamba2-130m's
# width at B 1 and 3 and with its bf16 conv weights, zamba2-7b's mamba
# layers (d_inner 7168, N 64, conv_dim 7296) with a bf16 and an f32 window,
# and the kernel's other paths: a d_state without a template of its own
# (40: one chunk; 200 with P 7: two chunks and one-channel conv loads) and
# a conv of 6 taps (past the 4 loaded together)
SSM_WIDE = {"mamba2_b1": (1, 24, 64, 128, torch.bfloat16, torch.float32, 3),
            "mamba2_b3": (3, 24, 64, 128, torch.bfloat16, torch.float32, 3),
            "mamba2_bf16_conv_w": (4, 24, 64, 128, torch.bfloat16,
                                   torch.bfloat16, 3),
            "zamba2_bf16": (4, 112, 64, 64, torch.bfloat16, torch.float32, 3),
            "zamba2_f32": (4, 112, 64, 64, torch.float32, torch.float32, 3),
            "generic_n40": (2, 3, 24, 40, torch.float32, torch.float32, 3),
            "generic_n200_p7": (2, 5, 7, 200, torch.bfloat16, torch.bfloat16,
                                3),
            "conv_width_6": (2, 4, 32, 64, torch.bfloat16, torch.float32, 5)}


def _misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned address: the
    kernel takes its one-channel conv loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("case", list(SSM_WIDE))
def test_ssm_kernel_matches_plain_served_widths(cuda, case):
    """The kernel at served widths and on its other paths: the window
    exact, state and y rows within 1e-5 of their max against the plain
    version (fed the conv weights widened to f32), in place equal to out of
    place, one launch a call; bf16 conv weights give exactly what their
    widening gives, and misaligned conv weights (one-channel loads) exactly
    what aligned ones give; the wrong variants (no decay; another slot's
    state) fail every row."""
    b, h, p, n, wdt, cdt, win = SSM_WIDE[case]
    gen = torch.Generator(device=cuda).manual_seed(b * n + h)
    r = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa: E731
    cd = h * p + 2 * n
    dt = torch.exp(torch.rand((b, h), generator=gen, device=cuda)
                   * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    args = [r(b, win, cd).to(wdt), r(b, 1, cd).to(wdt),
            (0.2 * r(win + 1, cd)).to(cdt), (0.1 * r(cd)).to(cdt), dt,
            -torch.linspace(1.0, 16.0, h, device=cuda), r(h), r(b, h, p, n)]
    dims = (h * p, 1, n)
    wide = args[:2] + [args[2].float(), args[3].float()] + args[4:]
    ssm_decode_step.launches = 0
    out = ssm_decode_step(*args, *dims)
    assert ssm_decode_step.launches == 1
    ref = ssm_decode_step_plain(*wide, *dims)
    assert out[1].dtype == wdt and torch.equal(out[1], ref[1])
    assert not any(m.any() for m in _ssm_rows_off(out, ref))
    st = args[-1].clone()
    y2, _, st2 = ssm_decode_step(*args[:-1], st, *dims, state_out=st)
    assert st2 is st and torch.equal(st, out[2]) and torch.equal(y2, out[0])
    assert ssm_decode_step.launches == 2
    if cdt != torch.float32:
        assert all(torch.equal(u, v) for u, v in
                   zip(out, ssm_decode_step(*wide, *dims)))
    odd = args[:2] + [_misaligned(args[2]), _misaligned(args[3])] + args[4:]
    assert all(torch.equal(u, v) for u, v in
               zip(out, ssm_decode_step(*odd, *dims)))
    no_decay, wrong_slot = list(wide), list(wide)
    no_decay[5] = torch.zeros_like(args[5])
    wrong_slot[7] = args[7].roll(1, dims=0) if b > 1 else r(b, h, p, n)
    for variant in (no_decay, wrong_slot):
        off = _ssm_rows_off(out, ssm_decode_step_plain(*variant, *dims))
        assert all(m.all() for m in off)


@pytest.mark.parametrize("mode", ["off", "sim"])
def test_reduced_mamba2_tokens_card_equal_cpu(cuda, mode):
    base = get_config("mamba2-130m").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode=mode, use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 1, 57, 9)]
    ssm_decode_step.launches = 0
    outs = [Engine(cfg, params, max_slots=2, max_len=128, attn_impl="kernel",
                   device=dev).generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
        for dev in (cuda, "cpu")]
    assert ssm_decode_step.launches > 0
    assert outs[0] == outs[1]


MLA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _mla_case(dev, dtype, h, lat, rope, t, lens):
    """Random latent-cache decode operands; N(0, 1) queries and cache give
    scores of std sqrt(3) at scale 1/sqrt(192), spread enough that every
    32-key stretch carries weight."""
    g = torch.Generator(device=dev).manual_seed(h + lat)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (r(len(lens), h, lat), r(len(lens), h, rope),
            r(len(lens), t, lat), r(len(lens), t, rope),
            torch.tensor(lens, dtype=torch.int32, device=dev), 192 ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,lat,rope,t,lens", [
    (128, 512, 64, 512, (301, 138, 96, 212)),     # deepseek-v2
    (128, 512, 64, 512, (0, 512, 1, 33)),
    (4, 64, 16, 128, (0, 128, 5, 70)),            # the reduced model
    (128, 512, 64, 4096, (4096, 1, 0, 2000)),     # many tiles a split
    (16, 96, 16, 320, (0, 320, 33, 32)),          # H 16, L 96, odd R / 16
    (16, 128, 32, 32, (32, 1, 0, 17)),            # one split (one tile)
    (20, 128, 64, 100, (100, 99, 17, 3)),         # head rows past H
])
def test_mla_kernel_matches_plain(cuda, dtype, h, lat, rope, t, lens):
    """Every output row within the dtype's tolerance of the plain version,
    lens == 0 rows exactly zero, at lens that give one split of the key
    tiles and many (bf16: ``mla_decode_plan``)."""
    args = _mla_case(cuda, dtype, h, lat, rope, t, lens)
    plan = mla_decode_plan(len(lens), h, t, lat, dtype)
    if dtype == torch.bfloat16:
        assert (plan["n_split"] == 1) == (t == 32)
    mla_decode_attention.launches = 0
    out = mla_decode_attention(*args)
    ref = mla_decode_attention_plain(*args)
    assert mla_decode_attention.launches == 1 and out.dtype == dtype
    assert not _rows_off(out.float(), ref.float(), MLA_TOL[dtype]).any()
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].abs().max().item()


def test_mla_tolerance_catches_wrong_variants(cuda):
    """The plain version over 32 fewer live keys, and over the cache of
    another batch entry, fail the check in every output row."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _mla_case(cuda, dtype, 128, 512, 64, 512, (301, 138, 96, 212))
        out = mla_decode_attention(*args).float()
        short = list(args)
        short[4] = args[4] - 32
        rolled = list(args)
        rolled[2], rolled[3] = args[2].roll(1, 0), args[3].roll(1, 0)
        for variant in (short, rolled):
            ref = mla_decode_attention_plain(*variant).float()
            assert _rows_off(out, ref, MLA_TOL[dtype]).all()


@pytest.mark.parametrize("mode", ["off", "sim"])
def test_reduced_deepseek_tokens_card_equal_cpu(cuda, mode):
    base = get_config("deepseek-v2-236b").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode=mode, use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 1, 57, 9)]
    mla_decode_attention.launches = 0
    outs = [Engine(cfg, params, max_slots=2, max_len=128, attn_impl="kernel",
                   device=dev).generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
        for dev in (cuda, "cpu")]
    assert mla_decode_attention.launches > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("m,k,n", [(8, 512, 8), (100, 2048, 130),
                                   (1, 1024, 1), (33, 1085, 77),
                                   (64, 896, 128), (256, 4864, 896)])
def test_cim_int8_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                       dtype=torch.int8)
    scale = torch.tensor(0.0125, device=cuda)
    cim_matmul_int8.launches = 0
    assert torch.equal(cim_matmul_int8(xq, wq, None, 0.0, scale),
                       cim_matmul_int8_plain(xq, wq, None, 0.0, scale))
    for seed in (-7, (0x89ABCDEF, 0x01234567)):
        yk = cim_matmul_int8(xq, wq, seed, 2.5, scale)
        yp = cim_matmul_int8_plain(xq, wq, seed, 2.5, scale)
        torch.testing.assert_close(yk, yp, rtol=5e-6, atol=2e-3 * 0.0125)
    assert cim_matmul_int8.launches == 3


@pytest.mark.parametrize("m,k,n,offsets", [
    (100, 1024, 256, (0, 0)),       # aligned, 32-row blocks, M ragged
    (1024, 1280, 896, (0, 0)),      # aligned, 64-row blocks, two tiles
    (1024, 896, 4864, (0, 0)),      # aligned, 128-row blocks with noise,
                                    # 64 without (gate / up)
    (130, 2048 + 16, 272, (0, 0)),  # three macro tiles, ragged last tile
    (64, 1040, 96, (1, 0)),         # K, N multiples of 16, xq unaligned
    (40, 1024, 48, (0, 3)),         # wq unaligned
    (7, 1100, 33, (0, 0)),          # ragged K and N
    (1000, 520, 900, (0, 0)),       # masked, 64-row blocks
    (2048, 100, 4100, (0, 0))])     # masked, 128 / 64-row blocks
def test_cim_int8_kernel_paths_match_plain(cuda, m, k, n, offsets):
    """Both load paths and the three block heights against the plain
    version: exact without noise, within the JAX package's slack with it."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    # contiguous views that start offsets[i] bytes into a fresh buffer
    xb = torch.randint(-127, 128, (m * k + offsets[0],), generator=g,
                       device=cuda, dtype=torch.int8)
    wb = torch.randint(-127, 128, (k * n + offsets[1],), generator=g,
                       device=cuda, dtype=torch.int8)
    xq = xb[offsets[0]:].view(m, k)
    wq = wb[offsets[1]:].view(k, n)
    plan = cim_int8_plan(m, k, n, xq.data_ptr(), wq.data_ptr())
    assert plan["aligned"] == (k % 16 == 0 and n % 16 == 0
                               and offsets == (0, 0))
    scale = torch.tensor(0.0125, device=cuda)
    assert torch.equal(cim_matmul_int8(xq, wq, None, 0.0, scale),
                       cim_matmul_int8_plain(xq, wq, None, 0.0, scale))
    seed = (0x2468ACE0, 0x13579BDF)
    torch.testing.assert_close(cim_matmul_int8(xq, wq, seed, 2.5, scale),
                               cim_matmul_int8_plain(xq, wq, seed, 2.5, scale),
                               rtol=5e-6, atol=2e-3 * 0.0125)


def test_cim_matmul_ste_on_card(cuda):
    spec = sac.paper_sac().mlp
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 96, 1100), generator=g, device=cuda)
    w = torch.randn((1100, 72), generator=g, device=cuda)
    key = prng.PRNGKey(11)
    xc = x.clone().requires_grad_(True)
    wc = w.clone().requires_grad_(True)
    cim_matmul_int8.launches = 0
    y = ops.cim_matmul(xc, wc, spec, key)
    assert cim_matmul_int8.launches == 1
    y_cpu = ops.cim_matmul(x.cpu(), w.cpu(), spec, key)
    scale = (quant.abs_max_scale(x, spec.in_bits)
             * quant.abs_max_scale(w, spec.w_bits)).item()
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=5e-6, atol=2e-3 * scale)
    gy = torch.randn(y.shape, generator=g, device=cuda)
    y.backward(gy)
    assert cim_matmul_int8.launches == 1            # none in backward
    xs = quant.abs_max_scale(x, spec.in_bits)
    ws = quant.abs_max_scale(w, spec.w_bits)
    fq_x = quant.dequantize(quant.quantize(x, xs, spec.in_bits), xs)
    fq_w = quant.dequantize(quant.quantize(w, ws, spec.w_bits), ws)
    g2 = gy.reshape(-1, 72)
    torch.testing.assert_close(xc.grad, (g2 @ fq_w.T).reshape(x.shape),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(wc.grad, fq_x.reshape(-1, 1100).T @ g2,
                               rtol=1e-6, atol=0)


def mha_counts(bh, s, t, d, causal, start, dtype):
    """Closed form of the MHA kernel's block counts (summed over a q
    block's splits): causal query block i visits the key blocks up to its
    frontier, non-causal every block."""
    bq, bk = MHA_BLOCK_Q, MHA_BLOCK_K[dtype]
    n_q = -(-s // bq)
    st = [0] * bh if start is None else start.tolist()
    if not causal:
        return [[-(-t // bk)] * n_q for _ in range(bh)]
    return [[-(-min(st[b] + min((i + 1) * bq, s), t) // bk)
             for i in range(n_q)] for b in range(bh)]


def mha_rows_off(out, ref, dtype):
    """Rows (one query over D) out of tolerance: f32 2e-5 + 2e-5 |ref|,
    bf16 2^-7 of the row's max |ref|."""
    out, ref = out.float(), ref.float()
    if dtype == torch.float32:
        tol = 2e-5 + 2e-5 * ref.abs()
    else:
        tol = 2 ** -7 * ref.abs().amax(-1, keepdim=True)
    return ((out - ref).abs() > tol).any(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,t,d,causal,start", [
    (4, 128, 128, 64, True, None), (2, 200, 200, 64, True, None),
    (3, 128, 384, 128, False, None), (1, 130, 257, 64, True, None),
    (3, 10, 64, 64, True, [0, 7, 20]), (3, 12, 40, 128, True, [33, 5, 0]),
    (5, 65, 65, 64, False, None), (4, 130, 130, 96, True, None),
    (3, 70, 200, 96, False, None), (3, 12, 40, 112, True, [33, 5, 0]),
    (2, 129, 257, 112, False, None)])
def test_flash_mha_kernel_matches_plain(cuda, dtype, bh, s, t, d, causal,
                                        start):
    g = torch.Generator(device=cuda).manual_seed(s + t + d)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((bh, s, d), (bh, t, d), (bh, t, d)))
    st = (None if start is None
          else torch.tensor(start, dtype=torch.int32, device=cuda))
    flash_attention.launches = 0
    out, counts = flash_attention(q, k, v, causal, st,
                                  return_block_counts=True)
    assert flash_attention.launches == 1 and out.dtype == dtype
    ref = flash_attention_plain(q, k, v, causal, st)
    assert not mha_rows_off(out, ref, dtype).any()
    assert counts.tolist() == mha_counts(bh, s, t, d, causal, st, dtype)


@pytest.mark.parametrize("bh,s,t,d,causal,start", [
    (56, 32, 320, 64, True, [0, 96, 160, 288] * 14),  # five splits, starts
    (2, 64, 1000, 128, False, None),     # non-causal T > S, 16 splits
    (3, 200, 77, 64, False, None),       # non-causal T < S, ragged
    (2, 40, 50, 128, True, [30, 5]),     # frontier past T
    (4, 129, 129, 64, True, None)])      # one query past a q block
def test_flash_mha_splits_match_plain(cuda, bh, s, t, d, causal, start):
    """The bf16 body, split over blocks where the grid is small, against
    the plain version (2^-7 of the row max); counts summed over the splits
    equal the closed form."""
    g = torch.Generator(device=cuda).manual_seed(bh + s + t)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16()
               for shape in ((bh, s, d), (bh, t, d), (bh, t, d)))
    st = (None if start is None
          else torch.tensor(start, dtype=torch.int32, device=cuda))
    assert flash_mha_plan(bh, s, t, d, torch.bfloat16)["n_split"] > 1
    flash_attention.launches = 0
    out, counts = flash_attention(q, k, v, causal, st,
                                  return_block_counts=True)
    assert flash_attention.launches == 1
    ref = flash_attention_plain(q, k, v, causal, st)
    assert not mha_rows_off(out, ref, torch.bfloat16).any()
    assert counts.tolist() == mha_counts(bh, s, t, d, causal, st,
                                         torch.bfloat16)


def test_flash_mha_head_dims(cuda):
    q = torch.zeros((2, 8, 80), device=cuda)
    with pytest.raises(ValueError, match="64, 96, 112, 128"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False,
                        start=torch.zeros(2, dtype=torch.int32, device=cuda))


# --------------------------------------------- fused_step: CUDA graphs

def _reduced(arch, mode="sim", dtype="float32", int8=False):
    base = get_config(arch).reduced()
    return dataclasses.replace(base, dtype=dtype, kv_cache_int8=int8,
                               cim=dataclasses.replace(base.cim, mode=mode,
                                                       use_kernel=True))


def _graph_requests(cfg, lens=(40, 1, 57, 9, 20), sampled=2):
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=6, temperature=0.7 if i == sampled else 0.0,
                    rid=f"g{i}") for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch,mode,dtype,int8,fuse", [
    ("qwen2-0.5b", "sim", "bfloat16", False, False),
    ("qwen2-0.5b", "sim", "bfloat16", True, False),
    ("qwen2-0.5b", "off", "float32", False, False),
    ("qwen2-0.5b", "sim", "float32", False, True),
    ("qwen2-0.5b", "sim", "float32", True, True),
    ("qwen2-0.5b", "off", "float32", True, True),
    ("mamba2-130m", "sim", "bfloat16", False, False),
    ("mamba2-130m", "off", "float32", False, False)])
def test_graphed_engine_equals_per_call_on_card(cuda, arch, mode, dtype,
                                                int8, fuse):
    cfg = _reduced(arch, mode, dtype, int8)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for fused in (True, False):
        eng = Engine(cfg, params, max_slots=2, max_len=96, attn_impl="kernel",
                     fuse_layer=fuse, fused_step=fused, record_steps=True,
                     device=cuda)
        for f in engine.COUNTED:           # after the capture's warm-up
            f.launches = 0
        outs = eng.generate(_graph_requests(cfg))
        runs[fused] = (outs, {f.__name__: f.launches for f in engine.COUNTED},
                       eng)
    (go, gc, ge), (eo, ec, ee) = runs[True], runs[False]
    assert go == eo
    assert gc == ec and sum(gc.values()) > 0
    assert (gc["fused_dense_layer"] > 0) == fuse
    assert ge.fused_ok and ge.fallbacks == 0
    assert all(e["graph"] for e in ge.step_log)
    assert all(e["replays"] == 1 for e in ge.step_log
               if e["decode"] and not e["chunks"])
    assert ge.replay_count == ge.launch_count == ee.launch_count
    assert ee.replay_count == 0


def test_fused_layer_past_its_reach_serves_unfused(cuda):
    """C10: nine slots are past the fused kernel's eight rows; the step
    serves unfused with the unfused tokens, graphed or not."""
    cfg = _reduced("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lens = (30, 5, 17, 9, 12, 1, 25, 8, 14, 20)
    outs = {}
    fused_dense_layer.launches = 0
    for fuse, fused in ((True, True), (True, False), (False, True)):
        outs[fuse, fused] = Engine(
            cfg, params, max_slots=9, max_len=64, attn_impl="kernel",
            fuse_layer=fuse, fused_step=fused, device=cuda).generate(
            _graph_requests(cfg, lens))
    assert fused_dense_layer.launches == 0
    assert outs[True, True] == outs[True, False] == outs[False, True]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
@pytest.mark.parametrize("mode", ["off", "sim"])
def test_whole_prompt_and_loop_engine_card_equal_cpu(cuda, arch, mode):
    cfg = _reduced(arch, mode)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lens = (13, 1, 9, 20)
    for make in (lambda d: Engine(cfg, params, max_slots=2, max_len=64,
                                  chunk_size=0, attn_impl="kernel", device=d),
                 lambda d: LoopEngine(cfg, params, max_slots=2, max_len=64,
                                      attn_impl="kernel", device=d)):
        outs = [make(d).generate(_graph_requests(cfg, lens))
                for d in (cuda, "cpu")]
        assert outs[0] == outs[1]


class _RaisingGraph:
    def replay(self):
        raise RuntimeError("replay failed")


def test_replay_failure_falls_back_and_capture_failure_raises(cuda,
                                                              monkeypatch):
    cfg = _reduced("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(max_slots=2, max_len=96, attn_impl="kernel", device=cuda)
    want = Engine(cfg, params, fused_step=False, **kw).generate(
        _graph_requests(cfg))
    eng = Engine(cfg, params, fused_step=True, **kw)
    eng._graphs["decode"] = _RaisingGraph()
    assert eng.generate(_graph_requests(cfg)) == want
    assert not eng.fused_ok and eng.fallbacks == 1

    def no_capture(self, fn, pool):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(engine._Graph, "__init__", no_capture)
    with pytest.raises(RuntimeError, match="capturing"):
        Engine(cfg, params, fused_step=True, **kw)


class _ReplayThenRaise:
    def __init__(self, graph):
        self.graph = graph

    def replay(self):
        self.graph.replay()
        raise RuntimeError("replay failed after it ran")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_a_replay_that_raises_after_running_is_undone_on_card(cuda, arch):
    """The decode graph replays in full (every row advanced) and then
    raises: the per-call step that follows starts from the caches as they
    were before it, so the tokens are those of an engine that never
    replayed."""
    cfg = _reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(max_slots=2, max_len=96, attn_impl="kernel", device=cuda)
    want = Engine(cfg, params, fused_step=False, **kw).generate(
        _graph_requests(cfg))
    eng = Engine(cfg, params, fused_step=True, **kw)
    eng._graphs["decode"] = _ReplayThenRaise(eng._graphs["decode"])
    assert eng.generate(_graph_requests(cfg)) == want
    assert not eng.fused_ok and eng.fallbacks == 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_decode_failure_at_the_last_layer_card_equals_cpu(cuda, arch,
                                                          monkeypatch):
    """A per-call batch decode that raises at its last layer whenever slot
    1 is active, on the card and on the CPU: the same requests fail and
    the survivors' tokens are equal (the CPU's equal the reference's,
    tests/test_torch_engine_step.py)."""
    cfg = _reduced(arch, "off")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    block = tf._BLOCKS[cfg.family]
    outs = []
    for dev in (cuda, "cpu"):
        eng = Engine(cfg, params, max_slots=2, max_len=96,
                     attn_impl="kernel", fused_step=False, device=dev)
        calls = [0]

        def last_layer_raises(ctx, p, x, positions, cache, eng=eng,
                              calls=calls):
            layer = calls[0] % cfg.n_layers
            calls[0] += 1
            out = block(ctx, p, x, positions, cache)
            if (x.shape[1] == 1 and layer == cfg.n_layers - 1
                    and bool(eng._inputs.act[1])):
                raise RuntimeError("injected")
            return out

        monkeypatch.setitem(tf._BLOCKS, cfg.family, last_layer_raises)
        outs.append(eng.generate(_graph_requests(cfg)))
        monkeypatch.undo()
    assert outs[0] == outs[1]
    assert any(isinstance(o, RequestError) for o in outs[0])
    assert any(isinstance(o, list) for o in outs[0])


# ---------------------------------------------------- the robustness layer

def _robust_drift_kw(every=8):
    from repro_torch.core.calibrate import CalibPolicy
    from repro_torch.core.drift import DriftSpec
    from repro_torch.core.faults import FaultSpec
    return dict(drift=DriftSpec(seed=3, walk_gain_std=0.02,
                                walk_offset_std=0.5, supply_offset_mag=8.0,
                                supply_every=every),
                calib=CalibPolicy(probe_rows=16, probe_chunk=16, probe_k=128,
                                  every_steps=2 * every, canary_every=4),
                fault=FaultSpec(seed=2, col_gain_std=0.01, col_offset_std=0.3,
                                brownout_rate=0.02, adc_stuck_rate=0.002,
                                adc_stuck_code=520))


@pytest.mark.parametrize("m", [1, 4, 32])
def test_cim_kernel_on_stuck_plane_and_retry_spec_matches_plain(cuda, m):
    """Row 1 on a stuck-at plane (rate 1e-3; the card's draw equals the
    CPU's) at qwen2-0.5b's gate shape, at the first read's and the
    re-read's (CB on, 12 votes) sigma: integer part exact, noise within
    the kernel checks' tolerance."""
    from repro_torch.core import quant
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.faults import stuck_bit_plane
    from repro_torch.core.guard import GuardSpec, _retry_spec
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels.cim_matmul import (cim_matmul_fused,
                                                cim_matmul_fused_plain)
    spec = paper_sac().mlp
    g = torch.Generator(device=cuda).manual_seed(m)
    k, n = 896, 4864
    w = torch.randn((k, n), generator=g, device=cuda)
    clean = quant.quantize(w, quant.abs_max_scale(w, 6), 6).to(torch.int8)
    key = (0, 3)
    sp = stuck_bit_plane(clean, 6, 1e-3, key)
    assert torch.equal(sp.cpu(), stuck_bit_plane(clean.cpu(), 6, 1e-3, key))
    assert (sp != clean).any()
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(6)
    qp = torch.stack([xs, torch.ones_like(xs)])
    assert torch.equal(cim_matmul_fused(x, sp, qp, None, 0.0, 6),
                       cim_matmul_fused_plain(x, sp, qp, None, 0.0, 6))
    for s in (spec, _retry_spec(spec, GuardSpec())):
        sigma = output_noise_std_int_per_tile(s, k)
        yk = cim_matmul_fused(x, sp, qp, (11, 12), sigma, 6)
        yp = cim_matmul_fused_plain(x, sp, qp, (11, 12), sigma, 6)
        tol = 1e-6 * yp.abs().max().item() + 1e-5 * sigma
        assert (yk - yp).abs().max().item() <= tol


def test_guarded_engine_card_equals_cpu(cuda):
    """The reduced qwen2 under the guard with a 64-sigma transient on
    slot 1: tokens, statuses, per-layer counts and reports card = CPU."""
    from repro_torch.core.faults import FaultSpec
    cfg = _reduced("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = []
    for dev in (cuda, "cpu"):
        eng = Engine(cfg, params, max_slots=3, max_len=96,
                     attn_impl="kernel", guard=True,
                     fault=FaultSpec(transient_mag=64.0), fault_slots={1},
                     device=dev)
        outs = eng.generate(_graph_requests(cfg, sampled=None))
        got.append((outs, eng.status, eng.guard_trip_counts.tolist(),
                    eng.guard_hard_counts.tolist(), eng.guard_report))
    assert got[0] == got[1]
    assert got[0][4][1]["hard"] > 0
    with pytest.raises(ValueError, match="no guard"):
        Engine(cfg, params, guard=True, fused_step=True, device=cuda)


def test_drift_engine_replayed_equals_per_call_and_cpu(cuda):
    """Drift (a supply step every 8 steps), calibration and runtime faults
    with a brownout: replayed through the graphs (the step and the trims
    read on the card, the brownout keyed by the staged fold table) = per
    call = CPU in tokens and drift events, replayed = per call in launch
    counts."""
    cfg = _reduced("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for name, dev, fused in (("replayed", cuda, True),
                             ("per_call", cuda, False), ("cpu", "cpu", None)):
        eng = Engine(cfg, params, max_slots=2, max_len=96,
                     attn_impl="kernel", fused_step=fused, device=dev,
                     **_robust_drift_kw())
        for f in engine.COUNTED:
            f.launches = 0
        outs = eng.generate(_graph_requests(cfg, sampled=None))
        runs[name] = (outs, {f.__name__: f.launches for f in engine.COUNTED},
                      [(e["kind"], e["step"])
                       for e in eng.take_drift_events()], eng)
    assert runs["replayed"][0] == runs["per_call"][0] == runs["cpu"][0]
    assert runs["replayed"][1] == runs["per_call"][1]
    assert runs["replayed"][2] == runs["per_call"][2] == runs["cpu"][2]
    eng = runs["replayed"][3]
    assert eng.replay_count > 0 and eng.fallbacks == 0
    assert eng.drift_step > 8 and eng.calibrations >= 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_laddered_engine_replayed_equals_per_call_and_cpu(cuda, arch):
    """The load ladder under the graphs: requests at levels 2, 0, 1, 2, 1
    on 2 slots, so a slot's level changes between admissions (the levels
    staged with the seeds, the ladder's draw keyed by the staged 0xD364
    fold table): replayed = per call in tokens and launch counts, and the
    card's tokens = the CPU's; the ladder-free run's tokens differ."""
    cfg = _reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    levels = (2, 0, 1, 2, 1)

    def reqs():
        out = _graph_requests(cfg, sampled=None)
        for r, lvl in zip(out, levels):
            r.degrade_level = lvl
        return out

    runs = {}
    for name, dev, fused, ladder in (
            ("replayed", cuda, True, True), ("per_call", cuda, False, True),
            ("cpu", "cpu", None, True), ("no_ladder", cuda, True, False)):
        eng = Engine(cfg, params, max_slots=2, max_len=96, attn_impl="kernel",
                     fused_step=fused, device=dev,
                     ladder=sac.DegradeLadder() if ladder else None)
        for f in engine.COUNTED:
            f.launches = 0
        outs = eng.generate(reqs())
        runs[name] = (outs, {f.__name__: f.launches for f in engine.COUNTED},
                      eng)
    assert runs["replayed"][0] == runs["per_call"][0] == runs["cpu"][0]
    assert runs["replayed"][1] == runs["per_call"][1]
    eng = runs["replayed"][2]
    assert eng.replay_count > 0 and eng.fallbacks == 0
    assert runs["no_ladder"][0] != runs["replayed"][0]


def test_qat_engine_card_equals_cpu(cuda):
    """``cim_mode="qat"`` (fake-quant plus readout noise under the layer's
    host key, served per call): the reduced qwen2's first 4 greedy tokens
    card = CPU on ``chip_smoke.py``'s ``serve_qat`` requests, on the
    undeployed weights; ``fused_step=True`` raises. qat's float matmuls
    and its batch activation scale sum in another order on the card, so
    an activation exactly on a rounding tie can round the other way (a
    1-token prompt at chunk 16 put one at x / scale = -2.5 on the CPU;
    ROADMAP C2)."""
    cfg = _reduced("qwen2-0.5b", mode="qat")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
    outs = {}
    for dev in (cuda, "cpu"):
        eng = Engine(cfg, params, max_slots=2, max_len=128,
                     attn_impl="kernel", device=dev)
        assert not eng.deployed and not eng.fused_step
        outs[str(dev)] = [o[:4] for o in eng.generate(
            [Request(prompt=p, max_new_tokens=4, rid=f"q{i}")
             for i, p in enumerate(prompts)])]
    assert outs["cuda"] == outs["cpu"]
    with pytest.raises(NotImplementedError, match="qat"):
        Engine(cfg, params, fused_step=True, device=cuda)


def test_sharded_row1_shard_equals_column_slice(cuda):
    """Row 1 (``cim_matmul_fused``, readout noise 0) on each model-axis
    shard of a deployed q and gate plane, resolved by the default rules on
    a (data 1, model 2) mesh, equals the matching column slice of the
    whole plane's output exactly, and its plain version."""
    from repro_torch.distributed.sharding import (VirtualMesh, default_rules,
                                                  local_slice)
    from repro_torch.models.model import param_specs
    cfg = _reduced("qwen2-0.5b")
    plain = deploy(cfg, init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda))
    vm = VirtualMesh.make(data=1, model=2)
    rules, axes = default_rules(vm), param_specs(cfg)[1]
    pol = sac.paper_sac()
    g = torch.Generator(device=cuda).manual_seed(7)
    for block, name, spec in (("attn", "q", pol.attn),
                              ("mlp", "gate", pol.mlp)):
        wq = plain["blocks"][block][name][f"wq{spec.w_bits}"]
        pspec = rules.param_spec(axes["blocks"][block][name]["w"],
                                 tuple(wq.shape))
        assert pspec[-1] == "model"
        x = torch.randn((8, cfg.d_model), generator=g, device=cuda)
        qp = torch.tensor([0.02, 1e-3], device=cuda)
        full = cim_matmul_fused(x, wq[0], qp, (1, 2), 0.0, spec.in_bits)
        n = wq.shape[-1] // 2
        for r in range(2):
            shard = wq[local_slice(pspec, wq.shape, vm,
                                   {"data": 0, "model": r})][0].contiguous()
            y = cim_matmul_fused(x, shard, qp, (1, 2), 0.0, spec.in_bits)
            assert torch.equal(y, full[:, r * n:(r + 1) * n])
            assert torch.equal(y, cim_matmul_fused_plain(
                x, shard, qp, (1, 2), 0.0, spec.in_bits))


# qwen2-0.5b's q and gate planes split over two ranks' columns, o and down
# over two ranks' rows (down's cut at 2432 falls inside macro tile 2), at
# a decode step's and a prefill chunk's rows
@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n,cut", [(896, 896, "col"), (896, 4864, "col"),
                                     (896, 896, "row"), (4864, 896, "row")])
def test_row1_shards_with_offsets_on_card(cuda, m, k, n, cut):
    """A column shard with its noise offsets (``col0``, and ``row0`` for a
    row block) is bit-equal to its slice of the whole plane's launch, noise
    on; the row shards' ``cim_tile_partials`` equal their plain version
    exactly and, summed, ``cim_tile_merge`` is bit-equal to the whole
    launch and within the noise tolerance of its plain version."""
    from repro_torch.kernels.cim_matmul import (cim_tile_merge,
                                                cim_tile_merge_plain,
                                                cim_tile_partials,
                                                cim_tile_partials_plain)
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    wq = torch.randint(-31, 32, (k, n), generator=g, device=cuda,
                       dtype=torch.int8)
    xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(6)
    qp = torch.stack([xs, xs * 0.0125])
    sigma = cim.output_noise_std_int_per_tile(sac.paper_sac().mlp, k)
    seed = (5, 6)
    whole = cim_matmul_fused(x, wq, qp, seed, sigma, 6)
    if cut == "col":
        h = n // 2
        for r in range(2):
            y = cim_matmul_fused(x, wq[:, r * h:(r + 1) * h].contiguous(), qp,
                                 seed, sigma, 6, col0=r * h)
            assert torch.equal(y, whole[:, r * h:(r + 1) * h])
        hm = m // 2
        y = cim_matmul_fused(x[hm:], wq, qp, seed, sigma, 6, row0=hm)
        assert torch.equal(y, whole[hm:])
        return
    h = k // 2
    total = None
    for r in range(2):
        xr, wr = x[:, r * h:(r + 1) * h], wq[r * h:(r + 1) * h]
        part = cim_tile_partials(xr, wr, qp, 6, r * h, k)
        assert torch.equal(part, cim_tile_partials_plain(xr, wr, qp, 6,
                                                         r * h, k))
        total = part if total is None else total + part
    y = cim_tile_merge(total, qp, seed, sigma)
    assert torch.equal(y, whole)
    assert torch.equal(cim_tile_merge(total, qp, None, 0.0),
                       cim_matmul_fused(x, wq, qp, None, 0.0, 6))
    yp = cim_tile_merge_plain(total, qp, seed, sigma)
    tol = 1e-6 * -(-k // 1024) * yp.abs().max().item() + 1e-5 * sigma * \
        float(qp[1])
    assert (y - yp).abs().max().item() <= tol
