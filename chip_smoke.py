"""Chip smoke test of the PyTorch/CUDA port (run on a machine with one H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes, checks
greedy-token parity of the reduced model between the card (kernels) and
the CPU (plain versions), serves full-width qwen2-0.5b in CIM sim mode
through the kernels with the bf16 and the int8 KV cache, and times each
kernel against its bound (the CIM kernel per decode step and per 32-row
prefill chunk, beside torch._int_mm, with its split-K launch plans).
Then the per-layer decode megakernel
(``fuse_layer=True``) on float32 qwen2-0.5b: the kernel against its plain
version at full width (with two deliberately wrong plain versions that the
tolerance must catch), full-width serving with both caches and exact
launch counts, a profile of one decode step fused and unfused, fused vs
unfused tokens and logits, and its times. Then the ssm family: the mamba2
selective-scan decode kernel against its plain version at full width
(B 4, 1 and 3, bf16 and f32 windows, bf16 and misaligned conv weights),
at zamba2-7b's mamba width and at a d_state with no template of its own
(with two deliberately wrong inputs that the tolerance must catch),
card-vs-CPU greedy tokens of the reduced mamba2 in off and sim mode,
full-width mamba2-130m serving with exact launch counts, a profile of one
decode step and the kernel's times. Then the moe family with MLA
attention: the latent-cache decode kernel against its plain version at
deepseek-v2 width (with two deliberately wrong inputs that the tolerance
must catch) and the CIM kernel at deepseek-v2's shapes, card-vs-CPU greedy
tokens of the reduced deepseek-v2 in off and sim mode, deepseek-v2-236b at
every published width and 4 of its 60 layers served with exact launch
counts and its peak memory, a profile of one decode step and the kernel's
times (CUDA events) beside one scaled_dot_product_attention call and the
earlier body's time. The f32-query GQA prefill of the float32 cells is
held against its plain version, its block counts against their closed
form, and timed at their chunk shape beside SDPA in f32 and the earlier
body's time. Last, the two
entry-point kernels at qwen2-0.5b width: the int8 CIM kernel against its
plain version at the seven projections (M = 1024) and at ragged shapes
(with a shifted-tile variant that the tolerance must catch), the
straight-through ops.cim_matmul forward and backward with exact launch
counts, MHA flash attention against its plain version at five shapes in
bf16 and f32 with its block counts (and a variant with 32 live keys
dropped that must fail), and both kernels' times (per projection for the
int8 kernel, with and without noise; the bf16 MHA body at both key
tiles). The two GQA kernels
(decode and flash prefill, split over the key axis) are also held against
their plain versions at head dim 128 (G 2, 4, 8) in every dtype
combination, at decode lengths on the split edges and flash starts past
the cache's end, and timed beside scaled_dot_product_attention and their
earlier times. The behavioural sim path (cim.use_kernel=False, what the
serving CLI's --cim sim runs): reduced-model tokens card vs CPU, and
full-width qwen2-0.5b served with no CIM kernel launch. And
Engine(fuse_layer=True) on a bf16 model serves unfused.

The serving cells A-E run the engine's main path, ``fused_step``: the
decode step and each slot's prefill chunk replayed as CUDA graphs. Each
cell's session is served replayed and per call (``graph_vs_eager``):
greedy tokens and every kernel's launch count equal, no capture falling
back, every iteration all replays, one decode replay per pure-decode
step; the profile phase reads a pure decode step both ways (host step
ms, device-busy share, device launches, host dispatches). Float32
qwen2-0.5b with fuse_layer=True at 9 slots, past the fused kernel's 8
rows, serves unfused with the unfused tokens (``fused_layer_reach``); the
whole-prompt path and LoopEngine give the CPU's tokens on the reduced
models (``whole_prompt_loop_parity``). Every phase prints one JSON line;
any failure exits non-zero. The last line is the device record.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 / int8
# tensor-core operations/s; bounds are stated against them
HBM_BPS = 3.35e12
BF16_OPS = 989e12
INT8_OPS = 1979e12
FP32_OPS = 67e12       # float32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def row_check(out, ref):
    """Attention outputs against the plain version, row by row (a row is
    one query head's output vector): each element within 2^-6 times the
    largest |ref| of its row. Returns (max abs err, max err / row scale,
    share of rows out of tolerance); a lens==0 row must match exactly."""
    scale = ref.abs().amax(-1, keepdim=True)
    err = (out - ref).abs()
    bad = (err > 2 ** -6 * scale).any(-1)
    rel = (err / scale.clamp(min=1e-30)).max().item()
    return err.max().item(), rel, bad.float().mean().item()


def wall_ms(fn, reps: int) -> float:
    """Mean ms per ``fn()`` between CUDA events after one warm-up. For a
    few small launches this is the host's enqueue rate, not device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def busy_ms(events, reps: int) -> float:
    """Device-busy ms per repetition: the union of the CUDA kernel and copy
    intervals that torch.profiler recorded."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1e30
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / reps


def device_ms(fn, reps: int) -> float:
    """Device time of ``fn()`` (ms, after one warm-up): what the card spends
    on it, without the host's launch gaps between small kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return busy_ms(prof.events(), reps)


def queued_ms(fn, reps: int) -> float:
    """Device ms per ``fn()`` from CUDA events around ``reps`` calls queued
    behind a spinning kernel: the host enqueues them all while the card
    spins, so the events time the card's work without the host's launch
    gaps, as the profiler does (which dropped kernels from some windows of
    the entry-point phase). ``fn`` must not wait for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Device ms per ``fn()`` from CUDA events around ``reps`` replays of a
    CUDA graph of one call: for a plain version of many small launches,
    whose enqueue the host cannot keep ahead of the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------ phase 1
def phase_device():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    emit("device", smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0, nvcc_s=_build.build_seconds)


def random_plane(g, k, n, spec):
    """A (K, N) int8 plane quantized from N(0, 1) weights at spec.w_bits."""
    import torch
    from repro_torch.core import quant
    w = torch.randn((k, n), generator=g, device="cuda")
    return quant.quantize(w, quant.abs_max_scale(w, spec.w_bits),
                          spec.w_bits).to(torch.int8)


def cim_case(g, m, wq, spec):
    """The CIM kernel against its plain version on an (M, K) bf16 input:
    sigma = 0 gives the integer part, which must match exactly (every tile
    sum is an integer below 2^24 and so is the f32 total); with noise,
    Box-Muller's logf/cosf differ from the CPU's by ulps: tolerance
    1e-6 * tiles * max|y| + 1e-5 * sigma. Returns (max abs err, max err
    over max|y|)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.kernels.cim_matmul import (cim_matmul_fused,
                                                cim_matmul_fused_plain)
    k, n = wq.shape
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(
        spec.in_bits)
    qp = torch.stack([xs, torch.ones_like(xs)])
    ex = cim_matmul_fused(x, wq, qp, None, 0.0, spec.in_bits)
    ep = cim_matmul_fused_plain(x, wq, qp, None, 0.0, spec.in_bits)
    if not torch.equal(ex, ep):
        fail(f"cim_matmul_fused integer part differs at M={m} K={k} N={n} "
             f"bits={spec.in_bits}: {(ex - ep).abs().max().item()}")
    sigma = output_noise_std_int_per_tile(spec, k)
    seed = (0x12345678 + m, 0x9ABCDEF0 + n)
    yk = cim_matmul_fused(x, wq, qp, seed, sigma, spec.in_bits)
    yp = cim_matmul_fused_plain(x, wq, qp, seed, sigma, spec.in_bits)
    err = (yk - yp).abs().max().item()
    tol = 1e-6 * -(-k // 1024) * yp.abs().max().item() + 1e-5 * sigma
    if not err <= tol:
        fail(f"cim_matmul_fused noisy M={m} K={k} N={n}: err {err} > tol "
             f"{tol}")
    return err, err / yp.abs().max().item()


# ------------------------------------------------------------ phase 2
def phase_kernels(cfg):
    """Each kernel against its plain version on the card, main-path shapes."""
    import torch
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                     flash_gqa_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    pol = paper_sac()
    worst = {}
    # kernel 1 at qwen2-0.5b's shapes (cim_case states the tolerance)
    n_cases, rel1 = 0, 0.0
    for spec in (pol.attn, pol.mlp):
        for k in (896, 4864):
            for n in (128, 896, 4864):
                wq = random_plane(g, k, n, spec)
                for m in (1, 4, 8, 32):
                    err, rel = cim_case(g, m, wq, spec)
                    worst["cim_matmul_fused"] = max(
                        worst.get("cim_matmul_fused", 0.0), err)
                    rel1 = max(rel1, rel)
                    n_cases += 1
    emit("kernel_check", kernel="cim_matmul_fused", cases=n_cases,
         integer_part="exact", max_abs_err=worst["cim_matmul_fused"],
         max_rel_err=rel1,
         tol="1e-6*tiles*max|y| + 1e-5*sigma")

    # kernels 2 and 3: bf16 cache (bf16 q) and int8 cache (bf16 q); the
    # kernel rounds p to bf16 before p@V on a bf16 cache as the reference
    # kernel does, and both write bf16: tolerance 2^-6 * max|ref row| per
    # query head (row_check). Its reach is checked on the plain version: a
    # result that drops the last 32 live keys (a skipped tail block) must
    # fail it in every long row.
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = 320
    for int8 in (False, True):
        kc, vc, ks, vs = attn_cache(g, 4, t, kv, hd, "int8" if int8
                                    else "bf16")
        q = torch.randn((4, h, hd), generator=g, device=dev).bfloat16()
        lens = torch.tensor([0, 1, 77, t], dtype=torch.int32, device=dev)
        ok = decode_attention(q, kc, vc, lens, ks, vs).float()
        op = decode_attention_plain(q, kc, vc, lens, ks, vs).float()
        err, rel, bad = row_check(ok, op)
        if bad or ok[0].abs().max().item() != 0.0:
            fail(f"decode_attention int8={int8}: {bad:.3f} of the rows out "
                 f"of tolerance (max err {err}, max err/row {rel}) or "
                 f"lens==0 row nonzero")
        short = decode_attention_plain(q, kc, vc, (lens - 32).clamp(min=1),
                                       ks, vs).float()
        reach = row_check(short[2:], op[2:])[2]
        if reach < 1.0:
            fail(f"decode_attention tolerance too loose: dropping the last "
                 f"32 keys fails only {reach:.3f} of the long rows")
        worst[("decode", int8)] = err
        emit("kernel_check", kernel="decode_attention", int8_cache=int8,
             lens=lens.tolist(), max_abs_err=err, max_err_over_row_max=rel,
             tol="2^-6*max|ref row|", tail_block_dropped_rows_failing=reach)
        qf = torch.randn((1, 32, h, hd), generator=g, device=dev).bfloat16()
        kvs = (kc[:1], vc[:1], None if ks is None else ks[:1],
               None if vs is None else vs[:1])
        rel, reach = 0.0, 1.0
        for start in (0, 32, 96, 256):
            st = torch.tensor([start], dtype=torch.int32, device=dev)
            fk, counts = flash_gqa_attention(qf, kvs[0], kvs[1], st, *kvs[2:],
                                             return_block_counts=True)
            fk = fk.float()
            want = flash_counts(qf, kvs[0], kv, start)
            if counts[0].tolist() != want:
                fail(f"flash_gqa start={start}: block counts "
                     f"{counts[0].tolist()} != {want}")
            fp = flash_gqa_plain(qf, kvs[0], kvs[1], st, *kvs[2:]).float()
            err, r, bad = row_check(fk, fp)
            if bad:
                fail(f"flash_gqa int8={int8} start={start}: {bad:.3f} of "
                     f"the rows out of tolerance (max err {err}, max "
                     f"err/row {r})")
            if start:
                # the frontier 32 keys earlier: each query loses its last
                # 32 visible keys
                short = flash_gqa_plain(qf, kvs[0], kvs[1], st - 32,
                                        *kvs[2:]).float()
                reach = min(reach, row_check(short, fp)[2])
            worst[("flash", int8)] = max(worst.get(("flash", int8), 0), err)
            rel = max(rel, r)
        if reach < 1.0:
            fail(f"flash_gqa tolerance too loose: dropping the last 32 "
                 f"visible keys fails only {reach:.3f} of the rows")
        emit("kernel_check", kernel="flash_gqa", int8_cache=int8,
             starts=[0, 32, 96, 256], max_abs_err=worst[("flash", int8)],
             max_err_over_row_max=rel, tol="2^-6*max|ref row|",
             block_counts="exact", tail_block_dropped_rows_failing=reach)
    attn_shape_checks(g)
    return worst


ATTN_COMBOS = (("f32", "f32"), ("f32", "int8"), ("bf16", "bf16"),
               ("bf16", "int8"))


def attn_cache(g, b, t, kv, d, kvdt):
    """A random (B, T, KV, D) K/V cache in ``kvdt`` (f32, bf16 or int8
    with its per-key scales, quantized as the model quantizes it)."""
    import torch
    from repro_torch.models.attention import _kv_quant
    kf = torch.randn((b, t, kv, d), generator=g, device="cuda")
    vf = torch.randn((b, t, kv, d), generator=g, device="cuda")
    if kvdt == "int8":
        (kc, ks), (vc, vs) = _kv_quant(kf), _kv_quant(vf)
        return kc, vc, ks, vs
    dt = torch.float32 if kvdt == "f32" else torch.bfloat16
    return kf.to(dt), vf.to(dt), None, None


def flash_counts(q, k, kv, start):
    """Closed form of flash_gqa's block counts, from the wrapper's launch
    plan (its blocks: ``block_q`` query positions, ``block_k`` keys): q
    block i visits the key blocks up to its causal frontier start +
    min((i + 1) block_q, S), clipped to the written prefix min(T, start +
    S); the same for every KV head."""
    import torch
    from repro_torch.kernels.flash_attention import flash_gqa_plan
    b, s, h, d = q.shape
    t = k.shape[1]
    plan = flash_gqa_plan(b, s, t, h, kv, d, q.dtype == torch.bfloat16)
    bq, bk = plan["block_q"], plan["block_k"]
    end = min(t, start + s)
    return [[-(-min(start + min((i + 1) * bq, s), end) // bk)
             for i in range(plan["n_q"])]] * kv


def attn_shape_checks(g):
    """The two GQA kernels beyond the main path's bf16 shapes, in every
    dtype combination they take (q f32 or bf16; cache f32, bf16 or int8):
    head dim 128 at G 2, 4 and 8 (internlm2-1.8b, pixtral-12b,
    deepseek-67b), qwen2's head dim 64 at G 7; decode lengths at the split
    edges (1, the split width - 1, + 1, T) on caches whose T is a multiple
    of no block, and a multi-tile split (T 2000); flash starts whose
    frontier lands past T. Tolerance 2^-6 of each query head's row max;
    lens == 0 rows exactly zero; flash block counts equal the closed form."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      decode_plan)
    from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                     flash_gqa_plain)
    dev = torch.device("cuda")
    for d, g_, t in ((64, 7, 2000), (64, 7, 333), (128, 2, 300),
                     (128, 4, 257), (128, 8, 333)):
        kv = 2
        h = g_ * kv
        for qdt, kvdt in ATTN_COMBOS:
            qd = torch.float32 if qdt == "f32" else torch.bfloat16
            kc, vc, ks, vs = attn_cache(g, 4, t, kv, d, kvdt)
            q = torch.randn((4, h, d), generator=g, device=dev).to(qd)
            sp = decode_plan(4, t, kv, d)["split"]
            worst_d = 0.0
            for lens in ([0, 1, sp - 1, t], [sp + 1, 2 * sp, t - 1, 3],
                         [t, 137, 95, 211 % t]):
                ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                ok = decode_attention(q, kc, vc, ln, ks, vs).float()
                op = decode_attention_plain(q, kc, vc, ln, ks, vs).float()
                err, rel, bad = row_check(ok, op)
                zero = all(ok[i].abs().max().item() == 0.0
                           for i, n in enumerate(lens) if n == 0)
                if bad or not zero:
                    fail(f"decode_attention D={d} G={g_} T={t} {qdt}/{kvdt} "
                         f"lens={lens}: {bad:.3f} of the rows out of "
                         f"tolerance (max err/row {rel}) or lens==0 row "
                         f"nonzero")
                worst_d = max(worst_d, rel)
            qf = torch.randn((1, 32, h, d), generator=g, device=dev).to(qd)
            one = [None if x is None else x[:1] for x in (kc, vc, ks, vs)]
            worst_f = 0.0
            for start in (0, 96, t - 32, t - 5):
                st = torch.tensor([start], dtype=torch.int32, device=dev)
                fk, counts = flash_gqa_attention(qf, one[0], one[1], st,
                                                 one[2], one[3],
                                                 return_block_counts=True)
                fp = flash_gqa_plain(qf, one[0], one[1], st, one[2],
                                     one[3]).float()
                err, rel, bad = row_check(fk.float(), fp)
                want = flash_counts(qf, one[0], kv, start)
                if bad or counts[0].tolist() != want:
                    fail(f"flash_gqa D={d} G={g_} T={t} {qdt}/{kvdt} "
                         f"start={start}: {bad:.3f} of the rows out of "
                         f"tolerance (max err/row {rel}) or counts "
                         f"{counts[0].tolist()} != {want}")
                worst_f = max(worst_f, rel)
            emit("kernel_check", kernel="decode_attention+flash_gqa",
                 head_dim=d, group=g_, T=t, q=qdt, cache=kvdt, split=sp,
                 decode_max_err_over_row_max=worst_d,
                 flash_max_err_over_row_max=worst_f, tol="2^-6*max|ref row|",
                 block_counts="closed form")


# ------------------------------------------------------------ phase 3
def phase_parity():
    """Reduced model: greedy tokens on the card through the kernels equal
    the CPU's through the plain versions, with the same parameters."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.serving.engine import Engine, Request

    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(cfg, params, max_slots=2, max_len=128,
                     attn_impl="kernel", device=dev)
        outs[dev] = eng.generate([Request(prompt=p, max_new_tokens=8,
                                          rid=f"p{i}")
                                  for i, p in enumerate(prompts)])
    if outs["cuda"] != outs["cpu"]:
        fail(f"reduced-model tokens differ: cuda {outs['cuda']} vs cpu "
             f"{outs['cpu']}")
    emit("token_parity", requests=len(prompts), new_tokens=8,
         equal=True, tokens=outs["cuda"])


# ------------------------------------------------------------ phase 4
def full_config(int8: bool):
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen2-0.5b")
    return dataclasses.replace(cfg, kv_cache_int8=int8, cim=dataclasses.replace(
        cfg.cim, mode="sim", use_kernel=True))


SESSION_LENS = (60, 300, 137, 95, 211, 64)


def run_session(cfg, params, kernels, fused_step, fuse_layer=False,
                slots=4, lens=SESSION_LENS, new=16):
    """The cells' session (requests of ``lens`` tokens, ``new`` greedy
    tokens each, ``slots`` slots, chunk 32) on one engine; the launch
    counts of ``kernels`` are zeroed after the engine is built (its CUDA
    graph capture and warm-up included) and read after the session.
    Returns (engine, requests, outputs, counts, wall seconds)."""
    import torch
    from repro_torch.serving.engine import Engine, Request

    eng = Engine(cfg, params, max_slots=slots, max_len=320,
                 attn_impl="kernel", fuse_layer=fuse_layer,
                 fused_step=fused_step, record_ttft=True, record_steps=True,
                 device="cuda")
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=new, rid=f"r{i}")
            for i, n in enumerate(lens)]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, outs, {k.__name__: k.launches for k in kernels}, wall


def session_numbers(eng, outs, wall):
    dec = [e["s"] for e in eng.step_log if e["decode"] and not e["chunks"]]
    toks = sum(len(o) for o in outs if isinstance(o, list))
    return {"wall_s": wall, "session_tok_per_s": toks / wall,
            "pure_decode_step_ms_mean": 1e3 * float(np.mean(dec)),
            "ttft_ms_mean": 1e3 * float(np.mean(eng.ttft_s)),
            "ttft_ms_max": 1e3 * float(np.max(eng.ttft_s)),
            "launch_count": eng.launch_count,
            "replay_count": eng.replay_count}


def graph_vs_eager(cell, cfg, params, kernels, fuse_layer=False):
    """A cell's session replayed through the engine's CUDA graphs (the
    main path, ``fused_step=True``) and per call (``fused_step=False``):
    fails unless the greedy tokens and every kernel's launch count are
    equal, the capture held (no fallback), every iteration of the replayed
    run was all replays and every pure-decode step one decode replay.
    Returns the replayed run (engine, requests, outputs, counts, wall)."""
    g = run_session(cfg, params, kernels, True, fuse_layer)
    e = run_session(cfg, params, kernels, False, fuse_layer)
    eng, _, outs, counts, wall = g
    log = eng.step_log
    pure = [x for x in log if x["decode"] and not x["chunks"]]
    problems = []
    if outs != e[2]:
        problems.append("tokens differ")
    if counts != e[3]:
        problems.append(f"launches {counts} vs per-call {e[3]}")
    if not eng.fused_ok or eng.fallbacks:
        problems.append(f"fell back ({eng.fallbacks})")
    if not all(x["graph"] for x in log):
        problems.append("an iteration left the graphs")
    if not pure or any(x["replays"] != 1 for x in pure):
        problems.append("a pure-decode step was not one decode replay")
    if e[0].replay_count:
        problems.append("the per-call run replayed")
    if problems:
        fail(f"graph_vs_eager {cell}: {'; '.join(problems)}")
    emit("graph_vs_eager", cell=cell, arch=cfg.name, dtype=cfg.dtype,
         kv_cache_int8=cfg.kv_cache_int8, fuse_layer=fuse_layer,
         tokens_equal=True, launches_equal=True, launches=counts,
         iterations=len(log), pure_decode_steps=len(pure),
         replayed=session_numbers(eng, outs, wall),
         per_call=session_numbers(e[0], e[2], e[4]))
    return g


def phase_serve(params, int8: bool):
    """Full-width qwen2-0.5b, sim mode, through the kernels, replayed and
    per call (``graph_vs_eager``); the launch counts of the replayed run
    (the main path) are zeroed just before it and read just after."""
    import torch
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    cfg = full_config(int8)
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    eng, reqs, outs, counts, wall = graph_vs_eager("B" if int8 else "A", cfg,
                                                   params, kernels)
    lens = SESSION_LENS
    bad = [o for o in outs if not isinstance(o, list) or len(o) != 16
           or not all(0 <= t < cfg.vocab_size for t in o)]
    if bad:
        fail(f"int8={int8}: failed, short or out-of-range requests: {bad}")
    # the model's output on one chunk: finite logits of the expected shape
    ctx = Ctx.make(cfg, prng.PRNGKey(11), mode="sim")
    tokens = torch.from_numpy(reqs[0].prompt[:32]).cuda()[None]
    logits, _ = tf.forward(eng.params, {"tokens": tokens}, cfg, ctx,
                           tf.init_caches(cfg, 1, 32, "cuda"))
    if (tuple(logits.shape) != (1, 32, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        fail(f"int8={int8}: logits {tuple(logits.shape)} not finite")
    n_chunks = sum(e["chunks"] for e in eng.step_log)
    n_decode = sum(e["decode"] for e in eng.step_log)
    L = cfg.n_layers
    expect = {"cim_matmul_fused": 7 * L * (n_chunks + n_decode),
              "decode_attention": L * n_decode,
              "flash_gqa_attention": L * n_chunks}
    for name, n in expect.items():
        if counts[name] != n or n == 0:
            fail(f"int8={int8}: {name} launched {counts[name]} times, "
                 f"expected {n}")
    dec = [e["s"] for e in eng.step_log if e["decode"] and not e["chunks"]]
    toks = sum(len(o) for o in outs)
    emit("serve_full_width", arch=cfg.name, kv_cache_int8=int8,
         requests=len(reqs), prompt_lens=list(lens), new_tokens=16,
         slots=4, tokens=toks, wall_s=wall, session_tok_per_s=toks / wall,
         chunks=n_chunks, decode_steps=n_decode,
         pure_decode_step_ms_mean=1e3 * float(np.mean(dec)),
         ttft_ms_mean=1e3 * float(np.mean(eng.ttft_s)),
         ttft_ms_max=1e3 * float(np.max(eng.ttft_s)),
         launches=counts, expected=expect, logits_finite=True, replayed=True)
    return counts, n_decode, n_chunks


# CUDA runtime and driver calls that hand the card work: a host dispatch
HOST_DISPATCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                   "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel",
                   "cuLaunchKernelEx", "cuGraphLaunch")


# the CUDA kernels each counted wrapper launches, as the profiler names
# them (whole words of the demangled name)
KERNEL_NAMES = {"cim_matmul_fused": ("cim_gemv", "cim_int8_mma"),
                "cim_matmul_int8": ("cim_int8_mma",),
                "decode_attention": ("decode_kernel",),
                "flash_gqa_attention": ("flash_mma_kernel",
                                        "flash_f32_kernel"),
                "flash_attention": ("flash_mma_kernel", "flash_f32_kernel"),
                "fused_dense_layer": ("fused_layer_kernel",),
                "mla_decode_attention": ("mla_f32_kernel", "mla_mma_kernel"),
                "ssm_decode_step": ("ssm_decode_kernel",)}


def kernels_seen(events, names, reps: int) -> dict:
    """Device kernel events per repetition whose demangled name holds one
    of ``KERNEL_NAMES[name]`` as a whole word, for each wrapper name."""
    import re
    import torch
    pats = {n: re.compile(r"\b(" + "|".join(KERNEL_NAMES[n]) + r")\b")
            for n in names}
    seen = {n: 0 for n in names}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n, pat in pats.items():
                if pat.search(e.name):
                    seen[n] += 1
    return {n: c / reps for n, c in seen.items()}


def phase_profile(params, cfg=None, fuse_layer=False, path=None,
                  fused_step=None):
    """Where a pure decode step's time goes at full width: the device's
    busy share (union of kernel intervals over the host wall clock),
    device time by kernel and the host's dispatches (the runtime calls of
    ``HOST_DISPATCHES`` the profiler saw), from torch.profiler over three
    steps. ``path`` names the sim path in the emitted line; ``fused_step``
    as the engine takes it (None: replayed where the family allows).
    Replayed, the wrappers' counts are the launches the decode graph
    recorded at capture: the profiler's kernel events of each replayed
    step, counted by name, must equal them and each step must be one
    replay (per call, both counts are emitted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving.engine import COUNTED, Engine, Request

    cfg = cfg or full_config(False)
    eng = Engine(cfg, params, max_slots=4, max_len=320, attn_impl="kernel",
                 fuse_layer=fuse_layer, fused_step=fused_step, device="cuda")
    rng = np.random.default_rng(6)
    for i in range(4):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 128),
                           max_new_tokens=32))
    for _ in range(6):          # 4 chunks per prompt, then pure decode
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / 3
    replayed = eng._graphs is not None
    # the profiler loses kernels of its first milliseconds (three
    # fused-layer steps showed 15 + 24 + 24 launches, and 68 of 72 after
    # one step of warm-up; PERF.md §6, PR 21): a 50 ms spin and one step
    # run under it first, and only the events inside the "measured" range
    # are read: on the host its own span, on the card the span of the
    # kernels launched in it (its device twin; the device clock does not
    # line up with the host's to within the last kernels of the warm-up)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(2e9 * 0.05))
        eng.step()
        torch.cuda.synchronize()
        before = {f.__name__: f.launches for f in COUNTED}
        replays = eng.replay_count
        with record_function("measured"):
            t0 = time.perf_counter()
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3
    cuda = torch.autograd.DeviceType.CUDA
    marks = {e.device_type == cuda: e.time_range for e in prof.events()
             if e.name == "measured"}
    events = [e for e in prof.events() if e.name != "measured" and (
        marks[True].start <= e.time_range.start
        and e.time_range.end <= marks[True].end
        if e.device_type == cuda else
        e.time_range.start >= marks[False].start)]
    counted = {f.__name__: (f.launches - before[f.__name__]) / 3
               for f in COUNTED if f.launches != before[f.__name__]}
    seen = kernels_seen(events, counted, 3)
    if replayed:
        recorded = {f.__name__: n
                    for f, n in eng._graphs["decode"].launches.items()}
        if (eng.replay_count - replays != 3 or counted != recorded
                or seen != recorded):
            fail(f"profile {cfg.name} fuse_layer={fuse_layer}: a replayed "
                 f"step ran {seen} kernels by the profiler, counted "
                 f"{counted}, the decode graph recorded {recorded} "
                 f"({eng.replay_count - replays} replays in 3 steps)")
    by_name, n_kernels, n_dispatch = {}, 0, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 3e3)
        elif e.name in HOST_DISPATCHES:
            n_dispatch += 1
    busy = busy_ms(events, 3) if n_kernels else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile_decode_step", arch=cfg.name, n_layers=cfg.n_layers,
         slots=4, dtype=cfg.dtype, **({} if path is None else {"path": path}),
         cache="int8" if cfg.kv_cache_int8 else cfg.dtype,
         fuse_layer=fuse_layer, replayed=replayed,
         counted_launches_per_step=counted,
         profiler_kernels_per_step=seen,
         step_ms=1e3 * plain_wall, profiled_step_ms=1e3 * wall,
         device_busy_ms=busy,
         device_busy_share_of_step=None if busy is None
         else busy / (1e3 * plain_wall),
         device_launches=n_kernels // 3, host_dispatches=n_dispatch / 3,
         top_device_ms=[[n[:80], ms] for n, ms in top])
    return {"step_ms": 1e3 * plain_wall, "device_busy_ms": busy,
            "launches": n_kernels // 3}


# ------------------------------------------------- C10, whole prompt, loop
def phase_fused_reach(params32):
    """C10: float32 qwen2-0.5b at full width with fuse_layer=True and 9
    slots, past the fused kernel's 8 rows: the engine serves unfused
    (replayed), the fused kernel launches 0 times, and the tokens equal
    fuse_layer=False's."""
    from repro_torch.kernels.fused_step import fused_dense_layer

    lens = SESSION_LENS + (40, 120, 33, 77)
    outs = {}
    for fuse in (True, False):
        eng, _, outs[fuse], counts, _ = run_session(
            full_config32(False), params32, (fused_dense_layer,), True,
            fuse_layer=fuse, slots=9, lens=lens, new=8)
        if not eng.fused_ok or not all(e["graph"] for e in eng.step_log):
            fail(f"fused reach: fuse_layer={fuse} left the graphs")
        if counts["fused_dense_layer"]:
            fail(f"fused reach: {counts} fused launches at 9 slots")
    bad = [o for o in outs[True] if not isinstance(o, list) or len(o) != 8]
    if bad or outs[True] != outs[False]:
        fail(f"fused reach: tokens {outs[True]} vs unfused {outs[False]}")
    emit("fused_layer_reach", dtype="float32", slots=9, requests=len(lens),
         fused_launches=0, tokens_equal_unfused=True, replayed=True)


def phase_whole_prompt_loop_parity():
    """The reduced qwen2 and mamba2 in off and sim mode: the whole-prompt
    path (``chunk_size=0``) and ``LoopEngine`` give the CPU's greedy
    tokens on the card."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.serving.engine import Engine, LoopEngine, Request

    rows = []
    for arch in ("qwen2-0.5b", "mamba2-130m"):
        for mode in ("off", "sim"):
            base = get_config(arch).reduced()
            cfg = dataclasses.replace(base, cim=dataclasses.replace(
                base.cim, mode=mode, use_kernel=True))
            params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            rng = np.random.default_rng(3)
            prompts = [rng.integers(0, cfg.vocab_size, n)
                       for n in (40, 1, 57, 9)]
            for name, make in (
                    ("whole_prompt", lambda d: Engine(
                        cfg, params, max_slots=2, max_len=128, chunk_size=0,
                        attn_impl="kernel", device=d)),
                    ("loop", lambda d: LoopEngine(
                        cfg, params, max_slots=2, max_len=128,
                        attn_impl="kernel", device=d))):
                outs = [make(d).generate(
                    [Request(prompt=p, max_new_tokens=6, rid=f"w{i}")
                     for i, p in enumerate(prompts)]) for d in ("cuda", "cpu")]
                if outs[0] != outs[1]:
                    fail(f"{name} {arch} {mode}: card {outs[0]} vs cpu "
                         f"{outs[1]}")
                rows.append([arch, mode, name])
    emit("whole_prompt_loop_parity", equal=True, runs=rows)


# ------------------------------------------------------- behavioural sim
def phase_behavioural_sim(params):
    """Sim mode on the behavioural path (``cim.use_kernel=False``, the
    configs' default and what ``launch.serve --cim sim`` runs): every CIM
    linear is ``core.cim.cim_dense`` (exact integer dot on the card, one
    whole-K ``prng.normal`` draw in eager int64 Threefry ops), no CIM
    kernel. First the reduced qwen2's greedy tokens on the card equal the
    CPU's over 8 tokens; then full-width qwen2-0.5b serves cell A's six
    requests, with cim_matmul_fused launched 0 times and the attention
    kernels at their counts, and a profiled decode step."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.serving.engine import Engine, Request

    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=False))
    rparams = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(cfg, rparams, max_slots=2, max_len=128,
                     attn_impl="kernel", device=dev)
        outs[dev] = eng.generate([Request(prompt=p, max_new_tokens=8,
                                          rid=f"p{i}")
                                  for i, p in enumerate(prompts)])
    if outs["cuda"] != outs["cpu"]:
        fail(f"behavioural sim: reduced-model tokens differ: cuda "
             f"{outs['cuda']} vs cpu {outs['cpu']}")
    emit("behavioural_sim_parity", requests=len(prompts), new_tokens=8,
         equal=True, tokens=outs["cuda"])

    full = dataclasses.replace(full_config(False), cim=dataclasses.replace(
        full_config(False).cim, use_kernel=False))
    eng = Engine(full, params, max_slots=4, max_len=320, attn_impl="kernel",
                 record_ttft=True, record_steps=True, device="cuda")
    rng = np.random.default_rng(5)
    lens = (60, 300, 137, 95, 211, 64)
    reqs = [Request(prompt=rng.integers(0, full.vocab_size, n),
                    max_new_tokens=16, rid=f"r{i}")
            for i, n in enumerate(lens)]
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    bad = [o for o in outs if not isinstance(o, list) or len(o) != 16
           or not all(0 <= t < full.vocab_size for t in o)]
    n_chunks = sum(e["chunks"] for e in eng.step_log)
    n_decode = sum(e["decode"] for e in eng.step_log)
    L = full.n_layers
    if (bad or counts["cim_matmul_fused"] != 0
            or counts["decode_attention"] < L * n_decode
            or counts["flash_gqa_attention"] < L * n_chunks):
        fail(f"behavioural sim full width: bad requests {bad} or launches "
             f"{counts}")
    dec = [e["s"] for e in eng.step_log if e["decode"] and not e["chunks"]]
    toks = sum(len(o) for o in outs)
    prof = phase_profile(params, full, path="behavioural")
    emit("serve_behavioural_full_width", arch=full.name, path="behavioural",
         requests=len(reqs), prompt_lens=list(lens), new_tokens=16, slots=4,
         tokens=toks, wall_s=wall, session_tok_per_s=toks / wall,
         chunks=n_chunks, decode_steps=n_decode,
         pure_decode_step_ms_mean=1e3 * float(np.mean(dec)),
         ttft_ms_mean=1e3 * float(np.mean(eng.ttft_s)),
         launches=counts, device_busy_ms_per_step=prof["device_busy_ms"],
         device_busy_share_of_step=None if prof["device_busy_ms"] is None
         else prof["device_busy_ms"] / prof["step_ms"])


def phase_fuse_fallback():
    """``Engine(fuse_layer=True)`` on a config the fused route never takes
    (the bf16 reduced qwen2) serves unfused, as the reference does: on the
    card, greedy tokens equal fuse_layer=False and the fused layer kernel
    launches 0 times."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.fused_step import fused_dense_layer
    from repro_torch.serving.engine import Engine, Request

    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, dtype="bfloat16", cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (33, 70)]
    outs = {}
    fused_dense_layer.launches = 0
    for fuse in (True, False):
        eng = Engine(cfg, params, max_slots=2, max_len=128,
                     attn_impl="kernel", fuse_layer=fuse, device="cuda")
        outs[fuse] = eng.generate([Request(prompt=p, max_new_tokens=8)
                                   for p in prompts])
    if outs[True] != outs[False] or fused_dense_layer.launches:
        fail(f"fuse_layer fallback: tokens {outs[True]} vs {outs[False]}, "
             f"{fused_dense_layer.launches} fused launches")
    emit("fuse_layer_fallback", dtype=cfg.dtype, equal=True,
         fused_launches=0, tokens=outs[True])


# ------------------------------------------------------------ phase 5
# Device ms of the bodies that later designs replaced, printed beside the
# new times for comparison, not measured here (H100 80GB HBM3 at 700 W): the
# GQA kernels per step / chunk before the split-key kernels (an earlier
# chip_smoke.py run); the fused CIM kernel per decode step (a chip_smoke.py
# run) and per prefill chunk (tools/cim_fused_time.py) before the split-K
# designs; the fused layer per step (a chip_smoke.py run) before its split
# stages.
PREVIOUS_BODY_MS = {"decode_attention": 1.212,
                    "decode_attention[int8]": 1.251, "flash_gqa": 1.875,
                    "flash_gqa[int8]": 1.882, "cim_matmul_fused": 3.387,
                    "cim_matmul_fused[chunk]": 5.703,
                    "fused_dense_layer": 3.727,
                    "fused_dense_layer[int8]": 3.713}


def phase_times(params, cfg):
    """Kernel, plain and library device times (torch.profiler) at the main
    path's shapes, per decode step or per prefill chunk of all 24 layers
    (the CIM kernel both: M = 4 on its split-K GEMV, M = 32 on its
    tensor-core tile, beside torch._int_mm on the same int8 shapes without
    the quantization and the noise, and with both launch plans printed);
    ``wall_ms`` is the kernel's event-timed rate, which the host's launch
    overhead bounds for these small grids, and ``queued_ms`` (the GQA
    kernels and their library call) the same launches timed with CUDA
    events while queued behind a spinning kernel, so without the host's
    gaps, beside ``launch_floor_queued_ms``, the same for 24 launches of a
    one-element add, and the same launches where no split merges (decode
    lens 16, flash start 0). ``previous_body_ms``: the replaced bodies'
    times from an earlier run (PREVIOUS_BODY_MS)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels.cim_matmul import (cim_fused_plan,
                                                cim_matmul_fused,
                                                cim_matmul_fused_plain)
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                     flash_gqa_plain)
    from repro_torch.models.attention import _kv_quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    pol = paper_sac()
    dp = deploy(cfg, params)
    blocks = dp["blocks"]
    L = cfg.n_layers
    seed = prng.seed_from_key(prng.PRNGKey(9))
    res = {}
    # one decode step's CIM work: 7 projections x 24 layers at M = 4 slots,
    # and one prefill chunk's at M = 32; the planes (358 MB) exceed the 50
    # MB L2, so each launch streams cold
    for m, name in ((4, "cim_matmul_fused"), (32, "cim_matmul_fused[chunk]")):
        calls = []
        for i in range(L):
            for grp, proj, spec in (
                    ("attn", "q", pol.attn), ("attn", "k", pol.attn),
                    ("attn", "v", pol.attn), ("attn", "o", pol.attn),
                    ("mlp", "gate", pol.mlp), ("mlp", "up", pol.mlp),
                    ("mlp", "down", pol.mlp)):
                wq = blocks[grp][proj][f"wq{spec.w_bits}"][i]
                k, n = wq.shape
                x = torch.randn((m, k), generator=g, device=dev).bfloat16()
                xs = (4.0 * torch.sqrt(torch.mean(x.float() ** 2))
                      / (2 ** (spec.in_bits - 1) - 1))
                qp = torch.stack([xs, xs * 1e-2])
                calls.append((x, wq, qp,
                              output_noise_std_int_per_tile(spec, k),
                              spec.in_bits))

        def run_k():
            for x, wq, qp, s, b in calls:
                cim_matmul_fused(x, wq, qp, seed, s, b)

        def run_p():
            for x, wq, qp, s, b in calls:
                cim_matmul_fused_plain(x, wq, qp, seed, s, b)

        bytes1 = sum(wq.numel() + x.numel() * 2 + 8
                     + x.shape[0] * wq.shape[1] * 4 for x, wq, *_ in calls)
        ops1 = sum(2 * x.shape[0] * wq.shape[0] * wq.shape[1]
                   for x, wq, *_ in calls)
        k_ms = device_ms(run_k, 10)
        p_ms = device_ms(run_p, 2)
        bound1 = 1e3 * max(bytes1 / HBM_BPS, ops1 / INT8_OPS)
        lib_ms = library = None
        if m > 16:
            # the yardstick: torch._int_mm on the same int8 shapes (the
            # plane column-major, as _int_mm takes it), no quantization
            # and no noise
            lib = [(torch.randint(-31, 32, (m, wq.shape[0]), generator=g,
                                  device=dev, dtype=torch.int8),
                    wq.t().contiguous().t()) for _, wq, *_ in calls]

            def run_lib():
                for xq, wcol in lib:
                    torch._int_mm(xq, wcol)

            lib_ms = device_ms(run_lib, 10)
            library = ("torch._int_mm(xq, wq): the same int8 products "
                       "without the quantization and the readout noise; "
                       "kernels " + ", ".join(top_kernels(run_lib)))
            del lib
        plans = {f"{proj} {k}x{n}": cim_fused_plan(m, k, n)
                 for proj, k, n in (("q/o", 896, 896), ("k/v", 896, 128),
                                    ("gate/up", 896, 4864),
                                    ("down", 4864, 896))}
        res[name] = dict(
            ms=k_ms, wall_ms=wall_ms(run_k, 10), plain_ms=p_ms,
            bound_ms=bound1,
            bound_by="bytes" if bytes1 / HBM_BPS >= ops1 / INT8_OPS
            else "operations", library_ms=lib_ms, library=library,
            previous_body_ms=PREVIOUS_BODY_MS[name],
            unit=f"one {'decode step' if m == 4 else 'prefill chunk'}: 7 "
                 f"projections x 24 layers, M={m}",
            launches=7 * L, bound_us=1e3 * bound1,
            grids={p_: [pl["path"], pl["grid"], pl["nspan"], pl["klen"]]
                   for p_, pl in plans.items()})
        emit("time", kernel=name, **res[name], bytes=bytes1, ops=ops1)

    # the launch floor: 24 launches (a step's or a chunk's worth) of a
    # one-element in-place add, queued as the kernels' queued_ms are
    one_elem = torch.zeros(1, device=dev)

    def run_floor():
        for _ in range(L):
            one_elem.add_(1)

    floor_ms = queued_ms(run_floor, 10)
    emit("time", kernel="launch_floor", queued_ms=floor_ms,
         unit=f"{L} launches of a one-element in-place add")
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = 320
    lens = torch.tensor([300, 137, 95, 211], dtype=torch.int32, device=dev)
    for int8 in (False, True):
        caches = []
        for _ in range(L):
            kf = torch.randn((4, t, kv, hd), generator=g, device=dev)
            vf = torch.randn((4, t, kv, hd), generator=g, device=dev)
            if int8:
                (kc, ks), (vc, vs) = _kv_quant(kf), _kv_quant(vf)
            else:
                kc, vc, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
            caches.append((kc, vc, ks, vs))
        q = torch.randn((4, h, hd), generator=g, device=dev).bfloat16()
        esz = 1 if int8 else 2
        live = int(lens.sum())
        bytes2 = L * (2 * live * kv * hd * esz + (2 * live * kv * 4 if int8
                                                  else 0) + 2 * q.numel() * 2)
        ops2 = L * 4 * live * (h // kv) * kv * hd
        def run_d():
            for c in caches:
                decode_attention(q, *c[:2], lens, *c[2:])

        d_k, d_w = device_ms(run_d, 10), wall_ms(run_d, 10)
        d_q = queued_ms(run_d, 10)
        # the same launches when every row fits one split: no merge
        short = torch.full_like(lens, 16)
        d_q1 = queued_ms(lambda: [decode_attention(q, *c[:2], short, *c[2:])
                                  for c in caches], 10)
        d_p = device_ms(lambda: [decode_attention_plain(q, *c[:2], lens,
                                                        *c[2:])
                                 for c in caches], 3)
        d_lib = d_lib_q = None
        if not int8:
            mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]
                    )[:, None, None, :]

            def run_dl():
                for c in caches:
                    F.scaled_dot_product_attention(
                        q[:, :, None], c[0].transpose(1, 2),
                        c[1].transpose(1, 2), attn_mask=mask,
                        enable_gqa=True)

            d_lib, d_lib_q = device_ms(run_dl, 10), queued_ms(run_dl, 10)
        name = "decode_attention" + ("[int8]" if int8 else "")
        res[name] = dict(ms=d_k, wall_ms=d_w, queued_ms=d_q,
                         queued_ms_lens16_no_merge=d_q1,
                         launch_floor_queued_ms=floor_ms,
                         previous_body_ms=PREVIOUS_BODY_MS[name], plain_ms=d_p,
                         library_ms=d_lib, library_queued_ms=d_lib_q,
                         bound_ms=1e3 * max(bytes2 / HBM_BPS, ops2 / BF16_OPS),
                         bound_by="bytes" if bytes2 / HBM_BPS >= ops2 / BF16_OPS
                         else "operations",
                         unit="one decode step: 24 layers, B=4, lens "
                              + str(lens.tolist()),
                         launches_per_decode_step=L,
                         bound_us=1e6 * max(bytes2 / HBM_BPS,
                                            ops2 / BF16_OPS))
        emit("time", kernel=name, **res[name], bytes=bytes2, ops=ops2)

        # one prefill chunk: 32 queries at start 128 against slot 0's cache
        s, start = 32, 128
        qf = torch.randn((1, s, h, hd), generator=g, device=dev).bfloat16()
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        one = [(c[0][:1], c[1][:1], None if c[2] is None else c[2][:1],
                None if c[3] is None else c[3][:1]) for c in caches]
        keys = start + s
        bytes3 = L * (2 * keys * kv * hd * esz + (2 * keys * kv * 4 if int8
                                                  else 0) + 2 * qf.numel() * 2)
        # causal: query i sees start + i + 1 keys
        ops3 = L * 4 * h * hd * sum(start + i + 1 for i in range(s))
        def run_f():
            for c in one:
                flash_gqa_attention(qf, c[0], c[1], st, c[2], c[3])

        f_k, f_w = device_ms(run_f, 10), wall_ms(run_f, 10)
        f_q = queued_ms(run_f, 10)
        # the same launches at start 0: one key block per q block, no merge
        st0 = torch.zeros_like(st)
        f_q0 = queued_ms(lambda: [flash_gqa_attention(qf, c[0], c[1], st0,
                                                      c[2], c[3])
                                  for c in one], 10)
        f_p = device_ms(lambda: [flash_gqa_plain(qf, c[0], c[1], st, c[2],
                                                 c[3]) for c in one], 3)
        f_lib = f_lib_q = None
        if not int8:
            qi = torch.arange(s, device=dev)[:, None] + start
            kj = torch.arange(t, device=dev)[None, :]
            fmask = ((kj <= qi) & (kj < start + s))[None, None]

            def run_fl():
                for c in one:
                    F.scaled_dot_product_attention(
                        qf.transpose(1, 2), c[0].transpose(1, 2),
                        c[1].transpose(1, 2), attn_mask=fmask,
                        enable_gqa=True)

            f_lib, f_lib_q = device_ms(run_fl, 10), queued_ms(run_fl, 10)
        name = "flash_gqa" + ("[int8]" if int8 else "")
        res[name] = dict(ms=f_k, wall_ms=f_w, queued_ms=f_q,
                         queued_ms_start0_no_merge=f_q0,
                         launch_floor_queued_ms=floor_ms,
                         previous_body_ms=PREVIOUS_BODY_MS[name], plain_ms=f_p,
                         library_ms=f_lib, library_queued_ms=f_lib_q,
                         bound_ms=1e3 * max(bytes3 / HBM_BPS, ops3 / BF16_OPS),
                         bound_by="bytes" if bytes3 / HBM_BPS >= ops3 / BF16_OPS
                         else "operations",
                         unit="one prefill chunk: 24 layers, S=32, start=128",
                         launches_per_decode_step=0, launches_per_chunk=L,
                         bound_us=1e6 * max(bytes3 / HBM_BPS,
                                            ops3 / BF16_OPS))
        emit("time", kernel=name, **res[name], bytes=bytes3, ops=ops3)
    return res


# ------------------------------------------------------------ phase 6
# the per-layer decode megakernel (fuse_layer=True) on a float32 model
FUSED_OLD_LENS = (299, 136, 94, 210)     # 300/137/95/211 keys after the write
X_TOL = 2 ** -10       # x_out: per row, times the row's max |value|
ATTN_TOL = 2 ** -12    # attention output: per query-head row, same
ROW_TOL = 1e-6         # f32 cache row / int8 scale: relative to the row max


def full_config32(int8: bool):
    return dataclasses.replace(full_config(int8), dtype="float32")


def fused_inputs(cfg, t: int, seed: int, lens=FUSED_OLD_LENS):
    """A (B, 1, d) layer input and a random slot cache at ``lens``."""
    import torch
    from repro_torch.models.attention import _kv_quant
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, kv, hd = len(lens), cfg.n_kv_heads, cfg.hd
    x = torch.randn((b, 1, cfg.d_model), generator=g, device="cuda")
    kf = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    vf = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    if cfg.kv_cache_int8:
        (kq, ks), (vq, vs) = _kv_quant(kf), _kv_quant(vf)
        cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    else:
        cache = {"k": kf, "v": vf}
    cache["len"] = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return x, cache


class plain_variant:
    """Context manager: a deliberately wrong plain version, to show the
    check's reach. ``no_current``: attention without the current token;
    ``kv_seeds_swapped``: the k and v noise seeds swapped."""

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self):
        from repro_torch.kernels import fused_step
        self.saved = (fused_step.decode_attention_plain, fused_step._Layer)
        attend, layer = self.saved
        if self.kind == "no_current":
            fused_step.decode_attention_plain = (
                lambda q, k, v, lens, ks=None, vs=None:
                attend(q, k, v, lens - 1, ks, vs))
        else:
            class Swapped(layer):
                def __init__(self, ctx, p):
                    super().__init__(ctx, p)
                    self.seeds[1], self.seeds[2] = self.seeds[2], self.seeds[1]
            fused_step._Layer = Swapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import fused_step
        fused_step.decode_attention_plain, fused_step._Layer = self.saved


def fused_rows(ko, kc, kp, po, pc, pp, lens):
    """Kernel (ko, kc, kp) against a plain run (po, pc, pp), row by row.
    Returns per-check boolean masks of rows out of tolerance and errors."""
    import torch

    def rows_off(a, b, tol):
        err = (a - b).abs()
        return (err > tol * b.abs().amax(-1, keepdim=True)).any(-1), err

    b = ko.shape[0]
    h = kp["attn"].shape[1] // 64
    bad_x, ex = rows_off(ko[:, 0], po[:, 0], X_TOL)
    bad_a, ea = rows_off(kp["attn"].view(b, h, 64),
                         pp["attn"].view(b, h, 64), ATTN_TOL)
    at = torch.arange(b, device=ko.device)
    pos = torch.as_tensor(lens, device=ko.device).long()
    bad_kv, code_off_by_1, kv_err = [], 0, 0.0
    for name in ("k", "v"):
        a, r = kc[name][at, pos].float(), pc[name][at, pos].float()
        if kc[name].dtype == torch.int8:
            d = (a - r).abs()
            bad_kv.append((d > 1).any(-1))
            code_off_by_1 += int((d == 1).sum())
            sa, sr = kc[name + "s"][at, pos], pc[name + "s"][at, pos]
            bad_kv.append(((sa - sr).abs() > ROW_TOL * sr.abs()).any(-1))
            kv_err = max(kv_err, float(d.max()))
        else:
            bad, e = rows_off(a, r, ROW_TOL)
            bad_kv.append(bad)
            kv_err = max(kv_err, float(e.max()))
    # everything but the written rows stays as it was in both
    untouched = all(
        torch.equal(kc[n].index_put((at, pos), torch.zeros_like(kc[n][at, pos])),
                    pc[n].index_put((at, pos), torch.zeros_like(pc[n][at, pos])))
        for n in kc if n != "len")
    return dict(x=bad_x, attn=bad_a, kv=torch.stack(bad_kv, -1),
                x_err=float(ex.max()),
                x_err_over_row_max=float((ex / po[:, 0].abs().amax(
                    -1, keepdim=True)).max()),
                attn_err=float(ea.max()), kv_err=kv_err,
                int8_codes_off_by_one=code_off_by_1,
                lens_equal=torch.equal(kc["len"], pc["len"]),
                untouched_equal=untouched)


def ulps(a, b):
    import torch
    return (a.float().view(torch.int32).long()
            - b.float().view(torch.int32).long()).abs()


def phase_fused_check(params32):
    """The fused-layer kernel against its plain version at full width
    (float32 qwen2-0.5b, sim mode, 4 slots, lens 300/137/95/211 after the
    write), f32 and int8 caches; the plain version runs on the kernel's
    seven activation scales. Tolerances: x_out per row 2^-10 of its max;
    attention output per query-head row 2^-12; written f32 cache rows and
    int8 scales 1e-6 relative; int8 codes equal or one apart; each scale
    within 1 ulp of the scale of an f64 mean over the same activations
    (the plain version's f32 mean is reported beside it: its own
    summation error reached 4 ulps over the 19456 inputs of ``down``).
    Reach: each wrong plain variant must fail in every row it touches."""
    import torch
    from repro_torch.core import prng, quant
    from repro_torch.core.deploy import deploy
    from repro_torch.kernels.fused_step import (fused_dense_layer,
                                                fused_dense_layer_plain)
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    worst = {}
    for int8 in (False, True):
        cfg = full_config32(int8)
        layer = tf._index(deploy(cfg, params32)["blocks"], 3)
        x, cache = fused_inputs(cfg, 320, 21 + int8)
        key = prng.PRNGKey(77)

        def clone():
            return {k: v.clone() for k, v in cache.items()}

        kc, kp = clone(), {}
        ko, _ = fused_dense_layer(Ctx.make(cfg, key, mode="sim"), layer, x,
                                  kc, probe=kp)
        torch.cuda.synchronize()

        def plain(scales):
            pc, pp = clone(), {}
            po, _ = fused_dense_layer_plain(Ctx.make(cfg, key, mode="sim"),
                                            layer, x, pc, scales=scales,
                                            probe=pp)
            return po, pc, pp

        po, pc, pp = plain(kp["scales"])
        res = fused_rows(ko, kc, kp, po, pc, pp, FUSED_OLD_LENS)
        _, _, own = plain(None)
        # the kernel's scales against the f64 mean of the same activations
        # (rounded once to f32, then the kernel's f32 steps), and against
        # the plain version's own f32-mean scales, whose summation error
        # alone reaches a few ulps at B * d_ff elements; flips: quantized
        # activations that the kernel's scales put in another bucket than
        # the plain version's own (q/k/v and gate/up share one scale)
        su, su_own, flips = [], [], 0
        ctx = Ctx.make(cfg, key, mode="sim")
        for i, role in ((0, "attn_qkv"), (3, "attn_out"), (4, "mlp_in"),
                        (6, "mlp_out")):
            qm = quant.qmax(ctx.spec_for(role).in_bits)
            m = torch.mean(pp["acts"][i].double() ** 2).float()
            exact = cfg.cim.act_clip_sigmas * (torch.sqrt(m) + 1e-8) / qm
            su.append(int(ulps(kp["scales"][i], exact)))
            su_own.append(int(ulps(kp["scales"][i], own["scales"][i])))
            act = own["acts"][i]
            a = torch.clamp(torch.round(act / own["scales"][i]), -qm, qm)
            b = torch.clamp(torch.round(act / kp["scales"][i]), -qm, qm)
            flips += int((a != b).sum())
        bad = {k: float(res[k].float().mean()) for k in ("x", "attn", "kv")}
        if (any(bad.values()) or max(su) > 1 or not res["lens_equal"]
                or not res["untouched_equal"]
                or not bool(torch.isfinite(ko).all())):
            fail(f"fused_dense_layer int8={int8}: rows out of tolerance "
                 f"{bad}, scale ulps {su}, lens equal "
                 f"{res['lens_equal']}, untouched {res['untouched_equal']}, "
                 f"x err {res['x_err']}, attn err {res['attn_err']}, kv err "
                 f"{res['kv_err']}")
        reach = {}
        for kind in ("no_current", "kv_seeds_swapped"):
            with plain_variant(kind):
                vo, vc, vp = plain(kp["scales"])
            r = fused_rows(ko, kc, kp, vo, vc, vp, FUSED_OLD_LENS)
            touched = r["attn"] if kind == "no_current" else r["kv"]
            reach[kind] = {"rows_failing": float(touched.float().mean()),
                           "x_rows_failing": float(r["x"].float().mean())}
            if float(touched.float().mean()) < 1.0:
                fail(f"fused_dense_layer tolerance too loose: the "
                     f"{kind} variant fails only {reach[kind]} of its rows")
        worst[int8] = res["x_err"]
        emit("kernel_check", kernel="fused_dense_layer", int8_cache=int8,
             lens=[n + 1 for n in FUSED_OLD_LENS], grid=fused_dense_layer.grid,
             max_abs_err=res["x_err"],
             max_err_over_row_max=res["x_err_over_row_max"],
             attn_max_abs_err=res["attn_err"], kv_row_max_err=res["kv_err"],
             int8_codes_off_by_one=res["int8_codes_off_by_one"],
             scale_ulps_vs_f64_mean=su,
             scale_ulps_vs_plain_f32_mean=su_own,
             scales=kp["scales"].tolist(),
             quantized_activations_flipped=flips,
             tol={"x_out": "2^-10*max|row|", "attn": "2^-12*max|row|",
                  "kv_rows": "1e-6 relative; int8 codes +-1",
                  "scales": "1 ulp of the f64 mean's scale"},
             reach=reach)
    return worst


def phase_serve_fused(params32, int8: bool):
    """Full-width float32 qwen2-0.5b with fuse_layer=True: every decode
    step is one fused launch per layer (a cooperative kernel node of the
    decode graph); prefill chunks stay on the CIM and flash kernels.
    Replayed and per call (``graph_vs_eager``); launch counts must hold
    exactly."""
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.kernels.fused_step import fused_dense_layer

    cfg = full_config32(int8)
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention,
               fused_dense_layer)
    eng, reqs, outs, counts, wall = graph_vs_eager(
        "D" if int8 else "C", cfg, params32, kernels, fuse_layer=True)
    lens = SESSION_LENS
    bad = [o for o in outs if not isinstance(o, list) or len(o) != 16
           or not all(0 <= t < cfg.vocab_size for t in o)]
    if bad:
        fail(f"fused int8={int8}: failed, short or out-of-range requests: "
             f"{bad}")
    n_chunks = sum(e["chunks"] for e in eng.step_log)
    n_decode = sum(e["decode"] for e in eng.step_log)
    L = cfg.n_layers
    expect = {"fused_dense_layer": L * n_decode, "decode_attention": 0,
              "cim_matmul_fused": 7 * L * n_chunks,
              "flash_gqa_attention": L * n_chunks}
    if counts != expect or n_decode == 0:
        fail(f"fused int8={int8}: launches {counts} != expected {expect}")
    dec = [e["s"] for e in eng.step_log if e["decode"] and not e["chunks"]]
    toks = sum(len(o) for o in outs)
    emit("serve_fused_full_width", arch=cfg.name, dtype=cfg.dtype,
         kv_cache_int8=int8, requests=len(reqs), prompt_lens=list(lens),
         new_tokens=16, slots=4, tokens=toks, wall_s=wall,
         session_tok_per_s=toks / wall, chunks=n_chunks,
         decode_steps=n_decode,
         pure_decode_step_ms_mean=1e3 * float(np.mean(dec)),
         ttft_ms_mean=1e3 * float(np.mean(eng.ttft_s)),
         ttft_ms_max=1e3 * float(np.max(eng.ttft_s)),
         launches=counts, expected=expect)
    return counts, outs


def first_step_logits(cfg, params32, mode, reqs, perturb=None):
    """Logits of the first decode step of 4 prefilled prompts, fused and
    unfused, from one prefilled cache; ``perturb`` (a relative change)
    also runs the unfused step with its first activation scale moved by
    that much."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import layers, transformer as tf
    from repro_torch.models.layers import Ctx
    from repro_torch.serving.engine import Engine, Request

    eng = Engine(cfg, params32, max_slots=4, max_len=320, attn_impl="kernel",
                 cim_mode=mode, device="cuda")
    for r in reqs[:4]:
        eng.submit(Request(prompt=r.prompt, max_new_tokens=2))
    while not all(eng._decoding):
        eng._fill_slots()
        eng._prefill_chunks()
    key = prng.PRNGKey(123)
    orig = layers._act_scale

    def step(fuse, scale=None):
        c = dataclasses.replace(cfg, fuse_layer=fuse)
        caches = {k: v.clone() for k, v in eng.caches.items()}
        calls = []
        if scale is not None:
            def moved(ctx, x, spec):
                calls.append(1)
                xs = orig(ctx, x, spec)
                return xs * (1 + scale) if len(calls) == 1 else xs
            layers._act_scale = moved
        try:
            out, _ = tf.forward(eng.params,
                                {"tokens": eng.last_tok[:, None]}, c,
                                Ctx.make(c, key, mode=mode), caches)
        finally:
            layers._act_scale = orig
        return out[:, 0].float()

    res = {"fused": step(True), "unfused": step(False)}
    if perturb is not None:
        res["moved"] = step(False, perturb)
    return res


def rel_rows(a, b):
    return ((a - b).abs().amax(-1) / b.abs().amax(-1)).tolist()


def phase_fused_tokens(params32, fused_outs):
    """fuse_layer=True against fuse_layer=False. Required: greedy tokens of
    the reduced float32 sim model on the card equal; at full width in off
    mode (float32 dots, no quantization) the first decode step's logits
    agree per row within 2^-10 of the row's max |logit|. Reported: the
    same comparison in sim mode, where the kernel's f64-mean scales and the
    unfused path's f32-mean scales may put a few activations in the next
    quantization bucket and the 24 quantized layers amplify that (measured
    here by moving one unfused activation scale by 1e-4), and the 16-token
    agreement of the full-width sim run."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.serving.engine import Engine, Request

    base = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
    red = [Engine(cfg, params, max_slots=2, max_len=128, attn_impl="kernel",
                  fuse_layer=fuse, device="cuda").generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
        for fuse in (True, False)]
    if red[0] != red[1]:
        fail(f"reduced f32 fused tokens {red[0]} != unfused {red[1]}")

    cfg = full_config32(False)
    rng = np.random.default_rng(5)
    lens = (60, 300, 137, 95, 211, 64)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=16, rid=f"r{i}")
            for i, n in enumerate(lens)]
    off = first_step_logits(cfg, params32, "off", reqs)
    off_rel = rel_rows(off["fused"], off["unfused"])
    if (not bool(torch.isfinite(off["fused"]).all())
            or max(off_rel) > 2 ** -10):
        fail(f"full-width off-mode first-step logits fused vs unfused: "
             f"max err / row max {off_rel}")
    sim = first_step_logits(cfg, params32, "sim", reqs, perturb=1e-4)
    if not bool(torch.isfinite(sim["fused"]).all()):
        fail("full-width sim-mode fused logits not finite")
    unfused = Engine(cfg, params32, max_slots=4, max_len=320,
                     attn_impl="kernel", device="cuda").generate(
        [Request(prompt=r.prompt, max_new_tokens=16, rid=r.rid)
         for r in reqs])
    same = sum(a == b for o, u in zip(fused_outs, unfused)
               for a, b in zip(o, u))
    emit("fused_vs_unfused", reduced_tokens_equal=True,
         reduced_tokens=red[0],
         off_first_step_logits_err_over_row_max=off_rel,
         off_tol="2^-10*max|row|",
         sim_first_step_logits_err_over_row_max=rel_rows(sim["fused"],
                                                         sim["unfused"]),
         sim_first_step_argmax_equal=torch.equal(
             sim["fused"].argmax(-1), sim["unfused"].argmax(-1)),
         sim_scale_moved_by=1e-4,
         sim_moved_vs_unfused_err_over_row_max=rel_rows(
             sim["moved"], sim["unfused"]),
         sim_full_width_tokens_equal=same,
         sim_full_width_tokens=sum(len(o) for o in unfused))


def phase_times_fused(params32):
    """Device ms of one decode step's 24 fused launches (B = 4, lens
    300/137/95/211 after the write) for each cache, its plain version's,
    and the bound: the bytes the step must move (the seven planes of every
    layer, the live cache rows, the activations in and out) over 3.35 TB/s
    against its int8 and f32 operations over their peaks."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy
    from repro_torch.kernels.fused_step import (fused_dense_layer,
                                                fused_dense_layer_plain,
                                                fused_layer_plan)
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    res = {}
    for int8 in (False, True):
        cfg = full_config32(int8)
        L, b = cfg.n_layers, len(FUSED_OLD_LENS)
        d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd)
        blocks = deploy(cfg, params32)["blocks"]
        layers = [tf._index(blocks, i) for i in range(L)]
        key = prng.PRNGKey(9)

        def run(fn, lens=FUSED_OLD_LENS):
            # fresh caches for each measurement: every call advances its
            # layer's lens by one, at most 11 times per measurement
            ins = [fused_inputs(cfg, 320, 40 + i, lens) for i in range(L)]

            def go():
                for lay, (x, c) in zip(layers, ins):
                    fn(Ctx.make(cfg, key, mode="sim"), lay, x, c)
            return go

        live = sum(n + 1 for n in FUSED_OLD_LENS)
        esz = 1 if int8 else 4
        planes = sum(v.numel() for grp in ("attn", "mlp")
                     for leaf in layers[0][grp].values()
                     for k_, v in leaf.items() if k_.startswith("wq"))
        per_layer = (planes + 7 * 4 + 4 * (h * hd + 2 * kv * hd)  # ws, bias
                     + 2 * d * 4                       # gains
                     + 2 * b * d * 4                   # x in, out
                     + 2 * live * kv * hd * esz        # live keys, values
                     + (2 * live * kv * 4 if int8 else 0)
                     + 2 * b * 4)                      # lens in, out
        nbytes = L * per_layer
        int8_ops = L * 2 * b * planes
        f32_ops = L * 4 * live * (h // kv) * kv * hd
        t_ops = int8_ops / INT8_OPS + f32_ops / FP32_OPS
        k_ms = device_ms(run(fused_dense_layer), 10)
        # the same step with one key per row: what is left without the
        # attention stage's walk over the cache
        k1_ms = device_ms(run(fused_dense_layer, (0,) * b), 10)
        plan = fused_layer_plan(b, d, h, kv, f, 320)
        p_ms = device_ms(run(fused_dense_layer_plain), 2)
        bound = 1e3 * max(nbytes / HBM_BPS, t_ops)
        name = "fused_dense_layer" + ("[int8]" if int8 else "")
        res[name] = dict(ms=k_ms, wall_ms=wall_ms(run(fused_dense_layer), 10),
                         plain_ms=p_ms, bound_ms=bound,
                         bound_by="bytes" if nbytes / HBM_BPS >= t_ops
                         else "operations", library_ms=None,
                         unit=f"one decode step: {L} layers, B={b}, lens "
                              + str([n + 1 for n in FUSED_OLD_LENS]),
                         launches_per_decode_step=L,
                         grid=fused_dense_layer.grid,
                         previous_body_ms=PREVIOUS_BODY_MS[name],
                         splits={k_: [s_["units"] * s_["planes"],
                                      s_["n_split"], s_["klen"]]
                                 for k_, s_ in plan["stages"].items()},
                         attn_key_tiles=plan["attn_tiles"],
                         ms_one_key_per_row=k1_ms)
        emit("time", kernel=name, **res[name], bytes=nbytes,
             int8_ops=int8_ops, f32_ops=f32_ops)
    return res


# the two kernels' times before their split-key designs (CUDA events, the
# last chip_smoke.py run of the earlier bodies, H100 80GB HBM3 at 700 W):
# the f32 queries of the GQA prefill on a CUDA-core body of scalar shared
# loads, MLA on 4-head CUDA-core blocks walking every key tile; printed
# beside the new times for comparison, not measured here
PREVIOUS_GQA_F32_MLA_MS = {"flash_gqa[f32]": 1.722,
                           "flash_gqa[f32,int8]": 1.739,
                           "mla_decode_attention": 0.312}


def phase_times_gqa_f32():
    """The f32-query GQA prefill of the float32 cells C (f32 cache) and D
    (int8 cache): one 32-token chunk (24 layers, start 128, qwen2-0.5b
    heads, a cache of T = 320 rows) through flash_gqa_attention, held
    against its plain version at the f32 limit of B5 (b5_rows_off: 2e-5 +
    2e-5 |ref| per element; the max abs error returned), whose reach is
    checked on the plain version (a result that drops each query's last 32
    visible keys must fail every row), timed with CUDA events (queued_ms)
    and the profiler, beside the earlier body's time, its plain version, one
    scaled_dot_product_attention call per layer in f32 on the f32 cache
    (enable_gqa, a boolean mask; its events time the host - the calls do
    not queue behind the kernel - so ``library_ms`` is the profiler's
    device time and the events figure is kept as
    ``library_host_bound_queued_ms``), and the bound: the live cache rows (and int8 scales) and the queries in
    and out over 3.35 TB/s against 4 D operations per live (query head,
    key) pair over the f32 peak. The block counts of one launch equal
    their closed form (flash_counts), and the launch plan is printed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                     flash_gqa_plain,
                                                     flash_gqa_plan)
    cfg = full_config32(False)
    L, h, kv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t, s, start = 320, 32, 128
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(56)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    keys = start + s
    ops = L * 4 * h * hd * sum(start + i + 1 for i in range(s))
    res, errs = {}, {}
    for int8 in (False, True):
        caches = [attn_cache(g, 1, t, kv, hd, "int8" if int8 else "f32")
                  for _ in range(L)]
        qf = torch.randn((1, s, h, hd), generator=g, device=dev)

        def run_f():
            for c in caches:
                flash_gqa_attention(qf, *c[:2], st, *c[2:])

        worst, reach = 0.0, 1.0
        for c in caches[:4]:
            ok = flash_gqa_attention(qf, *c[:2], st, *c[2:])
            op = flash_gqa_plain(qf, *c[:2], st, *c[2:])
            off, err = b5_rows_off(ok, op, torch.float32)
            if off.any():
                fail(f"flash_gqa f32 q int8={int8}: "
                     f"{off.float().mean().item():.3f} of the rows out of "
                     f"tolerance (max err {err})")
            # the frontier 32 keys earlier: each query loses its last 32
            # visible keys
            short = flash_gqa_plain(qf, *c[:2], st - 32, *c[2:])
            reach = min(reach, b5_rows_off(short, op, torch.float32)[0]
                        .float().mean().item())
            worst = max(worst, err)
        if reach < 1.0:
            fail(f"flash_gqa f32 q tolerance too loose: dropping the last "
                 f"32 visible keys fails only {reach:.3f} of the rows")
        counts = flash_gqa_attention(qf, *caches[0][:2], st, *caches[0][2:],
                                     return_block_counts=True)[1]
        want = flash_counts(qf, caches[0][0], kv, start)
        if counts[0].tolist() != want:
            fail(f"flash_gqa f32 q block counts {counts[0].tolist()} != "
                 f"closed form {want}")
        plan = flash_gqa_plan(1, s, t, h, kv, hd, False)
        esz = 1 if int8 else 4
        nbytes = L * (2 * keys * kv * hd * esz + (2 * keys * kv * 4 if int8
                                                  else 0) + 2 * qf.numel() * 4)
        lib = lib_q = None
        if not int8:
            qi = torch.arange(s, device=dev)[:, None] + start
            kj = torch.arange(t, device=dev)[None, :]
            fmask = ((kj <= qi) & (kj < start + s))[None, None]

            def run_lib():
                for c in caches:
                    F.scaled_dot_product_attention(
                        qf.transpose(1, 2), c[0].transpose(1, 2),
                        c[1].transpose(1, 2), attn_mask=fmask,
                        enable_gqa=True)

            lib_q, lib = queued_ms(run_lib, 10), device_ms(run_lib, 10)
        name = "flash_gqa[f32" + (",int8]" if int8 else "]")
        res[name] = dict(
            ms=queued_ms(run_f, 10), profiler_ms=device_ms(run_f, 10),
            plain_ms=device_ms(lambda: [flash_gqa_plain(qf, *c[:2], st,
                                                        *c[2:])
                                        for c in caches], 3),
            library_ms=lib, library_host_bound_queued_ms=lib_q,
            bound_ms=1e3 * max(nbytes / HBM_BPS, ops / FP32_OPS),
            bound_by="bytes" if nbytes / HBM_BPS >= ops / FP32_OPS
            else "operations",
            previous_body_ms=PREVIOUS_GQA_F32_MLA_MS[
                "flash_gqa[f32" + (",int8]" if int8 else "]")],
            unit=f"one prefill chunk of cell {'D' if int8 else 'C'}: {L} "
                 f"layers, S={s}, start={start}, f32 queries",
            launches_per_chunk=L,
            plan={k: plan[k] for k in ("block_q", "block_k", "n_q", "kbps",
                                       "n_split", "grid")},
            blocks_reading_keys=sum(-(-c // plan["kbps"])
                                    for row in want for c in row),
            block_counts=want)
        errs[name] = worst
        emit("time", kernel=name, **res[name], bytes=nbytes, f32_ops=ops,
             max_abs_err=worst, tol="2e-5+2e-5*|ref|",
             tail_block_dropped_rows_failing=reach, library="scaled_dot_product_attention, f32"
             if lib is not None else None)
    return res, errs


# ------------------------------------------------------------ phase 7
# the ssm family: mamba2-130m, every decode step through ssm_decode_step
SSM_TOL = 1e-5         # state and y rows: times the row's max |value|


def ssm_config(mode="sim"):
    from repro_torch.configs.registry import get_config
    cfg = get_config("mamba2-130m")
    return dataclasses.replace(cfg, cim=dataclasses.replace(
        cfg.cim, mode=mode, use_kernel=True))


def ssm_inputs(cfg, b, window_dtype, seed):
    """One layer's decode-step operands at ``cfg``'s width (see
    ``ssm_operands``)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return ssm_operands(b, d_inner // s.headdim, s.headdim, s.d_state,
                        s.conv_width - 1, window_dtype, seed)


def ssm_operands(b, h, p, n, win, window_dtype, seed, w_dtype=None):
    """One layer's decode-step operands for B slot rows, H heads of P state
    rows, d_state N and a window of ``win`` rows: a random window in
    ``window_dtype``, a random f32 state, conv weights (float32, or
    ``w_dtype``), the model's decay rates, and ragged dt log-uniform in
    [1e-3, 1e-1] (mamba2's dt range: every row keeps part of its state, so
    a wrong state shows). ngroups is 1, as in every config."""
    import torch
    d_inner = h * p
    cd = d_inner + 2 * n
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    dt = torch.exp(torch.rand((b, h), generator=g, device="cuda")
                   * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    w_dtype = w_dtype or torch.float32
    args = [r(b, win, cd).to(window_dtype), r(b, 1, cd).to(window_dtype),
            (0.2 * r(win + 1, cd)).to(w_dtype), (0.1 * r(cd)).to(w_dtype),
            dt, a, r(h), r(b, h, p, n)]
    return args, (d_inner, 1, n)


def misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned address."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def ssm_rows(out, ref):
    """(y, window, state) against a plain result, row by row: a state row
    is one (slot, head, p) over N, a y row one (slot, head) over P. Returns
    the rows out of SSM_TOL and the max errors."""
    b, h = ref[2].shape[:2]

    def off(a, r):
        err = (a - r).abs()
        return (err > SSM_TOL * r.abs().amax(-1, keepdim=True)).any(-1), err

    bad_s, es = off(out[2], ref[2])
    bad_y, ey = off(out[0].view(b, h, -1), ref[0].view(b, h, -1))
    return dict(state=bad_s, y=bad_y, state_err=float(es.max()),
                y_err=float(ey.max()),
                y_err_over_row_max=float((ey / ref[0].view(b, h, -1).abs()
                                          .amax(-1, keepdim=True)).max()))


# (name, B, H, P, N, window dtype, conv_w / conv_b dtype) of phase
# ssm_check: mamba2-130m (cell E's width) at B 4 in both window dtypes, at
# B 1 and 3, with the model's bf16 conv weights widened in the kernel,
# zamba2-7b's mamba layers (d_inner 7168, N 64, conv_dim 7296), and a
# d_state with no template of its own (two chunks a row, P 7: one-channel
# conv loads)
SSM_CASES = (("mamba2-130m", 4, 24, 64, 128, "bfloat16", "float32"),
             ("mamba2-130m", 4, 24, 64, 128, "float32", "float32"),
             ("mamba2-130m", 1, 24, 64, 128, "bfloat16", "float32"),
             ("mamba2-130m", 3, 24, 64, 128, "bfloat16", "float32"),
             ("mamba2-130m", 4, 24, 64, 128, "bfloat16", "bfloat16"),
             ("zamba2-7b", 4, 112, 64, 64, "bfloat16", "float32"),
             ("zamba2-7b", 4, 112, 64, 64, "float32", "float32"),
             ("generic", 2, 5, 7, 200, "bfloat16", "bfloat16"))


def phase_ssm_check():
    """The selective-scan kernel against its plain version at every shape
    of ``SSM_CASES``: the new window bit for bit, state and y rows within
    SSM_TOL of their max; the in-place update (state_out = state) equal to
    the out-of-place one. bf16 conv weights: the plain version takes their
    float32 widening, and the kernel's result equals its own on the widened
    weights exactly; misaligned conv weights (the kernel's one-channel
    loads) give exactly what aligned ones give. Reach: the plain step without the decay (A = 0) and on
    the wrong slot's state (the next slot's; at B 1 another draw) must fail
    in every state and y row."""
    import torch
    from repro_torch.kernels.ssm_scan import (ssm_decode_plan,
                                              ssm_decode_step,
                                              ssm_decode_step_plain)
    worst = 0.0
    for i, (arch, b, h, p, n, wname, cname) in enumerate(SSM_CASES):
        wdt, cdt = getattr(torch, wname), getattr(torch, cname)
        args, dims = ssm_operands(b, h, p, n, 3, wdt, 31 + i, cdt)
        wide = args[:2] + [args[2].float(), args[3].float()] + args[4:]
        out = ssm_decode_step(*args, *dims)
        ref = ssm_decode_step_plain(*wide, *dims)
        res = ssm_rows(out, ref)
        st = args[7].clone()
        y2, _, _ = ssm_decode_step(*args[:7], st, *dims, state_out=st)
        in_place = torch.equal(st, out[2]) and torch.equal(y2, out[0])
        window_equal = (out[1].dtype == wdt and torch.equal(out[1], ref[1]))
        widened_equal = cdt == torch.float32 or all(
            torch.equal(u, v)
            for u, v in zip(out, ssm_decode_step(*wide, *dims)))
        odd = args[:2] + [misaligned(args[2]), misaligned(args[3])] + args[4:]
        aligned_equal = all(torch.equal(u, v) for u, v in
                            zip(out, ssm_decode_step(*odd, *dims)))
        bad = {k: float(res[k].float().mean()) for k in ("state", "y")}
        if (any(bad.values()) or not window_equal or not in_place
                or not widened_equal or not aligned_equal
                or not bool(torch.isfinite(out[0]).all())):
            fail(f"ssm_decode_step {arch} B {b} window {wdt} conv weights "
                 f"{cdt}: rows out of tolerance {bad}, window equal "
                 f"{window_equal}, in place {in_place}, widened weights "
                 f"equal {widened_equal}, misaligned weights equal "
                 f"{aligned_equal}, state err {res['state_err']}, "
                 f"y err {res['y_err']}")
        reach = {}
        no_decay, wrong_slot = list(wide), list(wide)
        no_decay[5] = torch.zeros_like(args[5])
        wrong_slot[7] = (args[7].roll(1, dims=0) if b > 1 else
                         ssm_operands(b, h, p, n, 3, wdt, 99, cdt)[0][7])
        for kind, v in (("no_decay", no_decay), ("wrong_slot", wrong_slot)):
            r = ssm_rows(out, ssm_decode_step_plain(*v, *dims))
            reach[kind] = {k: float(r[k].float().mean())
                           for k in ("state", "y")}
            if min(reach[kind].values()) < 1.0:
                fail(f"ssm_decode_step tolerance too loose: the {kind} "
                     f"variant fails only {reach[kind]} of the rows "
                     f"({arch} B {b})")
        worst = max(worst, res["state_err"], res["y_err"])
        emit("ssm_kernel_check", kernel="ssm_decode_step", arch=arch,
             window_dtype=wname, conv_weight_dtype=cname,
             shape={"B": b, "H": h, "P": p, "N": n,
                    "conv_dim": args[0].shape[2]},
             plan=ssm_decode_plan(b, h, p, n),
             window_equal=True, in_place_equal=True,
             misaligned_weights_equal=True,
             state_max_abs_err=res["state_err"], y_max_abs_err=res["y_err"],
             y_err_over_row_max=res["y_err_over_row_max"],
             tol=f"state and y rows: {SSM_TOL}*max|row|; window exact",
             reach=reach)
    return worst


def phase_ssm_parity():
    """Reduced mamba2: greedy tokens on the card (selective-scan and CIM
    kernels) equal the CPU's (plain versions), in off and sim mode, with a
    1-token prompt and a recycled slot."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.ssm_scan import ssm_decode_step
    from repro_torch.serving.engine import Engine, Request

    base = get_config("mamba2-130m").reduced()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (40, 1, 90, 57)]
    res = {}
    for mode in ("off", "sim"):
        cfg = dataclasses.replace(base, cim=dataclasses.replace(
            base.cim, mode=mode, use_kernel=True))
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        outs = {}
        ssm_decode_step.launches = 0
        for dev in ("cuda", "cpu"):
            eng = Engine(cfg, params, max_slots=2, max_len=128,
                         attn_impl="kernel", device=dev)
            outs[dev] = eng.generate([Request(prompt=p, max_new_tokens=8,
                                              rid=f"p{i}")
                                      for i, p in enumerate(prompts)])
        if outs["cuda"] != outs["cpu"] or ssm_decode_step.launches == 0:
            fail(f"reduced mamba2 {mode}: tokens differ: cuda "
                 f"{outs['cuda']} vs cpu {outs['cpu']} (kernel launches "
                 f"{ssm_decode_step.launches})")
        res[mode] = outs["cuda"]
    emit("ssm_token_parity", arch=base.name, requests=len(prompts),
         prompt_lens=[len(p) for p in prompts], new_tokens=8, equal=True,
         tokens=res)


def phase_serve_ssm(params):
    """Cell E: full-width mamba2-130m, sim mode, through the CIM and
    selective-scan kernels, the session of cells A-D, replayed and per
    call (``graph_vs_eager``). Launch counts must hold exactly:
    ssm_decode_step 24 per decode step, cim_matmul_fused 2 x 24 per chunk
    and per decode step, no attention kernel."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.kernels.fused_step import fused_dense_layer
    from repro_torch.kernels.ssm_scan import ssm_decode_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    cfg = ssm_config()
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention,
               fused_dense_layer, ssm_decode_step)
    eng, reqs, outs, counts, wall = graph_vs_eager("E", cfg, params, kernels)
    lens = SESSION_LENS
    bad = [o for o in outs if not isinstance(o, list) or len(o) != 16
           or not all(0 <= t < cfg.vocab_size for t in o)]
    if bad:
        fail(f"mamba2: failed, short or out-of-range requests: {bad}")
    ctx = Ctx.make(cfg, prng.PRNGKey(11), mode="sim")
    tokens = torch.from_numpy(reqs[0].prompt[:32]).cuda()[None]
    logits, _ = tf.forward(eng.params, {"tokens": tokens}, cfg, ctx,
                           tf.init_caches(cfg, 1, 32, "cuda"))
    if (tuple(logits.shape) != (1, 32, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        fail(f"mamba2: logits {tuple(logits.shape)} not finite")
    n_chunks = sum(e["chunks"] for e in eng.step_log)
    n_decode = sum(e["decode"] for e in eng.step_log)
    L = cfg.n_layers
    expect = {"cim_matmul_fused": 2 * L * (n_chunks + n_decode),
              "decode_attention": 0, "flash_gqa_attention": 0,
              "fused_dense_layer": 0, "ssm_decode_step": L * n_decode}
    if counts != expect or n_decode == 0:
        fail(f"mamba2: launches {counts} != expected {expect}")
    dec = [e["s"] for e in eng.step_log if e["decode"] and not e["chunks"]]
    toks = sum(len(o) for o in outs)
    emit("serve_ssm_full_width", arch=cfg.name, dtype=cfg.dtype,
         requests=len(reqs), prompt_lens=list(lens), new_tokens=16, slots=4,
         tokens=toks, wall_s=wall, session_tok_per_s=toks / wall,
         chunks=n_chunks, decode_steps=n_decode,
         pure_decode_step_ms_mean=1e3 * float(np.mean(dec)),
         ttft_ms_mean=1e3 * float(np.mean(eng.ttft_s)),
         ttft_ms_max=1e3 * float(np.max(eng.ttft_s)),
         launches=counts, expected=expect, logits_finite=True)
    return counts


def ssm_step_work(layers):
    """Bytes and f32 operations of one decode step over ``layers`` (each
    ``(args, dims)`` of ``ssm_operands``): the f32 state read and written
    once, the window in and out, xbc, the conv weights, dt, A, D and y
    once; five operations per state element, three per x channel, and the
    conv + SiLU of every channel a head reads."""
    nbytes = ops = 0
    for args, (d_inner, _, n) in layers:
        conv, state = args[0], args[7]
        b, win, _ = conv.shape
        h, p = state.shape[1:3]
        nbytes += (2 * state.numel() * 4
                   + 2 * conv.numel() * conv.element_size()
                   + sum(t.numel() * t.element_size() for t in args[1:7])
                   + b * d_inner * 4)
        ops += b * h * (5 * p * n + 3 * p
                        + (p + 2 * n) * (2 * (win + 1) + 4))
    return nbytes, ops


def phase_times_ssm():
    """Device ms of one decode step's 24 selective-scan launches (full
    width, B = 4, bf16 window, each layer its own state, updated in place
    as on the serving path), its plain version's, and the bound: the bytes
    the step must move (the f32 state read and written once, the window in
    and out, xbc, the conv weights, dt, A, D and y) over 3.35 TB/s against
    its f32 operations over the f32 peak. No single PyTorch call computes
    this step, so there is no library time."""
    import torch
    from repro_torch.kernels.ssm_scan import (ssm_decode_plan,
                                              ssm_decode_step,
                                              ssm_decode_step_plain)
    cfg = ssm_config()
    s, L, b = cfg.ssm, cfg.n_layers, 4
    layers = [ssm_inputs(cfg, b, torch.bfloat16, 60 + i) for i in range(L)]
    args, (_, _, n) = layers[0]
    h, p = args[5].numel(), s.headdim
    nbytes, ops = ssm_step_work(layers)

    def run_k():
        for a, dims in layers:
            ssm_decode_step(*a, *dims, state_out=a[7])

    def run_p():
        for a, dims in layers:
            ssm_decode_step_plain(*a, *dims)

    k_ms = device_ms(run_k, 10)
    p_ms = device_ms(run_p, 3)
    bound = 1e3 * max(nbytes / HBM_BPS, ops / FP32_OPS)
    res = dict(ms=k_ms, wall_ms=wall_ms(run_k, 10), plain_ms=p_ms,
               bound_ms=bound,
               bound_by="bytes" if nbytes / HBM_BPS >= ops / FP32_OPS
               else "operations", library_ms=None,
               unit=f"one decode step: {L} layers, B={b}, H={h}, P={p}, "
                    f"N={n}, bf16 window",
               launches_per_decode_step=L)
    emit("time", kernel="ssm_decode_step", **res, bytes=nbytes, f32_ops=ops,
         plan=ssm_decode_plan(b, h, p, n))
    return {"ssm_decode_step": res}


# ------------------------------------------------------------ phase 8
# the moe family with MLA attention: deepseek-v2-236b at full width, four of
# its 60 layers (the depth one card holds), every decode step of every layer
# through the latent-cache kernel mla_decode_attention
MLA_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}   # times the row's max
MLA_LENS = (301, 138, 96, 212)         # the session's lengths + the token
MLA_LAYERS = 4


def mla_config(mode="sim", reduced=False):
    from repro_torch.configs.registry import get_config
    cfg = get_config("deepseek-v2-236b")
    cfg = (cfg.reduced() if reduced
           else dataclasses.replace(cfg, n_layers=MLA_LAYERS))
    return dataclasses.replace(cfg, cim=dataclasses.replace(
        cfg.cim, mode=mode, use_kernel=True))


def mla_inputs(dtype, lens, t, seed, h=128, lat=512, rope=64):
    """One layer's decode operands at deepseek-v2 width: N(0, 1) queries
    and latent cache give scores of std sqrt(3) at scale 1/sqrt(192), so
    every 32-key stretch carries weight (a dropped tail shows)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    b = len(lens)
    return (r(b, h, lat), r(b, h, rope), r(b, t, lat), r(b, t, rope),
            torch.tensor(lens, dtype=torch.int32, device="cuda"),
            float(1.0 / 192 ** 0.5))


def mla_rows(out, ref, tol):
    """Rows (one (slot, head) over the latent width) out of tolerance, the
    max abs error and the max error over the row's max."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    scale = ref.abs().amax(-1, keepdim=True)
    return ((err > tol * scale).any(-1), float(err.max()),
            float((err / scale.clamp(min=1e-30)).max()))


def phase_mla_check():
    """The latent-cache kernel against its plain version at full width
    (B = 4, H = 128, L = 512, R = 64, T = 512) in bf16 and f32, at the
    session's lengths and with a 0 and a T row; lens == 0 rows exactly
    zero. Reach: the plain version over 32 fewer live keys, and over the
    cache of another batch entry (rolled by one), must fail nearly every
    row."""
    import torch
    from repro_torch.kernels.mla_decode import (mla_decode_attention,
                                                mla_decode_attention_plain)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        tol = MLA_TOL[name]
        for lens in (MLA_LENS, (0, 512, 1, 33)):
            args = mla_inputs(dtype, lens, 512, 41)
            out = mla_decode_attention(*args)
            ref = mla_decode_attention_plain(*args)
            bad, err, rel = mla_rows(out, ref, tol)
            zero_ok = all(not out[b].abs().max().item()
                          for b, n in enumerate(lens) if n == 0)
            if bad.any() or not zero_ok or out.dtype != dtype:
                fail(f"mla_decode_attention {name} lens {lens}: "
                     f"{float(bad.float().mean())} of the rows out of "
                     f"{tol}*max|row| (max err {err}), lens==0 rows zero "
                     f"{zero_ok}")
            reach = None
            if lens == MLA_LENS:
                short, rolled = list(args), list(args)
                short[4] = args[4] - 32
                rolled[2], rolled[3] = args[2].roll(1, 0), args[3].roll(1, 0)
                reach = {k: float(mla_rows(out, mla_decode_attention_plain(
                    *v), tol)[0].float().mean())
                    for k, v in (("32_keys_dropped", short),
                                 ("other_entry_cache", rolled))}
                if min(reach.values()) < 0.99:
                    fail(f"mla_decode_attention tolerance too loose: "
                         f"variants fail only {reach} of the rows")
            worst = max(worst, err)
            emit("mla_kernel_check", kernel="mla_decode_attention",
                 dtype=name, shape={"B": 4, "H": 128, "L": 512, "R": 64,
                                    "T": 512}, lens=list(lens),
                 max_abs_err=err, max_err_over_row_max=rel,
                 tol=f"{tol}*max|row| per (slot, head) row",
                 zero_rows_exact=True, reach_rows_failing=reach)
    return worst


def phase_cim_check_mla():
    """The CIM kernel against its plain version at the shapes cell F gives
    it: dq, dkv, uq, o and the shared expert at decode (M = 4) and in a
    prefill chunk (M = 32), uk/uv over the whole cache row (M = 320)."""
    import torch
    from repro_torch.core.sac import paper_sac
    g = torch.Generator(device="cuda").manual_seed(43)
    pol = paper_sac()
    shapes = [(m, 5120, 1536, pol.attn) for m in (4, 32)] + \
        [(m, 5120, 576, pol.attn) for m in (4, 32)] + \
        [(m, 1536, 24576, pol.attn) for m in (4, 32)] + \
        [(m, 16384, 5120, pol.attn) for m in (4, 32)] + \
        [(320, 512, 16384, pol.attn)] + \
        [(m, 5120, 3072, pol.mlp) for m in (4, 32)] + \
        [(m, 3072, 5120, pol.mlp) for m in (4, 32)]
    worst = rel = 0.0
    for m, k, n, spec in shapes:
        err, r = cim_case(g, m, random_plane(g, k, n, spec), spec)
        worst, rel = max(worst, err), max(rel, r)
    emit("kernel_check", kernel="cim_matmul_fused", arch="deepseek-v2-236b",
         cases=len(shapes), shapes=[list(x[:3]) for x in shapes],
         integer_part="exact", max_abs_err=worst, max_rel_err=rel,
         tol="1e-6*tiles*max|y| + 1e-5*sigma")
    return worst


def phase_mla_parity():
    """Reduced deepseek-v2 (2 layers, f32, 8 experts): greedy tokens on the
    card (MLA and CIM kernels) equal the CPU's (plain versions), in off
    and sim mode, with a 1-token prompt and a recycled slot."""
    import torch
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.mla_decode import mla_decode_attention
    from repro_torch.serving.engine import Engine, Request

    base = mla_config("off", reduced=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (40, 1, 90, 57)]
    res = {}
    for mode in ("off", "sim"):
        cfg = mla_config(mode, reduced=True)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        outs = {}
        mla_decode_attention.launches = 0
        for dev in ("cuda", "cpu"):
            eng = Engine(cfg, params, max_slots=2, max_len=128,
                         attn_impl="kernel", device=dev)
            outs[dev] = eng.generate([Request(prompt=p, max_new_tokens=8,
                                              rid=f"p{i}")
                                      for i, p in enumerate(prompts)])
        if outs["cuda"] != outs["cpu"] or mla_decode_attention.launches == 0:
            fail(f"reduced deepseek-v2 {mode}: tokens differ: cuda "
                 f"{outs['cuda']} vs cpu {outs['cpu']} (kernel launches "
                 f"{mla_decode_attention.launches})")
        res[mode] = outs["cuda"]
    emit("mla_token_parity", arch=base.name, requests=len(prompts),
         prompt_lens=[len(p) for p in prompts], new_tokens=8, equal=True,
         tokens=res)


def phase_serve_mla(params):
    """Cell F: deepseek-v2-236b at full width, 4 of 60 layers, bf16, sim
    mode, the session of cells A-E. Launch counts must hold exactly:
    mla_decode_attention 4 per decode step; cim_matmul_fused 9 per layer per
    chunk (dq, uq, dkv, uk, uv, o, shared gate/up/down) and 7 per layer per
    decode step (no uk/uv in the absorbed decode); no other kernel."""
    import gc
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.cim_matmul import cim_matmul_int8
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_gqa_attention)
    from repro_torch.kernels.fused_step import fused_dense_layer
    from repro_torch.kernels.mla_decode import mla_decode_attention
    from repro_torch.kernels.ssm_scan import ssm_decode_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx
    from repro_torch.serving.engine import Engine, Request

    cfg = mla_config()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=4, max_len=320, attn_impl="kernel",
                 record_ttft=True, record_steps=True, device="cuda")
    rng = np.random.default_rng(5)
    lens = (60, 300, 137, 95, 211, 64)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=16, rid=f"r{i}")
            for i, n in enumerate(lens)]
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention,
               fused_dense_layer, ssm_decode_step, mla_decode_attention)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    bad = [o for o in outs if not isinstance(o, list) or len(o) != 16
           or not all(0 <= t < cfg.vocab_size for t in o)]
    if bad:
        fail(f"deepseek-v2: failed, short or out-of-range requests: {bad}")
    ctx = Ctx.make(cfg, prng.PRNGKey(11), mode="sim")
    tokens = torch.from_numpy(reqs[0].prompt[:32]).cuda()[None]
    logits, _ = tf.forward(eng.params, {"tokens": tokens}, cfg, ctx,
                           tf.init_caches(cfg, 1, 32, "cuda"))
    if (tuple(logits.shape) != (1, 32, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        fail(f"deepseek-v2: logits {tuple(logits.shape)} not finite")
    n_chunks = sum(e["chunks"] for e in eng.step_log)
    n_decode = sum(e["decode"] for e in eng.step_log)
    L = cfg.n_layers
    expect = {"cim_matmul_fused": 9 * L * n_chunks + 7 * L * n_decode,
              "decode_attention": 0, "flash_gqa_attention": 0,
              "fused_dense_layer": 0, "ssm_decode_step": 0,
              "mla_decode_attention": L * n_decode}
    if counts != expect or n_decode == 0:
        fail(f"deepseek-v2: launches {counts} != expected {expect}")
    dec = [e["s"] for e in eng.step_log if e["decode"] and not e["chunks"]]
    toks = sum(len(o) for o in outs)
    ttft = [t for t in eng.ttft_s if t is not None]
    emit("serve_mla_full_width", arch=cfg.name, n_layers=L,
         reduced={"n_layers": "60 -> 4"}, dtype=cfg.dtype,
         requests=len(reqs), prompt_lens=list(lens), new_tokens=16, slots=4,
         tokens=toks, wall_s=wall, session_tok_per_s=toks / wall,
         chunks=n_chunks, decode_steps=n_decode,
         pure_decode_step_ms_mean=1e3 * float(np.mean(dec)),
         ttft_ms_mean=1e3 * float(np.mean(ttft)),
         ttft_ms_max=1e3 * float(np.max(ttft)),
         launches=counts, expected=expect, logits_finite=True,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def top_kernels(fn, n=3):
    """Names of the device kernels that one call of ``fn`` launched, by
    device time (the backend a library call picked)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
    return [k[:80] for k, _ in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def phase_times_mla():
    """Device ms (CUDA events, queued_ms; the profiler's beside) of one
    decode step's 4 latent-cache launches (B = 4,
    H = 128, L = 512, R = 64, bf16, the engine's cache of T = 320 rows, each
    layer its own cache, lens 301/138/96/212), the plain version's, one
    scaled_dot_product_attention call per layer over the same inputs (the
    yardstick: query [q_lat | q_rope], key [ckv | krope] and value ckv
    broadcast over the heads, a boolean length mask), the earlier body's
    time, and the bound of the tensor-core body: the live latent and rope
    rows, queries and outputs over 3.35 TB/s against the operations (2 (L +
    R) per score and 2 L per weighted latent row, per head and live key)
    over the bf16 peak; the f32-operations figure of the CUDA-core design
    beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mla_decode import (mla_decode_attention,
                                                mla_decode_attention_plain,
                                                mla_decode_plan)
    b, h, lat, rope, t = 4, 128, 512, 64, 320
    layers = [mla_inputs(torch.bfloat16, MLA_LENS, t, 70 + i)
              for i in range(MLA_LAYERS)]
    live = sum(MLA_LENS)
    nbytes = MLA_LAYERS * (live * (lat + rope) * 2 + b * h * (lat + rope) * 2
                           + b * h * lat * 2 + b * 4)
    ops = MLA_LAYERS * h * live * (2 * (lat + rope) + 2 * lat)

    def run_k():
        for a in layers:
            mla_decode_attention(*a)

    def run_p():
        for a in layers:
            mla_decode_attention_plain(*a)

    lib_in = []
    for ql, qr, ckv, kr, lens, scale in layers:
        q = torch.cat([ql, qr], -1)[:, :, None]            # (B, H, 1, 576)
        k = torch.cat([ckv, kr], -1)[:, None].expand(b, h, t, lat + rope)
        v = ckv[:, None].expand(b, h, t, lat)
        mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        lib_in.append((q, k, v, mask, scale))

    def run_lib():
        for q, k, v, mask, scale in lib_in:
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           scale=scale)

    # CUDA events behind a spinning kernel (queued_ms) for the kernel and
    # its yardstick; the profiler's figures beside them (its window for
    # this phase undercounts late in a long run)
    k_ms = queued_ms(run_k, 10)
    lib_ms = queued_ms(run_lib, 10)
    p_ms = device_ms(run_p, 3)
    bound = 1e3 * max(nbytes / HBM_BPS, ops / BF16_OPS)
    plan = mla_decode_plan(b, h, t, lat, torch.bfloat16)
    res = dict(ms=k_ms, profiler_ms=device_ms(run_k, 10),
               wall_ms=wall_ms(run_k, 10), plain_ms=p_ms, bound_ms=bound,
               bound_by="bytes" if nbytes / HBM_BPS >= ops / BF16_OPS
               else "operations",
               bound_f32_ops_ms=1e3 * ops / FP32_OPS,
               bound_bytes_ms=1e3 * nbytes / HBM_BPS,
               previous_body_ms=PREVIOUS_GQA_F32_MLA_MS[
                   "mla_decode_attention"],
               plan={k: plan[k] for k in ("heads", "block_k", "kbps",
                                          "n_split", "grid")},
               library_ms=lib_ms,
               library_profiler_ms=device_ms(run_lib, 3),
               library="scaled_dot_product_attention, bf16, kernels "
                       + ", ".join(top_kernels(run_lib)),
               unit=f"one decode step: {MLA_LAYERS} layers, B={b}, H={h}, "
                    f"L={lat}, R={rope}, T={t}, lens {list(MLA_LENS)}, bf16",
               launches_per_decode_step=MLA_LAYERS)
    emit("time", kernel="mla_decode_attention", **res, bytes=nbytes,
         ops=ops)
    return {"mla_decode_attention": res}


# ------------------------------------------------------------ phase 9
# the entry-point kernels: the straight-through CIM matmul ops.cim_matmul on
# the int8 kernel cim_matmul_int8, and the MHA flash attention
# flash_attention, at qwen2-0.5b width (the train CLI's batch 8 x seq 128)
INT32_OPS = 132 * 64 * 1.98e9   # H100 SXM: 64 INT32 lanes per SM at boost
NOISE_INT_OPS = 85     # integer operations per readout normal, see PERF.md
B2_M = 1024
B2_PROJ = (("q", 896, 896, "attn"), ("k", 896, 128, "attn"),
           ("v", 896, 128, "attn"), ("o", 896, 896, "attn"),
           ("gate", 896, 4864, "mlp"), ("up", 896, 4864, "mlp"),
           ("down", 4864, 896, "mlp"))
B2_RAGGED = ((100, 2048, 130), (1, 1024, 1), (8, 512, 8),
             (33, 2 * 512 + 61, 77))
# (name, BH, S, T, D, causal, per-batch-row starts or None, heads per row)
B5_SHAPES = (("qwen2_train", 112, 128, 128, 64, True, None, 14),
             ("qwen2_prefill_cache", 56, 32, 320, 64, True,
              (0, 96, 160, 288), 14),
             ("vit_small", 384, 65, 65, 64, False, None, 6),
             ("d128_cross", 16, 512, 1536, 128, False, None, 16),
             ("d128_causal", 16, 2048, 2048, 128, True, None, 16))


# the entry-point kernels' times before their redesign (CUDA events, final
# chip_smoke.py run of the PR 16 tree, H100 80GB HBM3 at 700 W): printed
# beside the new times for comparison, not measured here
PREVIOUS_B2_B5_MS = {"cim_matmul_int8": 1.354,
                     "cim_matmul_int8[noiseless]": 1.29,
                     "flash_attention": 3.264, "flash_attention[f32]": 3.313}


def b2_operands(g, m, k, n, spec):
    """int8 operands quantized from N(0, 1) at the spec's bits, and their
    scale xs * ws (what ops.cim_matmul hands the kernel)."""
    import torch
    from repro_torch.core import quant
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda")
    xq, xs, wq, ws = quant.quantize_operands(x, w, spec.in_bits, spec.w_bits)
    return xq.to(torch.int8), wq.to(torch.int8), xs * ws


def b2_shifted_plain(xq, wq, seed, sigma, scale):
    """Reach variant: the plain version with every tile's noise drawn at
    the next tile index."""
    import torch
    from repro_torch.core import prng
    m, k = xq.shape
    n = wq.shape[1]
    rows = torch.arange(m, device=xq.device)[:, None].expand(m, n)
    cols = torch.arange(n, device=xq.device)[None, :].expand(m, n)
    y = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for t in range(-(-k // 1024)):
        sl = slice(t * 1024, (t + 1) * 1024)
        s = (xq[:, sl].double() @ wq[sl].double()).float()
        y = y + (s + sigma * prng.tile_gaussian(seed[0], seed[1], t + 1,
                                                rows, cols))
    return y * scale


def b2_off(yk, yp, scale):
    """Elements out of the JAX package's slack: rtol 5e-6, atol 2e-3 *
    scale (Box-Muller's ulps)."""
    return (yk - yp).abs() > 5e-6 * yp.abs() + 2e-3 * scale


def phase_cim_int8_check():
    """The int8 CIM kernel against its plain version at qwen2-0.5b's seven
    CIM projections (M = 1024, paper_sac bits) and at ragged shapes over the
    whole int8 range: exact without noise; with noise within rtol 5e-6 /
    atol 2e-3 * scale (the error printed, expected 0). Reach: the plain
    version with the noise of the next tile index fails every row."""
    import torch
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels.cim_matmul import (cim_matmul_int8,
                                                cim_matmul_int8_plain)
    g = torch.Generator(device="cuda").manual_seed(51)
    pol = paper_sac()
    worst, reach = 0.0, 1.0
    cases = [(B2_M, k, n, getattr(pol, role), name)
             for name, k, n, role in B2_PROJ]
    cases += [(m, k, n, None, "ragged") for m, k, n in B2_RAGGED]
    for i, (m, k, n, spec, name) in enumerate(cases):
        if spec is None:
            xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                               dtype=torch.int8)
            scale, sigma = torch.tensor(0.0125, device="cuda"), 2.5
        else:
            xq, wq, scale = b2_operands(g, m, k, n, spec)
            sigma = output_noise_std_int_per_tile(spec, k)
        y0 = cim_matmul_int8(xq, wq, None, 0.0, scale)
        if not torch.equal(y0, cim_matmul_int8_plain(xq, wq, None, 0.0,
                                                     scale)):
            fail(f"cim_matmul_int8 integer part differs at {name} M={m} "
                 f"K={k} N={n}")
        seed = (0x12345678 + i, 0x9ABCDEF0 - i)
        yk = cim_matmul_int8(xq, wq, seed, sigma, scale)
        yp = cim_matmul_int8_plain(xq, wq, seed, sigma, scale)
        err = (yk - yp).abs().max().item()
        if b2_off(yk, yp, scale).any() or not torch.isfinite(yk).all():
            fail(f"cim_matmul_int8 noisy {name} M={m} K={k} N={n}: max err "
                 f"{err} (scale {scale.item()})")
        row_reach = None
        if spec is not None:
            ys = b2_shifted_plain(xq, wq, seed, sigma, scale)
            row_reach = float(b2_off(yk, ys, scale).any(-1).float().mean())
            reach = min(reach, row_reach)
        worst = max(worst, err)
        emit("cim_int8_check", kernel="cim_matmul_int8", shape=[m, k, n],
             projection=name, bits=None if spec is None else spec.in_bits,
             sigma=sigma, integer_part="exact", max_abs_err=err,
             max_err_over_scale=err / scale.item(),
             tol="5e-6*|y| + 2e-3*scale",
             shifted_tile_rows_failing=row_reach)
    if reach < 1.0:
        fail(f"cim_matmul_int8 tolerance too loose: the shifted-tile "
             f"variant fails only {reach} of the rows")
    return worst


def phase_cim_ste():
    """The straight-through ops.cim_matmul on the card at the seven
    projections (M = 1024, f32 x and w, noise on): the forward equals the
    plain int8 path on the same quantized operands, seed and scale; the
    gradients equal the f32 dequantized products within rtol 1e-6; exactly
    one int8-kernel launch per projection forward and none in backward."""
    import torch
    from repro_torch.core import prng, quant
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels import ops
    from repro_torch.kernels.cim_matmul import (cim_matmul_int8,
                                                cim_matmul_int8_plain)
    g = torch.Generator(device="cuda").manual_seed(52)
    pol = paper_sac()
    ins = []
    for i, (name, k, n, role) in enumerate(B2_PROJ):
        x = torch.randn((8, 128, k), generator=g, device="cuda")
        w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
        ins.append((name, getattr(pol, role), x.requires_grad_(True),
                    w.requires_grad_(True), prng.fold_in(prng.PRNGKey(7), i)))
    cim_matmul_int8.launches = 0
    t0 = time.perf_counter()
    ys = [ops.cim_matmul(x, w, spec, key) for _, spec, x, w, key in ins]
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = cim_matmul_int8.launches
    gys = [torch.randn(y.shape, generator=g, device="cuda") for y in ys]
    t0 = time.perf_counter()
    for y, gy in zip(ys, gys):
        y.backward(gy)
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    launches = cim_matmul_int8.launches
    if fwd_launches != len(B2_PROJ) or launches != fwd_launches:
        fail(f"ops.cim_matmul launches: {fwd_launches} in forward (want "
             f"{len(B2_PROJ)}), {launches - fwd_launches} in backward "
             f"(want 0)")
    worst = 0.0
    for (name, spec, x, w, key), y, gy in zip(ins, ys, gys):
        with torch.no_grad():
            k, n = w.shape
            x2 = x.reshape(-1, k)
            xq, xs, wq, ws = quant.quantize_operands(x2, w, spec.in_bits,
                                                     spec.w_bits)
            sigma = output_noise_std_int_per_tile(spec, k)
            yp = cim_matmul_int8_plain(xq.to(torch.int8), wq.to(torch.int8),
                                       prng.seed_from_key(key), sigma,
                                       xs * ws).reshape(8, 128, n)
            if (y.shape != (8, 128, n) or not torch.isfinite(y).all()
                    or b2_off(y, yp, xs * ws).any()):
                fail(f"ops.cim_matmul forward {name}: shape {tuple(y.shape)}"
                     f", max err {(y - yp).abs().max().item()}")
            g2 = gy.reshape(-1, n)
            dx = (g2 @ quant.dequantize(wq, ws).T).reshape(x.shape)
            dw = quant.dequantize(xq, xs).T @ g2
            for got, want, what in ((x.grad, dx, "dx"), (w.grad, dw, "dw")):
                rel = ((got - want).abs() / want.abs().clamp(min=1e-30)).max()
                if not (got - want).abs().le(1e-6 * want.abs()).all():
                    fail(f"ops.cim_matmul {what} {name}: max rel err "
                         f"{rel.item()} > 1e-6")
            worst = max(worst, (y - yp).abs().max().item())
    emit("cim_ste", entry="repro_torch.kernels.ops.cim_matmul",
         shapes=[[8, 128, k, n] for _, k, n, _ in B2_PROJ],
         launches_forward=fwd_launches,
         launches_backward=launches - fwd_launches,
         forward_max_abs_err_vs_plain=worst, grad_rtol=1e-6,
         forward_s=fwd_s, backward_s=bwd_s)
    return launches


def b5_inputs(g, bh, s, t, d, starts, heads, dtype):
    import torch
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((bh, s, d), (bh, t, d), (bh, t, d)))
    st = (None if starts is None else torch.tensor(
        starts, dtype=torch.int32, device="cuda").repeat_interleave(heads))
    return q, k, v, st


def b5_live(bh, s, t, causal, st):
    """Live keys of every (row, query): keys 0 .. n - 1, n = min(start + i
    + 1, start + S, T) when causal, T when not."""
    import torch
    if not causal:
        return torch.full((bh, s), t, dtype=torch.int64, device="cuda")
    st0 = (torch.zeros(bh, dtype=torch.int64, device="cuda") if st is None
           else st.long())
    pos = st0[:, None] + torch.arange(s, device="cuda")[None, :]
    return torch.minimum(pos + 1, torch.clamp(st0 + s, max=t)[:, None])


def b5_variant(q, k, v, upper):
    """Reach variant: attention over keys j < upper (per row, query), in the
    kernel's arithmetic (f32 scores, p in v's dtype, f32 sums)."""
    import torch
    d = q.shape[-1]
    sc = torch.einsum("bsd,btd->bst", q.float(), k.float()) * (d ** -0.5)
    kj = torch.arange(k.shape[1], device="cuda")
    sc = torch.where(kj[None, None, :] < upper[:, :, None], sc,
                     torch.full_like(sc, -1e30))
    p = torch.softmax(sc, -1)
    return torch.einsum("bst,btd->bsd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def b5_rows_off(out, ref, dtype):
    """Rows (one query over D) out of tolerance: f32 within 2e-5 + 2e-5
    |ref|; bf16 within 2^-7 of the row's max |ref| (one output rounding)."""
    import torch
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if dtype == torch.float32:
        return (err > 2e-5 + 2e-5 * ref.abs()).any(-1), err.max().item()
    scale = ref.abs().amax(-1, keepdim=True)
    return (err > 2 ** -7 * scale).any(-1), err.max().item()


def b5_counts(bh, s, t, d, causal, st, dtype):
    """Closed form of the kernel's block counts (its blocks: MHA_BLOCK_Q
    queries, MHA_BLOCK_K[dtype] keys; a q block's count summed over the
    blocks its key range is split over): causal query blocks count up to
    their frontier, non-causal ones every key block."""
    from repro_torch.kernels.flash_attention import MHA_BLOCK_K, MHA_BLOCK_Q
    bq, bk = MHA_BLOCK_Q, MHA_BLOCK_K[dtype]
    n_q = -(-s // bq)
    if not causal:
        return [[-(-t // bk)] * n_q for _ in range(bh)]
    starts = [0] * bh if st is None else st.tolist()
    return [[-(-min(starts[b] + min((i + 1) * bq, s), t) // bk)
             for i in range(n_q)] for b in range(bh)]


def phase_flash_mha_check():
    """flash_attention at every B5 shape in bf16 and f32, driven once per
    shape and dtype through the entry point (the launches counted), then
    held against its plain version (f32 2e-5 + 2e-5 |ref|, bf16 2^-7 of the
    row max), its block counts against the closed form, and its reach: the
    result over each row's live keys less the last 32 must fail every long
    row (more than 32 live keys). Head dims other than 64 and 128 raise."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(53)
    launches, worst = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        cases = [(shape, b5_inputs(g, *shape[1:5], shape[6], shape[7], dtype))
                 for shape in B5_SHAPES]
        flash_attention.launches = 0
        outs = [flash_attention(q, k, v, shape[5], st,
                                return_block_counts=True)
                for shape, (q, k, v, st) in cases]
        torch.cuda.synchronize()
        launches[name] = flash_attention.launches
        if launches[name] != len(B5_SHAPES):
            fail(f"flash_attention {name}: {launches[name]} launches for "
                 f"{len(B5_SHAPES)} calls")
        worst[name] = 0.0
        for (shape, (q, k, v, st)), (out, counts) in zip(cases, outs):
            sname, bh, s, t, d, causal = shape[:6]
            ref = flash_attention_plain(q, k, v, causal, st)
            bad, err = b5_rows_off(out, ref, dtype)
            if bad.any() or out.dtype != dtype or out.shape != q.shape:
                fail(f"flash_attention {name} {sname}: {bad.float().mean()} "
                     f"of the rows out of tolerance (max err {err})")
            want = b5_counts(bh, s, t, d, causal, st, dtype)
            if counts.tolist() != want:
                fail(f"flash_attention {name} {sname}: block counts differ "
                     f"from the closed form")
            live = b5_live(bh, s, t, causal, st)
            long_rows = live > 32
            short = b5_variant(q, k, v, live - 32)
            reach = (float(b5_rows_off(out, short, dtype)[0][long_rows]
                           .float().mean()) if long_rows.any() else None)
            if reach is not None and reach < 1.0:
                fail(f"flash_attention {name} {sname}: tolerance too loose: "
                     f"dropping the last 32 live keys fails only {reach} of "
                     f"the long rows")
            worst[name] = max(worst[name], err)
            emit("flash_mha_check", kernel="flash_attention", dtype=name,
                 shape=sname, BH=bh, S=s, T=t, D=d, causal=causal,
                 starts=None if shape[6] is None else list(shape[6]),
                 max_abs_err=err,
                 tol="2e-5+2e-5|ref|" if dtype == torch.float32
                 else "2^-7*max|ref row|",
                 block_counts="closed form", blocks_visited=int(
                     counts.sum()), long_rows=int(long_rows.sum()),
                 last_32_keys_dropped_long_rows_failing=reach)
    q = torch.zeros((2, 8, 96), device="cuda")
    try:
        flash_attention(q, q, q)
    except ValueError as e:
        emit("flash_mha_check", head_dim_96="raises", message=str(e))
    else:
        fail("flash_attention took head_dim 96")
    return launches, worst


def b2_bound(calls):
    """Bytes, int8 products and readout-noise integer operations of the
    int8 kernel over ``calls`` of (xq, wq, noise); bound = the larger of
    the bytes over 3.35 TB/s and the operations over their peak, the int8
    products on the tensor cores and the noise on the CUDA cores' INT32
    lanes (counted as running side by side)."""
    nbytes = ops8 = noise = 0
    for xq, wq, on in calls:
        m, k = xq.shape
        n = wq.shape[1]
        nbytes += m * k + k * n + 4 * m * n + 8
        ops8 += 2 * m * k * n
        noise += NOISE_INT_OPS * m * n * -(-k // 1024) if on else 0
    t_bytes = nbytes / HBM_BPS
    t_ops = max(ops8 / INT8_OPS, noise / INT32_OPS)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            dict(bytes=nbytes, int8_ops=ops8, noise_int_ops=noise,
                 bytes_ms=1e3 * t_bytes, int8_ms=1e3 * ops8 / INT8_OPS,
                 noise_ms=1e3 * noise / INT32_OPS))


def b5_work(bh, s, t, d, causal, st, dtype):
    """Bytes (q, k, v read once, out written once, starts) and operations
    (4 D per live (query, key) pair) of one flash_attention call."""
    import torch
    esz = 2 if dtype == torch.bfloat16 else 4
    nbytes = esz * d * (2 * bh * s + 2 * bh * t) + (0 if st is None
                                                    else 4 * bh)
    pairs = int(b5_live(bh, s, t, causal, st).sum())
    return nbytes, 4 * d * pairs


def phase_times_b2_b5():
    """Device ms of the two entry-point kernels (queued_ms) at the
    full-width shapes, their plain versions (graph_ms) and a library
    yardstick (queued_ms).
    B2: one forward of the seven qwen2-0.5b projections at M = 1024, noise
    on (7 launches); the yardstick torch._int_mm(xq, wq).float() * scale is
    the same function without the noise. B5: one launch at each shape and
    dtype; the yardstick scaled_dot_product_attention in the same dtype
    (is_causal, or a boolean mask for start offsets)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels.cim_matmul import (cim_int8_plan,
                                                cim_matmul_int8,
                                                cim_matmul_int8_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_mha_plan)
    g = torch.Generator(device="cuda").manual_seed(54)
    pol = paper_sac()
    calls = []
    for i, (name, k, n, role) in enumerate(B2_PROJ):
        spec = getattr(pol, role)
        xq, wq, scale = b2_operands(g, B2_M, k, n, spec)
        calls.append((xq, wq, wq.t().contiguous().t(), scale,
                      output_noise_std_int_per_tile(spec, k), (9, i)))

    def run_k(noise=True):
        for xq, wq, _, sc, sigma, seed in calls:
            cim_matmul_int8(xq, wq, seed if noise else None, sigma, sc)

    def run_p():
        for xq, wq, _, sc, sigma, seed in calls:
            cim_matmul_int8_plain(xq, wq, seed, sigma, sc)

    def run_lib():
        for xq, _, wcol, sc, *_ in calls:
            torch._int_mm(xq, wcol).float() * sc

    k_ms = queued_ms(run_k, 10)
    k0_ms = queued_ms(lambda: run_k(False), 10)
    p_ms = graph_ms(run_p, 2)
    lib_ms = queued_ms(run_lib, 10)
    # each projection alone, noise on, and its launch plan
    per_proj = {}
    for (name, k, n, _), (xq, wq, _, sc, sigma, seed) in zip(B2_PROJ, calls):
        per_proj[name] = dict(
            ms=queued_ms(lambda: cim_matmul_int8(xq, wq, seed, sigma, sc),
                         10),
            ms_noiseless=queued_ms(
                lambda: cim_matmul_int8(xq, wq, None, sigma, sc), 10),
            plan=cim_int8_plan(B2_M, k, n, xq.data_ptr(), wq.data_ptr()),
            plan_noiseless=cim_int8_plan(B2_M, k, n, xq.data_ptr(),
                                         wq.data_ptr(), False))
    bound, by, terms = b2_bound([(c[0], c[1], True) for c in calls])
    bound0 = b2_bound([(c[0], c[1], False) for c in calls])[0]
    res = {"cim_matmul_int8": dict(
        ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
        library_ms=lib_ms,
        library="torch._int_mm(xq, wq).float() * scale: the same products "
                "without the readout noise; kernels "
                + ", ".join(top_kernels(run_lib)),
        ms_noiseless=k0_ms, bound_ms_noiseless=bound0,
        previous_body_ms=PREVIOUS_B2_B5_MS["cim_matmul_int8"],
        previous_body_ms_noiseless=PREVIOUS_B2_B5_MS[
            "cim_matmul_int8[noiseless]"], per_projection=per_proj,
        unit="one forward of the seven qwen2-0.5b projections, M=1024, "
             "noise on (7 launches)", **terms)}
    emit("time", kernel="cim_matmul_int8", **res["cim_matmul_int8"])

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        peak = BF16_OPS if dtype == torch.bfloat16 else FP32_OPS
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
        for sname, bh, s, t, d, causal, starts, heads in B5_SHAPES:
            q, k, v, st = b5_inputs(g, bh, s, t, d, starts, heads, dtype)
            if st is None:
                mask = None
            else:
                qi = st.long()[:, None] + torch.arange(s, device="cuda")
                kj = torch.arange(t, device="cuda")
                mask = ((kj[None, None, :] <= qi[:, :, None])
                        & (kj[None, None, :] < (st.long() + s)[:, None, None])
                        )[:, None]
            q4, k4, v4 = q[:, None], k[:, None], v[:, None]

            def run_lib_b5():
                F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask,
                    is_causal=causal and mask is None)

            f_ms = queued_ms(lambda: flash_attention(q, k, v, causal, st), 10)
            f_p = graph_ms(lambda: flash_attention_plain(q, k, v, causal,
                                                          st), 3)
            f_lib = queued_ms(run_lib_b5, 10)
            nbytes, ops = b5_work(bh, s, t, d, causal, st, dtype)
            b_ms = 1e3 * max(nbytes / HBM_BPS, ops / peak)
            plan = flash_mha_plan(bh, s, t, d, dtype)
            emit("time", kernel="flash_attention", dtype=name, shape=sname,
                 ms=f_ms, plain_ms=f_p, library_ms=f_lib, bound_ms=b_ms,
                 block_q=plan["block_q"],
                 block_k=plan["block_k"], n_split=plan["n_split"],
                 grid=list(plan["grid"]),
                 bound_by="bytes" if nbytes / HBM_BPS >= ops / peak
                 else "operations", bytes=nbytes, ops=ops,
                 library="scaled_dot_product_attention, " + name
                         + ", kernels " + ", ".join(top_kernels(run_lib_b5)))
            for key, val in (("ms", f_ms), ("plain_ms", f_p),
                             ("library_ms", f_lib), ("bytes", nbytes),
                             ("ops", ops)):
                tot[key] += val
        t_b, t_o = tot["bytes"] / HBM_BPS, tot["ops"] / peak
        key = "flash_attention" + ("" if dtype == torch.bfloat16 else "[f32]")
        res[key] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"],
                        library_ms=tot["library_ms"],
                        bound_ms=1e3 * max(t_b, t_o),
                        bound_by="bytes" if t_b >= t_o else "operations",
                        previous_body_ms=PREVIOUS_B2_B5_MS[key],
                        unit="one launch at each of the five B5 shapes, "
                             + name)
        emit("time", kernel=key, **res[key], bytes=tot["bytes"],
             ops=tot["ops"])
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.cim_matmul import cim_matmul_int8
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_gqa_attention)
    from repro_torch.kernels.fused_step import fused_dense_layer
    from repro_torch.kernels.mla_decode import mla_decode_attention
    from repro_torch.kernels.ssm_scan import ssm_decode_step

    phase_device()
    cfg = full_config(False)
    errs = phase_kernels(cfg)
    phase_parity()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if not all(bool(torch.isfinite(v).all()) for v in
               (params["embed"]["e"], params["blocks"]["mlp"]["down"]["w"])):
        fail("non-finite parameters")
    runs = {int8: phase_serve(params, int8)[0] for int8 in (False, True)}
    for int8 in (False, True):
        for fused_step in (True, False):
            phase_profile(params, full_config(int8), fused_step=fused_step)
    times = phase_times(params, cfg)
    phase_behavioural_sim(params)
    phase_fuse_fallback()
    phase_whole_prompt_loop_parity()
    del params
    params32 = init_params(full_config32(False),
                           torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    errs.update({("fused", k): v
                 for k, v in phase_fused_check(params32).items()})
    fused = {int8: phase_serve_fused(params32, int8)
             for int8 in (False, True)}
    for int8 in (False, True):
        runs[("fused", int8)] = fused[int8][0]
    for int8 in (False, True):
        for fused_step in (True, False):
            phase_profile(params32, full_config32(int8), fuse_layer=True,
                          fused_step=fused_step)
    phase_profile(params32, full_config32(False), fused_step=False)
    phase_fused_reach(params32)
    phase_fused_tokens(params32, fused[False][1])
    times.update(phase_times_fused(params32))
    del params32
    gqa_f32_times, gqa_f32_errs = phase_times_gqa_f32()
    times.update(gqa_f32_times)
    errs.update(gqa_f32_errs)
    errs["ssm"] = phase_ssm_check()
    phase_ssm_parity()
    params_ssm = init_params(ssm_config(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    runs["ssm"] = phase_serve_ssm(params_ssm)
    for fused_step in (True, False):
        phase_profile(params_ssm, ssm_config(), fused_step=fused_step)
    times.update(phase_times_ssm())
    del params_ssm
    torch.cuda.empty_cache()
    errs["mla"] = phase_mla_check()
    errs["cim_matmul_fused"] = max(errs["cim_matmul_fused"],
                                   phase_cim_check_mla())
    phase_mla_parity()
    params_mla = init_params(mla_config(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    runs["mla"] = phase_serve_mla(params_mla)
    phase_profile(params_mla, mla_config())
    del params_mla
    torch.cuda.empty_cache()
    times.update(phase_times_mla())
    errs["cim_matmul_int8"] = phase_cim_int8_check()
    runs["ste"] = {"cim_matmul_int8": phase_cim_ste()}
    mha_launches, mha_errs = phase_flash_mha_check()
    runs["mha"] = {"flash_attention": mha_launches["bfloat16"],
                   "flash_attention[f32]": mha_launches["float32"]}
    errs["mha"] = mha_errs["bfloat16"]
    errs["mha[f32]"] = mha_errs["float32"]
    times.update(phase_times_b2_b5())
    src = {"cim_matmul_fused": ("src/repro_torch/csrc/cim_matmul.cu",
                                "src/repro/kernels/cim_matmul.py:340",
                                cim_matmul_fused, "cim_matmul_fused"),
           "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:185",
                                decode_attention, ("decode", False)),
           "decode_attention[int8]": (
               "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention.py:185",
               decode_attention, ("decode", True)),
           "flash_gqa": ("src/repro_torch/csrc/flash_gqa.cu",
                         "src/repro/kernels/flash_attention.py:409",
                         flash_gqa_attention, ("flash", False)),
           "flash_gqa[int8]": ("src/repro_torch/csrc/flash_gqa.cu",
                               "src/repro/kernels/flash_attention.py:409",
                               flash_gqa_attention, ("flash", True)),
           "flash_gqa[f32]": ("src/repro_torch/csrc/flash_gqa.cu",
                              "src/repro/kernels/flash_attention.py:409",
                              flash_gqa_attention, ("fused", False)),
           "flash_gqa[f32,int8]": (
               "src/repro_torch/csrc/flash_gqa.cu",
               "src/repro/kernels/flash_attention.py:409",
               flash_gqa_attention, ("fused", True)),
           "fused_dense_layer": ("src/repro_torch/csrc/fused_layer.cu",
                                 "src/repro/kernels/fused_step.py:327",
                                 fused_dense_layer, ("fused", False)),
           "fused_dense_layer[int8]": (
               "src/repro_torch/csrc/fused_layer.cu",
               "src/repro/kernels/fused_step.py:327",
               fused_dense_layer, ("fused", True)),
           "ssm_decode_step": ("src/repro_torch/csrc/ssm_scan.cu",
                               "src/repro/kernels/ssm_scan.py:140",
                               ssm_decode_step, "ssm"),
           "mla_decode_attention": ("src/repro_torch/csrc/mla_decode.cu",
                                    "src/repro/kernels/mla_decode.py:144",
                                    mla_decode_attention, "mla"),
           "cim_matmul_int8": ("src/repro_torch/csrc/cim_matmul.cu",
                               "src/repro/kernels/cim_matmul.py:275",
                               cim_matmul_int8, "cim_matmul_int8"),
           "flash_attention": ("src/repro_torch/csrc/flash_mha.cu",
                               "src/repro/kernels/flash_attention.py:204",
                               flash_attention, "mha"),
           "flash_attention[f32]": (
               "src/repro_torch/csrc/flash_mha.cu",
               "src/repro/kernels/flash_attention.py:204",
               flash_attention, "mha[f32]")}
    line = []
    for name, (path, tpu, fn, ekey) in src.items():
        t = times[name]
        # launches of the main-path run this entry's times describe (the
        # bf16 qwen2 cells A and B, the mamba2 cell E and the deepseek-v2
        # cell F for the CIM kernel, which they share; the entry-point
        # phases cim_ste and flash_mha_check for the int8 CIM and MHA
        # kernels; the float32 cells C and D for the fused layer and the
        # f32-query GQA prefill, whose error phase_times_gqa_f32 keys by
        # name)
        n = (runs[False][fn.__name__] + runs[True][fn.__name__]
             + runs["ssm"][fn.__name__] + runs["mla"][fn.__name__]
             if ekey == "cim_matmul_fused" else
             runs["ste"][name] if ekey == "cim_matmul_int8" else
             runs["mha"][name] if ekey in ("mha", "mha[f32]") else
             runs[ekey][fn.__name__] if ekey in ("ssm", "mla")
             or ekey[0] == "fused" else runs[ekey[1]][fn.__name__])
        line.append({"name": name, "route": "cuda", "source": path,
                     "replaces": tpu, "launches": n,
                     "max_abs_err": errs[name if name in errs else ekey],
                     "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
