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
launch counts, a profile of one fused decode step (replayed and per
call), fused vs unfused tokens and logits, and its times. Then the same
kernel past head dim 64: one layer of phi3-mini (head dim 96), zamba2-7b's
shared block (112), internlm2-1.8b, pixtral-12b and deepseek-67b (128 at
G 2, 4, 8) at full width against its plain version, each later stage
also on the kernel's own operands (``fused_wide_check``), one launch's
time beside its bound and the unfused layer step (``times_fused_wide``),
full-width internlm2-1.8b served fused replayed and per call and
phi3-mini and zamba2-7b at cut depth replayed, with exact launch counts
(``serve_fused_wide``), fused vs unfused tokens of reduced models at the
new head dims and internlm2's full-width off-mode logits
(``fused_vs_unfused_wide``). Then the ssm family: the mamba2
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
every published width and 1 of its 60 layers served with exact launch
counts and its peak memory, and the kernel's times (CUDA events) beside
one scaled_dot_product_attention call and the earlier body's time. The f32-query GQA prefill of the float32 cells is
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
their plain versions at head dims 128 (G 1, 2, 4, 8), 96 and 112 in every
dtype combination, at decode lengths on the split edges and flash starts past
the cache's end, and timed beside scaled_dot_product_attention and their
earlier times. The behavioural sim path (cim.use_kernel=False, what the
serving CLI's --cim sim runs): reduced-model tokens card vs CPU, and
qwen2-0.5b at full width (2 of its 24 layers) served with no CIM kernel
launch. And
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
models (``whole_prompt_loop_parity``). Last, the paper's own results:
SQNR, CSNR, column noise, the energy model and the FoMs measured on the
card and held against the port's CPU run and the paper's bands, with the
bit-exact SAR engine at 256x4096x512 (``paper_metrics``); noise-aware QAT
of the reference test's ViT and of vit-small-cifar at its published
width (6 of its 12 layers), evaluated
off, in behavioural sim and through the CIM kernel, which is held against
its plain version on the ViT's own operands, its logits against the
CPU's (``vit_qat``); full-width qwen2-0.5b trained in qat mode with a
checkpoint resume (``train_lm``); and the figure runner
(``paper_figures``). Then the registry's other archs: card-vs-CPU
greedy tokens of reduced olmoe-1b-7b, phi3-mini-3.8b (head dim 96),
internlm2-1.8b (head dim 128), pixtral-12b with a patch prefix,
zamba2-7b (hybrid; replayed and per call, which must agree in tokens and
launch counts) and whisper-medium (encdec, on stub frames)
(``arch_parity``); internlm2-1.8b, phi3-mini-3.8b, deepseek-67b (32 of
its 95 layers), pixtral-12b, olmoe-1b-7b (2 of its 16 layers) and
zamba2-7b (all 81) served at full width with exact launch counts, every
kernel call of a prefill chunk and of a decode step (the selective scan
too) held against its plain version on its own operands, the step's
logits kernels vs plain beside a control that must exceed the limit, its
device time, peak memory and pixtral's 1024-patch prefix; whisper-medium
at full width decoded by cached forwards, every kernel call of its
prefill (the encoder's CIM calls in its first and last layers) and of a
decode step held the same way (``serve_archs``); rows 2 and 3 at head
dims 96 and 112 timed on phi3's and zamba2's units
(``times_wide_heads``). The GQA kernels' shape checks and the MHA check
cover head dims 96 and 112 as well. The robustness layer: row 1 on a
stuck-at plane and under the guard's re-read spec against its plain
version, the stuck draw and the drift and fault epilogue card vs CPU
(``robust_kernel_checks``); the reduced qwen2 guarded with a faulted
slot and drifted with calibration, card vs CPU and replayed vs per call
(``robust_parity``); full-width qwen2-0.5b under the guard quiet, with a
faulted slot pinned against its pinned twin, on a stuck-at deploy, and
drifted with calibration replayed vs per call (``serve_robust``). The
front-end and the load ladder: full-width qwen2-0.5b replayed under
``DegradeLadder((None, 3, 1))`` driven through the front-end by a
scripted burst on a fake clock (sheds, deadlines, a client cancel,
admissions at rungs 1 and 2 and back at 0), the same script per call
giving every record, rung 0 = no ladder, and the ladder's noise card vs
CPU (``serve_frontend``). The replica router: full-width qwen2-0.5b
replicas of one seed, replayed, behind ``ReplicaRouter``: the same rid's
stream on two replicas, a kill mid-decode and mid-chunked-prefill and a
wedge, each equal to a single engine's streams, the kill in sim mode,
a guarded drift storm (4 of the 24 layers) that drains only its victim,
and the front-end over a pool that loses a replica (``serve_router``).
QAT serving: the reduced qwen2's first 4 tokens card = CPU in
``cim_mode="qat"``, full-width qwen2-0.5b served in qat per call with
its step's host and device ms and peak memory, ``fused_step=True``
raising (``serve_qat``). The four examples of the port through their
``main`` at cut sizes (``example_*``: the quickstart's metrics in the
paper's bands, the serving example replayed through rows 1-3). And
distribution (A7.1) on two spawned ranks of the one card over gloo:
the int8-compressed all-reduce bit-equal to its formula in one process,
a 2-stage pipeline through row 5 equal to the sequential stack in
outputs and gradients, and full-width qwen2-0.5b deployed on a (data 1,
model 2) mesh with every local shard bit-equal to its slice of the
whole plane and row 1 on the q and gate shards equal to the column
slices (``distributed``). Then the models' sharded forward (A7.2): row
1's row-parallel pair (``cim_tile_partials``, ``cim_tile_merge``) at
qwen2's o and down shards against its plain version and bit-equal to the
whole plane's launch, timed beside it (``tile_kernels``); full-width
qwen2-0.5b tensor-parallel on the same pair of ranks, (data 1, model 2),
against its one-rank forward (tokens, logits, row 1's shards bit-equal
with the noise on), and full-width olmoe-1b-7b (2 of 16 layers)
expert-parallel on four spawned ranks, (data 2, model 2), against the
grouped one-rank forward (``tensor_parallel``). Every phase prints one
JSON line; any failure exits non-zero. The last line is the device
record.
"""

from __future__ import annotations

import contextlib
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


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase; ``t_s``: seconds since the script began."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T0}), flush=True)


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


def device_breakdown(fn, n=5):
    """Device-busy ms of one ``fn()`` (after one warm-up) and its ``n``
    kernels with the most device time, (name, ms) each."""
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
            by[e.name[:60]] = by.get(e.name[:60], 0.0) + \
                e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return busy_ms(prof.events(), 1), top


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
    """The CIM kernel against its plain version on an (M, K) bf16 input
    (``cim_operands_check`` states the tolerance). Returns (max abs err,
    max err over max|y|)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.core.cim import output_noise_std_int_per_tile
    k, n = wq.shape
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(
        spec.in_bits)
    qp = torch.stack([xs, torch.ones_like(xs)])
    return cim_operands_check(x, wq, qp, (0x12345678 + m, 0x9ABCDEF0 + n),
                              output_noise_std_int_per_tile(spec, k),
                              spec.in_bits)


def cim_operands_check(x, wq, qp, seed, sigma, in_bits, row0=0, col0=0):
    """The CIM kernel against its plain version on the card, on the given
    operands (``row0``/``col0``: a shard's noise offsets): sigma = 0 gives
    the integer part, which must match exactly
    (both quantize x by the same IEEE division and rint; every tile sum is
    an integer below 2^24 and so is the f32 total); with the noise of
    ``seed``, Box-Muller's logf/cosf differ from the CPU's by ulps:
    tolerance 1e-6 * tiles * max|y| + 1e-5 * sigma, sigma in output units
    (times qp[1], the epilogue's scale), and the noise itself must exceed
    it. Returns (max abs err, max err over max|y|)."""
    import torch
    from repro_torch.kernels.cim_matmul import (cim_matmul_fused,
                                                cim_matmul_fused_plain)
    (m, k), n = x.shape, wq.shape[1]
    ex = cim_matmul_fused(x, wq, qp, None, 0.0, in_bits)
    ep = cim_matmul_fused_plain(x, wq, qp, None, 0.0, in_bits)
    if not torch.equal(ex, ep):
        fail(f"cim_matmul_fused integer part differs at M={m} K={k} N={n} "
             f"bits={in_bits} x {x.dtype}: {(ex - ep).abs().max().item()}")
    yk = cim_matmul_fused(x, wq, qp, seed, sigma, in_bits, row0, col0)
    yp = cim_matmul_fused_plain(x, wq, qp, seed, sigma, in_bits, row0, col0)
    err = (yk - yp).abs().max().item()
    tol = (1e-6 * -(-k // 1024) * yp.abs().max().item()
           + 1e-5 * sigma * abs(qp[1].item()))
    if not err <= tol:
        fail(f"cim_matmul_fused noisy M={m} K={k} N={n} x {x.dtype}: err "
             f"{err} > tol {tol}")
    if sigma > 0 and not (yp - ep).abs().max().item() > tol:
        fail(f"cim_matmul_fused M={m} K={k} N={n}: the tolerance {tol} "
             f"would pass a kernel that draws no noise")
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
    head dim 128 at G 1, 2, 4 and 8 (olmoe-1b-7b, internlm2-1.8b,
    pixtral-12b, deepseek-67b), head dim 64 at G 7 (qwen2) and G 1
    (whisper-medium's decoder), head dim 96 at
    G 1 (phi3-mini-3.8b) and G 4, head dim 112 at G 1 (zamba2-7b); decode
    lengths at the split edges (1, the split width - 1, + 1, T) on caches
    whose T is a multiple
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
    for d, g_, t in ((64, 7, 2000), (64, 7, 333), (64, 1, 300),
                     (128, 1, 333),
                     (128, 2, 300),
                     (128, 4, 257), (128, 8, 333), (96, 1, 333),
                     (96, 4, 2000), (112, 1, 300)):
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
    replayed steps or one per-call step (some 4000 launches and their host
    ops, whose read-back costs seconds a step). ``path`` names the sim path in the emitted line; ``fused_step``
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
    reps = 3 if replayed else 1
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
            for _ in range(reps):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
    cuda = torch.autograd.DeviceType.CUDA
    marks = {e.device_type == cuda: e.time_range for e in prof.events()
             if e.name == "measured"}
    events = [e for e in prof.events() if e.name != "measured" and (
        marks[True].start <= e.time_range.start
        and e.time_range.end <= marks[True].end
        if e.device_type == cuda else
        e.time_range.start >= marks[False].start)]
    counted = {f.__name__: (f.launches - before[f.__name__]) / reps
               for f in COUNTED if f.launches != before[f.__name__]}
    seen = kernels_seen(events, counted, reps)
    if replayed:
        recorded = {f.__name__: n
                    for f, n in eng._graphs["decode"].launches.items()}
        if (eng.replay_count - replays != reps or counted != recorded
                or seen != recorded):
            fail(f"profile {cfg.name} fuse_layer={fuse_layer}: a replayed "
                 f"step ran {seen} kernels by the profiler, counted "
                 f"{counted}, the decode graph recorded {recorded} "
                 f"({eng.replay_count - replays} replays in {reps} steps)")
    by_name, n_kernels, n_dispatch = {}, 0, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / (1e3 * reps))
        elif e.name in HOST_DISPATCHES:
            n_dispatch += 1
    busy = busy_ms(events, reps) if n_kernels else None
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
         device_launches=n_kernels // reps,
         host_dispatches=n_dispatch / reps,
         top_device_ms=[[n[:80], ms] for n, ms in top])
    return {"step_ms": 1e3 * plain_wall, "device_busy_ms": busy,
            "launches": n_kernels // reps}


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
# the full-width behavioural session's depth: 2 of qwen2-0.5b's 24 layers
# for the script's time (its eager Threefry draws take 6-9 s a layer; 4
# before the robustness phases came)
BEHAVIOURAL_LAYERS = 2


def phase_behavioural_sim(params):
    """Sim mode on the behavioural path (``cim.use_kernel=False``, the
    configs' default and what ``launch.serve --cim sim`` runs): every CIM
    linear is ``core.cim.cim_dense`` (exact integer dot on the card, one
    whole-K ``prng.normal`` draw in eager int64 Threefry ops), no CIM
    kernel. First the reduced qwen2's greedy tokens on the card equal the
    CPU's over 8 tokens; then qwen2-0.5b at full width and
    ``BEHAVIOURAL_LAYERS`` of its layers serves cell A's six requests, with cim_matmul_fused launched 0 times and the attention
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

    full = dataclasses.replace(full_config(False),
                               n_layers=BEHAVIOURAL_LAYERS,
                               cim=dataclasses.replace(full_config(False).cim,
                                                       use_kernel=False))
    params = dict(params, blocks={k: _tree_first(v, BEHAVIOURAL_LAYERS)
                                  for k, v in params["blocks"].items()})
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
         n_layers=L, reduced={"n_layers": f"24 -> {L}"}, requests=len(reqs), prompt_lens=list(lens), new_tokens=16, slots=4,
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
        # one repetition of the plain version: some 30000 eager launches,
        # whose profiler read-back costs seconds
        p_ms = device_ms(run_p, 1)
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


def tol_rows(a, b, tol):
    """Rows of ``a`` off ``b`` by more than ``tol`` of the row's max |b|:
    (mask, max err over the row max, max abs err)."""
    err = (a - b).abs()
    scale = b.abs().amax(-1, keepdim=True)
    return ((err > tol * scale).any(-1),
            float((err / scale.clamp(min=1e-30)).max()), float(err.max()))


def fused_rows(ko, kc, kp, po, pc, pp, lens):
    """Kernel (ko, kc, kp) against a plain run (po, pc, pp), row by row.
    Returns per-check boolean masks of rows out of tolerance and errors."""
    import torch

    def rows_off(a, b, tol):
        err = (a - b).abs()
        return (err > tol * b.abs().amax(-1, keepdim=True)).any(-1), err

    b, hd = ko.shape[0], kc["k"].shape[-1]
    h = kp["attn"].shape[1] // hd
    bad_x, ex = rows_off(ko[:, 0], po[:, 0], X_TOL)
    bad_a, ea = rows_off(kp["attn"].view(b, h, hd),
                         pp["attn"].view(b, h, hd), ATTN_TOL)
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


def fused_layer_check(cfg, layer, x, cache, key, mode="sim", **tags):
    """One fused-layer launch against its plain version on the same
    inputs (``cfg``'s cache type; in sim mode the plain version runs on
    the kernel's seven activation scales), the rows of ``fused_rows``
    held to X_TOL, ATTN_TOL and ROW_TOL, int8 codes equal or one apart.
    Each later stage is also held on the kernel's own operands (the plain
    version fed the kernel's attention output, x1 and hm): x1, hm and
    x_out within X_TOL of each row's max. The plain version's own chain
    may put a quantized input of o, gate/up or down in the next bucket
    where its float order moved it by an ulp (a row with such a flip;
    deepseek-67b's 4 x 8192 attention outputs held one), and the
    quantized layers after it amplify that: its x_out is held only in
    rows without a flip. In sim mode also: each scale within 1 ulp of the
    scale of an f64 mean over the kernel's own stage inputs (the plain
    version's f32 mean is reported beside it: its own summation error
    reached 4 ulps over the 19456 inputs of qwen2's ``down``), and each
    wrong plain variant must fail in every row it touches: every row that
    it moves past the tolerance from the right plain version. Emits a
    kernel_check line (``tags`` added); returns the worst x_out error."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fused_step import (fused_dense_layer,
                                                fused_dense_layer_plain)
    from repro_torch.models.layers import Ctx

    lens = [int(n) for n in cache["len"].tolist()]
    sim = mode == "sim"

    def clone():
        return {k: v.clone() for k, v in cache.items()}

    kc, kp = clone(), {}
    ko, _ = fused_dense_layer(Ctx.make(cfg, key, mode=mode), layer, x, kc,
                              probe=kp)
    torch.cuda.synchronize()
    grid = fused_dense_layer.grid

    def plain(scales, feed=None):
        pc, pp = clone(), {}
        po, _ = fused_dense_layer_plain(Ctx.make(cfg, key, mode=mode),
                                        layer, x, pc, scales=scales,
                                        probe=pp, feed=feed)
        return po, pc, pp

    scales = kp["scales"] if sim else None
    po, pc, pp = plain(scales)
    res = fused_rows(ko, kc, kp, po, pc, pp, lens)
    so, _, sp = plain(scales, feed=kp)
    stage = {n: tol_rows(a, r, X_TOL) for n, (a, r) in (
        ("x1", (kp["x1"], sp["x1"])), ("hm", (kp["hm"], sp["hm"])),
        ("x_out", (ko[:, 0], so[:, 0])))}
    ctx = Ctx.make(cfg, key, mode="sim")
    flipped = torch.zeros(ko.shape[0], dtype=torch.bool, device=ko.device)
    # the kernel's scales against the f64 mean of its own stage inputs
    # (rounded once to f32, then the kernel's f32 steps), and against the
    # plain version's own f32-mean scales, whose summation error alone
    # reaches a few ulps at B * d_ff elements; flips: quantized
    # activations that the kernel's scales put in another bucket than the
    # plain version's own (q/k/v and gate/up share one scale)
    su, su_own, flips = [], [], 0
    if sim:
        _, _, own = plain(None)
        for i, role in ((0, "attn_qkv"), (3, "attn_out"), (4, "mlp_in"),
                        (6, "mlp_out")):
            qm = quant.qmax(ctx.spec_for(role).in_bits)
            m = torch.mean(sp["acts"][i].double() ** 2).float()
            exact = cfg.cim.act_clip_sigmas * (torch.sqrt(m) + 1e-8) / qm
            su.append(int(ulps(kp["scales"][i], exact)))
            su_own.append(int(ulps(kp["scales"][i], own["scales"][i])))
            act = own["acts"][i]
            a = torch.clamp(torch.round(act / own["scales"][i]), -qm, qm)
            b = torch.clamp(torch.round(act / kp["scales"][i]), -qm, qm)
            flips += int((a != b).sum())
            if i:           # the kernel's stage input against the chain's
                a = torch.clamp(torch.round(sp["acts"][i] / kp["scales"][i]),
                                -qm, qm)
                b = torch.clamp(torch.round(pp["acts"][i] / kp["scales"][i]),
                                -qm, qm)
                flipped |= (a != b).any(-1)
    bad = {k: float(res[k].float().mean()) for k in ("attn", "kv")}
    bad["x"] = float((res["x"] & ~flipped).float().mean())
    bad.update({f"stage_{n}": float(v[0].float().mean())
                for n, v in stage.items()})
    what = f"fused_dense_layer {tags} {mode} int8={cfg.kv_cache_int8}"
    if (any(bad.values()) or max(su, default=0) > 1 or not res["lens_equal"]
            or not res["untouched_equal"]
            or not bool(torch.isfinite(ko).all())):
        fail(f"{what}: rows out of tolerance {bad}, scale ulps {su}, lens "
             f"equal {res['lens_equal']}, untouched "
             f"{res['untouched_equal']}, x err {res['x_err']}, attn err "
             f"{res['attn_err']}, kv err {res['kv_err']}, flipped rows "
             f"{flipped.tolist()}")
    reach = {}
    for kind in ("no_current", "kv_seeds_swapped") if sim else ():
        with plain_variant(kind):
            vo, vc, vp = plain(scales)
        r = fused_rows(ko, kc, kp, vo, vc, vp, lens)
        # the rows the variant moves past the tolerance from the right
        # plain version: each must fail against the kernel
        t = fused_rows(po, pc, pp, vo, vc, vp, lens)
        field = "attn" if kind == "no_current" else "kv"
        caught, touched = r[field], t[field]
        reach[kind] = {"rows_touched": float(touched.float().mean()),
                       "rows_failing": float(caught.float().mean()),
                       "x_rows_failing": float(r["x"].float().mean())}
        if not bool(touched.any()) or bool((touched & ~caught).any()):
            fail(f"{what}: tolerance too loose: the {kind} variant "
                 f"{reach[kind]}")
    emit("kernel_check", kernel="fused_dense_layer", **tags, mode=mode,
         head_dim=cfg.hd, heads=[cfg.n_heads, cfg.n_kv_heads],
         int8_cache=cfg.kv_cache_int8, lens=[n + 1 for n in lens],
         grid=grid, max_abs_err=res["x_err"],
         max_err_over_row_max=res["x_err_over_row_max"],
         rows_with_a_flip=int(flipped.sum()),
         stage_err_over_row_max={n: v[1] for n, v in stage.items()},
         attn_max_abs_err=res["attn_err"], kv_row_max_err=res["kv_err"],
         int8_codes_off_by_one=res["int8_codes_off_by_one"],
         scale_ulps_vs_f64_mean=su, scale_ulps_vs_plain_f32_mean=su_own,
         scales=kp["scales"].tolist(),
         quantized_activations_flipped=flips,
         tol={"x_out": "2^-10*max|row|", "attn": "2^-12*max|row|",
              "kv_rows": "1e-6 relative; int8 codes +-1",
              "stages": "2^-10*max|row| on the kernel's operands",
              "scales": "1 ulp of the f64 mean's scale"},
         reach=reach)
    return max(res["x_err"] if not bool(flipped.any()) else 0.0,
               max(v[2] for v in stage.values()))


def phase_fused_check(params32):
    """The fused-layer kernel against its plain version at full width
    (float32 qwen2-0.5b, sim mode, 4 slots, lens 300/137/95/211 after the
    write), f32 and int8 caches (``fused_layer_check``)."""
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy
    from repro_torch.models import transformer as tf

    worst = {}
    for int8 in (False, True):
        cfg = full_config32(int8)
        layer = tf._index(deploy(cfg, params32)["blocks"], 3)
        x, cache = fused_inputs(cfg, 320, 21 + int8)
        worst[int8] = fused_layer_check(cfg, layer, x, cache,
                                        prng.PRNGKey(77))
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
        p_ms = device_ms(run(fused_dense_layer_plain), 1)   # as phase_times
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


# ------------------------------------------------------------ phase 6b
# the fused decode layer past head dim 64: one layer of each arch the
# reference fuses (``_use_fused_layer``) at its published width, float32,
# sim mode on deployed planes: phi3-mini (hd 96, G 1), zamba2-7b's shared
# block (hd 112, G 1), internlm2-1.8b, pixtral-12b and deepseek-67b (hd 128
# at G 2, 4 and 8)
WIDE_FUSED = ("phi3-mini-3.8b", "zamba2-7b", "internlm2-1.8b", "pixtral-12b",
              "deepseek-67b")
# the kernels line's entry of each new head dim: the arch that serves it
WIDE_ROW = {96: "phi3-mini-3.8b", 112: "zamba2-7b", 128: "internlm2-1.8b"}
# serve_fused_wide's replayed-only runs, depth cut for the script's time:
# phi3-mini 4 of 32 layers, zamba2-7b 2 super-blocks (6 of 81 layers)
WIDE_SERVED_LAYERS = {"phi3-mini-3.8b": 4, "zamba2-7b": 6}


def wide_config(arch, int8=False, mode="sim", **over):
    """``arch`` at its published width in float32 on the CIM kernel path
    and kernel attention; ``over`` replaces fields (n_layers)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, dtype="float32", kv_cache_int8=int8, attn_impl="kernel", **over,
        cim=dataclasses.replace(cfg.cim, mode=mode, use_kernel=True))


def wide_layer(arch):
    """One deployed layer of ``arch`` at its published width, weights from
    seed 0: layer 0 of a one-layer model (zamba2: the shared block of a
    one-super-block model). The deployed tree keeps the f32 ``w`` leaves,
    so off mode runs on it too."""
    import torch
    from repro_torch.core.deploy import deploy, init_params
    from repro_torch.models import transformer as tf
    cfg = wide_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.attn_period or 1)
    params = deploy(cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    if cfg.family == "hybrid":
        return params["shared_attn"]
    return tf._index(params["blocks"], 0)


def fused_layer_work(cfg, layer, lens=FUSED_OLD_LENS):
    """Bytes and operations one fused launch must spend at ``lens`` (old
    lengths; f32 cache), by ``phase_times_fused``'s count: the seven int8
    planes, their scales, the q/k/v biases where the layer has them, the
    gains, x in and out, the live keys and values, lens in and out;
    2 B operations per plane byte (int8) and 4 hd per live (query head,
    key) pair (f32)."""
    b, d, h, kv, hd = (len(lens), cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.hd)
    live = sum(n + 1 for n in lens)
    planes = sum(v.numel() for grp in ("attn", "mlp")
                 for leaf in layer[grp].values()
                 for k_, v in leaf.items() if k_.startswith("wq"))
    bias = 4 * (h * hd + 2 * kv * hd) if "b" in layer["attn"]["q"] else 0
    nbytes = (planes + 7 * 4 + bias + 2 * d * 4 + 2 * b * d * 4
              + 2 * live * kv * hd * 4 + 2 * b * 4)
    return nbytes, 2 * b * planes, 4 * live * h * hd


def fused_wide_time(arch, cfg, layer):
    """times_fused_wide at one shape: one fused launch's device ms (B = 4,
    lens 300/137/95/211 after the write, f32 cache, sim) by CUDA events
    around replays of a CUDA graph of it (the profiler saw none of these
    single launches in the full script's run), its plain version's and
    the unfused float32 layer's decode step on the same inputs
    (``transformer._dense_block``: rows 1 and 2 and eager ops) by the
    profiler, and the bound by ``phase_times_fused``'s formula."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.fused_step import (fused_dense_layer,
                                                fused_dense_layer_plain,
                                                fused_layer_plan)
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    key = prng.PRNGKey(9)
    b = len(FUSED_OLD_LENS)
    pos = torch.tensor(FUSED_OLD_LENS, device="cuda")[:, None]

    def run(fn):
        # fresh inputs for each measurement: every call advances lens by
        # one, at most 11 times per measurement
        x, c = fused_inputs(cfg, 320, 50)
        return lambda: fn(x, c)

    k_ms = graph_ms(run(lambda x, c: fused_dense_layer(
        Ctx.make(cfg, key, mode="sim"), layer, x, c)), 10)
    grid = fused_dense_layer.grid
    p_ms = device_ms(run(lambda x, c: fused_dense_layer_plain(
        Ctx.make(cfg, key, mode="sim"), layer, x, c)), 2)
    u_ms = device_ms(run(lambda x, c: tf._dense_block(
        Ctx.make(cfg, key, mode="sim", deployed=True), layer, x, pos, c)),
        10)
    nbytes, int8_ops, f32_ops = fused_layer_work(cfg, layer)
    t_ops = int8_ops / INT8_OPS + f32_ops / FP32_OPS
    bound = 1e3 * max(nbytes / HBM_BPS, t_ops)
    plan = fused_layer_plan(b, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_ff, 320, cfg.hd)
    res = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
               bound_by="bytes" if nbytes / HBM_BPS >= t_ops
               else "operations", library_ms=None, unfused_step_ms=u_ms,
               unit=f"one launch: {arch}'s layer, B={b}, f32 cache, lens "
                    + str([n + 1 for n in FUSED_OLD_LENS]),
               grid=grid, splits={k_: [s_["units"] * s_["planes"],
                                       s_["n_split"], s_["klen"]]
                                  for k_, s_ in plan["stages"].items()})
    emit("times_fused_wide", arch=arch, head_dim=cfg.hd,
         group=cfg.n_heads // cfg.n_kv_heads, **res, bytes=nbytes,
         int8_ops=int8_ops, f32_ops=f32_ops)
    return res


def phase_fused_wide():
    """fused_wide_check: the kernel against its plain version at the five
    full-width shapes of ``WIDE_FUSED`` (``fused_layer_check``: sim mode,
    f32 and int8 caches, the wrong variants' reach; one off-mode case at
    each head dim), then times_fused_wide at each shape
    (``fused_wide_time``). Returns the worst x_out error and the times by
    arch, and the phase's seconds."""
    import gc
    import torch
    from repro_torch.core import prng

    t0 = time.perf_counter()
    errs, times, off_done = {}, {}, set()
    for arch in WIDE_FUSED:
        layer = wide_layer(arch)
        cfg = wide_config(arch)
        worst = 0.0
        for int8 in (False, True):
            c = wide_config(arch, int8)
            x, cache = fused_inputs(c, 320, 31 + int8)
            worst = max(worst, fused_layer_check(c, layer, x, cache,
                                                 prng.PRNGKey(78),
                                                 arch=arch))
        if cfg.hd not in off_done:
            off_done.add(cfg.hd)
            x, cache = fused_inputs(cfg, 320, 33)
            worst = max(worst, fused_layer_check(
                wide_config(arch, mode="off"), layer, x, cache,
                prng.PRNGKey(78), mode="off", arch=arch))
        errs[arch] = worst
        times[arch] = fused_wide_time(arch, cfg, layer)
        del layer
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit("fused_wide_check", archs=list(WIDE_FUSED),
         head_dims=sorted(off_done), max_abs_err=errs, seconds=seconds)
    return errs, times, seconds


def phase_serve_fused_wide():
    """serve_fused_wide, the slice's path: full-width float32
    internlm2-1.8b (24 layers, hd 128, G 2) with fuse_layer=True, sim on
    deployed planes, through the engine replayed and per call
    (``graph_vs_eager``: equal tokens and launches): every decode step is
    one fused launch a layer, prefill chunks stay on rows 1 and 3. Then
    phi3-mini (hd 96, 4 of 32 layers) and zamba2-7b (hd 112, 2
    super-blocks) at full width, replayed only. Launch counts must hold
    exactly. Returns the fused launches by head dim, internlm2's
    parameters and the phase's seconds."""
    import gc
    import torch
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.kernels.fused_step import fused_dense_layer
    from repro_torch.kernels.ssm_scan import ssm_decode_step
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention,
               fused_dense_layer, ssm_decode_step)
    launches, params_g = {}, None
    for arch in ("internlm2-1.8b",) + tuple(WIDE_SERVED_LAYERS):
        cfg = wide_config(arch, **({"n_layers": WIDE_SERVED_LAYERS[arch]}
                                   if arch in WIDE_SERVED_LAYERS else {}))
        params = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        if arch == "internlm2-1.8b":
            eng, reqs, outs, counts, wall = graph_vs_eager(
                "internlm2-fused", cfg, params, kernels, fuse_layer=True)
            params_g = params
        else:
            eng, reqs, outs, counts, wall = run_session(
                cfg, params, kernels, True, fuse_layer=True)
            if (not eng.fused_ok or eng.fallbacks
                    or not all(e["graph"] for e in eng.step_log)):
                fail(f"serve_fused_wide {arch}: left the graphs "
                     f"({eng.fallbacks} fallbacks)")
        bad = [o for o in outs if not isinstance(o, list) or len(o) != 16
               or not all(0 <= t < cfg.vocab_size for t in o)]
        if bad:
            fail(f"serve_fused_wide {arch}: failed, short or out-of-range "
                 f"requests: {bad}")
        n_chunks = sum(e["chunks"] for e in eng.step_log)
        n_decode = sum(e["decode"] for e in eng.step_log)
        if cfg.family == "hybrid":
            n_super, n_mamba = tf.hybrid_dims(cfg)
            n_attn, n_ssm = n_super, n_super * n_mamba
        else:
            n_attn, n_ssm = cfg.n_layers, 0
        # a decode step: one fused launch an attention layer (its seven
        # projections inside), the mamba layers' in/out projections on
        # row 1; a chunk: seven row-1 calls an attention layer and two a
        # mamba layer, one flash call an attention layer
        expect = {"fused_dense_layer": n_attn * n_decode,
                  "decode_attention": 0,
                  "cim_matmul_fused": (7 * n_attn + 2 * n_ssm) * n_chunks
                  + 2 * n_ssm * n_decode,
                  "flash_gqa_attention": n_attn * n_chunks,
                  "ssm_decode_step": n_ssm * n_decode}
        if counts != expect or n_decode == 0:
            fail(f"serve_fused_wide {arch}: launches {counts} != expected "
                 f"{expect}")
        launches[cfg.hd] = counts["fused_dense_layer"]
        emit("serve_fused_wide", arch=arch, n_layers=cfg.n_layers,
             head_dim=cfg.hd, group=cfg.n_heads // cfg.n_kv_heads,
             dtype=cfg.dtype, replayed_and_per_call=arch == "internlm2-1.8b",
             requests=len(reqs), prompt_lens=list(SESSION_LENS),
             new_tokens=16, slots=4, chunks=n_chunks, decode_steps=n_decode,
             launches=counts, expected=expect,
             **session_numbers(eng, outs, wall))
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return launches, params_g, time.perf_counter() - t0


def phase_fused_tokens_wide(params_g):
    """Fused against unfused at the new head dims, as
    ``phase_fused_tokens``: greedy tokens of reduced float32 sim models on
    the card equal at hd 96 (phi3-mini, G 1), hd 112 (zamba2-7b's hybrid,
    G 1) and hd 128 (internlm2, G 2; deepseek-67b with 8 heads on one KV
    head, G 8), the fused engine launching the kernel and the unfused one
    not; at full width in off mode the first decode step's logits of
    internlm2-1.8b within 2^-10 of each row's max |logit| of the unfused
    step's. Returns the phase's seconds."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.fused_step import fused_dense_layer
    from repro_torch.serving.engine import Engine, Request

    t0 = time.perf_counter()
    cases = {"hd96 G1 phi3-mini": ("phi3-mini-3.8b", {"head_dim": 96}),
             "hd112 G1 zamba2-7b": ("zamba2-7b", {"head_dim": 112}),
             "hd128 G2 internlm2": ("internlm2-1.8b", {"head_dim": 128}),
             "hd128 G8 deepseek-67b": ("deepseek-67b", {
                 "head_dim": 128, "n_heads": 8, "n_kv_heads": 1})}
    reduced = {}
    for name, (arch, over) in cases.items():
        base = dataclasses.replace(get_config(arch).reduced(), **over)
        cfg = dataclasses.replace(base, cim=dataclasses.replace(
            base.cim, mode="sim", use_kernel=True))
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]
        outs, fused = [], []
        for fuse in (True, False):
            eng = Engine(cfg, params, max_slots=2, max_len=128,
                         attn_impl="kernel", fuse_layer=fuse, device="cuda")
            fused_dense_layer.launches = 0
            outs.append(eng.generate([Request(prompt=p, max_new_tokens=8)
                                      for p in prompts]))
            fused.append(fused_dense_layer.launches)
        if outs[0] != outs[1] or not fused[0] or fused[1]:
            fail(f"fused tokens {name}: {outs[0]} != unfused {outs[1]} or "
                 f"fused launches {fused}")
        reduced[name] = {"tokens_equal": True, "fused_launches": fused[0],
                         "tokens": outs[0]}
    cfg = wide_config("internlm2-1.8b")
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=16, rid=f"r{i}")
            for i, n in enumerate(SESSION_LENS)]
    off = first_step_logits(cfg, params_g, "off", reqs)
    off_rel = rel_rows(off["fused"], off["unfused"])
    if (not bool(torch.isfinite(off["fused"]).all())
            or max(off_rel) > 2 ** -10):
        fail(f"internlm2-1.8b off-mode first-step logits fused vs unfused: "
             f"max err / row max {off_rel}")
    seconds = time.perf_counter() - t0
    emit("fused_vs_unfused_wide", reduced=reduced,
         internlm2_off_first_step_logits_err_over_row_max=off_rel,
         off_tol="2^-10*max|row|", seconds=seconds)
    return seconds


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
# the moe family with MLA attention: deepseek-v2-236b at full width, every
# decode step of every layer through the latent-cache kernel
# mla_decode_attention; the kernel's times over four layers' caches, the
# served cell F at one of its 60 layers (four, the depth one card holds,
# until the session's 55 s were cut to two, then one, for the script's
# time)
MLA_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}   # times the row's max
MLA_LENS = (301, 138, 96, 212)         # the session's lengths + the token
MLA_LAYERS = 4
MLA_SERVED_LAYERS = 1


def mla_config(mode="sim", reduced=False):
    from repro_torch.configs.registry import get_config
    cfg = get_config("deepseek-v2-236b")
    cfg = (cfg.reduced() if reduced
           else dataclasses.replace(cfg, n_layers=MLA_SERVED_LAYERS))
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
    """Cell F: deepseek-v2-236b at full width, 1 of 60 layers, bf16, sim
    mode, the session of cells A-E. Launch counts must hold exactly:
    mla_decode_attention 4 per decode step; cim_matmul_fused 9 per layer per
    chunk (dq, uq, dkv, uk, uv, o, shared gate/up/down) and 7 per layer per
    decode step (no uk/uv in the absorbed decode); no other kernel."""
    import gc
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.cim_matmul import cim_matmul_int8
    from repro_torch.kernels.cim_matmul import (cim_tile_merge,
                                                cim_tile_partials)
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
         reduced={"n_layers": f"60 -> {L}"}, dtype=cfg.dtype,
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
# head dims 96 (phi3-mini-3.8b's training attention, 32 heads) and 112
# (zamba2-7b's 32 heads over a prefix cache): checked, not timed
B5_NEW_D = (("d96_causal", 32, 256, 256, 96, True, None, 32),
            ("d112_prefill_cache", 32, 48, 400, 112, True,
             (0, 100, 352, 5), 8),
            ("d112_cross", 16, 96, 700, 112, False, None, 16))


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
    row (more than 32 live keys); also at head dims 96 and 112
    (``B5_NEW_D``). Head dims other than 64, 96, 112 and 128 raise."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(53)
    launches, worst = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        cases = [(shape, b5_inputs(g, *shape[1:5], shape[6], shape[7], dtype))
                 for shape in B5_SHAPES + B5_NEW_D]
        flash_attention.launches = 0
        outs = [flash_attention(q, k, v, shape[5], st,
                                return_block_counts=True)
                for shape, (q, k, v, st) in cases]
        torch.cuda.synchronize()
        launches[name] = flash_attention.launches
        if launches[name] != len(cases):
            fail(f"flash_attention {name}: {launches[name]} launches for "
                 f"{len(cases)} calls")
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
    q = torch.zeros((2, 8, 80), device="cuda")
    try:
        flash_attention(q, q, q)
    except ValueError as e:
        emit("flash_mha_check", head_dim_80="raises", message=str(e))
    else:
        fail("flash_attention took head_dim 80")
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



# ------------------------------------------------------ the paper's results
# the paper's anchors (tests/test_cim.py, test_adc.py, test_energy.py,
# test_system.py): each measured number must fall in its band
PAPER = {"sqnr_db": (45.3, 2.0), "csnr_db": (31.3, 2.0),
         "noise_wo_cb_lsb": (1.16, 0.12), "noise_w_cb_lsb": (0.58, 0.06),
         "peak_tops_w_1b": (818.0, 1.0)}
METRIC_DB_TOL = 0.1     # card vs CPU, dB (an erf ulp can flip a decision)
METRIC_LSB_TOL = 0.01   # card vs CPU, LSB
BIT_EXACT_SHAPE = (256, 4096, 512)   # benchmarks/kernel_bench.py's shape


def _metric_numbers(dev):
    """Every paper-metrics number of the port at the JAX functions' default
    sizes, on ``dev``."""
    from repro_torch.core import adc, energy, metrics
    from repro_torch.core.cim import CIMSpec
    spec = CIMSpec(cb=True)
    ch = metrics.column_characteristics(spec, device=dev)
    out = {
        "sqnr_db": metrics.measure_sqnr_db(spec, device=dev),
        "csnr_db": metrics.measure_csnr_db(spec, device=dev),
        "csnr_wo_cb_db": metrics.measure_csnr_db(CIMSpec(cb=False),
                                                 device=dev),
        "total_csnr_db": metrics.measure_total_csnr_db(spec, device=dev),
        "column_noise_lsb_mean": float(np.mean(ch["noise_lsb"])),
        "column_max_inl_lsb": float(np.max(np.abs(ch["inl"]))),
        "noise_wo_cb_lsb": adc.conversion_noise_lsb(adc.ADCSpec(), False,
                                                    device=dev),
        "noise_w_cb_lsb": adc.conversion_noise_lsb(adc.ADCSpec(), True,
                                                   device=dev),
        "conventional_8b_sqnr_db": metrics.measure_sqnr_db(
            CIMSpec(cb=False, scheme="conventional", in_bits=8, w_bits=8,
                    clip_sigmas=8.0), device=dev),
    }
    s = energy.summary()
    out.update(peak_tops_w_1b=s["peak_tops_w_1b"],
               sac_efficiency=s["sac_efficiency"],
               cb_power_ratio=s["cb_power_ratio"],
               cb_time_ratio=s["cb_time_ratio"])
    tw = energy.calibrated_model().tops_per_watt(CIMSpec(cb=False))
    out.update(sqnr_fom=energy.snr_fom(tw, out["sqnr_db"]),
               csnr_fom=energy.snr_fom(tw, out["csnr_db"]))
    return out


def phase_paper_metrics():
    """The paper's headline numbers measured by the port on the card, each
    held against the same function run by the port on the CPU from the
    same seeds and against the paper's band; then the bit-exact engine at
    kernel_bench's shape (3.1 M conversions a call), timed by CUDA events
    and held against its CPU run."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.cim import CIMSpec, cim_matmul_bit_exact
    t0 = time.perf_counter()
    card = _metric_numbers("cuda")
    card_s = time.perf_counter() - t0
    cpu = _metric_numbers("cpu")
    for k, v in card.items():
        tol = (METRIC_DB_TOL if k.endswith("_db") else
               METRIC_LSB_TOL if k.endswith("_lsb") or "lsb" in k else
               1e-9 * abs(cpu[k]) if k in ("peak_tops_w_1b",
                                           "sac_efficiency",
                                           "cb_power_ratio",
                                           "cb_time_ratio") else
               1e-2 * abs(cpu[k]))
        if not np.isfinite(v) or abs(v - cpu[k]) > tol:
            fail(f"paper_metrics: {k} on the card {v} vs the CPU {cpu[k]}")
    for k, (ref, band) in PAPER.items():
        if abs(card[k] - ref) > band:
            fail(f"paper_metrics: {k} = {card[k]} outside {ref} +- {band}")
    boost = card["csnr_db"] - card["csnr_wo_cb_db"]
    if not 4.0 <= boost <= 8.0 or card["sac_efficiency"] <= 2.0:
        fail(f"paper_metrics: CB boost {boost} dB or SAC efficiency "
             f"{card['sac_efficiency']}")

    m, k, n = BIT_EXACT_SHAPE
    spec = CIMSpec(cb=True)
    kx, kw, kn = prng.split(prng.PRNGKey(0), 3)
    xq = prng.randint(kx, (m, k), -31, 32, device="cuda")
    wq = prng.randint(kw, (k, n), -31, 32, device="cuda")
    y = cim_matmul_bit_exact(xq, wq, kn, spec)
    ms = wall_ms(lambda: cim_matmul_bit_exact(xq, wq, kn, spec), 3)
    t0 = time.perf_counter()
    y_cpu = cim_matmul_bit_exact(xq.cpu(), wq.cpu(), kn, spec)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    equal = float((y.cpu() == y_cpu).float().mean())
    exact = (xq.double() @ wq.double()).float()
    rel_err = float((y - exact).abs().max() / exact.abs().max())
    if equal < 0.999 or not torch.isfinite(y).all():
        fail(f"paper_metrics: bit-exact engine on the card equals its CPU "
             f"run on {equal} of its outputs")
    emit("paper_metrics", card=card, cpu=cpu, card_s=card_s,
         cb_boost_db=boost,
         paper={"sqnr_db": 45.3, "csnr_db": 31.3, "noise_wo_cb_lsb": 1.16,
                "noise_w_cb_lsb": 0.58, "peak_tops_w_1b": 818.0,
                "sac_efficiency": 2.1, "sqnr_fom": 118841.0,
                "csnr_fom": 24541.0},
         bit_exact={"shape": list(BIT_EXACT_SHAPE),
                    "conversions": (k // 1024) * spec.w_bits * m * n,
                    "ms": ms, "cpu_ms": cpu_ms, "equal_share": equal,
                    "max_rel_err_vs_exact": rel_err})


def _vit_eval(cfg, params, mode, dev, use_kernel=False):
    """test_system.py's accuracy: eval batches 1000-1003 of the procedural
    task (batch 64), batch ``s`` keyed fold_in(PRNGKey(0), s);
    ``use_kernel`` runs sim on deployed planes through row 1."""
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy
    from repro_torch.figures.common import images
    from repro_torch.models.layers import Ctx
    from repro_torch.models.vit import vit_accuracy
    if use_kernel:
        cfg = dataclasses.replace(cfg, cim=dataclasses.replace(
            cfg.cim, use_kernel=True))
        params = deploy(cfg, params)
    accs = []
    for s in range(4):
        x, y = images(1000 + s, "eval", dev)
        ctx = Ctx.make(cfg, prng.fold_in(prng.PRNGKey(0), s), mode=mode,
                       deployed=use_kernel)
        accs.append(float(vit_accuracy(params, x, y, cfg, ctx)))
    return float(np.mean(accs))


def _vit_run(cfg, steps, warmup, name):
    """Noise-aware QAT of ``cfg`` on the card and its accuracy off, in
    behavioural sim and in sim through row 1 (launches counted)."""
    import torch
    from repro_torch.figures.common import train_vit
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = train_vit(cfg, steps, "cuda", warmup=warmup)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    if not (np.all(np.isfinite(losses))
            and np.mean(losses[-20:]) < np.mean(losses[:20])):
        fail(f"vit_qat {name}: losses not finite and falling: {losses}")
    accs, eval_ms = {}, {}
    for path, mode, kern in (("off", "off", False),
                             ("sim", "sim", False),
                             ("sim_kernel", "sim", True)):
        cim_matmul_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accs[path] = _vit_eval(cfg, params, mode, "cuda", use_kernel=kern)
        torch.cuda.synchronize()
        eval_ms[path] = 1e3 * (time.perf_counter() - t0) / 4
        if kern:
            launches = cim_matmul_fused.launches
    return params, losses, step_ms, accs, eval_ms, launches


# card (row 1) vs CPU (plain) ViT logits, per image: max |error| over the
# image's largest logit. Read on an H100: at most 0.8 % (the test recipe,
# where one image's quantized activation flips) and 0.25 % (full width);
# the same forward with the noise off or doubled reads 55-109 %.
VIT_LOGIT_TOL = 0.05
# QAT steps of the full-width vit-small-cifar: 40 for the script's time
# (a step takes 0.65-0.9 s on an H100; 100 before the robustness phases
# came), on 6 of its 12 layers since the front-end phase came (every
# layer runs row 1 at the same shapes)
VIT_FULL_STEPS = 40
VIT_FULL_LAYERS = 6


def _vit_row1_parity(cfg, params, name):
    """One eval batch (64 images) of a trained ViT in sim through row 1 on
    deployed planes. Each of row 1's calls in the patch embedding, the
    first block and the last block (M = 64 x 65 rows of f32; K 48, d_model
    and d_ff) is held against row 1's plain version on its own operands
    (``cim_operands_check``). The card's logits are held against the same
    forward on the CPU (plain versions): the greedy class of at least 99 %
    of the images, and every image's logits within VIT_LOGIT_TOL of its
    largest. The same forward with the noise off and with the noise
    doubled must read beyond that limit, so a kernel that dropped or
    mis-scaled its noise would fail it."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy
    from repro_torch.figures.common import images, with_noise_scale
    from repro_torch.kernels import ops as kops
    from repro_torch.models.layers import Ctx
    from repro_torch.models.vit import vit_forward
    cfg = dataclasses.replace(cfg, cim=dataclasses.replace(
        cfg.cim, use_kernel=True))
    dep = deploy(cfg, params)
    x, _ = images(1000, "eval", "cuda")
    key = prng.fold_in(prng.PRNGKey(0), 0)

    def forward(tree, xs, noise=1.0):
        ctx = Ctx.make(cfg, key, mode="sim", deployed=True)
        if noise != 1.0:
            ctx.policy = with_noise_scale(ctx.policy, noise)
        return vit_forward(tree, xs, cfg, ctx).float().cpu()

    calls, real = [], kops.cim_matmul_fused

    def record(x2, wq, qp, seed, sigma, in_bits, **offsets):
        # the ViT's products are whole: their noise offsets are zero
        calls.append((x2.clone(), wq, qp.clone(), seed, sigma, in_bits))
        return real(x2, wq, qp, seed, sigma, in_bits, **offsets)
    kops.cim_matmul_fused = record
    try:
        card = forward(dep, x)
    finally:
        kops.cim_matmul_fused = real
    per = (len(calls) - 1) // cfg.n_layers
    checked = calls[:1 + per] + calls[-per:]
    op_err = max(cim_operands_check(*c)[1] for c in checked)
    del calls, checked

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.cpu()
    plain = forward(to_cpu(dep), x.cpu())

    def image_rel(a):
        return ((a - plain).abs().amax(-1) / plain.abs().amax(-1)).numpy()
    rel = image_rel(card)
    agree = float((card.argmax(-1) == plain.argmax(-1)).float().mean())
    wrong = {f"noise x{s}": float(image_rel(forward(dep, x, s)).max())
             for s in (0.0, 2.0)}
    if (agree < 0.99 or not torch.isfinite(card).all()
            or rel.max() > VIT_LOGIT_TOL
            or min(wrong.values()) <= VIT_LOGIT_TOL):
        fail(f"vit_qat {name}: row 1 vs plain class agreement {agree}, "
             f"per-image logit error max {rel.max()} (limit "
             f"{VIT_LOGIT_TOL}); a wrong noise reads {wrong}")
    return {"row1_calls_checked": 1 + 2 * per,
            "row1_max_err_over_max_y": op_err,
            "kernel_vs_plain_class_agreement": agree,
            "kernel_vs_plain_rel_err_median": float(np.median(rel)),
            "kernel_vs_plain_rel_err_max": float(rel.max()),
            "rel_err_limit": VIT_LOGIT_TOL,
            "wrong_noise_rel_err_max": wrong}


def phase_vit_qat():
    """The paper's CIFAR demo on the card: the reference test's recipe
    (tests/test_system.py: 3 layers, d 128, 150 QAT steps, batch 64, lr
    1.5e-3) and vit-small-cifar at its published width and
    ``VIT_FULL_LAYERS`` of its 12 layers (``VIT_FULL_STEPS`` QAT steps:
    its accuracy is not gated and its step ms is a mean), each evaluated
    off, in behavioural sim and in sim through row 1 on deployed planes
    (M = B * 65 rows). Row 1's launches on the ViT path are counted, and
    for each model row 1 is held against its plain version on the ViT's
    own operands and one batch's logits against the CPU's
    (``_vit_row1_parity``)."""
    from repro_torch.configs.base import CIMModelConfig
    from repro_torch.configs.registry import get_config
    small = dataclasses.replace(
        get_config("vit-small-cifar").reduced(), n_layers=3, d_model=128,
        d_ff=256, n_heads=4, n_kv_heads=4, head_dim=32,
        cim=CIMModelConfig(mode="qat", policy="paper_sac"))
    full = dataclasses.replace(get_config("vit-small-cifar"),
                               n_layers=VIT_FULL_LAYERS)
    total = 0
    for cfg, steps, warmup, name in (
            (small, 150, 10, "test recipe (3 layers, d 128)"),
            (full, VIT_FULL_STEPS, 15,
             f"vit-small-cifar (full width, {VIT_FULL_LAYERS} of 12 "
             f"layers)")):
        params, losses, step_ms, accs, eval_ms, launches = _vit_run(
            cfg, steps, warmup, name)
        if (launches <= 0 or cfg is small and (
                accs["off"] <= 0.85 or accs["off"] - accs["sim"] >= 0.05
                or accs["off"] - accs["sim_kernel"] >= 0.05
                or min(accs["sim"], accs["sim_kernel"]) <= 0.80)):
            fail(f"vit_qat {name}: accuracies {accs}, row-1 launches "
                 f"{launches}")
        total += launches
        emit("vit_qat", model=name, steps=steps, batch=64,
             first_loss=losses[0], last_loss=losses[-1],
             train_step_ms=step_ms, eval_ms_per_batch=eval_ms, acc=accs,
             row1_launches=launches, **_vit_row1_parity(cfg, params, name))
    return total


# the uninterrupted LM run's steps (10 before the robustness phases came,
# for the script's time; the resume check from its step-5 checkpoint needs
# 6)
LM_STEPS = 6


def phase_train_lm():
    """Full-width qwen2-0.5b trained with --cim qat through ``Trainer``:
    ``LM_STEPS`` steps at batch 8 x seq 128 (of a 10-step schedule), with a
    checkpoint after its fifth; a second trainer resumes from that
    checkpoint for the sixth step, whose loss must equal the uninterrupted
    run's sixth within 1e-5 relative. Step ms and peak memory."""
    import shutil
    import torch
    from repro_torch.configs.base import CIMModelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import prng
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.trainer import Trainer, TrainerConfig
    base = get_config("qwen2-0.5b")
    cfg = dataclasses.replace(base, cim=CIMModelConfig(mode="qat",
                                                       policy="paper_sac"))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                      global_batch=8)
    opt_cfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    root = os.path.join(ROOT, "build", "train_lm")
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name, total, every=5):
        tr = Trainer(cfg, opt_cfg, TrainerConfig(
            total_steps=total, checkpoint_every=every,
            checkpoint_dir=os.path.join(root, name)),
            lambda s: lm_batch(dcfg, s), device="cuda")
        real, log = tr.train_step, []

        def step(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a)
            log.append((float(out[2]["loss"]),
                        1e3 * (time.perf_counter() - t0)))
            return out
        tr.train_step = step
        return tr, log

    key = prng.PRNGKey(0)
    torch.cuda.reset_peak_memory_stats()
    tr, full = trainer("full", LM_STEPS)       # one save, after step 5
    tr.run(key, resume=False)
    peak = torch.cuda.max_memory_allocated()
    del tr
    tr, resumed = trainer("full", 6)
    out = tr.run(key, resume=True)
    del tr
    losses = [v for v, _ in full]
    if (len(resumed) != 1 or out["last_step"] != 6
            or not np.all(np.isfinite(losses))
            or np.mean(losses[-3:]) >= np.mean(losses[:3])
            or abs(resumed[0][0] - losses[5]) > 1e-5 * abs(losses[5])):
        fail(f"train_lm: losses {losses}, resumed {resumed}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("train_lm", arch=cfg.name, cim="qat", steps=LM_STEPS, batch=8,
         seq=128,
         losses=losses, resumed_step6_loss=resumed[0][0],
         step_ms_median=float(np.median([t for _, t in full[1:]])),
         first_step_ms=full[0][1], peak_mem_gib=peak / 2 ** 30)


def phase_paper_figures():
    """The figure runner on the card (``python -m repro_torch.figures``):
    fig2, fig4, fig5, fig6 and vit_accuracy, one JSON line each."""
    from repro_torch.figures.__main__ import main as figures
    t0 = time.perf_counter()
    if figures(["--device", "cuda"]) != 0:
        fail("paper_figures: a figure failed")
    emit("paper_figures", seconds=time.perf_counter() - t0)


# ------------------------------------------------- the robustness layer
# the full-width robustness sessions' prompts (cell A's two shortest,
# twice) and greedy tokens, sized to their time: a guarded step runs per
# call and reads every plane twice (0.55 s of host a step)
ROBUST_LENS = (60, 64, 60, 64)
ROBUST_NEW = 6
ROBUST_STUCK = 1e-3        # the kernel check's stuck-at rate
ULP_LIMIT = 3              # card vs CPU normals (ROADMAP C4)


def _ulps(a, b):
    """|a - b| in units of b's f32 spacing, elementwise (float64)."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


def phase_robust_kernel_checks():
    """Row 1 on the robustness layer's operands, card against plain, at
    qwen2-0.5b's ``gate`` plane (896 x 4864, the 6-bit MLP point): the
    stuck-at draw (rate ``ROBUST_STUCK``) card vs CPU, exactly, for one
    layer's slice of a stacked ``q`` plane (4 bits), and its time on the
    gate plane's slice; row 1 on the stuck gate plane (integer
    part exact, noise at ``cim_operands_check``'s limits) and under
    ``_retry_spec`` (CB on, 12 votes: another sigma); the deployed drift
    and fault epilogue card vs CPU on the same kernel output (gain,
    offset, stuck columns, trims within 1e-6 of the largest value), the
    brownout's Threefry bits exactly and its normal within ``ULP_LIMIT``
    ulp; and the epilogue keyed by a seed-table row's fold equal to the
    host key's, bit for bit."""
    import torch
    from repro_torch.core import prng, quant
    from repro_torch.core.cim import output_noise_std_int, \
        output_noise_std_int_per_tile
    from repro_torch.core.drift import DriftSpec, apply_drift
    from repro_torch.core.faults import (FaultSpec, apply_output_faults,
                                         stuck_bit_plane)
    from repro_torch.core.guard import GuardSpec, _retry_spec
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(7)
    pol = paper_sac()
    spec = pol.mlp
    k, n = 896, 4864
    key = prng.PRNGKey(3)
    # layer 5's slice of a stacked q plane (4 bits), card vs CPU
    q_plane = random_plane(g, k, k, pol.attn)
    sq = stuck_bit_plane(q_plane, pol.attn.w_bits, ROBUST_STUCK, key,
                         start=5 * k * k)
    if not torch.equal(sq.cpu(), stuck_bit_plane(
            q_plane.cpu(), pol.attn.w_bits, ROBUST_STUCK, key,
            start=5 * k * k)):
        fail("robust: the stuck plane differs card vs CPU")
    clean = random_plane(g, k, n, spec)
    stuck_bit_plane(clean[:8], spec.w_bits, ROBUST_STUCK, key)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp = stuck_bit_plane(clean, spec.w_bits, ROBUST_STUCK, key,
                         start=5 * k * n)
    torch.cuda.synchronize()
    draw_ms = 1e3 * (time.perf_counter() - t0)
    changed = float((sp != clean).float().mean())
    worst, cases = 0.0, 0
    for sp_spec, label in ((spec, "first read"),
                           (_retry_spec(spec, GuardSpec()), "retry")):
        for m in (1, 4, 32):
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(
                sp_spec.in_bits)
            err, _ = cim_operands_check(
                x, sp, torch.stack([xs, torch.ones_like(xs)]),
                (0x2468ACE0 + m, 0x13579BDF + len(label)),
                output_noise_std_int_per_tile(sp_spec, k), sp_spec.in_bits)
            worst = max(worst, err)
            cases += 1
    # the epilogue on one kernel output, card vs CPU
    d = DriftSpec(seed=4, walk_gain_std=0.05, walk_offset_std=1.0,
                  temp_gain_amp=0.02, supply_offset_mag=3.0, supply_every=16)
    f = FaultSpec(seed=5, col_gain_std=0.05, col_offset_std=1.0,
                  adc_stuck_rate=0.01, adc_stuck_code=600, brownout_rate=0.1)
    es = dataclasses.replace(spec, drift=d, fault=f)
    x = torch.randn((4, k), generator=g, device="cuda")
    xs = quant.abs_max_scale(x, es.in_bits)
    ws = torch.tensor(0.021, device="cuda")
    y0 = ops.cim_matmul_deployed(x, sp, ws, spec, key, x_scale=xs)
    trims = (1.0 + 0.01 * torch.randn(n, generator=g, device="cuda"),
             0.1 * torch.randn(n, generator=g, device="cuda"))
    bkey = prng.fold_in(key, 0x0FA1)
    outs = {}
    for dev in ("cuda", "cpu"):
        unit = (xs * ws).to(dev)
        y = apply_drift(y0.to(dev), d, output_noise_std_int(es, k) * unit,
                        (torch.tensor(21, dtype=torch.int32, device=dev),)
                        + tuple(t.to(dev) for t in trims))
        outs[dev] = apply_output_faults(
            y, f, output_noise_std_int(es, k) * unit,
            600.0 * unit, 0.7 * unit, key=bkey)
    epi = float((outs["cuda"].cpu() - outs["cpu"]).abs().max()
                / outs["cpu"].abs().max())
    bits_equal = torch.equal(
        prng.random_bits(bkey, (4, n), device="cuda").cpu(),
        prng.random_bits(bkey, (4, n)))
    normal_ulps = float(_ulps(prng.normal(bkey, (4, n), device="cuda"),
                              prng.normal(bkey, (4, n))).max())
    # the whole deployed call: a seed-table row carrying the fold draws
    # the host key's brownout, bit for bit
    w0, w1 = prng.key_words(key)
    table = torch.from_numpy(np.array([[w0, w1]], np.uint32).view(np.int32))
    folds = torch.from_numpy(prng.fold_table(table.numpy(), 0x0FA1))
    row = prng.SeedRow(table.cuda(), 0, {0x0FA1: folds.cuda()})
    st = (torch.tensor(21, dtype=torch.int32, device="cuda"), *trims)
    y_host = ops.cim_matmul_deployed(x, sp, ws, es, key, x_scale=xs,
                                     dstate=st)
    y_row = ops.cim_matmul_deployed(x, sp, ws, es, row, x_scale=xs,
                                    dstate=st)
    if (epi > 1e-6 or not bits_equal or normal_ulps > ULP_LIMIT
            or not torch.equal(y_host, y_row)):
        fail(f"robust epilogue: card vs CPU {epi} (limit 1e-6), brownout "
             f"bits equal {bits_equal}, normal {normal_ulps} ulp (limit "
             f"{ULP_LIMIT}), table row = host key "
             f"{torch.equal(y_host, y_row)}")
    emit("robust_kernel_checks", plane="qwen2-0.5b gate 896x4864, 6b",
         stuck_rate=ROBUST_STUCK,
         stuck_plane="card = CPU, exact (layer 5 of a stacked q plane)",
         bits_changed_share=changed, stuck_draw_ms_one_layer=draw_ms,
         row1_cases=cases, row1_integer_part="exact",
         row1_max_abs_err=worst, retry_votes=GuardSpec().retry_votes,
         epilogue_err_over_max=epi, epilogue_tol=1e-6,
         brownout_bits_equal=True, brownout_normal_max_ulps=normal_ulps,
         table_fold_equals_host_key=True)
    return worst


def _reduced_sim():
    from repro_torch.configs.registry import get_config
    base = get_config("qwen2-0.5b").reduced()
    return dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="sim", use_kernel=True))


# the drift session of robust_parity and serve_robust (d): a walk, a
# supply step every ``n_steps`` engine steps, a calibration every twice
# that, a canary every 4; and runtime faults without a guard, with a
# brownout (keyed by
# the staged fold table under replay) at reduced size only: its normal
# per call is some 200 eager Threefry kernels, 65 ms of device time a
# full-width step
def _drift_kw(n_steps=8, brownout=0.02):
    from repro_torch.core.calibrate import CalibPolicy
    from repro_torch.core.drift import DriftSpec
    from repro_torch.core.faults import FaultSpec
    return dict(drift=DriftSpec(seed=3, walk_gain_std=0.02,
                                walk_offset_std=0.5, supply_offset_mag=8.0,
                                supply_every=n_steps),
                calib=CalibPolicy(probe_rows=16, probe_chunk=16, probe_k=128,
                                  every_steps=2 * n_steps, canary_every=4),
                fault=FaultSpec(seed=2, col_gain_std=0.01,
                                col_offset_std=0.3, brownout_rate=brownout,
                                adc_stuck_rate=0.002, adc_stuck_code=520))


def phase_robust_parity():
    """The reduced qwen2 (float32, sim on the CIM kernel path), card
    against the port on the CPU: guarded, with a 64-sigma transient on
    slot 1 (``DegradePolicy(pin_after=1)``), the greedy tokens, statuses,
    per-layer trip and hard counts and every request's guard report equal;
    drifted (a walk and a supply step inside the session, calibration,
    runtime faults with a brownout), the tokens, the drift events' kinds
    and steps and the calibrations equal, and on the card the replayed run
    equal to the per-call one in tokens and launch counts (a step frozen
    at capture shows as tokens parting after the supply step)."""
    import torch
    from repro_torch.core.deploy import init_params
    from repro_torch.core.faults import FaultSpec
    from repro_torch.serving.engine import COUNTED, DegradePolicy, Engine, \
        Request

    cfg = _reduced_sim()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 90, 57)]

    def run(dev, **kw):
        eng = Engine(cfg, params, max_slots=3, max_len=128,
                     attn_impl="kernel", device=dev, **kw)
        for f in COUNTED:
            f.launches = 0
        outs = eng.generate([Request(prompt=p, max_new_tokens=10,
                                     rid=f"p{i}")
                             for i, p in enumerate(prompts)])
        return eng, outs, {f.__name__: f.launches for f in COUNTED
                           if f.launches}

    guarded = dict(guard=True, fault=FaultSpec(transient_mag=64.0),
                   fault_slots={1}, degrade=DegradePolicy(pin_after=1))
    res = {dev: run(dev, **guarded) for dev in ("cuda", "cpu")}
    got = {dev: (o, e.status, e.guard_trip_counts.tolist(),
                 e.guard_hard_counts.tolist(), e.guard_report)
           for dev, (e, o, _) in res.items()}
    if got["cuda"] != got["cpu"]:
        fail(f"robust_parity guarded: card {got['cuda']} vs CPU "
             f"{got['cpu']}")
    e = res["cuda"][0]
    if not (e.guard_report[1]["hard"] and not e.guard_report[0]["hard"]):
        fail(f"robust_parity guarded: report {e.guard_report}")
    runs = {"replayed": run("cuda", fused_step=True, **_drift_kw()),
            "per_call": run("cuda", fused_step=False, **_drift_kw()),
            "cpu": run("cpu", **_drift_kw())}
    ev = {k: [(x["kind"], x["step"]) for x in v[0].take_drift_events()]
          for k, v in runs.items()}
    toks = {k: v[1] for k, v in runs.items()}
    rep = runs["replayed"][0]
    if (toks["replayed"] != toks["per_call"] or toks["replayed"] != toks["cpu"]
            or runs["replayed"][2] != runs["per_call"][2]
            or ev["replayed"] != ev["per_call"] or ev["replayed"] != ev["cpu"]
            or not rep.replay_count or rep.fallbacks
            or rep.drift_step <= 8 or not rep.calibrations):
        fail(f"robust_parity drift: tokens {toks}, launches "
             f"{runs['replayed'][2]} vs {runs['per_call'][2]}, events {ev}, "
             f"replays {rep.replay_count}, fallbacks {rep.fallbacks}")
    emit("robust_parity", model="qwen2-0.5b reduced, f32, sim, use_kernel",
         guarded={"tokens_equal": True, "status": e.status,
                  "trips_per_layer": e.guard_trip_counts.tolist(),
                  "hard_per_layer": e.guard_hard_counts.tolist(),
                  "report": {str(k): v for k, v in e.guard_report.items()}},
         drift={"tokens_equal": True, "replayed_launches_equal": True,
                "launches": runs["replayed"][2], "events": ev["replayed"],
                "calibrations": rep.calibrations,
                "watchdog_trips": rep.watchdog_trips,
                "drift_steps": rep.drift_step, "replays": rep.replay_count})


def robust_session(cfg, params, profile=True, **kw):
    """A full-width session (``ROBUST_LENS``, ``ROBUST_NEW`` greedy tokens,
    4 slots) on an engine built with ``kw``: the build's seconds (the
    deploy; with ``fused_step`` the capture too), the tokens, the kernel
    launches of the session, and at the first pure-decode step its host ms
    and row-1 launches, then (``profile``) one profiled step's
    device-busy ms."""
    import torch
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.serving.engine import Engine, Request

    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, max_slots=4, max_len=320, attn_impl="kernel",
                 device="cuda", **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=ROBUST_NEW, rid=f"r{i}")
            for i, n in enumerate(ROBUST_LENS)]
    for k in kernels:
        k.launches = 0
    eng.begin()
    for r in reqs:
        eng.submit(r)
    step = {}
    t0 = time.perf_counter()
    while eng.has_work():
        live = [s for s, r in enumerate(eng._slots) if r is not None]
        if (not step and len(live) == 4 and not eng._queue
                and all(eng._decoding[s] for s in live)):
            n0 = cim_matmul_fused.launches
            torch.cuda.synchronize()
            ts = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            step = {"host_step_ms": 1e3 * (time.perf_counter() - ts),
                    "row1_launches_per_step": cim_matmul_fused.launches - n0}
            if profile:
                step["device_busy_ms"] = decode_step_device_ms(eng)
            continue
        eng.step()
    eng.drain_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [eng.request_errors[i] if eng.status[i] == "failed"
            else r.out_tokens for i, r in enumerate(reqs)]
    if not step or any(not isinstance(o, list) or len(o) != ROBUST_NEW
                       for o in outs):
        fail(f"serve_robust {sorted(kw)}: outputs {outs}, step {step}")
    return eng, outs, {k.__name__: k.launches for k in kernels}, {
        "build_s": build_s, "wall_s": wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, **step}


def phase_serve_robust(params, unguarded_profile):
    """qwen2-0.5b at full width and depth (bf16, sim on deployed planes,
    the CIM kernel, kernel attention), ``robust_session`` each: (a) under
    the guard, quiet: no trip, the unguarded per-call run's tokens, row 1
    twice a linear; (b) a 64-sigma transient on slot 1: slot 1 trips on
    every layer, is pinned and finishes on the digital rung, every slot
    equal to the fault-free twin with slot 1 pinned from the start (the
    batch shares one activation scale, so the twin and not (a) is the
    isolation baseline, as in the reference's test); (c) a deploy with
    stuck-at bitcells (rate 1e-4) under the guard: the build's seconds and
    the trips; (d) drift with calibration and runtime faults (no
    brownout: ``_drift_kw``), replayed through the CUDA graphs and per
    call: equal tokens and launches. A profiled decode step's device ms
    for (d) replayed, beside ``unguarded_profile``, cell A's profiled
    per-call step of this run; a guarded step is not profiled, for the
    script's time (its profile took some 18 s; (a)-(c) run the same
    kernels, every rung being computed and selected per row). Returns the
    launches of the runs and their seconds."""
    import torch
    from repro_torch.core.faults import FaultSpec

    t_start = time.perf_counter()
    cfg = full_config(False)
    res, launches = {}, {}

    def go(name, profile=True, **kw):
        t0 = time.perf_counter()
        eng, outs, counts, nums = robust_session(cfg, params, profile, **kw)
        nums["session_s"] = time.perf_counter() - t0
        res[name] = (eng, outs, counts, nums)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return eng, outs, counts, nums

    plain = go("unguarded", False, fused_step=False)
    a = go("a_guarded_quiet", False, guard=True)
    if (a[1] != plain[1] or a[0].guard_trip_counts.sum()
            or a[2]["cim_matmul_fused"] != 2 * plain[2]["cim_matmul_fused"]):
        fail(f"serve_robust (a): tokens {a[1]} vs {plain[1]}, trips "
             f"{a[0].guard_trip_counts.tolist()}, row-1 launches "
             f"{a[2]} vs {plain[2]}")
    faulted = dict(guard=True, fault=FaultSpec(transient_mag=64.0),
                   fault_slots={1})
    b = go("b_guarded_transient_slot1", False, **faulted)
    twin = go("b_twin_slot1_pinned", False, guard=True, pin_slots={1})
    rep = b[0].guard_report
    L = cfg.n_layers
    if (b[1] != twin[1] or rep[1]["hard_layers"] != list(range(L))
            or any(rep[i]["trips"] for i in (0, 2, 3))
            or twin[0].guard_hard_counts.sum()):
        fail(f"serve_robust (b): tokens {b[1]} vs twin {twin[1]}, report "
             f"{rep}")
    c = go("c_guarded_stuck_1e-4", False, guard=True,
           fault=FaultSpec(seed=1, stuck_rate=1e-4))
    # a supply step every 4 engine steps: the session runs about 9
    d = go("d_drift_replayed", fused_step=True,
           **_drift_kw(4, brownout=0.0))
    dp = go("d_drift_per_call", False, fused_step=False,
            **_drift_kw(4, brownout=0.0))
    if (d[1] != dp[1] or d[2] != dp[2] or not d[0].replay_count
            or d[0].fallbacks or not d[0].calibrations
            or d[0].drift_step <= 4):
        fail(f"serve_robust (d): tokens {d[1]} vs {dp[1]}, launches {d[2]} "
             f"vs {dp[2]}, replays {d[0].replay_count}, fallbacks "
             f"{d[0].fallbacks}, calibrations {d[0].calibrations}, drift "
             f"steps {d[0].drift_step}")
    emit("serve_robust", arch=cfg.name, n_layers=L, dtype=cfg.dtype,
         requests=len(ROBUST_LENS), prompt_lens=list(ROBUST_LENS),
         new_tokens=ROBUST_NEW, slots=4,
         runs={k: v[3] for k, v in res.items()},
         unguarded_per_call_profile_cell_a=unguarded_profile,
         launches={k: v[2] for k, v in res.items()},
         a={"zero_trips": True, "tokens_equal_unguarded": True},
         b={"slot1_hard_layers": L, "slot1_trips": rep[1]["trips"],
            "other_slots_trips": 0, "tokens_equal_pinned_twin": True,
            "slots_equal_quiet_run": [b[1][i] == a[1][i] for i in range(4)]},
         c={"trips_per_layer": c[0].guard_trip_counts.tolist(),
            "hard_per_layer": c[0].guard_hard_counts.tolist(),
            "report": {str(k): v for k, v in c[0].guard_report.items()}},
         d={"tokens_equal": True, "launches_equal": True,
            "calibrations": d[0].calibrations,
            "watchdog_trips": d[0].watchdog_trips,
            "events": [(e["kind"], e["step"])
                       for e in d[0].take_drift_events()],
            "replays": d[0].replay_count})
    del res, a, b, c, d, dp, plain, twin
    torch.cuda.empty_cache()
    return launches, time.perf_counter() - t_start


# --------------------------------------- the front-end and the load ladder
FE_BURST = 14              # requests submitted at once ...
FE_QUEUE = 10              # ... into this admission bound: 4 shed
FE_HIGH, FE_LOW = 4, 2     # the ladder's watermarks
FE_NEW = 16
FE_DT = 0.01               # fake-clock seconds a tick
FE_DEADLINE = (0, 0.05)    # request 0 (60 tokens): deadline 5 ticks in
FE_CANCEL = 3              # request 3 (95 tokens): cancelled after a token
FE_LATE = (211, 64)        # arrive after the burst drains
FE_LEVELS = (0, 1, 2, 1)   # the noise check's row levels


def frontend_script(eng):
    """The front-end session on ``eng`` under a fake clock (``FE_DT`` a
    tick): ``FE_BURST`` requests at once (cell A's lengths in turn,
    ``FE_NEW`` greedy tokens; request ``FE_DEADLINE[0]`` with a deadline,
    request ``FE_CANCEL`` cancelled by its client after its first token),
    ticks until the burst drains and the ladder is back at rung 0, then
    ``FE_LATE`` and ticks until they finish. Returns the front-end, the
    tickets, and per tick (host ms, row-3 launches, whether the tick was a
    pure decode)."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.serving.frontend import Frontend

    clock = {"t": 0.0}
    fe = Frontend(eng, queue_limit=FE_QUEUE, high_watermark=FE_HIGH,
                  low_watermark=FE_LOW, clock=lambda: clock["t"])
    rng = np.random.default_rng(6)
    vocab = eng.cfg.vocab_size
    tks = [fe.submit(list(rng.integers(0, vocab,
                                       SESSION_LENS[i % len(SESSION_LENS)])),
                     FE_NEW, rid=f"f{i}",
                     timeout_s=FE_DEADLINE[1] if i == FE_DEADLINE[0]
                     else None)
           for i in range(FE_BURST)]
    ticks = []

    def tick():
        f0, d0 = flash_gqa_attention.launches, decode_attention.launches
        t0 = time.perf_counter()
        fe.tick(clock["t"])
        ticks.append((1e3 * (time.perf_counter() - t0),
                      flash_gqa_attention.launches == f0
                      and decode_attention.launches > d0))
        clock["t"] += FE_DT
        c = tks[FE_CANCEL]
        if c.tokens and not c._cancel_asked and not c.done.is_set():
            c.cancel()
        if len(ticks) > 2000:
            fail("serve_frontend: the front-end wedged")

    while fe.pending() or fe.level:
        tick()
    tks += [fe.submit(list(rng.integers(0, vocab, n)), FE_NEW,
                      rid=f"f{FE_BURST + i}") for i, n in enumerate(FE_LATE)]
    while fe.pending():
        tick()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return fe, tks, ticks


def _records(tks):
    return [(t.rid, t.outcome, t.record.reason, t.tokens,
             dataclasses.astuple(t.record)) for t in tks]


def phase_serve_frontend(params):
    """The front-end (``serving/frontend.py``) and the load ladder on
    qwen2-0.5b at full width and depth as in cell A (bf16, bf16 cache, sim
    on deployed planes, the CIM kernel, kernel attention, 4 slots, chunk
    32), replayed (``fused_step``) with ``DegradeLadder((None, 3, 1))``,
    driven by ``frontend_script``: every ticket ends in one outcome, the 4
    past the bound shed with their reason, admissions at rungs 1 and 2, the
    ladder back at 0 and the late pair admitted there, the deadline and
    the client's cancel hit mid-decode; the same script per call
    (``fused_step=False``) gives every ticket the same outcome, tokens and
    record; a laddered engine whose requests all sit at rung 0 gives a
    ladder-free engine's tokens, both replayed; ``_degrade_noise`` on a
    full-width gate output card against CPU (Threefry bits equal, the
    normal within ``ULP_LIMIT`` ulp, level-0 rows the input bit for bit,
    the others within one bf16 ulp). Prints host ms a front-end tick
    against the engine's own replayed step, device ms a pure-decode step
    with the ladder's epilogue and without it (CUDA events after a spin),
    row-1 launches a step, the records' p99s and the phase's seconds.
    Returns the rows' launches in the replayed session and the
    seconds."""
    import torch
    from repro_torch.core import prng, quant
    from repro_torch.core.sac import DegradeLadder, paper_sac
    from repro_torch.kernels import ops
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.models import layers
    from repro_torch.serving.engine import OUTCOMES, Engine, Request

    t_start = time.perf_counter()
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    cfg = full_config(False)
    ladder = DegradeLadder(votes=(None, 3, 1))

    # _degrade_noise on a full-width gate output, card against CPU
    g = torch.Generator(device="cuda").manual_seed(11)
    spec = paper_sac().mlp
    k, n = cfg.d_model, cfg.d_ff
    wq = random_plane(g, k, n, spec)
    ws = torch.tensor(0.0213, dtype=torch.bfloat16, device="cuda")
    x = torch.randn((4, 1, k), generator=g, device="cuda").to(torch.bfloat16)
    xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / quant.qmax(
        spec.in_bits)
    key = prng.PRNGKey(21)
    y = ops.cim_matmul_deployed(x, wq, ws, spec, key, x_scale=xs).to(
        torch.bfloat16)
    # the card draws layer 5's gate call (row 5 * 7 + 4 of a forward's
    # table) with its column, the 24 layers' gate calls at once; the CPU
    # draws it alone under the host key
    words = np.zeros((cfg.n_layers * 7, 2), np.uint32)
    words[:, 0] = np.arange(words.shape[0])
    words[5 * 7 + 4] = prng.key_words(key)
    table = torch.from_numpy(words.view(np.int32))
    folds = torch.from_numpy(prng.fold_table(table.numpy(),
                                             layers.DEGRADE_FOLD))
    row = prng.SeedRow(table.cuda(), 5 * 7 + 4,
                       {layers.DEGRADE_FOLD: folds.cuda()})
    outs = {}
    for dev, kk, width in (("cuda", row, 7), ("cpu", key, 0)):
        ctx = layers.Ctx(cfg=cfg, mode="sim", degrade_levels=ladder.votes,
                         degrade_rows=torch.tensor(FE_LEVELS,
                                                   dtype=torch.int32,
                                                   device=dev),
                         seed_width=width)
        outs[dev] = layers._degrade_noise(
            ctx, {"ws6": ws.to(dev)}, x.to(dev), y.to(dev), spec, kk,
            xs.to(dev)).cpu()
    fk = prng.fold_in(key, layers.DEGRADE_FOLD)
    bits_equal = torch.equal(prng.random_bits(fk, y.shape, "cuda").cpu(),
                             prng.random_bits(fk, y.shape))
    normal_ulps = float(_ulps(prng.normal(fk, y.shape, "cuda"),
                              prng.normal(fk, y.shape)).max())
    lvl = torch.tensor(FE_LEVELS)
    rows0 = lvl == 0
    level0_exact = (torch.equal(outs["cuda"][rows0], y.cpu()[rows0])
                    and torch.equal(outs["cpu"][rows0], y.cpu()[rows0]))
    hit = outs["cuda"][~rows0].float()
    ref = outs["cpu"][~rows0].float()
    bf16_ulps = float(((hit - ref).abs() / torch.maximum(
        ref.abs(), torch.full_like(ref, 2.0 ** -126)) / 2.0 ** -8).max())
    moved = not torch.equal(outs["cuda"][~rows0], y.cpu()[~rows0])
    if (not bits_equal or normal_ulps > ULP_LIMIT or not level0_exact
            or bf16_ulps > 1.0 or not moved):
        fail(f"serve_frontend noise: bits equal {bits_equal}, normal "
             f"{normal_ulps} ulp (limit {ULP_LIMIT}), level-0 rows exact "
             f"{level0_exact}, laddered rows {bf16_ulps} bf16 ulp (limit 1), "
             f"moved {moved}")
    noise = {"operand": f"gate output (4, {n}) bf16, K {k}",
             "card": "layer 5's gate row, drawn with its column of 24",
             "levels": list(FE_LEVELS), "bits_equal": True,
             "normal_max_ulps": normal_ulps, "level0_rows_exact": True,
             "laddered_rows_max_bf16_ulps": bf16_ulps}

    # the front-end session, replayed, then the same script per call
    runs = {}
    for name, fused in (("replayed", True), ("per_call", False)):
        t0 = time.perf_counter()
        eng = Engine(cfg, params, max_slots=4, max_len=320,
                     attn_impl="kernel", fused_step=fused, ladder=ladder,
                     device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        fe, tks, ticks = frontend_script(eng)
        runs[name] = dict(eng=eng, fe=fe, tks=tks, ticks=ticks,
                          build_s=build_s,
                          session_s=time.perf_counter() - t0,
                          launches={kern.__name__: kern.launches
                                    for kern in kernels},
                          replays=eng.replay_count)
    rep, pc = runs["replayed"], runs["per_call"]
    tks, fe, eng = rep["tks"], rep["fe"], rep["eng"]
    recs = [t.record for t in tks]
    shed = [t for t in tks if t.outcome == "shed"]
    burst_lvls = {r.degrade_level for r in recs[:FE_BURST]
                  if r.admitted_s is not None}
    downs = [tr for tr in fe.metrics.transitions if tr.level_to == 0]
    dl, cn = tks[FE_DEADLINE[0]], tks[FE_CANCEL]
    checks = {
        "one_outcome_each": all(t.done.is_set() and t.outcome in OUTCOMES
                                for t in tks),
        "shed_4_with_reason": len(shed) == FE_BURST - FE_QUEUE and all(
            "admission queue full" in t.record.reason for t in shed),
        "rungs_1_and_2": {1, 2} <= burst_lvls,
        "ladder_back_to_0": bool(downs) and fe.level == 0,
        "late_pair_at_rung_0": all(r.degrade_level == 0
                                   and r.outcome == "completed"
                                   for r in recs[FE_BURST:]),
        "deadline_mid_decode": dl.outcome == "deadline_expired"
        and 0 < len(dl.tokens) < FE_NEW,
        "client_cancel_after_first_token": cn.outcome == "cancelled"
        and 0 < len(cn.tokens) < FE_NEW,
        "per_call_records_equal": _records(tks) == _records(pc["tks"]),
        "per_call_launches_equal": rep["launches"] == pc["launches"],
        "replayed": rep["replays"] > 0 and eng.fallbacks == 0,
    }
    if not all(checks.values()):
        got = [(t.rid, t.outcome, t.record.degrade_level, len(t.tokens))
               for t in tks]
        fail(f"serve_frontend: {checks}; outcomes {got}; transitions "
             f"{fe.metrics.transitions}")
    summary = fe.metrics.summary()
    tick_ms = [ms for ms, pure in rep["ticks"] if pure]

    # rung 0 under a ladder = no ladder, both replayed; the engine's own
    # replayed step and the device ms a step with and without the ladder's
    # epilogue
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in ROBUST_LENS]

    def own_session(e):
        # a fresh session on the engine's seed: the front-end session
        # advanced its key chain
        e.begin()
        e.key = prng.PRNGKey(0)
        reqs = [Request(prompt=p, max_new_tokens=FE_NEW, rid=f"z{i}")
                for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        steps, dev = [], None
        while e.has_work():
            pure = (all(e._decoding[s] for s, r in enumerate(e._slots)
                        if r is not None) and not e._queue
                    and any(r is not None for r in e._slots))
            n0 = cim_matmul_fused.launches
            if pure and dev is None:
                torch.cuda.synchronize()
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                torch.cuda._sleep(int(2e9 * 0.05))
                a.record()
                e.step()
                b.record()
                torch.cuda.synchronize()
                dev = (a.elapsed_time(b),
                       cim_matmul_fused.launches - n0)
                continue
            t0 = time.perf_counter()
            e.step()
            if pure:
                steps.append(1e3 * (time.perf_counter() - t0))
        e.drain_pending()
        torch.cuda.synchronize()
        return [r.out_tokens for r in reqs], steps, dev

    z_lad = own_session(eng)
    plain_eng = Engine(cfg, params, max_slots=4, max_len=320,
                       attn_impl="kernel", fused_step=True, device="cuda")
    z_plain = own_session(plain_eng)
    if z_lad[0] != z_plain[0] or not plain_eng.replay_count:
        fail(f"serve_frontend: rung-0 tokens {z_lad[0]} vs no ladder "
             f"{z_plain[0]}")
    new_s = time.perf_counter() - t_start
    emit("serve_frontend", arch=cfg.name, n_layers=cfg.n_layers,
         dtype=cfg.dtype, slots=4, chunk=32, ladder_votes=list(ladder.votes),
         burst=FE_BURST, queue_limit=FE_QUEUE, watermarks=[FE_HIGH, FE_LOW],
         late=list(FE_LATE), new_tokens=FE_NEW, fake_dt_s=FE_DT,
         checks=checks, noise_check=noise,
         outcomes=summary["outcomes"],
         degraded_admissions=summary["degraded_admissions"],
         ladder_transitions=summary["ladder_transitions"],
         queue_wait_p99_fake_s=summary["queue_wait_p99_s"],
         ttft_p99_fake_s=summary["ttft_p99_s"],
         admitted_levels=[r.degrade_level for r in recs],
         ticks=len(rep["ticks"]),
         frontend_tick_host_ms_pure_decode=float(np.mean(tick_ms)),
         engine_step_host_ms_pure_decode_laddered=float(np.mean(z_lad[1])),
         engine_step_host_ms_pure_decode_no_ladder=float(
             np.mean(z_plain[1])),
         device_ms_step_laddered=z_lad[2][0],
         device_ms_step_no_ladder=z_plain[2][0],
         row1_launches_per_step=z_lad[2][1],
         replayed={"build_s": rep["build_s"], "session_s": rep["session_s"],
                   "launches": rep["launches"],
                   "replays": rep["replays"]},
         per_call={"build_s": pc["build_s"], "session_s": pc["session_s"],
                   "launches": pc["launches"]},
         seconds=new_s)
    launches = rep["launches"]
    del runs, rep, pc, eng, fe, plain_eng
    torch.cuda.empty_cache()
    return launches, new_s


# ------------------------------------------------------- the replica router
RT_LENS = (300, 60, 137, 211, 64, 95)  # cell A's lengths; r1 is sent 60, 64
RT_NEW = 10
RT_TEMPS = (0.0, 0.8)
RT_WEDGE_LENS = (60, 137, 64, 95)
RT_STORM_LENS = (60, 64, 60, 64, 60, 64)
RT_STORM_NEW = 8
RT_STORM_LAYERS = 4        # a guarded full-width step costs 714 ms of host
RT_FE_LENS = (60, 64, 95, 137)
RT_FE_NEW = 8


def phase_serve_router(params):
    """The replica router (``serving/router.py``) over replicas that
    ``build_pool`` builds with one seed, on qwen2-0.5b at full width and
    depth as in cell A (bf16, bf16 cache, kernel attention, chunk 32, 2
    slots a replica, every replica replayed through its CUDA graphs),
    each scenario on fresh replicas (a killed one stays dead): (a) two
    replicas give 4 rids (greedy and sampled at 0.8) the same streams;
    (b) 3 replicas in off mode, no fault (the router timed), then a kill
    of r1 at router step 4: the streams equal a single engine's, the
    events hold kill, dead and a migration with tokens delivered, and the
    dead engine replays nothing after its kill; (c) (a)'s replicas, two
    300-token prompts, r0 killed at step 2 mid-chunked-prefill; (d) a
    wedge of r0 at step 3 caught by the watchdog (patience 3); (e) (b)'s
    kill in sim mode on deployed planes: every request completes with all
    its tokens (sim streams share one activation scale a batch, so they
    are not compared); (f) a drift storm on r1 (64 sigmas on every slot,
    ``cim_mode="sim"``, guard on, per call) at ``RT_STORM_LAYERS`` of the
    24 layers: drains only r1, never kills it, every request completes;
    (g) the front-end over 2 replicas, r0 killed at step 5: every record
    completed with its replica, at least one migration, the single
    engine's streams. The single engine is built first, with the
    replicas' 2 slots (cuBLAS may choose a bf16 GEMM by M), and serves
    every ground truth after the pools were built. Any dead event that a
    scenario's own ``ReplicaFaultSpec`` did not inject, or a failed
    request, fails the phase. Prints the router's host ms a tick against
    the replicas' summed busy ms, the pool's session tok/s against the
    single engine's, a pool's build seconds, the peak device memory, rows
    1-3 launches and the phase's seconds. Returns the launches of the
    router's sessions and the seconds."""
    import torch
    from repro_torch.core.faults import ReplicaFaultSpec
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.frontend import Frontend
    from repro_torch.serving.router import (HealthPolicy, ReplicaRouter,
                                            build_pool)

    t_start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    launches = {k.__name__: 0 for k in kernels}
    cfg = full_config(False)
    kw = dict(max_slots=2, max_len=320, attn_impl="kernel", device="cuda")
    builds = {}
    checks = {}

    def reqs(lens, new, temps=(0.0,), tag="q"):
        rng = np.random.default_rng(7)
        return [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                        max_new_tokens=new,
                        temperature=temps[i % len(temps)], rid=f"{tag}{i}")
                for i, n in enumerate(lens)]

    def pool(name, n, c=cfg, p=params, **extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines = build_pool(c, p, n, seed=0, **{**kw, **extra})
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0
        return engines

    def counted(fn):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in kernels:
            launches[k.__name__] += k.launches
        return out, wall

    def dead_events(router, injected):
        """Dead events beyond the injected victim's, and failed outputs."""
        return [e for e in router.events if e["kind"] == "dead"
                and e["replica"] not in injected]

    def fault_free(name, router, outs, injected=()):
        extra = dead_events(router, injected)
        failed = [o for o in outs if not isinstance(o, list)]
        if extra or failed:
            fail(f"serve_router ({name}): dead events {extra}, failed "
                 f"requests {failed}; events {router.events}")

    truth = Engine(cfg, params, cim_mode="off", seed=0, **kw)

    # (a) the determinism premise: two replicas, the same 4 rids
    p2 = pool("a_2_replicas", 2, cim_mode="off")
    (d0, d1), _ = counted(lambda: [
        e.generate(reqs(RT_LENS[:4], RT_NEW, RT_TEMPS, "d")) for e in p2])
    checks["a_same_streams_across_replicas"] = (
        d0 == d1 and all(len(o) == RT_NEW for o in d0))

    # (b) 3 replicas: no fault (timed), then r1 killed at step 4
    p3 = pool("b_3_replicas", 3, cim_mode="off")
    timed = ReplicaRouter(p3, timing=True)
    nf, nf_wall = counted(lambda: timed.generate(
        reqs(RT_LENS, RT_NEW, RT_TEMPS)))
    fault_free("b no fault", timed, nf)
    victim, at_kill = p3[1], {}
    real_kill = victim.kill

    def kill(reason="device lost"):
        at_kill["replays"] = victim.replay_count
        real_kill(reason)

    victim.kill = kill
    rb = ReplicaRouter(p3, replica_fault=ReplicaFaultSpec(
        mode="kill", at_step=4, victim=1))
    ob, _ = counted(lambda: rb.generate(reqs(RT_LENS, RT_NEW, RT_TEMPS)))
    fault_free("b", rb, ob, ("r1",))
    one, one_wall = counted(lambda: truth.generate(
        reqs(RT_LENS, RT_NEW, RT_TEMPS)))
    kinds = [e["kind"] for e in rb.events]
    checks["b_no_fault_equals_single_engine"] = nf == one
    checks["b_kill_equals_single_engine"] = ob == one
    checks["b_kill_dead_migrate_delivered"] = (
        "kill" in kinds and "dead" in kinds and any(
            e["kind"] == "migrate" and e["delivered"] > 0
            for e in rb.events))
    checks["b_r1_dead"] = rb.replica_states()[1]["state"] == "dead"
    checks["b_no_replay_after_kill"] = (
        at_kill.get("replays") is not None
        and victim.replay_count == at_kill["replays"])
    checks["b_replayed"] = all(e.replay_count > 0 and not e.fallbacks
                               for e in p3)
    b_events = rb.events
    nf_toks = sum(len(o) for o in nf)
    timing = {"router_host_ms_per_tick": 1e3 * timed.host_s
              / timed.step_count,
              "replicas_busy_ms_per_tick": 1e3 * sum(timed.busy_s)
              / timed.step_count,
              "ticks": timed.step_count,
              "pool_session_tok_per_s": nf_toks / nf_wall,
              "single_engine_session_tok_per_s": nf_toks / one_wall,
              "pool_session_s": nf_wall, "single_engine_session_s": one_wall}
    del timed, rb, victim
    p3.clear()

    # (c) (a)'s replicas: r0 killed mid-chunked-prefill
    rc = ReplicaRouter(p2, replica_fault=ReplicaFaultSpec(
        mode="kill", at_step=2, victim=0))
    oc, _ = counted(lambda: rc.generate(
        reqs((300, 300), RT_NEW, (0.0, 0.7), "long")))
    fault_free("c", rc, oc, ("r0",))
    mig_c = [e for e in rc.events if e["kind"] == "migrate"]
    checks["c_equals_single_engine"] = oc == truth.generate(
        reqs((300, 300), RT_NEW, (0.0, 0.7), "long"))
    checks["c_migrated_mid_prefill"] = bool(mig_c) and all(
        e["delivered"] == 0 for e in mig_c)
    c_events = rc.events
    del rc
    p2.clear()

    # (d) r0 wedged at step 3, caught by the watchdog
    rd = ReplicaRouter(pool("d_2_replicas", 2, cim_mode="off"),
                       health=HealthPolicy(wedge_patience=3),
                       replica_fault=ReplicaFaultSpec(
                           mode="wedge", at_step=3, victim=0))
    wreqs = reqs(RT_WEDGE_LENS, RT_NEW, RT_TEMPS, "w")
    od, _ = counted(lambda: rd.generate(wreqs))
    fault_free("d", rd, od, ("r0",))
    dead_d = [e for e in rd.events if e["kind"] == "dead"]
    checks["d_equals_single_engine"] = od == truth.generate(
        reqs(RT_WEDGE_LENS, RT_NEW, RT_TEMPS, "w"))
    checks["d_wedged_dead_and_migrated"] = (
        bool(dead_d) and "wedged" in dead_d[0]["reason"]
        and any(rd.migrations_of(r) > 0 for r in wreqs))
    d_events = rd.events
    del rd

    # (e) (b)'s kill in sim mode on deployed planes, replayed
    pe = pool("e_3_replicas_sim", 3, cim_mode="sim")
    re_ = ReplicaRouter(pe, replica_fault=ReplicaFaultSpec(
        mode="kill", at_step=4, victim=1))
    oe, _ = counted(lambda: re_.generate(reqs(RT_LENS, RT_NEW)))
    fault_free("e", re_, oe, ("r1",))
    checks["e_sim_all_tokens_none_reemitted"] = all(
        len(o) == RT_NEW for o in oe)
    checks["e_sim_kill_migrated_delivered"] = (
        re_.replica_states()[1]["state"] == "dead" and any(
            e["kind"] == "migrate" and e["delivered"] > 0
            for e in re_.events))
    checks["e_sim_replayed"] = all(e.replay_count > 0 and not e.fallbacks
                                   for i, e in enumerate(pe) if i != 1)
    e_events = re_.events
    del re_
    pe.clear()

    # (f) a drift storm on r1, guarded per call, at RT_STORM_LAYERS layers
    c4 = dataclasses.replace(cfg, n_layers=RT_STORM_LAYERS)
    p4 = dict(params, blocks={k: _tree_first(v, RT_STORM_LAYERS)
                              for k, v in params["blocks"].items()})
    storm = ReplicaFaultSpec(mode="storm", victim=1,
                             storm_transient_mag=64.0)
    pf = pool("f_3_replicas_storm", 3, c4, p4, cim_mode="sim", guard=True,
              replica_fault=storm)
    rf = ReplicaRouter(pf, replica_fault=storm)
    of, _ = counted(lambda: rf.generate(
        reqs(RT_STORM_LENS, RT_STORM_NEW, tag="s")))
    fault_free("f", rf, of)
    drains = [e for e in rf.events if e["kind"] == "drain"]
    hard = [int(e.guard_hard_counts.sum()) for e in pf]
    checks["f_storm_drains_r1_only"] = bool(drains) and all(
        e["replica"] == "r1" for e in drains)
    checks["f_r1_not_dead"] = rf.replica_states()[1]["state"] != "dead"
    checks["f_all_complete"] = all(len(o) == RT_STORM_NEW for o in of)
    checks["f_hard_trips_on_r1_only"] = hard[1] > 0 and hard[0] == hard[2] == 0
    f_events = rf.events
    del rf
    pf.clear()

    # (g) the front-end over 2 replicas, r0 killed at step 5
    rg = ReplicaRouter(pool("g_2_replicas", 2, cim_mode="off"),
                       replica_fault=ReplicaFaultSpec(
                           mode="kill", at_step=5, victim=0))
    clock = {"t": 0.0}
    fe = Frontend(rg, queue_limit=16, clock=lambda: clock["t"])
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in RT_FE_LENS]

    def drive():
        tks = [fe.submit(pr, RT_FE_NEW, rid=f"fe{i}")
               for i, pr in enumerate(prompts)]
        while fe.pending():
            fe.tick(clock["t"])
            clock["t"] += FE_DT
            if clock["t"] > 2000 * FE_DT:
                fail("serve_router (g): the front-end wedged")
        return tks

    tks, _ = counted(drive)
    recs = [t.record for t in tks]
    fault_free("g", rg, [t.tokens for t in tks], ("r0",))
    g_truth = truth.generate([Request(prompt=np.asarray(pr),
                                      max_new_tokens=RT_FE_NEW, rid=f"fe{i}")
                              for i, pr in enumerate(prompts)])
    checks["g_all_completed_with_replica"] = all(
        r.outcome == "completed" and r.replica in ("r0", "r1")
        for r in recs)
    checks["g_migrations"] = sum(r.migrations for r in recs) >= 1
    checks["g_equals_single_engine"] = [t.tokens for t in tks] == g_truth
    g_events = rg.events
    del rg, fe

    if not all(checks.values()):
        fail(f"serve_router: {checks}; events (b) {b_events}, (c) "
             f"{c_events}, (d) {d_events}, (e) {e_events}, (f) {f_events}, "
             f"(g) {g_events}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    new_s = time.perf_counter() - t_start
    emit("serve_router", arch=cfg.name, n_layers=cfg.n_layers,
         dtype=cfg.dtype, slots_per_replica=2, chunk=32,
         prompt_lens=list(RT_LENS), new_tokens=RT_NEW,
         storm_reduced={"n_layers": [cfg.n_layers, RT_STORM_LAYERS]},
         checks=checks, **timing, build_s=builds,
         events={"b": b_events, "c": c_events, "d": d_events,
                 "e": e_events, "f": f_events, "g": g_events},
         guard_hard_per_replica_f=hard,
         frontend_records_g=[(t.rid, t.record.replica, t.record.migrations)
                             for t in tks],
         peak_mem_gib=peak, launches=launches, seconds=new_s)
    del truth
    torch.cuda.empty_cache()
    return launches, new_s


# ------------------------------------------------- the registry's archs
# the registry's archs built from the GQA attention block and zamba2-7b's
# hybrid, served at full width through the engine (whisper-medium, which
# the token-only engine does not serve, is decoded by cached forwards in
# ``serve_whisper``); two depth cuts: deepseek-67b's 95 layers (126 GB of
# bf16 weights) to 32, and olmoe-1b-7b's 16 to 2 for the script's time
# (its eager expert banks took 97 s at 16 layers; 2 run the same kernels
# and the same banks; phase tensor_parallel serves it at 2 layers too)
ARCHS = ("internlm2-1.8b", "phi3-mini-3.8b", "deepseek-67b", "pixtral-12b",
         "olmoe-1b-7b", "zamba2-7b")
ARCH_LAYERS = {"deepseek-67b": 32, "olmoe-1b-7b": 2}
ARCH_PEAK_GIB = 72.0       # deepseek-67b at 32 layers must stay under it
# off-mode logits, kernels against plain versions on the card, per row:
# max |error| over the row's largest |logit|. Sound runs read at most
# 0.034 (decode steps) and 0.044 (pixtral's prefix); the control, the
# plain versions with the newest DROP_KEYS live keys of every decode row
# dropped, at least 0.16 (0.53 with 32 dropped; with one dropped 0.04-0.50,
# not always beyond the sound runs). The limit lies between, and the
# control must exceed it.
ARCH_LOGIT_TOL = 0.08
DROP_KEYS = 4


SIM_HORIZON = 4            # sim-mode tokens arch_parity holds card = CPU


def arch_config(arch, mode="sim", reduced=False, **over):
    """``arch`` in ``mode`` on the CIM kernel path and the attention
    kernels (bf16 KV cache); full width with ARCH_LAYERS' depth cut, or
    the reduced config."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else dataclasses.replace(
        cfg, n_layers=ARCH_LAYERS.get(arch, cfg.n_layers))
    return dataclasses.replace(cfg, **over, attn_impl="kernel",
                               cim=dataclasses.replace(cfg.cim, mode=mode,
                                                       use_kernel=True))


def ssm_plain(conv, xbc, conv_w, conv_b, dt1, a, d, state, d_inner,
              ngroups, d_state, state_out=None):
    """``ssm_decode_step``'s plain version on the card, called as the
    wrapper is (the conv weights widened, the state written to
    ``state_out``), as its CPU path runs it."""
    from repro_torch.kernels.ssm_scan import ssm_decode_step_plain
    y, c, st = ssm_decode_step_plain(conv, xbc, conv_w.float(),
                                     conv_b.float(), dt1, a, d, state,
                                     d_inner, ngroups, d_state)
    if state_out is not None:
        st = state_out.copy_(st)
    return y, c, st


class routes:
    """Context manager over the model's kernel routes (the CIM kernel,
    decode and flash GQA attention, the selective-scan decode step): with
    ``plain`` they run their plain versions on the card (``drop``: the
    control, decode attention with the newest ``drop`` live keys of each
    row dropped, at least one kept); otherwise every call runs the kernel
    and is recorded with its operands and output in ``calls`` (the scan's
    window and state, which it updates in place, as copies from before and
    after the call)."""

    def __init__(self, plain=False, drop=0):
        self.plain, self.drop, self.calls = plain, drop, []

    @staticmethod
    def _targets():
        from repro_torch.kernels import ops
        from repro_torch.models import attention, ssm
        return ((ops, "cim_matmul_fused"), (attention, "decode_attention"),
                (attention, "flash_gqa_attention"), (ssm, "ssm_decode_step"))

    def __enter__(self):
        from repro_torch.kernels.cim_matmul import cim_matmul_fused_plain
        from repro_torch.kernels.decode_attention import \
            decode_attention_plain
        from repro_torch.kernels.flash_attention import flash_gqa_plain
        self.saved = [getattr(m, n) for m, n in self._targets()]

        def rec(kind, fn):
            def call(*a, **k):
                if kind == "ssm":       # window and state before the call
                    before = (a[0].clone(), a[7].clone())
                out = fn(*a, **k)
                if kind == "ssm":
                    self.calls.append((kind, (before[0],) + a[1:7]
                                       + (before[1],) + a[8:], {},
                                       tuple(t.clone() for t in out)))
                else:
                    self.calls.append((kind, a, k, out))
                return out
            return call

        def dropped(q, k, v, lens, *a, **kw):
            return decode_attention_plain(
                q, k, v, (lens - self.drop).clamp(min=1), *a, **kw)

        new = ((cim_matmul_fused_plain,
                dropped if self.drop else decode_attention_plain,
                flash_gqa_plain, ssm_plain)
               if self.plain else [rec(n, f) for n, f in zip(
                   ("cim", "decode", "flash", "ssm"), self.saved)])
        for (m, n), f in zip(self._targets(), new):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self._targets(), self.saved):
            setattr(m, n, f)


def greedy_forward(cfg, params, batch, steps, dev, t_max, forced=None,
                   key=21):
    """Greedy tokens of ``steps`` cached forwards after a prefill of
    ``batch`` (patch prefix or frames, and tokens), step ``i`` keyed
    ``fold_in(PRNGKey(key), i)``, on ``dev``; ``forced`` (B, steps) feeds
    those tokens instead of the greedy ones. Returns the tokens (B, steps)
    and each step's last-position logits (B, steps, V), on the CPU."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx
    p = _tree_to(params, dev)
    if cfg.cim.mode == "sim":
        p = deploy(cfg, p)
    b = {k: v.to(dev) for k, v in batch.items()}
    caches = tf.init_caches(cfg, b["tokens"].shape[0], t_max, dev)
    toks, last = [], []
    for i in range(steps):
        ctx = Ctx.make(cfg, prng.fold_in(prng.PRNGKey(key), i),
                       mode=cfg.cim.mode, deployed=cfg.cim.mode == "sim")
        logits, caches = tf.forward(p, b, cfg, ctx, caches)
        last.append(logits[:, -1].float().cpu())
        nxt = logits[:, -1].float().argmax(-1)
        toks.append(nxt)
        if forced is not None:
            nxt = forced[:, i].to(dev)
        b = {"tokens": nxt[:, None]}
    return torch.stack(toks, 1).cpu(), torch.stack(last, 1)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _tree_first(tree, n):
    """The first ``n`` layers of a stacked (layers-leading) params tree."""
    if isinstance(tree, dict):
        return {k: _tree_first(v, n) for k, v in tree.items()}
    return tree[:n]


def phase_arch_parity():
    """Reduced configs of the new archs: greedy tokens on the card (CIM,
    decode and flash kernels, the selective scan) equal the CPU's (plain
    versions), in off and sim mode, with the same parameters: olmoe (moe
    with GQA) and the dense archs at their published head dims
    (phi3-mini-3.8b's 96, internlm2's 128) through the engine (4 prompts
    with a 1-token one, 2 slots, 8 new tokens); zamba2-7b (hybrid) the
    same way at chunk 8, on the card replayed (CUDA graphs) and per call,
    which must give the same tokens and launch counts; pixtral-12b with an
    8-position patch prefix through cached forwards (prefill of the prefix
    and 24 tokens, then 8 decode steps) and whisper-medium (encdec) on 32
    seeded stub frames (prefill of 12 decoder tokens, then 8 greedy
    steps). Off mode holds every token; sim mode the first
    ``SIM_HORIZON`` of each request (the short horizon of ROADMAP's
    contract: the card's float order and Box-Muller ulps move an
    activation by about 1e-6 of its value, which puts one in the next
    4-bit bucket about once in 1e5, and a flip can turn a later greedy
    token), and reports how many of all the tokens are equal. Returns the
    seconds the zamba2 and whisper runs took."""
    import torch
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.kernels.ssm_scan import ssm_decode_step
    from repro_torch.serving.engine import Engine, Request

    t0 = time.perf_counter()
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention,
               ssm_decode_step)
    res, new_s = {}, 0.0
    for arch, hd in (("olmoe-1b-7b", 64), ("phi3-mini-3.8b", 96),
                     ("internlm2-1.8b", 128), ("pixtral-12b", 64),
                     ("zamba2-7b", 64), ("whisper-medium", 64)):
        t_arch = time.perf_counter()
        for mode in ("off", "sim"):
            cfg = arch_config(arch, mode, reduced=True, head_dim=hd)
            params = init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
            outs, counts = {}, {}
            if cfg.family in ("vlm", "encdec"):
                g = torch.Generator().manual_seed(4)
                width = 24 if cfg.family == "vlm" else 12
                batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                                 (2, width), generator=g)}
                if cfg.family == "vlm":
                    batch["patch_embeds"] = 0.02 * torch.randn(
                        (2, cfg.n_patches, cfg.d_model), generator=g)
                else:
                    batch["frames"] = torch.randn(
                        (2, cfg.n_frames, cfg.d_model), generator=g)
                for dev in ("cuda", "cpu"):
                    for k in kernels:
                        k.launches = 0
                    outs[dev] = greedy_forward(cfg, params, batch, 9, dev,
                                               64)[0].tolist()
                    counts[dev] = {k.__name__: k.launches for k in kernels}
                if cfg.family == "encdec":
                    forced = encdec_forced(cfg, params, batch, outs["cpu"])
            else:
                rng = np.random.default_rng(3)
                prompts = [rng.integers(0, cfg.vocab_size, n)
                           for n in (40, 1, 90, 57)]
                runs = (("cuda", True), ("cuda", False), ("cpu", None)) \
                    if cfg.family == "hybrid" else (("cuda", None),
                                                    ("cpu", None))
                for dev, fused in runs:
                    eng = Engine(cfg, params, max_slots=2, max_len=128,
                                 attn_impl="kernel", fused_step=fused,
                                 chunk_size=8 if cfg.family == "hybrid"
                                 else None, device=dev)
                    for k in kernels:      # after the capture's warm-up
                        k.launches = 0
                    name = dev if fused is not False else "cuda per call"
                    outs[name] = eng.generate(
                        [Request(prompt=p, max_new_tokens=8, rid=f"p{i}")
                         for i, p in enumerate(prompts)])
                    counts[name] = {k.__name__: k.launches for k in kernels}
                    if dev == "cuda" and fused and not (
                            eng.fused_step and eng.replay_count
                            and eng.fused_ok):
                        fail(f"arch_parity {arch} {mode}: the engine did "
                             f"not replay its graphs")
                if "cuda per call" in outs and (
                        outs["cuda per call"] != outs["cuda"]
                        or counts["cuda per call"] != counts["cuda"]):
                    fail(f"arch_parity {arch} {mode}: replayed "
                         f"{outs['cuda']} {counts['cuda']} != per call "
                         f"{outs['cuda per call']} "
                         f"{counts['cuda per call']}")
            n = 8 if mode == "off" else SIM_HORIZON
            if cfg.family == "encdec" and mode == "sim":
                n = 1               # see encdec_forced
            held = [list(o[:n]) for o in outs["cuda"]] == [
                list(o[:n]) for o in outs["cpu"]]
            if cfg.family == "encdec" and not forced["held"]:
                fail(f"arch_parity {arch} {mode}: teacher-forced logits, "
                     f"card vs CPU {forced}")
            agree = sum(a == b for o, c in zip(outs["cuda"], outs["cpu"])
                        for a, b in zip(o, c))
            c = counts["cuda"]
            if (not held or not c["decode_attention"]
                    or not c["flash_gqa_attention"]
                    or (mode == "sim" and not c["cim_matmul_fused"])
                    or (cfg.family == "hybrid"
                        and not c["ssm_decode_step"])):
                fail(f"arch_parity {arch} D={hd} {mode}: tokens differ "
                     f"within {n}: cuda {outs['cuda']} vs cpu {outs['cpu']} "
                     f"(launches {c})")
            total = sum(map(len, outs["cpu"]))
            res[f"{arch} D={hd} {mode}"] = {
                "held_tokens": n, "equal_tokens": f"{agree}/{total}",
                "tokens": outs["cuda"], "launches": c,
                **({"replayed_equals_per_call": True}
                   if "cuda per call" in outs else {}),
                **({"teacher_forced": forced}
                   if cfg.family == "encdec" else {})}
        if arch in ("zamba2-7b", "whisper-medium"):
            new_s += time.perf_counter() - t_arch
    emit("arch_parity", equal=True, runs=res, new_archs_s=new_s,
         seconds=time.perf_counter() - t0)
    return new_s


ENCDEC_OFF_TOL = 1e-5      # off-mode logits, card vs CPU, times the row max


def encdec_forced(cfg, params, batch, cpu_tokens):
    """The reduced whisper's cached forwards on the card and on the CPU fed
    the CPU's greedy tokens, each step's logits compared per row (max |card
    - CPU| over the row's largest |CPU|). Off mode: within ENCDEC_OFF_TOL
    at every step (the greedy tokens alone say little: the reduced model
    repeats one token in off mode). Sim mode: at every step closer to the
    CPU's logits than the CPU's own logits under another noise key are;
    the sim tokens are held for the first (the prefill's) only, since the
    encoder's activation scale, a mean over the batch that the card sums
    in another order, lands an ulp off and moves one 4-bit activation of
    the first encoder layer across a bucket edge (a CPU run with the
    scales one ulp up reproduces the card's memory to 4e-7:
    ``tools/encdec_sim_drift.py``), which moves the decoder's logits by
    10-20 % of a row's largest."""
    import torch
    forced = torch.tensor(cpu_tokens)
    card = greedy_forward(cfg, params, batch, 9, "cuda", 64, forced)[1]
    cpu = greedy_forward(cfg, params, batch, 9, "cpu", 64, forced)[1]
    rel = logits_rel(card, cpu).reshape(forced.shape).amax(0)
    out = {"card_vs_cpu": rel.tolist()}
    if cfg.cim.mode == "off":
        out["held"] = bool(rel.max() <= ENCDEC_OFF_TOL)
        out["limit"] = ENCDEC_OFF_TOL
    else:
        other = greedy_forward(cfg, params, batch, 9, "cpu", 64, forced,
                               key=22)[1]
        orel = logits_rel(other, cpu).reshape(forced.shape).amin(0)
        out["another_key_vs_cpu"] = orel.tolist()
        out["held"] = bool((rel < orel).all())
    return out


def arch_units(cfg):
    """Kernel calls of one forward of ``cfg``: ``cim`` CIM calls, 7 a
    layer (q, k, v, o, gate, up, down), 4 for moe with GQA (q, k, v, o:
    the router is digital and the expert banks behavioural), for hybrid 11
    a super-block (in_proj, out_proj of two mamba layers, then the shared
    block's 7); ``attn`` attention layers (one decode or flash call each);
    ``ssm`` mamba layers (one selective scan a decode step)."""
    if cfg.family == "hybrid":
        n_super, n_mamba = (cfg.n_layers // cfg.attn_period,
                            cfg.attn_period - 1)
        return {"cim": (2 * n_mamba + 7) * n_super, "attn": n_super,
                "ssm": n_mamba * n_super}
    return {"cim": (4 if cfg.family == "moe" else 7) * cfg.n_layers,
            "attn": cfg.n_layers, "ssm": 0}


def arch_launches(cfg, n_chunks, n_decode):
    """Launches of rows 1-3 and 8 a session of ``cfg`` makes
    (``arch_units`` a forward): the CIM kernel every forward, decode
    attention and the selective scan every decode step, flash prefill
    every chunk."""
    u = arch_units(cfg)
    return {"cim_matmul_fused": u["cim"] * (n_chunks + n_decode),
            "decode_attention": u["attn"] * n_decode,
            "flash_gqa_attention": u["attn"] * n_chunks,
            "ssm_decode_step": u["ssm"] * n_decode}


def logits_rel(a, b):
    """Per row: max |a - b| over the row's largest |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1)).reshape(-1)


def ssm_call_errs(a, out, ref):
    """A model's selective-scan call against its plain result, row by row
    (a state row is one (slot, head, p) over N, a y row one (slot, head)
    over P): the error over the row's largest magnitude of the terms that
    rounding acts on. A float32 sum's rounding scales with its terms, not
    with its result, and on a model's operands the conv's four taps and
    bias cancel in some channels (never in ``ssm_check``'s synthetic
    ones), where an ulp of the terms is a large part of x, B or C. So each
    conv output carries m = sum_w |window_w w_w| + |bias| + |silu(conv)|,
    the state's terms |state exp(dt A)| + |dt| m_x m_B, y's sum_n |state|
    m_C + |D| m_x."""
    import torch
    from repro_torch.kernels.ssm_scan import silu
    conv, xbc, conv_w, conv_b, dt1, A, D, state, di, g, n = a
    f32 = torch.float32
    h = A.shape[0]
    win = torch.cat([conv.to(xbc.dtype), xbc], dim=1).to(f32)
    w, bias = conv_w.to(f32), conv_b.to(f32)
    xc = silu(torch.einsum("bwc,wc->bc", win, w) + bias)
    m = torch.einsum("bwc,wc->bc", win.abs(), w.abs()) + bias.abs() \
        + xc.abs()
    mx = m[:, :di].reshape(-1, h, di // h)
    mb = m[:, di:di + g * n].reshape(-1, g, n)[:, 0]
    mc = m[:, di + g * n:].reshape(-1, g, n)[:, 0]
    da = torch.exp(dt1 * A[None, :])[..., None, None]
    s_scale = ((state * da).abs()
               + (dt1.abs()[:, :, None] * mx)[..., None] * mb[:, None, None])
    y_scale = (torch.einsum("bhpn,bn->bhp", ref[2].abs(), mc)
               + (D.abs()[None, :, None] * mx))
    b = state.shape[0]
    return {"state": ((out[2] - ref[2]).abs().amax(-1)
                      / s_scale.amax(-1).clamp(min=1e-30)),
            "y": ((out[0] - ref[0]).view(b, h, -1).abs().amax(-1)
                  / y_scale.amax(-1).clamp(min=1e-30))}


def check_recorded(calls, where):
    """Each recorded kernel call against its plain version on the call's
    own operands, at the kernel checks' tolerances: the CIM kernel's
    integer part exactly and its noisy output within
    ``cim_operands_check``'s limit; attention rows within 2^-6 of each
    query head's row max (``row_check``); the selective scan's y and state
    rows within SSM_TOL of each row's largest magnitude of terms
    (``ssm_call_errs``) and its window exactly. Returns
    the worst error over the row scale and the number of calls, by
    kernel."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_gqa_plain
    worst = {"cim": 0.0, "decode": 0.0, "flash": 0.0, "ssm": 0.0}
    n = {"cim": 0, "decode": 0, "flash": 0, "ssm": 0}
    for kind, a, k, out in calls:
        if kind == "cim":
            rel = cim_operands_check(*a, **k)[1]
        elif kind == "ssm":
            ref = ssm_plain(*a)
            rel = {k: v.max().item() for k, v in
                   ssm_call_errs(a, out, ref).items()}
            if (max(rel.values()) > SSM_TOL
                    or not torch.equal(out[1], ref[1])):
                fail(f"{where}: the selective scan differs from its plain "
                     f"version on its operands: {rel} (limit {SSM_TOL}), "
                     f"window equal {torch.equal(out[1], ref[1])}")
            rel = max(rel.values())
        else:
            plain = decode_attention_plain if kind == "decode" else \
                flash_gqa_plain
            _, rel, bad = row_check(out.float(), plain(*a, **k).float())
            if bad:
                fail(f"{where}: {kind} attention differs from its plain "
                     f"version on its operands ({bad:.3f} of the rows)")
        worst[kind] = max(worst[kind], rel)
        n[kind] += 1
    return worst, n


def step_logits(cfg, params, batch, caches, key, mode="sim", plain=False,
                record=False, drop=0):
    """Logits of one cached forward from a copy of ``caches`` (and the
    updated copy), through the kernels or (``plain``) their plain
    versions (``drop``: ``routes``' control); ``record``: also the kernel
    calls (``routes``)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx
    c = {n: v.clone() for n, v in caches.items()}
    ctx = Ctx.make(cfg, key, mode=mode, deployed=True)
    route = (routes(plain, drop) if plain or record
             else contextlib.nullcontext())
    with route:
        logits, c = tf.forward(params, batch, cfg, ctx, c)
    return logits, c, route.calls if record else None


def decode_step_device_ms(eng):
    """Device-busy ms of one engine step in pure decode (one replay of the
    decode graph, or one per-call forward): the kernel intervals the
    profiler saw inside a marked step, after a 50 ms spin and one step it
    does not read (it loses its first milliseconds of kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(2e9 * 0.05))
        eng.step()
        torch.cuda.synchronize()
        with record_function("measured"):
            eng.step()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    mark = [e.time_range for e in prof.events()
            if e.name == "measured" and e.device_type == cuda]
    events = [e for e in prof.events() if e.device_type == cuda
              and e.name != "measured" and mark
              and mark[0].start <= e.time_range.start
              and e.time_range.end <= mark[0].end]
    return busy_ms(events, 1) if events else None


def serve_arch(arch, smi):
    """One arch at full width (``arch_config``), bf16, sim mode on
    deployed planes, the session of cells A-F: replayed (CUDA graphs of
    the decode step and the chunk) for the dense, vlm and hybrid archs,
    per call for moe. Checks: every request completes with 16 in-range
    tokens; the launches of rows 1-3 and 8 equal ``arch_launches``; 4
    slots prefilled with a
    32-token chunk each, then every kernel call of a second chunk (start
    32) and of the first decode step against its plain version on its own
    operands (``check_recorded``); that step's logits through the kernels
    against those through the plain versions on the card: in off mode
    within ARCH_LOGIT_TOL of each row's largest |logit|, which the control
    (``routes``' ``drop``) exceeds, in sim mode below the reading under
    another noise key. Reports session tok/s, TTFT, the decode step's
    device ms, peak memory, the int8 planes and the least time a decode
    step takes to stream them (zamba2-7b: its mamba planes once, the
    shared block's 27 times, since 205 MB of them do not stay in the 50 MB
    L2 between super-blocks)."""
    import gc
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import prng
    from repro_torch.core.deploy import init_params, plane_summary
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.kernels.ssm_scan import ssm_decode_step
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Engine, Request

    t0 = time.perf_counter()
    cfg = arch_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    graphed = cfg.family != "moe"
    eng = Engine(cfg, params, max_slots=4, max_len=320, attn_impl="kernel",
                 fused_step=graphed, record_ttft=True, record_steps=True,
                 device="cuda")
    del params
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=16, rid=f"r{i}")
            for i, n in enumerate(SESSION_LENS)]
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention,
               ssm_decode_step)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = {k.__name__: k.launches for k in kernels}
    bad = [o for o in outs if not isinstance(o, list) or len(o) != 16
           or not all(0 <= t < cfg.vocab_size for t in o)]
    if bad:
        fail(f"serve_archs {arch}: failed, short or out-of-range requests: "
             f"{bad}")
    n_chunks = sum(e["chunks"] for e in eng.step_log)
    n_decode = sum(e["decode"] for e in eng.step_log)
    expect = arch_launches(cfg, n_chunks, n_decode)
    if counts != expect or not n_decode:
        fail(f"serve_archs {arch}: launches {counts} != expected {expect}")
    if graphed and (not eng.fused_ok or eng.fallbacks or not all(
            e["graph"] for e in eng.step_log)):
        fail(f"serve_archs {arch}: an iteration left the graphs")
    dec = [e["s"] for e in eng.step_log if e["decode"] and not e["chunks"]]
    ttft = [t for t in eng.ttft_s if t is not None]
    numbers = {"session_tok_per_s": sum(map(len, outs)) / wall,
               "wall_s": wall, "chunks": n_chunks, "decode_steps": n_decode,
               "pure_decode_step_ms_mean": 1e3 * float(np.mean(dec)),
               "ttft_ms_mean": 1e3 * float(np.mean(ttft)),
               "ttft_ms_max": 1e3 * float(np.max(ttft))}

    # the first decode step of 4 slots prefilled with the first chunk of
    # the session's first 4 prompts: kernels vs plain
    eng.begin()
    for r in reqs[:4]:
        eng.submit(Request(prompt=r.prompt[:32], max_new_tokens=8))
    while not all(eng._decoding):
        eng._fill_slots()
        eng._prefill_chunks()
    u = arch_units(cfg)
    chunk = torch.as_tensor(np.asarray(reqs[1].prompt[32:64])[None],
                            device="cuda")
    ck, _, calls = step_logits(cfg, eng.params, {"tokens": chunk},
                               tf.take_slot(eng.caches, 1),
                               prng.PRNGKey(124), record=True)
    worst_c, n_chunk = check_recorded(calls, f"serve_archs {arch} chunk")
    del calls
    if (n_chunk != {"cim": u["cim"], "decode": 0, "flash": u["attn"],
                    "ssm": 0}
            or not bool(torch.isfinite(ck).all())):
        fail(f"serve_archs {arch}: a prefill chunk made {n_chunk} kernel "
             f"calls or non-finite logits")
    args = (cfg, eng.params, {"tokens": eng.last_tok[:, None]}, eng.caches,
            prng.PRNGKey(123))
    kern, _, calls = step_logits(*args, record=True)
    worst, n_calls = check_recorded(calls, f"serve_archs {arch}")
    del calls
    if n_calls != {"cim": u["cim"], "decode": u["attn"], "flash": 0,
                   "ssm": u["ssm"]}:
        fail(f"serve_archs {arch}: a decode step made {n_calls} kernel calls")
    plain = step_logits(*args, plain=True)[0]
    sim_rel = logits_rel(kern, plain)
    other = logits_rel(step_logits(*args[:4], prng.PRNGKey(321))[0], plain)
    del plain
    plain = step_logits(*args, mode="off", plain=True)[0]
    off = logits_rel(step_logits(*args, mode="off")[0], plain)
    ctrl = logits_rel(step_logits(*args, mode="off", plain=True,
                                  drop=DROP_KEYS)[0], plain)
    del plain
    if (not bool(torch.isfinite(kern).all())
            or tuple(kern.shape) != (4, 1, cfg.vocab_size)
            or off.max().item() > ARCH_LOGIT_TOL
            or not ctrl.min().item() > ARCH_LOGIT_TOL
            or not sim_rel.max().item() < other.min().item()):
        fail(f"serve_archs {arch}: first decode step's logits, kernels vs "
             f"plain: off {off.tolist()} (limit {ARCH_LOGIT_TOL}, control "
             f"{ctrl.tolist()} must exceed it), sim {sim_rel.tolist()}, sim "
             f"under another key {other.tolist()}")
    eng.step()                    # the first decode step (and a warm-up)
    step_dev_ms = decode_step_device_ms(eng)
    extra = {}
    if cfg.family == "vlm":
        extra = vlm_prefix_check(cfg, eng.params)
    peak = torch.cuda.max_memory_allocated()
    if arch == "deepseek-67b" and peak / 2 ** 30 > ARCH_PEAK_GIB:
        fail(f"serve_archs {arch}: peak memory {peak / 2 ** 30:.2f} GiB > "
             f"{ARCH_PEAK_GIB}")
    planes = plane_summary(eng.params)
    stream = planes["int8_bytes"]
    if cfg.family == "hybrid":
        stream = (plane_summary(eng.params["mamba_blocks"])["int8_bytes"]
                  + u["attn"] * plane_summary(
                      eng.params["shared_attn"])["int8_bytes"])
    emit("serve_archs", arch=arch, family=cfg.family, n_layers=cfg.n_layers,
         reduced={"n_layers": f"{get_config(arch).n_layers} -> "
                  f"{cfg.n_layers}"} if arch in ARCH_LAYERS else {},
         head_dim=cfg.hd,
         heads=[cfg.n_heads, cfg.n_kv_heads], d_model=cfg.d_model,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype=cfg.dtype,
         replayed=graphed, requests=len(reqs), prompt_lens=list(SESSION_LENS),
         new_tokens=16, slots=4, **numbers, launches=counts, expected=expect,
         chunk_calls_vs_plain={"calls": n_chunk,
                               "max_err_over_row_max": worst_c},
         first_step_calls_vs_plain={"calls": n_calls,
                                    "max_err_over_row_max": worst},
         first_step_logits_err_over_row_max={
             "off": off.tolist(), f"off_control_drop{DROP_KEYS}":
             ctrl.tolist(), "sim": sim_rel.tolist(),
             "sim_another_key": other.tolist()},
         logit_tol=f"off {ARCH_LOGIT_TOL}*max|row|, below the control's; "
                   "sim below another key's",
         decode_step_device_ms=step_dev_ms,
         peak_memory_gib=peak / 2 ** 30,
         memory_before_gib=base / 2 ** 30,
         int8_plane_gib=planes["int8_bytes"] / 2 ** 30,
         plane_stream_bound_ms=None if cfg.family == "moe"
         else 1e3 * stream / HBM_BPS, **extra,
         setup_s=setup_s, seconds=time.perf_counter() - t0, card=smi)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def vlm_prefix_check(cfg, params):
    """Pixtral's stub patch prefix: one cached forward of 1024 stub patch
    embeddings (N(0, 0.02^2)) and 64 tokens, a flash prefill at T = 1088,
    then 4 decode steps, in sim mode through the kernels (their tokens
    feed the next step). The prefill's kernel calls against their plain
    versions on their own operands: every flash call, and the CIM calls of
    its first layer (every layer has the same shapes; the plain noisy CIM
    version of all 40 would draw 22 G eager normals). At each step the
    same forward in off mode through the kernels and through the plain
    versions, from the same cache, their logits within ARCH_LOGIT_TOL per
    row; at each decode step the control (``routes``' ``drop``: the
    DROP_KEYS newest of about 1090 keys) reads beyond it."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.models import transformer as tf

    g = torch.Generator(device="cuda").manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 64),
                                     generator=g, device="cuda"),
             "patch_embeds": (0.02 * torch.randn(
                 (1, cfg.n_patches, cfg.d_model), generator=g,
                 device="cuda")).to(torch.bfloat16)}
    caches = tf.init_caches(cfg, 1, cfg.n_patches + 64 + 32, "cuda")
    before = flash_gqa_attention.launches
    errs, ctrls = [], []
    for i in range(5):
        key = prng.fold_in(prng.PRNGKey(9), i)
        kern, new_caches, calls = step_logits(cfg, params, batch, caches, key,
                                              record=i == 0)
        if i == 0:
            n = {k: sum(c[0] == k for c in calls) for k in ("cim", "flash")}
            if n != {"cim": 7 * cfg.n_layers, "flash": cfg.n_layers}:
                fail(f"serve_archs pixtral prefix: the prefill made {n} "
                     f"kernel calls")
            worst, n_checked = check_recorded(
                [c for c in calls if c[0] == "flash"]
                + [c for c in calls if c[0] == "cim"][:7],
                "serve_archs pixtral prefix")
            del calls
        plain = step_logits(cfg, params, batch, caches, key, "off",
                            plain=True)[0]
        rel = logits_rel(step_logits(cfg, params, batch, caches, key,
                                     "off")[0], plain)
        errs.append(rel.max().item())
        if i:
            ctrls.append(logits_rel(step_logits(
                cfg, params, batch, caches, key, "off", plain=True,
                drop=DROP_KEYS)[0], plain).min().item())
        del plain
        if (not bool(torch.isfinite(kern).all()) or errs[-1] > ARCH_LOGIT_TOL
                or (i and not ctrls[-1] > ARCH_LOGIT_TOL)):
            fail(f"serve_archs pixtral prefix step {i}: off-mode logits "
                 f"kernels vs plain {errs[-1]} > {ARCH_LOGIT_TOL} or the "
                 f"control {ctrls[-1:]} not beyond it")
        caches = new_caches
        batch = {"tokens": kern[:, -1].float().argmax(-1)[:, None]}
    if flash_gqa_attention.launches - before != 2 * cfg.n_layers:
        fail("serve_archs pixtral prefix: the prefill did not run the flash "
             "kernel in every layer")
    return {"patch_prefix": {"patches": cfg.n_patches, "tokens": 64,
                             "prefill_T": int(tf.cache_len(caches)[0]) - 4,
                             "decode_steps": 4,
                             "prefill_calls_vs_plain": {
                                 "checked": n_checked,
                                 "max_err_over_row_max": worst},
                             "off_logits_err_over_row_max": errs,
                             f"off_control_drop{DROP_KEYS}_min": ctrls}}


# run M: whisper-medium's batch, decoder prompt, decoder context (the
# published 448 positions) and greedy steps after the prefill; its control
# drops the newest 16 of the first decode step's 65 self-attention keys
# (4 moved the reduced model's logits by 0.04-0.08 only: the decoder's
# cross-attention, which the control leaves whole, carries much of them)
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_CTX, WHISPER_STEPS = 4, 64, 448, 16
WHISPER_DROP_KEYS = 16


def serve_whisper(smi):
    """Run M: whisper-medium at full width (24 encoder and 24 decoder
    layers, bf16), sim mode on deployed planes, decoded by cached forwards
    (the engines are token-only): a batch of WHISPER_BATCH requests, each
    with its own seeded stub frames (N(0, 1), n_frames x d_model) and a
    WHISPER_PROMPT-token decoder prompt, one prefill (the encoder, the
    cross K/V and the decoder prompt through flash) into a WHISPER_CTX
    cache, then WHISPER_STEPS greedy decode steps. Checks: the launches
    of rows 1-3 equal their closed form (the CIM kernel 6 an encoder
    layer, 10 a decoder layer on the prefill and 8 a decode step; flash a
    decoder layer on the prefill, decode attention a decoder layer a
    step); every kernel call of the prefill against its plain version on
    its own operands (flash in every decoder layer, the CIM calls of the
    encoder's first and last layers at M = 6000 and all of the
    decoder's), and every call of the first decode step; that step's
    logits as in ``serve_arch`` (off mode within ARCH_LOGIT_TOL, the
    control, WHISPER_DROP_KEYS dropped, beyond it; sim closer than another
    key). Reports the encoder's
    and a decode step's device ms, the decode tok/s, the prefill ms and
    the peak memory."""
    import gc
    import torch
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy, init_params, plane_summary
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Ctx

    t0 = time.perf_counter()
    cfg = arch_config("whisper-medium")
    B, E, L = WHISPER_BATCH, cfg.n_enc_layers, cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = deploy(cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    frames = torch.stack([torch.randn(
        (cfg.n_frames, cfg.d_model), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(100 + i))
        for i in range(B)]).to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(12)
    prompt = torch.randint(0, cfg.vocab_size, (B, WHISPER_PROMPT),
                           generator=g, device="cuda")
    empty = tf.init_caches(cfg, B, WHISPER_CTX, "cuda")
    caches = {k: v.clone() for k, v in empty.items()}

    def ctx(i):
        return Ctx.make(cfg, prng.fold_in(prng.PRNGKey(31), i),
                        mode="sim", deployed=True)

    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, caches = tf.forward(params, {"tokens": prompt, "frames": frames},
                                cfg, ctx(0), caches)
    tok = logits[:, -1].float().argmax(-1)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    after_prefill = {k: v.clone() for k, v in caches.items()}
    first = tok
    toks = [tok]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for i in range(WHISPER_STEPS):
        logits, caches = tf.forward(params, {"tokens": tok}, cfg,
                                    ctx(i + 1), caches)
        tok = logits[:, -1].float().argmax(-1)[:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t2
    counts = {k.__name__: k.launches for k in kernels}
    expect = {"cim_matmul_fused": 6 * E + 10 * L + 8 * L * WHISPER_STEPS,
              "decode_attention": L * WHISPER_STEPS,
              "flash_gqa_attention": L}
    out = torch.cat(toks, 1)
    if (counts != expect or tuple(out.shape) != (B, WHISPER_STEPS + 1)
            or not bool(((out >= 0) & (out < cfg.vocab_size)).all())
            or int(tf.cache_len(caches)[0]) != WHISPER_PROMPT
            + WHISPER_STEPS):
        fail(f"serve_whisper: launches {counts} != {expect} or tokens "
             f"{out.shape} out of range")

    # the prefill's calls against their plain versions, from an empty cache
    batch = {"tokens": prompt, "frames": frames}
    _, _, calls = step_logits(cfg, params, batch, empty, prng.PRNGKey(41),
                              record=True)
    cim = [c for c in calls if c[0] == "cim"]
    flash = [c for c in calls if c[0] == "flash"]
    if len(cim) != 6 * E + 10 * L or len(flash) != L or len(calls) != \
            len(cim) + len(flash):
        fail(f"serve_whisper: the prefill made {len(cim)} CIM and "
             f"{len(flash)} flash calls of {len(calls)}")
    held = flash + cim[:6] + cim[6 * E - 6:]   # encoder: first, last layer
    del calls, cim[:6 * E]
    worst_p, n_prefill = check_recorded(held + cim, "serve_whisper prefill")
    del held, cim, flash

    # the first decode step: every call vs plain, the logits kernels vs plain
    args = (cfg, params, {"tokens": first}, after_prefill, prng.PRNGKey(42))
    kern, _, calls = step_logits(*args, record=True)
    worst, n_calls = check_recorded(calls, "serve_whisper decode")
    del calls
    if n_calls != {"cim": 8 * L, "decode": L, "flash": 0, "ssm": 0}:
        fail(f"serve_whisper: a decode step made {n_calls} kernel calls")
    plain = step_logits(*args, plain=True)[0]
    sim_rel = logits_rel(kern, plain)
    other = logits_rel(step_logits(*args[:4], prng.PRNGKey(321))[0], plain)
    del plain
    plain = step_logits(*args, mode="off", plain=True)[0]
    off = logits_rel(step_logits(*args, mode="off")[0], plain)
    ctrl = logits_rel(step_logits(*args, mode="off", plain=True,
                                  drop=WHISPER_DROP_KEYS)[0], plain)
    del plain
    if (not bool(torch.isfinite(kern).all())
            or tuple(kern.shape) != (B, 1, cfg.vocab_size)
            or off.max().item() > ARCH_LOGIT_TOL
            or not ctrl.min().item() > ARCH_LOGIT_TOL
            or not sim_rel.max().item() < other.min().item()):
        fail(f"serve_whisper: first decode step's logits, kernels vs plain: "
             f"off {off.tolist()} (limit {ARCH_LOGIT_TOL}, control "
             f"{ctrl.tolist()} must exceed it), sim {sim_rel.tolist()}, sim "
             f"under another key {other.tolist()}")
    enc_ms, enc_top = device_breakdown(
        lambda: tf.encode(params, frames, cfg, ctx(0)))
    step_ms, step_top = device_breakdown(
        lambda: tf.forward(params, {"tokens": tok}, cfg, ctx(99), caches))
    peak = torch.cuda.max_memory_allocated()
    emit("serve_whisper", arch="whisper-medium", family=cfg.family,
         n_layers=L, n_enc_layers=E, n_frames=cfg.n_frames,
         head_dim=cfg.hd, heads=[cfg.n_heads, cfg.n_kv_heads],
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         dtype=cfg.dtype, batch=B, prompt_len=WHISPER_PROMPT,
         decoder_ctx=WHISPER_CTX, greedy_steps=WHISPER_STEPS,
         launches=counts, expected=expect, prefill_ms=1e3 * prefill_s,
         decode_tok_per_s=B * WHISPER_STEPS / decode_s,
         decode_step_ms_mean=1e3 * decode_s / WHISPER_STEPS,
         prefill_calls_vs_plain={"calls": n_prefill,
                                 "max_err_over_row_max": worst_p},
         first_step_calls_vs_plain={"calls": n_calls,
                                    "max_err_over_row_max": worst},
         first_step_logits_err_over_row_max={
             "off": off.tolist(), f"off_control_drop{WHISPER_DROP_KEYS}":
             ctrl.tolist(), "sim": sim_rel.tolist(),
             "sim_another_key": other.tolist()},
         encoder_device_ms=enc_ms, encoder_top_kernels_ms=enc_top,
         decode_step_device_ms=step_ms, decode_step_top_kernels_ms=step_top,
         peak_memory_gib=peak / 2 ** 30,
         int8_plane_gib=plane_summary(params)["int8_bytes"] / 2 ** 30,
         seconds=time.perf_counter() - t0, card=smi)
    del params, caches, after_prefill, empty, frames
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_serve_archs():
    """The six archs at full width (``ARCH_LAYERS``' depth cuts) and run
    M; returns the launches of rows 1-3 and 8 summed over their sessions
    and the seconds of runs L and M."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    total, new_s = {}, 0.0
    for arch in ARCHS + ("whisper-medium",):
        t0 = time.perf_counter()
        counts = (serve_whisper(smi) if arch == "whisper-medium"
                  else serve_arch(arch, smi))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if arch in ("zamba2-7b", "whisper-medium"):
            new_s += time.perf_counter() - t0
    return total, new_s


def phase_times_wide_heads():
    """Rows 2 and 3 at head dims 96 and 112, each on its arch's unit (bf16
    cache, MHA): phi3-mini-3.8b (32 layers, 32 heads of 96) and zamba2-7b
    (its 27 attention layers, 32 heads of 112). One decode step (B = 4,
    lens 300/137/95/211 after the write, T = 320) and one 32-token
    prefill chunk (start 128) by the profiler, beside the plain versions,
    one scaled_dot_product_attention call of the same function and the
    bound (the live cache bytes over 3.35 TB/s, or the operations over
    the bf16 peak). Returns the times and the seconds of the D 112 unit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_gqa_attention,
                                                     flash_gqa_plain)
    t0 = time.perf_counter()
    res, d112_s = {}, 0.0
    for arch, tag in (("phi3-mini-3.8b", "D96"), ("zamba2-7b", "D112")):
        t_unit = time.perf_counter()
        cfg = arch_config(arch)
        L = arch_units(cfg)["attn"]
        h, kv, hd, t = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 320
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(96)
        lens = torch.tensor([300, 137, 95, 211], dtype=torch.int32,
                            device=dev)
        caches = [tuple(torch.randn((4, t, kv, hd), generator=g, device=dev)
                        .bfloat16() for _ in range(2)) for _ in range(L)]
        q = torch.randn((4, h, hd), generator=g, device=dev).bfloat16()
        live = int(lens.sum())
        b2 = L * (2 * live * kv * hd * 2 + 2 * q.numel() * 2)
        o2 = L * 4 * live * h * hd
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]
                )[:, None, None, :]
        res[f"decode_attention[{tag}]"] = dict(
            ms=device_ms(lambda: [decode_attention(q, k, v, lens)
                                  for k, v in caches], 10),
            plain_ms=device_ms(lambda: [decode_attention_plain(q, k, v, lens)
                                        for k, v in caches], 3),
            library_ms=device_ms(lambda: [F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask) for k, v in caches], 10),
            bound_ms=1e3 * max(b2 / HBM_BPS, o2 / BF16_OPS),
            bound_by="bytes" if b2 / HBM_BPS >= o2 / BF16_OPS
            else "operations",
            unit=f"one decode step: {L} layers, B=4, H=KV={h}, D={hd}, lens "
                 + str(lens.tolist()))
        s, start = 32, 128
        qf = torch.randn((1, s, h, hd), generator=g, device=dev).bfloat16()
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        one = [(k[:1], v[:1]) for k, v in caches]
        b3 = L * (2 * (start + s) * kv * hd * 2 + 2 * qf.numel() * 2)
        o3 = L * 4 * h * hd * sum(start + i + 1 for i in range(s))
        qi = torch.arange(s, device=dev)[:, None] + start
        kj = torch.arange(t, device=dev)[None, :]
        fmask = ((kj <= qi) & (kj < start + s))[None, None]
        res[f"flash_gqa[{tag}]"] = dict(
            ms=device_ms(lambda: [flash_gqa_attention(qf, k, v, st)
                                  for k, v in one], 10),
            plain_ms=device_ms(lambda: [flash_gqa_plain(qf, k, v, st)
                                        for k, v in one], 3),
            library_ms=device_ms(lambda: [F.scaled_dot_product_attention(
                qf.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=fmask) for k, v in one], 10),
            bound_ms=1e3 * max(b3 / HBM_BPS, o3 / BF16_OPS),
            bound_by="bytes" if b3 / HBM_BPS >= o3 / BF16_OPS
            else "operations",
            unit=f"one prefill chunk: {L} layers, S=32, start=128, "
                 f"H=KV={h}, D={hd}")
        del caches, one
        if tag == "D112":
            d112_s = time.perf_counter() - t_unit
    for name, r in res.items():
        emit("time", kernel=name, **r)
    emit("times_wide_heads", seconds=time.perf_counter() - t0,
         d112_s=d112_s)
    return res, d112_s


# ------------------------------------------- qat serving, examples, A7.1
QAT_HORIZON = 4            # qat tokens held card = CPU (a noisy mode, C4)
QAT_LENS = (32, 29, 17, 9)  # one prefill chunk each: qat runs per call
QAT_NEW = 4


def phase_serve_qat(params):
    """``cim_mode="qat"`` in the engine (fake-quant of every CIM linear
    plus readout noise under the layer's host key, on the float weights,
    served per call): (a) the reduced qwen2's first 4 greedy tokens card =
    CPU; (b) qwen2-0.5b at full width and depth (bf16, kernel attention)
    serves 4 requests x 4 tokens, its launch counts zeroed just before and
    read just after (the CIM kernel 0), host ms and device ms of a pure
    decode step (profiler) and the peak memory; (c) ``fused_step=True``
    raises. Returns (attention launches of (b), seconds). For the
    script's time each prompt is one prefill chunk: a qat forward is
    some 40000 eager launches (about 0.8 s of host at full width)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deploy import init_params
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    from repro_torch.serving.engine import Engine, Request

    t_start = time.perf_counter()
    base = get_config("qwen2-0.5b").reduced()
    rcfg = dataclasses.replace(base, cim=dataclasses.replace(
        base.cim, mode="qat"))
    rparams = init_params(rcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, rcfg.vocab_size, n) for n in (40, 90, 57)]
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(rcfg, rparams, max_slots=2, max_len=128,
                     attn_impl="kernel", device=dev)
        if eng.deployed or eng.fused_step:
            fail(f"qat engine on {dev}: deployed {eng.deployed}, "
                 f"fused_step {eng.fused_step}")
        outs[dev] = [o[:QAT_HORIZON] for o in eng.generate(
            [Request(prompt=p, max_new_tokens=QAT_HORIZON, rid=f"q{i}")
             for i, p in enumerate(prompts)])]
    if outs["cuda"] != outs["cpu"]:
        fail(f"qat: reduced-model tokens differ: cuda {outs['cuda']} vs "
             f"cpu {outs['cpu']}")
    parity_s = time.perf_counter() - t_start
    try:
        Engine(rcfg, rparams, fused_step=True, device="cuda")
        fail("qat: fused_step=True did not raise")
    except NotImplementedError as e:
        if "qat" not in str(e):
            fail(f"qat: fused_step=True raised {e!r}")

    cfg = dataclasses.replace(full_config(False), cim=dataclasses.replace(
        full_config(False).cim, mode="qat"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=4, max_len=320, attn_impl="kernel",
                 record_ttft=True, record_steps=True, device="cuda")
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=QAT_NEW, rid=f"r{i}")
            for i, n in enumerate(QAT_LENS)]
    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    n_chunks = sum(e["chunks"] for e in eng.step_log)
    n_decode = sum(e["decode"] for e in eng.step_log)
    L = cfg.n_layers
    bad = [o for o in got if not isinstance(o, list) or len(o) != QAT_NEW
           or not all(0 <= t < cfg.vocab_size for t in o)]
    if (bad or counts["cim_matmul_fused"] != 0
            or counts["decode_attention"] != L * n_decode
            or counts["flash_gqa_attention"] != L * n_chunks
            or eng.replay_count):
        fail(f"qat full width: bad requests {bad}, launches {counts} "
             f"({n_chunks} chunks, {n_decode} decode steps), "
             f"{eng.replay_count} replays")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # pure decode steps: 4 fresh requests of one chunk each, the chunks
    # and the first decode in one step (2 tokens), then 2 steps on the
    # host clock and 2 under the profiler (one warm-up; a step is some
    # 40000 kernel events to read back): 6 tokens each
    t0 = time.perf_counter()
    for i in range(4):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 24),
                           max_new_tokens=6, rid=f"d{i}"))
    eng.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t1) / 2
    dev_ms = device_ms(eng.step, 1)
    eng.drain_pending()
    if eng.has_work():
        fail("qat: the timed requests did not finish in 5 steps")
    timing_s = time.perf_counter() - t0
    seconds = time.perf_counter() - t_start
    emit("serve_qat", arch=cfg.name, dtype=cfg.dtype, n_layers=L,
         d_model=cfg.d_model, reduced_tokens_equal=True,
         reduced_horizon=QAT_HORIZON, fused_step_raises=True,
         requests=len(reqs), prompt_lens=list(QAT_LENS), new_tokens=QAT_NEW,
         slots=4, wall_s=wall, chunks=n_chunks, decode_steps=n_decode,
         launches=counts, pure_decode_step_host_ms=host_ms,
         pure_decode_step_device_ms=dev_ms, peak_mem_gib=peak_gib,
         parity_s=parity_s, timing_s=timing_s, seconds=seconds)
    return counts, seconds


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(ROOT, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples():
    """The four examples of the port through their ``main`` on the card,
    at cut sizes (steps, requests), one line each: the quickstart's
    metrics in the paper's bands; the serving example on the CIM kernel
    and the attention kernels, replayed (rows 1-3), its launch counts
    zeroed just before its ``main`` and read just after; the ViT and LM
    trainers for a few steps. Returns (CIM kernel launches, seconds)."""
    import shutil
    import torch
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    q = _example("quickstart").main(["--device", "cuda"])
    bands = {"sqnr_db": (45.3, 2.0), "csnr_db": (31.3, 2.0),
             "peak_tops_w": (818.0, 1.0), "sac_gain": (2.1, 0.05)}
    off = {k: q[k] for k, (c, tol) in bands.items()
           if not abs(q[k] - c) < tol}
    if off:
        fail(f"example quickstart: {off} outside the bands {bands}")
    emit("example_quickstart", **q, bands=bands,
         seconds=time.perf_counter() - t0)

    kernels = (cim_matmul_fused, decode_attention, flash_gqa_attention)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    sv = _example("serve_lm_cim").main(
        ["--device", "cuda", "--requests", "4", "--new-tokens", "8",
         "--use-kernel", "--attn-impl", "kernel"])
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in kernels}
    eng = sv["engine"]
    if (any(len(o) != 8 for o in sv["outs"]) or not eng.fused_step
            or eng.replay_count == 0 or eng.fallbacks
            or min(counts.values()) == 0):
        fail(f"example serve_lm_cim: outputs {sv['outs']}, fused_step "
             f"{eng.fused_step}, {eng.replay_count} replays, launches "
             f"{counts}")
    emit("example_serve_lm_cim", requests=4, new_tokens=8,
         tok_s=sv["tok_s"], replay_count=eng.replay_count,
         launches=counts, sac_saving=sv["e_base"] / sv["e_sac"],
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    vit = _example("train_vit_cim").main(
        ["--device", "cuda", "--steps", "10", "--batch", "32",
         "--eval-batches", "2"])
    if not np.isfinite(vit["loss"]):
        fail(f"example train_vit_cim: loss {vit['loss']}")
    emit("example_train_vit_cim", steps=10, batch=32, **vit,
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    ckpt = os.path.join(ROOT, "build", "chip_smoke_lm_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    lm = _example("train_lm_100m").main(
        ["--device", "cuda", "--steps", "6", "--batch", "8", "--seq", "128",
         "--qat", "--ckpt-dir", ckpt])
    shutil.rmtree(ckpt, ignore_errors=True)
    loss = float(lm["metrics"]["loss"])
    if lm["last_step"] != 6 or not np.isfinite(loss):
        fail(f"example train_lm_100m: {lm['last_step']} steps, loss {loss}")
    emit("example_train_lm_100m", steps=6, batch=8, seq=128, dim=256,
         layers=8, loss=loss, seconds=time.perf_counter() - t0)
    return counts["cim_matmul_fused"], time.perf_counter() - t_start


DIST_WORLD = 2
DIST_TIMEOUT_S = 240
PIPE_TOL = 1e-6            # pipeline vs sequential, relative (norms)


def _dist_compress(rank, world):
    """compressed_dp_grads over the ranks against the same formula
    reckoned in this process from every rank's shard gradient."""
    import torch
    from repro_torch.core import prng
    from repro_torch.distributed.compression import (compressed_dp_grads,
                                                     quantize_int8)
    g = torch.Generator(device="cuda").manual_seed(40)
    d = 896
    params = {"w": torch.randn((d, d), generator=g, device="cuda") * d ** -.5,
              "b": torch.randn((d,), generator=g, device="cuda")}
    batch = {"x": torch.randn((16, d), generator=g, device="cuda")}

    def grad_fn(p, b):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        h = torch.tanh(b["x"] @ leaves["w"] + leaves["b"])
        gs = torch.autograd.grad((h ** 2).sum(), [leaves["b"], leaves["w"]])
        return {"b": gs[0], "w": gs[1]}

    key = prng.PRNGKey(17)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compressed_dp_grads(grad_fn, params, batch, key=key)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    n = batch["x"].shape[0] // world
    per = [grad_fn(params, {"x": batch["x"][r * n:(r + 1) * n]})
           for r in range(world)]
    # against the plain mean: the stochastic rounding's error, at most a
    # variance of scale^2 / 4 an element and rank, so the mean's error
    # norm is at most scale * sqrt(numel / (4 n)) in expectation; held
    # to twice that
    out = {"ms": ms, "equal": True, "rel_vs_mean": 0.0,
           "err_over_sr_bound": 0.0}
    for i, k in enumerate(sorted(per[0])):
        m = torch.stack([torch.maximum(p[k].abs().max(),
                                       torch.tensor(1e-12, device="cuda"))
                         for p in per]).max()
        scale = m / 127.0
        tot = sum(quantize_int8(p[k], prng.fold_in(prng.fold_in(key, i), r),
                                scale).to(torch.int32)
                  for r, p in enumerate(per))
        want = tot.to(torch.float32) * scale / world
        mean = sum(p[k] for p in per) / world
        out["equal"] &= bool(torch.equal(got[k], want))
        err = float(torch.linalg.norm(got[k] - mean))
        sr = float(scale) * (mean.numel() / (4 * world)) ** 0.5
        out["rel_vs_mean"] = max(out["rel_vs_mean"],
                                 err / float(torch.linalg.norm(mean)))
        out["err_over_sr_bound"] = max(out["err_over_sr_bound"], err / sr)
    return out


def _dist_pipeline(rank, world):
    """A 2-stage pipeline of residual blocks through row 5 (the
    straight-through ``ops.cim_matmul``, noise on) against the sequential
    stack of the same stages on the same microbatches in this process:
    outputs, this rank's stage gradient and (rank 0) the input's."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.sac import paper_sac
    from repro_torch.distributed import pipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.cim_matmul import cim_matmul_int8
    spec = paper_sac().mlp
    key = prng.PRNGKey(23)
    g = torch.Generator(device="cuda").manual_seed(41)
    d, b, n_micro = 896, 16, 4
    ws0 = torch.randn((world, d, d), generator=g, device="cuda") * d ** -0.5
    x0 = torch.randn((b, d), generator=g, device="cuda")

    def stage_fn(p, xb):
        return xb + ops.cim_matmul(xb, p["w"], spec,
                                   prng.fold_in(key, int(p["s"])))

    ws, x = ws0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    cim_matmul_int8.launches = 0
    staged = pipeline.HOST_STAGED
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = pipeline.pipeline_apply(stage_fn, {"w": ws, "s": torch.arange(world)},
                                x, n_micro=n_micro)
    (y ** 2).sum().backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = cim_matmul_int8.launches
    staged = pipeline.HOST_STAGED - staged
    ws2, x2 = ws0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    outs = []
    for m in x2.reshape(n_micro, b // n_micro, d):
        h = m
        for s in range(world):
            h = stage_fn({"w": ws2[s], "s": torch.tensor(s)}, h)
        outs.append(h)
    y2 = torch.cat(outs)
    (y2 ** 2).sum().backward()

    def rel(a, c):
        return float(torch.linalg.norm(a - c) / torch.linalg.norm(c))

    out = {"ms": ms, "launches": launches, "host_staged": staged,
           "y_rel": rel(y.detach(), y2.detach()),
           "gw_rel": rel(ws.grad[rank], ws2.grad[rank]),
           "y_finite": bool(torch.isfinite(y).all())}
    if rank == 0:
        out["gx_rel"] = rel(x.grad, x2.grad)
    return out


def _dist_deploy(rank, world, keep):
    """``deploy(rules=)`` of full-width qwen2-0.5b on a (data 1, model
    world) mesh: every plane's local shard bit-equal to its slice of the
    unsharded plane; row 1 (noise 0) on layer 0's q and gate shards equal
    to the column slice of the whole plane's output. Both trees and the
    rules stay in ``keep`` for ``_dist_tp``."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.core.deploy import (deploy, init_params,
                                         plane_logical_axes)
    from repro_torch.core.sac import get_policy
    from repro_torch.distributed.sharding import default_rules, local_slice
    from repro_torch.kernels.cim_matmul import cim_matmul_fused
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import param_specs
    cfg = full_config(False)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    mesh = make_debug_mesh(1, world)
    rules = default_rules(mesh)
    t0 = time.perf_counter()
    plain = deploy(cfg, params)
    shard = deploy(cfg, params, rules=rules)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    axes = param_specs(cfg)[1]
    coords = {"data": 0, "model": rank}
    out = {"planes": 0, "tp_sharded": 0, "mismatch": 0, "local_bytes": 0,
           "bytes": 0, "deploy_ms": ms}

    def walk(a, b, ax):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], ax.get(k, {}))
            elif k.startswith(("wq", "ws")):
                out["planes"] += 1
                if not isinstance(b[k], DTensor):
                    out["mismatch"] += 1
                    continue
                names = plane_logical_axes(ax["w"], k[:2])
                spec = rules.param_spec(names, tuple(a[k].shape))
                out["tp_sharded"] += "model" in spec
                loc = b[k].to_local()
                out["local_bytes"] += loc.numel() * loc.element_size()
                out["bytes"] += a[k].numel() * a[k].element_size()
                if not torch.equal(loc, a[k][local_slice(
                        spec, a[k].shape, mesh, coords)]):
                    out["mismatch"] += 1

    walk(plain, shard, axes)
    pol = get_policy(cfg.cim.policy)
    g = torch.Generator(device="cuda").manual_seed(7)
    for block, name, spec in (("attn", "q", pol.attn),
                              ("mlp", "gate", pol.mlp)):
        bits = spec.w_bits
        whole = plain["blocks"][block][name][f"wq{bits}"][0]
        part = shard["blocks"][block][name][f"wq{bits}"].to_local()[0]
        x = torch.randn((8, cfg.d_model), generator=g, device="cuda")
        qp = torch.tensor([0.02, 1e-3], device="cuda")
        y = cim_matmul_fused(x, part.contiguous(), qp, (1, 2), 0.0,
                             spec.in_bits)
        y_all = cim_matmul_fused(x, whole.contiguous(), qp, (1, 2), 0.0,
                                 spec.in_bits)
        n = part.shape[-1]
        out[f"row1_{name}_cols"] = n
        out[f"row1_{name}_equal"] = bool(torch.equal(
            y, y_all[:, rank * n:(rank + 1) * n]))
    keep.update(rules=rules, plain=plain, shard=shard)
    return out


TP_NEW = 4             # greedy decode steps of the tensor-parallel session
TP_PROMPT = (4, 32)    # its prefill: rows x tokens
TP_TOL = 1e-5          # TP logits vs one rank: times a row's max |logit|
TP_ROWS = (4, 128)     # row 1's shard checks: a decode step's, a chunk's M
TP_KERNELS = ("cim_matmul_fused", "cim_tile_partials", "cim_tile_merge",
              "decode_attention", "flash_gqa_attention")


def _launches():
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_gqa_attention
    return (cm.cim_matmul_fused, cm.cim_tile_partials, cm.cim_tile_merge,
            decode_attention, flash_gqa_attention)


def _greedy(cfg, params, rules, batch, key, steps, b, timed):
    """Prefill ``batch`` then ``steps`` greedy tokens through ``forward``
    with caches under ``rules``: the last position's global logits of
    every forward (f32), the tokens, host ms of each decode step."""
    import torch
    from repro_torch.core import prng
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build
    from repro_torch.models.parallel import gather_logits
    api = build(cfg)
    logits, tokens, ms = [], [], []
    with use_rules(rules):
        caches = tf.init_caches(cfg, b, batch.shape[1] + steps + 1, "cuda")
        for i in range(steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = api.forward(params, {"tokens": batch},
                                 prng.fold_in(key, i), caches)
            full = gather_logits(cfg, out, b)[:, -1].float()
            torch.cuda.synchronize()
            if i and timed:
                ms.append(1e3 * (time.perf_counter() - t0))
            nxt = full.argmax(-1)
            logits.append(full)
            tokens.append(nxt.tolist())
            batch = nxt[:, None]
    return logits, tokens, ms


def _dist_tp(rank, world, keep):
    """(a) of phase ``tensor_parallel``: full-width bf16 qwen2-0.5b in sim
    on the CIM kernel and the attention kernels, tensor-parallel on a
    (data 1, model 2) mesh (7 of 14 query heads over 1 of 2 KV heads a
    rank, d_ff 2432 a rank), a 4 x 32 prefill and 4 greedy decode steps;
    rank 0 also runs the one-rank forward of the same planes. Then row 1
    on layer 0's shards with the noise on: q and gate column shards
    against the whole plane's slice, o and down row shards (partials, an
    int32 all-reduce, the merge) against the whole launch."""
    import torch
    from repro_torch.core import prng, quant
    from repro_torch.core.sac import get_policy
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import pipeline
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(full_config(False), attn_impl="kernel")
    rules, plain, shard = keep["rules"], keep["plain"], keep["shard"]
    b, s = TP_PROMPT
    g = torch.Generator(device="cuda").manual_seed(11)
    batch = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                          device="cuda")
    key = prng.PRNGKey(21)
    for f in _launches():
        f.launches = 0
    for k in col.COUNTS:
        col.COUNTS[k] = 0
    staged0 = pipeline.HOST_STAGED
    logits, tokens, ms = _greedy(cfg, shard, rules, batch, key, TP_NEW, b,
                                 True)
    out = {"launches": {f.__name__: f.launches for f in _launches()},
           "collectives": dict(col.COUNTS),
           "host_staged": pipeline.HOST_STAGED - staged0,
           "tp_step_ms": float(np.mean(ms)), "tokens": tokens,
           "finite": bool(all(torch.isfinite(x).all() for x in logits))}
    def plane_bytes(node):
        if not isinstance(node, dict):
            return 0
        return sum(plane_bytes(v) if isinstance(v, dict) else
                   v.to_local().numel() * v.to_local().element_size()
                   if k.startswith(("wq", "ws")) else 0
                   for k, v in node.items())

    out["plane_bytes_rank"] = plane_bytes(shard)
    if rank == 0:
        one, one_tokens, one_ms = _greedy(cfg, plain, None, batch, key,
                                          TP_NEW, b, True)
        out["one_step_ms"] = float(np.mean(one_ms))
        out["one_tokens"] = one_tokens
        out["logit_err"] = max(
            float(((a - c).abs().amax(-1) / c.abs().amax(-1)).max())
            for a, c in zip(logits, one))
        out["logits_bit_equal"] = [bool(torch.equal(a, c))
                                   for a, c in zip(logits, one)]
    # row 1 on layer 0's shards, noise on
    lm = col.live_mesh(rules)
    pol = get_policy(cfg.cim.policy)
    eq = {}
    for blk, name, role in (("attn", "q", "attn_qkv"), ("mlp", "gate",
                                                        "mlp_in"),
                            ("attn", "o", "attn_out"), ("mlp", "down",
                                                        "mlp_out")):
        spec = pol.spec_for_role(role)
        bits = spec.w_bits
        whole = plain["blocks"][blk][name][f"wq{bits}"][0]
        ws = plain["blocks"][blk][name][f"ws{bits}"][0]
        part = shard["blocks"][blk][name][f"wq{bits}"].to_local()[0]
        k_dim, n_dim = whole.shape
        for m in TP_ROWS:
            gx = torch.Generator(device="cuda").manual_seed(m + k_dim)
            x = torch.randn((m, k_dim), generator=gx,
                            device="cuda").bfloat16()
            xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / \
                quant.qmax(spec.in_bits)
            want = ops.cim_matmul_deployed(x, whole, ws, spec,
                                           prng.PRNGKey(3), x_scale=xs)
            if part.shape[1] < n_dim:          # column shard
                n = part.shape[1]
                got = ops.cim_matmul_deployed(
                    x, part.contiguous(), ws, spec, prng.PRNGKey(3),
                    x_scale=xs, col0=rank * n)
                ok = torch.equal(got, want[:, rank * n:(rank + 1) * n])
            else:                              # row shard
                kl = part.shape[0]
                got = ops.cim_matmul_deployed_rows(
                    x[:, rank * kl:(rank + 1) * kl], part.contiguous(), ws,
                    spec, prng.PRNGKey(3), xs, rank * kl, k_dim,
                    lambda t: col.all_reduce(t, "model", lm))
                ok = torch.equal(got, want)
            eq[f"{name}_m{m}"] = bool(ok)
    out["row1_shards_bit_equal"] = eq
    return out


def _dist_rank(rank, world, run_dir):
    """One rank of the distributed phase (a spawned process): a gloo group
    over a file store in ``run_dir``, CUDA tensors on the one card; its
    results to ``run_dir/rank<r>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(run_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        out = {"rank": rank, "world": dist.get_world_size(),
               "up_s": time.perf_counter() - T0}
        keep = {}
        for name, fn in (("compress", _dist_compress),
                         ("pipeline", _dist_pipeline),
                         ("deploy", lambda r, w: _dist_deploy(r, w, keep)),
                         ("tp", lambda r, w: _dist_tp(r, w, keep))):
            t0 = time.perf_counter()
            out[name] = fn(rank, world)
            out[name]["s"] = time.perf_counter() - t0
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _spawn(target, world, name):
    """Spawn ``world`` ranks of ``target(rank, world, run_dir)`` on the one
    card (the kernels built by this process first, so the ranks load the
    library and never build) and return their results, rank order. A rank
    that raises, dies, hangs past twice ``DIST_TIMEOUT_S`` or writes no
    result fails the phase ``name``."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.kernels import _build
    _build.library()
    run_dir = os.path.join(ROOT, "build", f"chip_smoke_{name}")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.start_processes(target, args=(world, run_dir),
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + 2 * DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{2 * DIST_TIMEOUT_S} s")
    except Exception as e:      # a rank raised, died or hung
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        fail(f"{name}: a rank failed: {e}")
    res = []
    for r in range(world):
        path = os.path.join(run_dir, f"rank{r}.json")
        if not os.path.exists(path):
            fail(f"{name}: rank {r} of {world} wrote no result")
        with open(path) as f:
            res.append(json.load(f))
    shutil.rmtree(run_dir, ignore_errors=True)
    return res


def phase_distributed():
    """A7.1 on the card: two ranks spawned on the one H100 over a gloo
    process group with CUDA tensors (NCCL refuses two ranks on one
    device; gloo's point-to-point send and receive take no CUDA tensor, so
    the pipeline stages those hand-offs through host memory and counts
    them). This shows the code runs on the card; it measures no
    scale-out. The same pair then runs (a) of ``tensor_parallel``
    (``_dist_tp``), whose results it returns for that phase. Fails unless
    both ranks come up and every check holds. Returns the seconds and the
    ranks' results."""
    t0 = time.perf_counter()
    res = _spawn(_dist_rank, DIST_WORLD, "distributed")
    problems = []
    for r in res:
        c, p, d = r["compress"], r["pipeline"], r["deploy"]
        if r["world"] != DIST_WORLD:
            problems.append(f"rank {r['rank']} saw world {r['world']}")
        if not c["equal"] or c["err_over_sr_bound"] > 2.0:
            problems.append(f"rank {r['rank']} compression {c}")
        if (not p["y_finite"] or p["y_rel"] > PIPE_TOL
                or p["gw_rel"] > PIPE_TOL or p.get("gx_rel", 0) > PIPE_TOL
                or p["launches"] != 4 or p["host_staged"] == 0):
            problems.append(f"rank {r['rank']} pipeline {p}")
        if (d["mismatch"] or d["tp_sharded"] == 0
                or not d["row1_q_equal"] or not d["row1_gate_equal"]):
            problems.append(f"rank {r['rank']} deploy {d}")
    if problems:
        fail("distributed: " + "; ".join(problems))
    # the pair's tensor-parallel step is phase tensor_parallel's time
    seconds = time.perf_counter() - t0 - max(r["tp"]["s"] for r in res)
    emit("distributed", ranks=DIST_WORLD, backend="gloo", device="cuda:0",
         scale_out_measured=False,
         compress={"bit_equal_one_process": True,
                   "rel_vs_plain_mean": max(r["compress"]["rel_vs_mean"]
                                            for r in res),
                   "err_over_sr_bound": max(
                       r["compress"]["err_over_sr_bound"] for r in res),
                   "ms": [r["compress"]["ms"] for r in res]},
         pipeline={"stages": DIST_WORLD, "n_micro": 4,
                   "y_rel": max(r["pipeline"]["y_rel"] for r in res),
                   "grad_w_rel": max(r["pipeline"]["gw_rel"] for r in res),
                   "grad_x_rel": res[0]["pipeline"]["gx_rel"],
                   "tol": PIPE_TOL,
                   "cim_matmul_int8_launches": [r["pipeline"]["launches"]
                                                for r in res],
                   "host_staged": [r["pipeline"]["host_staged"] for r in res],
                   "ms": [r["pipeline"]["ms"] for r in res]},
         deploy={"arch": "qwen2-0.5b", "mesh": {"data": 1, "model": 2},
                 "planes": res[0]["deploy"]["planes"],
                 "tp_sharded": res[0]["deploy"]["tp_sharded"],
                 "local_bytes": [r["deploy"]["local_bytes"] for r in res],
                 "bytes": res[0]["deploy"]["bytes"],
                 "row1_q_cols": res[0]["deploy"]["row1_q_cols"],
                 "row1_gate_cols": res[0]["deploy"]["row1_gate_cols"],
                 "shards_bit_equal": True, "row1_shards_equal": True,
                 "deploy_ms": [r["deploy"]["deploy_ms"] for r in res]},
         rank_up_s=[r["up_s"] for r in res],
         part_s={k: [r[k]["s"] for r in res]
                 for k in ("compress", "pipeline", "deploy")},
         seconds=seconds)
    return seconds, res


ROW_PAR = (("o", "attn_out", 896, 896), ("down", "mlp_out", 4864, 896))


def phase_tile_kernels():
    """Row 1's row-parallel pair (``cim_tile_partials``, ``cim_tile_merge``)
    at qwen2-0.5b's o and down planes split over two ranks' rows (down's
    cut at 2432 inside macro tile 2), at M 4 (a decode step) and M 128 (a
    4 x 32 prefill): each rank's partials against their plain version
    (exact integers), the merge of their sum against its plain version
    (the noise's ulps) and bit-equal to one ``cim_matmul_fused`` launch on
    the whole plane (else the phase fails). Times (device ms, the
    profiler) of rank 0's partials and of the merge over the 24 layers'
    o and down, beside the whole plane's launch at the same shape; bounds
    from the bytes and the int8 operations (partials) or the noise's
    integer operations (merge); the yardstick of the partials at M 128
    ``torch._int_mm`` of the same int8 shard product (no tiles, no
    quantization). Returns the errors, the kernels line's times (M 4) and
    the seconds."""
    import torch
    from repro_torch.core import quant
    from repro_torch.core.cim import output_noise_std_int_per_tile
    from repro_torch.core.sac import paper_sac
    from repro_torch.kernels import cim_matmul as cm
    t_start = time.perf_counter()
    pol = paper_sac()
    dev = torch.device("cuda")
    layers, seed = 24, (5, 6)
    errs = {"cim_tile_partials": 0.0, "cim_tile_merge": 0.0}
    times = {}
    for m in (4, 128):
        calls = []
        for name, role, k, n in ROW_PAR:
            spec = pol.spec_for_role(role)
            bits = spec.in_bits
            g = torch.Generator(device=dev).manual_seed(m + k)
            x = torch.randn((m, k), generator=g, device=dev).bfloat16()
            wq = torch.randint(-31, 32, (k, n), generator=g, device=dev,
                               dtype=torch.int8)
            xs = 4.0 * torch.sqrt(torch.mean(x.float() ** 2)) / \
                quant.qmax(bits)
            qp = torch.stack([xs, xs * 0.0125])
            sigma = output_noise_std_int_per_tile(spec, k)
            h = k // 2
            total = None
            for r in range(2):
                xr = x[:, r * h:(r + 1) * h].contiguous()
                wr = wq[r * h:(r + 1) * h].contiguous()
                part = cm.cim_tile_partials(xr, wr, qp, bits, r * h, k)
                ref = cm.cim_tile_partials_plain(xr, wr, qp, bits, r * h, k)
                errs["cim_tile_partials"] = max(
                    errs["cim_tile_partials"],
                    float((part - ref).abs().max()))
                total = part if total is None else total + part
                if r == 0:
                    x0, w0 = xr, wr
            y = cm.cim_tile_merge(total, qp, seed, sigma)
            yp = cm.cim_tile_merge_plain(total, qp, seed, sigma)
            errs["cim_tile_merge"] = max(errs["cim_tile_merge"],
                                         float((y - yp).abs().max()))
            if not torch.equal(y, cm.cim_matmul_fused(x, wq, qp, seed, sigma,
                                                      bits)):
                fail(f"tile_kernels: {name} M={m}: partials + merge != the "
                     f"whole plane's launch")
            calls.append((x, wq, x0, w0, qp, total, sigma, bits, k, n))

        def run_part():
            for _, _, x0, w0, qp, _, _, bits, k, _ in calls:
                for _ in range(layers):
                    cm.cim_tile_partials(x0, w0, qp, bits, 0, k)

        def run_merge():
            for *_, qp, total, sigma, _, _, _ in calls:
                for _ in range(layers):
                    cm.cim_tile_merge(total, qp, seed, sigma)

        def run_whole():
            for x, wq, _, _, qp, _, sigma, bits, _, _ in calls:
                for _ in range(layers):
                    cm.cim_matmul_fused(x, wq, qp, seed, sigma, bits)

        def run_part_plain():
            for _, _, x0, w0, qp, _, _, bits, k, _ in calls:
                for _ in range(layers):
                    cm.cim_tile_partials_plain(x0, w0, qp, bits, 0, k)

        def run_merge_plain():
            for *_, qp, total, sigma, _, _, _ in calls:
                for _ in range(layers):
                    cm.cim_tile_merge_plain(total, qp, seed, sigma)

        part_ms, merge_ms = device_ms(run_part, 3), device_ms(run_merge, 3)
        whole_ms = device_ms(run_whole, 3)
        # the plain versions at the kernels line's unit (M 4) only
        part_plain = merge_plain = None
        if m == 4:
            part_plain, merge_plain = (device_ms(run_part_plain, 1),
                                       device_ms(run_merge_plain, 1))
        pb = po = mb = mn = 0
        for _, _, x0, w0, _, total, _, _, k, n in calls:
            touched = cm.tile_span(0, k // 2)[1]
            pb += x0.numel() * 2 + w0.numel() + touched * m * n * 4
            po += 2 * m * (k // 2) * n
            mb += total.numel() * 4 + m * n * 4
            mn += total.numel() * NOISE_INT_OPS
        pb, po, mb, mn = (layers * v for v in (pb, po, mb, mn))
        lib_ms = None
        if m > 16:
            lib = [(x0.float().round().clamp(-31, 31).to(torch.int8),
                    w0.t().contiguous().t()) for _, _, x0, w0, *_ in calls]

            def run_lib():
                for xq, wcol in lib:
                    for _ in range(layers):
                        torch._int_mm(xq, wcol)

            lib_ms = device_ms(run_lib, 3)
        unit = (f"rank 0's shards of one {'decode step' if m == 4 else
                'prefill chunk'}: o and down x 24 layers, M={m}")
        entry = {
            "cim_tile_partials": dict(
                ms=part_ms, plain_ms=part_plain,
                bound_ms=1e3 * max(pb / HBM_BPS, po / INT8_OPS),
                bound_by="bytes" if pb / HBM_BPS >= po / INT8_OPS
                else "operations", library_ms=lib_ms, unit=unit),
            "cim_tile_merge": dict(
                ms=merge_ms, plain_ms=merge_plain,
                bound_ms=1e3 * max(mb / HBM_BPS, mn / INT32_OPS),
                bound_by="bytes" if mb / HBM_BPS >= mn / INT32_OPS
                else "operations", library_ms=None, unit=unit)}
        emit("time", kernel="row_parallel", m=m, partials=entry[
            "cim_tile_partials"], merge=entry["cim_tile_merge"],
             partials_plus_merge_ms=part_ms + merge_ms,
             whole_plane_fused_ms=whole_ms,
             library="torch._int_mm(xq, wq) of rank 0's int8 shard "
                     "product" if lib_ms is not None else None)
        if m == 4:
            times.update(entry)
    emit("tile_kernels", errs=errs, seconds=time.perf_counter() - t_start)
    return errs, times, time.perf_counter() - t_start


EP_WORLD = 4
EP_MESH = (2, 2)       # (data, model)
EP_LAYERS = 2          # olmoe-1b-7b's 16 layers cut for the script's time
EP_PROMPT = (4, 128)   # 2 data groups of 256 tokens: the grouped dispatch
EP_TOL = 1e-5          # EP logits vs the grouped one rank, of a row's max


def _ep_rank(rank, world, run_dir):
    """(b) of phase ``tensor_parallel``, one of four spawned ranks: full-
    width float32 olmoe-1b-7b at 2 of its 16 layers in sim on the CIM
    kernel and the attention kernels, expert-parallel on a (data 2,
    model 2) mesh: a 4 x 128 prefill (2 data groups of 256 tokens, 32 of
    the 64 experts a rank) and one greedy decode step (one group over the
    all-gathered batch); rank 0 also runs the grouped forward in one
    process (rules on a ``VirtualMesh`` of the same shape: no
    collective) on the whole planes."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.core import prng
    from repro_torch.core.deploy import deploy, init_params
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import VirtualMesh, default_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(run_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        out = {"rank": rank, "up_s": time.perf_counter() - T0}
        t0 = time.perf_counter()
        cfg = dataclasses.replace(arch_config("olmoe-1b-7b"),
                                  n_layers=EP_LAYERS, dtype="float32")
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        rules = default_rules(make_debug_mesh(*EP_MESH))
        placed = deploy(cfg, params, rules=rules)
        bank = next(k for k in placed["blocks"]["moe"]
                    if k.startswith("w_gate_q"))
        out["local_experts"] = placed["blocks"]["moe"][bank].to_local(
            ).shape[1]
        b, s = EP_PROMPT
        g = torch.Generator(device="cuda").manual_seed(12)
        batch = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                              device="cuda")
        key = prng.PRNGKey(22)
        for f in _launches():
            f.launches = 0
        for k in col.COUNTS:
            col.COUNTS[k] = 0
        dispatch = []
        orig = moe.moe_block

        def spy(*a, **kw):
            y = orig(*a, **kw)
            dispatch.append(dict(moe.last_dispatch))
            return y

        moe.moe_block = spy
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, tokens, _ = _greedy(cfg, placed, rules, batch, key, 1, b,
                                    False)
        out["ep_s"] = time.perf_counter() - t1
        moe.moe_block = orig
        out["dispatch"] = dispatch
        out["launches"] = {f.__name__: f.launches for f in _launches()}
        out["collectives"] = dict(col.COUNTS)
        out["tokens"] = tokens
        out["finite"] = bool(all(torch.isfinite(x).all() for x in logits))
        del placed
        if rank == 0:
            whole = deploy(cfg, params)
            t1 = time.perf_counter()
            one, one_tokens, _ = _greedy(
                cfg, whole, default_rules(VirtualMesh.make(
                    data=EP_MESH[0], model=EP_MESH[1])), batch, key, 1, b,
                False)
            out["grouped_s"] = time.perf_counter() - t1
            out["one_tokens"] = one_tokens
            out["logit_err"] = max(
                float(((a - c).abs().amax(-1) / c.abs().amax(-1)).max())
                for a, c in zip(logits, one))
            out["logits_bit_equal"] = [bool(torch.equal(a, c))
                                       for a, c in zip(logits, one)]
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["s"] = time.perf_counter() - t0
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_tensor_parallel(dist_res):
    """A7.2 on the card, on ranks of the one H100 over gloo with CUDA
    tensors: (a) full-width qwen2-0.5b tensor-parallel on the distributed
    phase's pair (``_dist_tp``), (b) full-width olmoe-1b-7b (2 of 16
    layers) expert-parallel on four spawned ranks (``_ep_rank``). Ranks
    that share one card and a gloo group measure no scale-out. Fails
    unless every rank comes up and: the TP greedy tokens equal the one-
    rank tokens, its logits within ``TP_TOL`` of the one rank's; row 1's
    shards bit-equal with the noise on; rows 1-3 and the row-parallel
    entries launched on every rank; the EP prefill dispatched in 2 groups
    with 32 of 64 experts a rank (the expert-parallel path), the decode
    in one gathered group; the EP logits within ``EP_TOL`` of the grouped
    one-rank forward and its tokens equal. Returns the seconds and the
    launches of the main-path runs (both ranks' sums; the EP ranks'
    rows 1-3 and the row-parallel pair too)."""
    t0 = time.perf_counter()
    tp = [r["tp"] for r in dist_res]
    ep = _spawn(_ep_rank, EP_WORLD, "ep")
    problems = []
    a0 = tp[0]
    if a0["tokens"] != a0["one_tokens"]:
        problems.append(f"TP tokens {a0['tokens']} != one rank "
                        f"{a0['one_tokens']}")
    if not a0["logit_err"] <= TP_TOL:
        problems.append(f"TP logits {a0['logit_err']} > {TP_TOL}")
    for r, a in enumerate(tp):
        if not a["finite"] or a["tokens"] != a0["tokens"]:
            problems.append(f"TP rank {r} tokens or finiteness")
        bad = [k for k, v in a["row1_shards_bit_equal"].items() if not v]
        if bad:
            problems.append(f"TP rank {r} row 1 shards not bit-equal: {bad}")
        zero = [k for k, v in a["launches"].items() if not v]
        if zero:
            problems.append(f"TP rank {r} launched no {zero}")
    e0 = ep[0]
    for r, e in enumerate(ep):
        d = e["dispatch"]
        if e["local_experts"] != 32:
            problems.append(f"EP rank {r} holds {e['local_experts']} experts")
        pre = d[:EP_LAYERS]
        if len(d) != 2 * EP_LAYERS or any(
                x["groups"] != 2 or x["g_local"] != 1 or x["e_local"] != 32
                or x["gathered"] for x in pre) or any(
                x["groups"] != 1 or not x["gathered"] or x["e_local"] != 32
                for x in d[EP_LAYERS:]):
            problems.append(f"EP rank {r} dispatch {d}")
        if not e["finite"] or e["tokens"] != e0["tokens"]:
            problems.append(f"EP rank {r} tokens or finiteness")
        zero = [k for k, v in e["launches"].items() if not v]
        if zero:
            problems.append(f"EP rank {r} launched no {zero}")
    if e0["tokens"] != e0["one_tokens"] or not e0["logit_err"] <= EP_TOL:
        problems.append(f"EP vs grouped one rank: tokens {e0['tokens']} / "
                        f"{e0['one_tokens']}, logits {e0['logit_err']}")
    if problems:
        fail("tensor_parallel: " + "; ".join(problems))
    tp_s = max(a["s"] for a in tp)
    seconds = time.perf_counter() - t0 + tp_s
    launches = {k: sum(a["launches"][k] for a in tp)
                + sum(e["launches"][k] for e in ep) for k in TP_KERNELS}
    emit("tensor_parallel", scale_out_measured=False, backend="gloo",
         device="cuda:0",
         a={"arch": "qwen2-0.5b", "dtype": "bfloat16",
            "mesh": {"data": 1, "model": 2}, "ranks": DIST_WORLD,
            "traffic": f"{TP_PROMPT[0]} x {TP_PROMPT[1]} prefill, "
                       f"{TP_NEW} greedy decode steps",
            "tokens_equal_one_rank": True, "logit_err": a0["logit_err"],
            "tol": TP_TOL, "logits_bit_equal": a0["logits_bit_equal"],
            "row1_shards_bit_equal": a0["row1_shards_bit_equal"],
            "launches": [a["launches"] for a in tp],
            "collectives": [a["collectives"] for a in tp],
            "host_staged": [a["host_staged"] for a in tp],
            "tp_decode_step_host_ms": [a["tp_step_ms"] for a in tp],
            "one_rank_decode_step_host_ms": a0["one_step_ms"],
            "plane_bytes_rank": [a["plane_bytes_rank"] for a in tp],
            "s": [a["s"] for a in tp]},
         b={"arch": "olmoe-1b-7b", "dtype": "float32",
            "reduced": {"n_layers": [16, EP_LAYERS]},
            "mesh": {"data": EP_MESH[0], "model": EP_MESH[1]},
            "ranks": EP_WORLD,
            "traffic": f"{EP_PROMPT[0]} x {EP_PROMPT[1]} prefill, "
                       f"1 greedy decode step",
            "experts_rank": e0["local_experts"],
            "dispatch_rank0": e0["dispatch"],
            "tokens_equal_grouped": True, "logit_err": e0["logit_err"],
            "tol": EP_TOL, "logits_bit_equal": e0["logits_bit_equal"],
            "launches": [e["launches"] for e in ep],
            "collectives": [e["collectives"] for e in ep],
            "ep_s": [e["ep_s"] for e in ep], "grouped_s": e0["grouped_s"],
            "peak_gib_rank0": e0["peak_gib"],
            "rank_up_s": [e["up_s"] for e in ep], "s": [e["s"] for e in ep]},
         seconds=seconds)
    return seconds, launches


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
    from repro_torch.kernels.cim_matmul import (cim_tile_merge,
                                                cim_tile_partials)
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
    # cell B's per-call step is not profiled, for the script's time (about
    # 12 s; PERF.md §5 keeps its figure)
    profiles = {(int8, fused_step): phase_profile(
        params, full_config(int8), fused_step=fused_step)
        for int8, fused_step in ((False, True), (False, False), (True, True))}
    times = phase_times(params, cfg)
    phase_behavioural_sim(params)
    phase_fuse_fallback()
    phase_whole_prompt_loop_parity()
    t_robust = time.perf_counter()
    errs["cim_matmul_fused"] = max(errs["cim_matmul_fused"],
                                   phase_robust_kernel_checks())
    phase_robust_parity()
    runs["robust"], _ = phase_serve_robust(params, profiles[False, False])
    emit("robust", new_phases_s=time.perf_counter() - t_robust,
         new_phases_limit_s=100)
    runs["frontend"], frontend_s = phase_serve_frontend(params)
    emit("frontend", new_phases_s=frontend_s, new_phases_limit_s=60)
    runs["router"], router_s = phase_serve_router(params)
    emit("router", new_phases_s=router_s, new_phases_limit_s=60)
    runs["qat"], qat_s = phase_serve_qat(params)
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
    # replayed only: neither the per-call fused step (cells C and D, about
    # 9 s) nor the unfused float32 step (about 11 s) is profiled, for the
    # script's time (PERF.md §5 keeps their figures)
    for int8 in (False, True):
        phase_profile(params32, full_config32(int8), fuse_layer=True,
                      fused_step=True)
    phase_fused_reach(params32)
    phase_fused_tokens(params32, fused[False][1])
    times.update(phase_times_fused(params32))
    del params32
    torch.cuda.empty_cache()
    # the fused layer at head dims 96, 112 and 128 (B1)
    wide_errs, wide_times, wide_s = phase_fused_wide()
    wide_launches, params_g, served_s = phase_serve_fused_wide()
    wide_s += served_s + phase_fused_tokens_wide(params_g)
    del params_g
    torch.cuda.empty_cache()
    emit("fused_wide", new_phases_s=wide_s, new_phases_limit_s=60)
    for hd, arch in WIDE_ROW.items():
        name = f"fused_dense_layer[hd{hd}]"
        times[name], errs[name] = wide_times[arch], wide_errs[arch]
        runs[("fused_wide", hd)] = {"fused_dense_layer": wide_launches[hd]}
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
    # cell F's per-call step is not profiled, for the script's time (about
    # 39 s; PERF.md §5 keeps its figure)
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
    phase_paper_metrics()
    runs["vit"] = {"cim_matmul_fused": phase_vit_qat()}
    phase_train_lm()
    phase_paper_figures()
    t_archs = time.perf_counter()
    new_s = phase_arch_parity()
    runs["archs"], served_s = phase_serve_archs()
    new_s += served_s + phase_times_wide_heads()[1]
    emit("archs", seconds=time.perf_counter() - t_archs,
         new_phases_s=new_s, new_phases_limit_s=110)
    torch.cuda.empty_cache()
    runs["examples"], examples_s = phase_examples()
    dist_s, dist_res = phase_distributed()
    emit("qat_examples_distributed", new_phases_s=qat_s + examples_s + dist_s,
         new_phases_limit_s=90, serve_qat_s=qat_s, examples_s=examples_s,
         distributed_s=dist_s)
    tile_errs, tile_times, tile_s = phase_tile_kernels()
    errs.update(tile_errs)
    times.update(tile_times)
    tp_s, runs["tp"] = phase_tensor_parallel(dist_res)
    emit("distribution_a72", new_phases_s=tile_s + tp_s,
         new_phases_limit_s=90, tile_kernels_s=tile_s,
         tensor_parallel_s=tp_s)
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
           **{f"fused_dense_layer[hd{hd}]": (
               f"src/repro_torch/csrc/fused_layer_hd{hd}.cu",
               "src/repro/kernels/fused_step.py:327", fused_dense_layer,
               ("fused_wide", hd)) for hd in WIDE_ROW},
           "ssm_decode_step": ("src/repro_torch/csrc/ssm_scan.cu",
                               "src/repro/kernels/ssm_scan.py:140",
                               ssm_decode_step, "ssm"),
           "mla_decode_attention": ("src/repro_torch/csrc/mla_decode.cu",
                                    "src/repro/kernels/mla_decode.py:144",
                                    mla_decode_attention, "mla"),
           "cim_tile_partials": ("src/repro_torch/csrc/cim_matmul.cu",
                                 "src/repro/kernels/cim_matmul.py:340",
                                 cim_tile_partials, "tp"),
           "cim_tile_merge": ("src/repro_torch/csrc/cim_matmul.cu",
                              "src/repro/kernels/cim_matmul.py:340",
                              cim_tile_merge, "tp"),
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
        # bf16 qwen2 cells A and B, the mamba2 cell E, the deepseek-v2
        # cell F and the ViT's kernel-path evaluations for the CIM kernel,
        # which they share; the entry-point
        # phases cim_ste and flash_mha_check for the int8 CIM and MHA
        # kernels; the float32 cells C and D for the fused layer and the
        # f32-query GQA prefill, whose error phase_times_gqa_f32 keys by
        # name; serve_fused_wide's replayed runs for the fused layer at
        # head dims 96, 112 and 128)
        n = (runs[False][fn.__name__] + runs[True][fn.__name__]
             + runs["ssm"][fn.__name__] + runs["mla"][fn.__name__]
             + runs["vit"][fn.__name__]
             if ekey == "cim_matmul_fused" else
             runs["tp"][fn.__name__] if ekey == "tp" else
             runs["ste"][name] if ekey == "cim_matmul_int8" else
             runs["mha"][name] if ekey in ("mha", "mha[f32]") else
             runs[ekey][fn.__name__] if ekey in ("ssm", "mla")
             or ekey[0] in ("fused", "fused_wide")
             else runs[ekey[1]][fn.__name__])
        # the registry archs' runs G-M (bf16 caches) run rows 1-3 too,
        # zamba2-7b's (L) row 8
        if name in ("cim_matmul_fused", "decode_attention", "flash_gqa",
                    "ssm_decode_step"):
            n += runs["archs"][fn.__name__]
        # the robustness, the front-end and the router's sessions (bf16
        # qwen2, bf16 cache) run rows 1-3
        if name in ("cim_matmul_fused", "decode_attention", "flash_gqa"):
            n += (runs["robust"][fn.__name__] + runs["frontend"][fn.__name__]
                  + runs["router"][fn.__name__])
        # the qat session (bf16 qwen2, bf16 cache) runs rows 2 and 3, the
        # serving example (replayed) row 1 among others
        if name in ("decode_attention", "flash_gqa"):
            n += runs["qat"][fn.__name__]
        if name == "cim_matmul_fused":
            n += runs["examples"]
        # the tensor- and expert-parallel runs (phase tensor_parallel, every
        # rank) run rows 1-3 too
        if name in ("cim_matmul_fused", "decode_attention", "flash_gqa"):
            n += runs["tp"][fn.__name__]
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
