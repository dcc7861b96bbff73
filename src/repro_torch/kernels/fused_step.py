"""Per-layer decode megakernel: one dense layer's decode step in one launch.

Replaces ``src/repro/kernels/fused_step.py`` ``fused_dense_layer`` (TPU
kernel ``_kernel``, ``pl.pallas_call`` at :327); the kernel is
``csrc/fused_layer.cu``, whose note gives its bound on the H100 (the seven
int8 weight planes) and its design (one cooperative launch, five stages
between grid-wide barriers; every projection on the split-K GEMV of
``csrc/cim_gemv.cuh``, split as ``fused_layer_plan`` says, attention split
over key ranges, each merged in the stage by the last block to arrive;
every block computing the batch-global activation scales itself in one
fixed order).

``fused_dense_layer(ctx, p, x, cache)`` has the reference's contract: x
(B, 1, d) float32, the layer's cache view ``{k, v[, ks, vs], len}``;
returns ``(x_out (B, 1, d), cache)``. Like the port's ``gqa_attention`` it
writes the current token's K/V (int8 codes and scales with an int8 cache)
into the cache at the old ``len`` and advances ``len`` by one **in place**.
Projections run as in the unfused layer: ``mode="off"`` plain f32 dots;
``mode="sim"`` the deployed planes through the ``cim_matmul_fused``
contract, with the seven noise seeds drawn from ``ctx.next_key()`` in the
unfused layer's order (q, k, v, o, gate, up, down).

CPU tensors take ``fused_dense_layer_plain``, which follows the reference
kernel stage by stage with the port's own pieces (``rmsnorm``,
``apply_rope``, ``_kv_quant``, ``cim_matmul_fused_plain``,
``decode_attention_plain``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import CIMSpec, output_noise_std_int_per_tile
from repro_torch.kernels import _build
from repro_torch.kernels._attn import SM_COUNT, arrival_counters
from repro_torch.kernels.cim_matmul import (cim_matmul_fused_plain,
                                            split_geometry, split_lengths)
from repro_torch.kernels.decode_attention import decode_attention_plain

# projection order == the unfused layer's dense-call (and next_key) order
_ROLES = ("attn_qkv", "attn_qkv", "attn_qkv", "attn_out",
          "mlp_in", "mlp_in", "mlp_out")
_LEAVES = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
           ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))
ROWS_MAX = 8       # batch rows the kernel holds
HEAD_DIM = 64
GROUP_MAX = 8      # query heads per KV head
COLS = 64          # output columns of a projection unit (one head)
ATTN_TILE = 32     # keys of an attention tile


_P = ctypes.c_void_p


class _Params(ctypes.Structure):
    """Mirror of ``Params`` in ``csrc/fused_layer.cu``."""

    _fields_ = [
        ("x", _P), ("g1", _P), ("g2", _P), ("w", _P * 7), ("ws", _P * 7),
        ("bias", _P * 3), ("freqs", _P), ("kc", _P), ("vc", _P),
        ("ksc", _P), ("vsc", _P), ("lens", _P), ("q", _P), ("attn", _P),
        ("x1", _P), ("hm", _P), ("out", _P), ("scales", _P),
        ("part", _P), ("nz", _P), ("apart", _P), ("aml", _P), ("ssq", _P),
        ("counters", _P), ("seeds", _P),
        ("sigma", ctypes.c_float * 7), ("qmax", ctypes.c_int * 7),
        ("klen", ctypes.c_int * 4),
        ("B", ctypes.c_int), ("d", ctypes.c_int), ("H", ctypes.c_int),
        ("KV", ctypes.c_int), ("F", ctypes.c_int), ("T", ctypes.c_int),
        ("eps", ctypes.c_float), ("clip_k", ctypes.c_float),
        ("attn_scale", ctypes.c_float), ("sim", ctypes.c_int),
        ("int8", ctypes.c_int), ("grid", ctypes.c_int),
    ]


def fused_layer_plan(b: int, d: int, h: int, kv: int, f: int, t: int,
                     hd: int = HEAD_DIM) -> dict:
    """How the kernel cuts its work: per projection stage ("qkv", "o",
    "gate_up", "down") its units of ``COLS`` columns, planes a unit, K and
    split length ``klen`` (the longest balanced split, a multiple of 16,
    whose units x planes x splits reach ``SM_COUNT`` items, as
    ``cim_fused_plan`` splits the decode GEMV), splits and tiles; the
    attention's key tiles a cache row (``ATTN_TILE`` keys, split over the
    grid by the kernel); ``counters`` (arrival counters of all stages) and
    the split scratch in 4-byte words, ``part`` and ``noise`` (the largest
    stage's)."""
    stages = {}
    for name, units, planes, k in (("qkv", h + 2 * kv, 1, d),
                                   ("o", d // COLS, 1, h * hd),
                                   ("gate_up", f // COLS, 2, d),
                                   ("down", d // COLS, 1, f)):
        for klen in split_lengths(k, 16):
            n_split = split_geometry(k, klen)[1]
            if units * planes * n_split >= SM_COUNT:
                break
        tiles = split_geometry(k, klen)[2]
        stages[name] = {"units": units, "planes": planes, "k": k,
                        "klen": klen, "n_split": n_split, "tiles": tiles,
                        "items": units * planes * n_split}
    slot = b * COLS
    n_t = -(-t // ATTN_TILE)
    return {"stages": stages, "attn_tiles": n_t,
            "counters": h + 2 * kv + b * kv + 2 * (d // COLS) + f // COLS,
            "part": max(s["items"] for s in stages.values()) * slot,
            "noise": max(s["units"] * s["planes"] * s["tiles"]
                         for s in stages.values()) * slot}


@functools.lru_cache(maxsize=None)
def _sigma(spec: CIMSpec, k: int) -> float:
    return output_noise_std_int_per_tile(spec, k)


_FREQS: Dict[tuple, torch.Tensor] = {}


def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    """``layers.rope_freqs`` on the device, made once per (hd, theta)."""
    from repro_torch.models.layers import rope_freqs
    key = (hd, float(theta), str(device))
    if key not in _FREQS:
        _FREQS[key] = rope_freqs(hd, theta, device)
    return _FREQS[key]


class _Layer:
    """One layer's projection operands, read from its params leaves; in
    sim mode it draws the seven noise keys from ``ctx`` (in order)."""

    def __init__(self, ctx, p):
        leaves = [p[a][b] for a, b in _LEAVES]
        self.sim = ctx.mode == "sim"
        self.biases: Optional[List[torch.Tensor]] = (
            [p["attn"][n]["b"] for n in ("q", "k", "v")]
            if "b" in p["attn"]["q"] else None)
        if self.sim:
            self.specs = layer_specs(ctx)
            self.weights = [lf[f"wq{sp.w_bits}"]
                            for lf, sp in zip(leaves, self.specs)]
            self.wscales = [lf[f"ws{sp.w_bits}"]
                            for lf, sp in zip(leaves, self.specs)]
            self.sigmas = [_sigma(sp, w.shape[0])
                           for sp, w in zip(self.specs, self.weights)]
            self.qmaxes = [quant.qmax(sp.in_bits) for sp in self.specs]
            self.seeds = [ctx.next_key() for _ in range(7)]
        else:
            self.specs = [None] * 7
            self.weights = [lf["w"] for lf in leaves]
            self.wscales = None
            self.sigmas = [0.0] * 7
            self.qmaxes = [0] * 7
            self.seeds = [(0, 0)] * 7

    def proj(self, idx: int, h: torch.Tensor,
             xs: Optional[torch.Tensor]) -> torch.Tensor:
        """Projection ``idx`` of the (B, K) f32 activation: the unfused
        ``dense`` arithmetic (``cim_matmul_deployed`` in sim mode)."""
        if not self.sim:
            y = h @ self.weights[idx]
        else:
            sigma = self.sigmas[idx]
            xs = xs.reshape(())
            qp = torch.stack([xs, xs * self.wscales[idx].to(torch.float32)
                              .reshape(())])
            seed = self.seeds[idx]
            if sigma > 0 and not isinstance(seed, prng.SeedRow):
                seed = prng.seed_from_key(seed)
            y = cim_matmul_fused_plain(
                h, self.weights[idx], qp, seed if sigma > 0 else None, sigma,
                self.specs[idx].in_bits)
        if idx < 3 and self.biases is not None:
            y = y + self.biases[idx]
        return y


def fused_dense_layer_plain(ctx, p, x: torch.Tensor, cache,
                            scales: Optional[torch.Tensor] = None,
                            probe: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, dict]:
    """Plain PyTorch version of the layer, stage by stage as the reference
    kernel runs it; returns ``(x_out, cache)``. ``scales`` (7,) replaces
    the activation scales it would compute (the card check feeds the
    kernel's, so that an ulp of the batch mean cannot flip a quantized
    activation). A ``probe`` dict receives the scales used (zeros in off
    mode), the attention output (B, H * hd) and the seven projection
    inputs (``acts``)."""
    from repro_torch.models.attention import _kv_quant, row_update
    from repro_torch.models.layers import _act_scale, apply_rope, rmsnorm

    cfg = ctx.cfg
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lay = _Layer(ctx, p)
    used = [torch.zeros((), dtype=torch.float32, device=x.device)] * 7

    def xs_of(idx, act):
        if not lay.sim:
            return None
        s = (scales[idx] if scales is not None
             else _act_scale(ctx, act, lay.specs[idx]))
        used[idx] = s
        return s

    xf = x[:, 0].to(torch.float32)
    start = cache["len"].clone()
    h1 = rmsnorm(p["n1"], xf, cfg.norm_eps)
    xs = xs_of(0, h1)
    used[1] = used[2] = used[0]
    q = lay.proj(0, h1, xs).reshape(b, 1, h, hd)
    k = lay.proj(1, h1, xs).reshape(b, 1, kv, hd)
    v = lay.proj(2, h1, xs).reshape(b, 1, kv, hd)
    q = apply_rope(q, start[:, None], cfg.rope_theta)
    k = apply_rope(k, start[:, None], cfg.rope_theta)
    if "ks" in cache:
        (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
        for name, val in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            row_update(cache[name], val, start)
    else:
        row_update(cache["k"], k, start)
        row_update(cache["v"], v, start)
    cache["len"].copy_(start + 1)
    # the current token's key is read back as written (int8: codes * scale)
    attn = decode_attention_plain(q[:, 0], cache["k"], cache["v"], start + 1,
                                  cache.get("ks"), cache.get("vs"))
    attn = attn.reshape(b, h * hd)
    x1 = xf + lay.proj(3, attn, xs_of(3, attn))
    h2 = rmsnorm(p["n2"], x1, cfg.norm_eps)
    xs = xs_of(4, h2)
    used[5] = used[4]
    g = lay.proj(4, h2, xs)
    u = lay.proj(5, h2, xs)
    hm = torch.nn.functional.silu(g) * u
    out = x1 + lay.proj(6, hm, xs_of(6, hm))
    if probe is not None:
        probe["scales"] = torch.stack([s.reshape(()).to(torch.float32)
                                       for s in used])
        probe["attn"] = attn
        probe["acts"] = [h1, h1, h1, attn, h2, h2, hm]
    return out[:, None].to(x.dtype), cache


def layer_specs(ctx) -> list:
    """The seven projections' CIM specs (None each in off mode)."""
    return [ctx.spec_for(r) for r in _ROLES]


def kernel_takes(cfg, b: int, specs=()) -> bool:
    """Whether the kernel takes a layer of ``cfg`` at batch ``b``: B <=
    ``ROWS_MAX``, head dim ``HEAD_DIM``, H / KV <= ``GROUP_MAX``, d_model
    and d_ff multiples of ``COLS``, and every projection's ``in_bits`` <= 8
    (``specs``: the seven projections' CIM specs, None in off mode). The
    plain version takes any shape."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return (b <= ROWS_MAX and cfg.hd == HEAD_DIM and h % kv == 0
            and h // kv <= GROUP_MAX and cfg.d_model % COLS == 0
            and cfg.d_ff % COLS == 0
            and all(sp is None or sp.in_bits <= 8 for sp in specs))


def _check(ctx, p, x, cache) -> None:
    cfg = ctx.cfg
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if s != 1 or x.dtype != torch.float32:
        raise ValueError(f"fused_dense_layer: decode-only float32 x "
                         f"(B, 1, d), got {tuple(x.shape)} {x.dtype}")
    if b > ROWS_MAX or hd != HEAD_DIM or h % kv or h // kv > GROUP_MAX:
        raise ValueError(f"fused_dense_layer: kernel takes B <= {ROWS_MAX}, "
                         f"head_dim {HEAD_DIM}, H / KV <= {GROUP_MAX}; got "
                         f"B={b}, head_dim={hd}, H={h}, KV={kv}")
    if d % COLS or cfg.d_ff % COLS:
        raise ValueError(f"fused_dense_layer: d_model and d_ff must be "
                         f"multiples of {COLS}")
    int8 = "ks" in cache
    want = torch.int8 if int8 else torch.float32
    if cache["k"].dtype != want or cache["v"].dtype != want:
        raise ValueError(f"fused_dense_layer: cache must be {want}, got "
                         f"{cache['k'].dtype}")
    for name, t in cache.items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_dense_layer: cache[{name!r}] must be a "
                             f"contiguous tensor on {x.device} (it is "
                             f"written in place)")
    if cache["k"].data_ptr() % 16 or cache["v"].data_ptr() % 16:
        raise ValueError("fused_dense_layer: cache rows are read in 16-byte "
                         "pieces; the k and v caches must start on 16 bytes")
    if cache["len"].dtype != torch.int32:
        raise ValueError("fused_dense_layer: cache['len'] must be int32")


def _seed_words(seeds, device) -> torch.Tensor:
    """The seven seeds as (7, 2) int32 device words: a view of the seed
    table where they are seven consecutive rows of it (table mode, no
    copy), else the host keys' words copied from pinned memory."""
    if all(isinstance(s, prng.SeedRow) for s in seeds):
        t, r0 = seeds[0].table, seeds[0].row
        if (all(s.table is t and s.row == r0 + i for i, s in enumerate(seeds))
                and t.device == device and t.dtype == torch.int32
                and t.is_contiguous()):
            return t[r0:r0 + 7]
        raise ValueError("fused_dense_layer: the seven seeds must be seven "
                         "consecutive rows of one int32 seed table on the "
                         "layer's device")
    words = np.array([prng.seed_from_key(s) for s in seeds], np.uint32)
    host = torch.from_numpy(words.view(np.int32))
    return host.pin_memory().to(device, non_blocking=True)


def _launch(ctx, p, x, cache, probe: Optional[dict]) -> torch.Tensor:
    _check(ctx, p, x, cache)
    cfg = ctx.cfg
    b, _, d = x.shape
    h, kv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    t = cache["k"].shape[1]
    lay = _Layer(ctx, p)
    if lay.sim and max(sp.in_bits for sp in lay.specs) > 8:
        raise ValueError("fused_dense_layer: kernel takes in_bits <= 8")
    keep = []                      # operands that must outlive the launch

    def ptr(tensor, dtype, shape=None, align=4):
        tensor = tensor.contiguous()
        if tensor.dtype != dtype or tensor.device != x.device:
            raise ValueError(f"fused_dense_layer: operand {tensor.dtype} "
                             f"on {tensor.device}, want {dtype} on "
                             f"{x.device}")
        if shape is not None and tuple(tensor.shape) != shape:
            raise ValueError(f"fused_dense_layer: operand shape "
                             f"{tuple(tensor.shape)}, want {shape}")
        if tensor.data_ptr() % align:
            raise ValueError("fused_dense_layer: misaligned operand")
        keep.append(tensor)
        return tensor.data_ptr()

    n_out = (h * hd, kv * hd, kv * hd, d, f, f, d)
    n_in = (d, d, d, h * hd, d, d, f)
    prm = _Params()
    prm.x = ptr(x[:, 0], torch.float32)
    prm.g1 = ptr(p["n1"]["g"], torch.float32, (d,))
    prm.g2 = ptr(p["n2"]["g"], torch.float32, (d,))
    for i in range(7):
        if lay.sim:
            prm.w[i] = ptr(lay.weights[i], torch.int8, (n_in[i], n_out[i]),
                           align=8)
            prm.ws[i] = ptr(lay.wscales[i].reshape(()), torch.float32)
        else:
            prm.w[i] = ptr(lay.weights[i], torch.float32,
                           (n_in[i], n_out[i]), align=16)
        prm.sigma[i] = lay.sigmas[i]
        prm.qmax[i] = lay.qmaxes[i]
    if lay.sim:
        prm.seeds = ptr(_seed_words(lay.seeds, x.device), torch.int32,
                        (7, 2))
    if lay.biases is not None:
        for i in range(3):
            prm.bias[i] = ptr(lay.biases[i], torch.float32, (n_out[i],))
    prm.freqs = ptr(_rope_freqs(hd, cfg.rope_theta, x.device), torch.float32)
    prm.kc, prm.vc = cache["k"].data_ptr(), cache["v"].data_ptr()
    int8 = "ks" in cache
    if int8:
        prm.ksc, prm.vsc = cache["ks"].data_ptr(), cache["vs"].data_ptr()
    prm.lens = cache["len"].data_ptr()
    plan = fused_layer_plan(b, d, h, kv, f, t, hd)
    # one buffer: roped q, attention output, x1, hm, out, scales (padded to
    # 16 bytes), the split partials, their noise, the attention ranges'
    # outputs and (m, l), hm's sums of squares (f64)
    n_at = plan["attn_tiles"] * b * kv
    sizes = (b * h * hd, b * h * hd, b * d, b * f, b * d, 8, plan["part"],
             plan["noise"], n_at * GROUP_MAX * hd, n_at * 2 * GROUP_MAX,
             2 * (f // COLS))
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    parts = torch.split(buf, sizes)
    (prm.q, prm.attn, prm.x1, prm.hm, prm.out, prm.scales, prm.part, prm.nz,
     prm.apart, prm.aml, prm.ssq) = (t_.data_ptr() for t_ in parts)
    prm.counters = arrival_counters(x.device, plan["counters"]).data_ptr()
    for i, name in enumerate(("qkv", "o", "gate_up", "down")):
        prm.klen[i] = plan["stages"][name]["klen"]
    prm.B, prm.d, prm.H, prm.KV, prm.F, prm.T = b, d, h, kv, f, t
    prm.eps = cfg.norm_eps
    prm.clip_k = cfg.cim.act_clip_sigmas
    prm.attn_scale = 1.0 / math.sqrt(hd)
    prm.sim, prm.int8 = int(lay.sim), int(int8)
    rc = _build.library().fused_dense_layer(ctypes.byref(prm),
                                            _build.stream_ptr(x.device))
    _build.check(rc, "fused_dense_layer")
    fused_dense_layer.launches += 1
    fused_dense_layer.grid = prm.grid
    if probe is not None:
        probe["scales"] = parts[5][:7]
        probe["attn"] = parts[1].view(b, h * hd)
    return parts[4].view(b, 1, d)


def fused_dense_layer(ctx, p, x: torch.Tensor, cache,
                      probe: Optional[dict] = None):
    """One dense layer's decode step (see module doc): ``(x_out, cache)``.
    A ``probe`` dict receives the (7,) activation scales the projections
    used and the attention output (B, H * hd)."""
    if x.device.type == "cpu":
        return fused_dense_layer_plain(ctx, p, x, cache, probe=probe)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_layer: unsupported device {x.device}")
    return _launch(ctx, p, x, cache, probe), cache


fused_dense_layer.launches = 0
fused_dense_layer.grid = 0       # blocks of the last launch
