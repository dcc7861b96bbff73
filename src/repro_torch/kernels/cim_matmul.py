"""CIM matmuls on int8 weight planes: CUDA kernels and plain PyTorch versions.

Two wrappers of ``csrc/cim_matmul.cu`` (whose design note says what
bounds each on the H100 and how each streams the plane):

* ``cim_matmul_fused`` replaces ``src/repro/kernels/cim_matmul.py``
  ``cim_matmul_fused_pallas`` (TPU kernel ``_fused_kernel``): float
  activations, quantized in the kernel; ``cim_fused_plan`` splits K
  inside macro tiles over the grid and picks the body: the split-K GEMV
  of ``csrc/cim_gemv.cuh`` at decode (M <= 16) or the int8 tensor-core
  tile at prefill, the splits merged in the same launch;
* ``cim_matmul_int8`` replaces ``cim_matmul_pallas`` (TPU kernel
  ``_kernel``): activations already quantized to int8, a scalar scale
  epilogue, any K and N, on the int8 tensor cores (``cim_int8_plan`` picks
  the block tile and the aligned or masked load path).

``cim_matmul_fused`` takes the float activation (M, K), quantizes it
against the scalar ``x_scale`` (round half to even, clip at +-qmax), takes
the int32 dot with the deployed int8 plane per 1024-row macro tile, adds
``sigma`` times the Threefry/Box-Muller readout noise of each tile
(``core.prng.tile_gaussian``: key (seed0 ^ DOMAIN, seed1 ^ tile), counter
global (row, col)), sums the tiles in f32 in order and multiplies by
``out_scale``. Scales arrive as a device tensor ``qp = [x_scale,
out_scale]`` so the host never waits for them, and so do the seed words:
``seed`` is a host pair or a ``prng.SeedRow`` of a seed table, and the
kernel reads the two words where they lie (a CUDA graph of a forward
replays with its table staged anew).

A shard of a larger product keeps the whole product's noise: the
counter of output (m, n) is the global (row0 + m, col0 + n), as the JAX
kernel counts on the global (row, col). A column shard (a plane split
over N, or a batch split over rows) passes its first column and row to
``cim_matmul_fused``; a row shard (a plane split over K, whose boundary
may cut a macro tile) runs ``cim_tile_partials`` (the int32 dot of each
global tile its rows touch), the caller's int32 all-reduce, then
``cim_tile_merge`` (the tile epilogue, noise on the global tile index):
each is bit-equal to the whole plane's ``cim_matmul_fused``.

CPU tensors take ``cim_matmul_fused_plain`` (twin of
``ref.cim_matmul_fused_ref``), ``cim_matmul_int8_plain`` (twin of
``ref.cim_matmul_prng_ref``), ``cim_tile_partials_plain`` and
``cim_tile_merge_plain``; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng, quant
from repro_torch.core.cim import MACRO_ROWS
from repro_torch.kernels import _build
from repro_torch.kernels._attn import SM_COUNT, arrival_counters

INT8_BLOCK_N = 128       # output columns a block of the int8 kernel
INT8_STAGE_K = 128       # K bytes a pipeline stage (eight to a macro tile)
GEMV_ROWS = 16           # the largest M the split-K GEMV takes
GEMV_SPANS = (64, 32)    # column units the GEMV can take


def split_geometry(k: int, klen: int) -> Tuple[int, int, int]:
    """How a K axis is cut into splits of ``klen`` rows that never straddle
    a macro tile (the kernels' ``rt::Splits``): returns (splits per full
    tile ``spt``, splits ``n_split``, tiles). Split j covers rows
    ``split_range(k, klen, j)``."""
    spt = -(-MACRO_ROWS // klen)
    tiles = -(-k // MACRO_ROWS)
    last = k - (tiles - 1) * MACRO_ROWS
    return spt, (tiles - 1) * spt + -(-last // klen), tiles


def split_range(k: int, klen: int, j: int) -> Tuple[int, int, int]:
    """(tile, k0, k1) of split j (``rt::Splits::range``)."""
    spt = split_geometry(k, klen)[0]
    t = j // spt
    k0 = t * MACRO_ROWS + (j - t * spt) * klen
    return t, k0, min(k0 + klen, (t + 1) * MACRO_ROWS, k)


def split_lengths(k: int, align: int):
    """Split lengths, longest first: a tile (or the whole K, if shorter)
    cut into 1, 2, 3, ... balanced pieces, rounded up to ``align`` rows."""
    rows = min(k, MACRO_ROWS)
    seen = set()
    for s in range(1, -(-rows // align) + 1):
        klen = -(-(-(-rows // s)) // align) * align
        if klen not in seen:
            seen.add(klen)
            yield klen


def cim_fused_plan(m: int, k: int, n: int, w_ptr: int = 0) -> dict:
    """Launch plan of the fused CIM kernel (one launch either way).

    M <= ``GEMV_ROWS`` (decode): the split-K GEMV. ``block_m`` rows (4, 8
    or 16, the least that holds M) and ``vec``-byte plane loads (16, 8 or
    4: the widest that divides N and the plane's address, at most 64 /
    block_m, which bounds a thread's accumulators). Columns in units of
    ``nspan`` (64 or 32), K in splits of ``klen`` rows (a multiple of 16):
    for each unit width the longest balanced split whose grid reaches
    ``SM_COUNT`` blocks; among the widths, the one whose merge reads the
    fewest partials (splits x width, 32-column units counted four times
    over for their 32-byte row pieces), the wider on a tie. No width
    reaching ``SM_COUNT`` (narrow shapes outside the served models): the
    most blocks.

    M > 16 (prefill): the int8 tensor-core tile, ``block_m`` 32 or 64 rows
    x 128 columns, ``aligned`` (cp.async plane) when K and N are multiples
    of 16 and the plane starts on 16 bytes; splits of a multiple of 128
    rows, picked by a cost in pipeline stages: the waves of two blocks an
    SM times a block's stages, plus the merge's partials (block_m / 64 of a
    stage each).

    ``slot``: values of one split's partial (rows x columns of a unit);
    ``part_ints`` and ``noise_floats`` the scratch the wrapper allocates."""
    tiles = -(-k // MACRO_ROWS)
    if m <= GEMV_ROWS:
        rows = next(r for r in (4, 8, 16) if m <= r)
        vec = min(next(v for v in (16, 8, 4) if n % v == 0 and w_ptr % v == 0),
                  64 // rows)
        best = None
        for nspan in GEMV_SPANS:
            units = -(-n // nspan)
            for klen in split_lengths(k, 16):
                n_split = split_geometry(k, klen)[1]
                if units * n_split >= SM_COUNT:
                    break
            blocks = units * n_split
            cost = n_split * nspan * (4 if nspan == 32 else 1)
            key = (blocks < SM_COUNT, -blocks if blocks < SM_COUNT else cost)
            if best is None or key < best[0]:
                best = (key, nspan, klen, units, n_split)
        _, nspan, klen, units, n_split = best
        grid = (units, n_split)
        slot = m * nspan
        plan = {"path": "gemv", "block_m": rows, "vec": vec, "aligned": False}
    else:
        bm = 32 if m <= 32 else 64
        spans, rb = -(-n // INT8_BLOCK_N), -(-m // bm)
        nspan, units = INT8_BLOCK_N, spans * rb
        best = None
        for klen in split_lengths(k, INT8_STAGE_K):
            n_split = split_geometry(k, klen)[1]
            waves = -(-units * n_split // (2 * SM_COUNT))
            cost = waves * klen // INT8_STAGE_K + n_split * bm / 64
            if best is None or cost < best[0]:
                best = (cost, klen, n_split)
        _, klen, n_split = best
        grid = (spans, rb, n_split)
        slot = bm * nspan
        aligned = k % 16 == 0 and n % 16 == 0 and w_ptr % 16 == 0
        plan = {"path": "mma", "block_m": bm, "vec": 16, "aligned": aligned}
    plan.update(nspan=nspan, klen=klen, units=units, n_split=n_split,
                tiles=tiles, grid=grid, slot=slot,
                part_ints=units * n_split * slot,
                noise_floats=units * tiles * slot)
    return plan


def cim_int8_plan(m: int, k: int, n: int, x_ptr: int = 0,
                  w_ptr: int = 0, noise: bool = True) -> dict:
    """Launch plan of the int8 kernel: ``block_m`` x ``INT8_BLOCK_N`` output
    tiles, ``block_m`` the smallest of 32, 64 whose grid fits one wave
    (``SM_COUNT`` blocks: a block's stages run in series, so a smaller tile
    shortens the wave), else 128 with ``noise`` and 64 without (then two
    64-row blocks share an SM, the noise's shared slots left out, and ran
    faster on the H100 than one 128-row block, PERF.md); the cp.async
    path (``aligned``) when K and N are multiples of 16 and both operands
    start on 16 bytes, else masked byte loads; ``stages`` of
    ``INT8_STAGE_K`` bytes over K and ``tiles`` macro tiles (noise draws per
    output)."""
    cols = -(-n // INT8_BLOCK_N)
    bm = next((b for b in (32, 64) if cols * -(-m // b) <= SM_COUNT),
              128 if noise else 64)
    aligned = k % 16 == 0 and n % 16 == 0 and x_ptr % 16 == 0 \
        and w_ptr % 16 == 0
    return {"block_m": bm, "block_n": INT8_BLOCK_N,
            "grid": (cols, -(-m // bm)), "aligned": aligned,
            "stages": -(-k // INT8_STAGE_K), "tiles": -(-k // MACRO_ROWS)}


def _tile_sums(xq: torch.Tensor, wq: torch.Tensor,
               seed: Optional[Tuple[int, int]], sigma: float,
               row0: int = 0, col0: int = 0) -> torch.Tensor:
    """sum_t (xq[:, tile t] . wq[tile t] + sigma * noise_t), f32, in order;
    the noise counter of output (m, n) is (row0 + m, col0 + n).

    The int32 dot runs as a float64 product: every partial sum is an integer
    below 2^53, so it is exact in any order, on the CPU and on the card."""
    k = xq.shape[1]
    parts = [(xq[:, t * MACRO_ROWS:(t + 1) * MACRO_ROWS].to(torch.float64)
              @ wq[t * MACRO_ROWS:(t + 1) * MACRO_ROWS].to(torch.float64))
             for t in range(-(-k // MACRO_ROWS))]
    return _merge_tiles(parts, seed, sigma, row0, col0)


def _merge_tiles(parts, seed: Optional[Tuple[int, int]], sigma: float,
                 row0: int, col0: int) -> torch.Tensor:
    """The tile epilogue: sum_t (float(S_t) + sigma * noise_t(row0 + m,
    col0 + n)) in f32, tile by tile in order (``S_t`` exact integers)."""
    m, n = parts[0].shape
    device = parts[0].device
    noise = seed is not None and sigma > 0.0
    if noise:
        rows = torch.arange(row0, row0 + m, dtype=torch.int64,
                            device=device)[:, None].expand(m, n)
        cols = torch.arange(col0, col0 + n, dtype=torch.int64,
                            device=device)[None, :].expand(m, n)
    y = torch.zeros((m, n), dtype=torch.float32, device=device)
    for t, part in enumerate(parts):
        s = part.to(torch.float32)
        if noise:
            s = s + sigma * prng.tile_gaussian(seed[0], seed[1], t, rows, cols)
        y = y + s
    return y


def _quantize(x: torch.Tensor, qp: torch.Tensor, in_bits: int) -> torch.Tensor:
    q = quant.qmax(in_bits)
    return torch.clamp(torch.round(x.to(torch.float32) / qp[0]), -q, q)


def cim_matmul_fused_plain(x: torch.Tensor, wq: torch.Tensor,
                           qp: torch.Tensor, seed: Optional[prng.Seed],
                           sigma: float, in_bits: int, row0: int = 0,
                           col0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (same arithmetic, tile by
    tile)."""
    words = None if seed is None else prng.seed_words(seed)
    return _tile_sums(_quantize(x, qp, in_bits), wq, words, sigma, row0,
                      col0) * qp[1]


_SEED_WORDS: dict = {}


def seed_operand(seed: prng.Seed, device: torch.device) -> torch.Tensor:
    """The (2,) int32 device words a kernel reads its seed from: the table
    row of a ``SeedRow`` (a view, no copy), or a host pair copied
    asynchronously from pinned memory (the last 256 pairs kept, so a
    loop over one pair copies once)."""
    if isinstance(seed, prng.SeedRow):
        t = seed.table
        if (t.device != device or t.dtype != torch.int32 or t.ndim != 2
                or t.shape[1] != 2 or not t.is_contiguous()):
            raise ValueError(f"seed table must be a contiguous (rows, 2) "
                             f"int32 tensor on {device}")
        return t[seed.row]
    words = prng.key_words(seed)
    key = (device, words)
    out = _SEED_WORDS.get(key)
    if out is None:
        host = torch.from_numpy(np.array(words, np.uint32).view(np.int32))
        out = host.pin_memory().to(device, non_blocking=True)
        if len(_SEED_WORDS) >= 256:
            _SEED_WORDS.clear()
        _SEED_WORDS[key] = out
    return out


def cim_matmul_fused(x: torch.Tensor, wq: torch.Tensor, qp: torch.Tensor,
                     seed: Optional[prng.Seed], sigma: float,
                     in_bits: int, row0: int = 0,
                     col0: int = 0) -> torch.Tensor:
    """(M, K) float x, (K, N) int8 plane -> (M, N) float32. See module doc.
    ``row0``/``col0``: the global row and column of output (0, 0) in the
    noise counter (a shard of a larger product)."""
    if x.device.type == "cpu":
        return cim_matmul_fused_plain(x, wq, qp, seed, sigma, in_bits, row0,
                                      col0)
    if x.device.type != "cuda":
        raise ValueError(f"cim_matmul_fused: unsupported device {x.device}")
    m, k = x.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(wq.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if wq.dtype != torch.int8 or qp.dtype != torch.float32 or qp.numel() != 2:
        raise ValueError("wq must be int8 and qp a (2,) float32 tensor")
    if not (wq.device == x.device == qp.device):
        raise ValueError("x, wq and qp must be on one device")
    if in_bits > 8:
        raise ValueError(f"kernel takes in_bits <= 8, got {in_bits}")
    x = x.contiguous()
    if x.data_ptr() % 16:          # rows are read in 16-byte pieces
        x = x.clone()
    wq = wq.contiguous()
    qp = qp.contiguous()
    if k % 4 or n % 4 or wq.data_ptr() % 4:
        raise ValueError(f"kernel needs K % 4 == 0, N % 4 == 0 and an aligned "
                         f"plane, got K={k}, N={n}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    noise = seed is not None and sigma > 0.0
    seeds = seed_operand(seed, x.device) if noise else None
    plan = cim_fused_plan(m, k, n, wq.data_ptr())
    # the splits' partials and (with noise) their tiles' draws, one buffer
    scratch = torch.empty(plan["part_ints"] + (plan["noise_floats"] if noise
                                               else 0),
                          dtype=torch.int32, device=x.device)
    counters = arrival_counters(x.device, plan["units"])
    rc = _build.library().cim_matmul_fused(
        x.data_ptr(), 0 if x.dtype == torch.float32 else 1, wq.data_ptr(),
        qp.data_ptr(), out.data_ptr(), m, k, n, quant.qmax(in_bits),
        float(sigma) if noise else 0.0,
        None if seeds is None else seeds.data_ptr(), int(noise),
        scratch.data_ptr(), scratch.data_ptr() + 4 * plan["part_ints"],
        counters.data_ptr(), plan["block_m"], plan["vec"], plan["nspan"],
        plan["klen"], int(plan["aligned"]), int(row0), int(col0),
        _build.stream_ptr(x.device))
    _build.check(rc, "cim_matmul_fused")
    cim_matmul_fused.launches += 1
    return out


cim_matmul_fused.launches = 0


def tile_span(k_off: int, k: int) -> Tuple[int, int]:
    """(first global macro tile, tiles) that rows [k_off, k_off + k) of a
    K axis touch."""
    first = k_off // MACRO_ROWS
    return first, (k_off + k - 1) // MACRO_ROWS - first + 1


def cim_tile_partials_plain(x: torch.Tensor, wq: torch.Tensor,
                            qp: torch.Tensor, in_bits: int, k_off: int,
                            k_total: int) -> torch.Tensor:
    """Plain PyTorch version of ``cim_tile_partials``: exact integer dots
    (float64 products), int32."""
    m, k = x.shape
    parts = torch.zeros((-(-k_total // MACRO_ROWS), m, wq.shape[1]),
                        dtype=torch.int32, device=x.device)
    xq = _quantize(x, qp, in_bits).to(torch.float64)
    first, n = tile_span(k_off, k)
    for t in range(first, first + n):
        a = max(t * MACRO_ROWS - k_off, 0)
        b = min((t + 1) * MACRO_ROWS - k_off, k)
        parts[t] = (xq[:, a:b] @ wq[a:b].to(torch.float64)).to(torch.int32)
    return parts


def cim_tile_partials(x: torch.Tensor, wq: torch.Tensor, qp: torch.Tensor,
                      in_bits: int, k_off: int, k_total: int) -> torch.Tensor:
    """The first half of a row-parallel CIM product (``csrc/cim_matmul.cu``
    ``cim_tile_partials``): this shard's rows ``[k_off, k_off + K)`` of a
    K axis of ``k_total`` rows, float (M, K) ``x`` quantized against
    ``qp[0]`` as the fused kernel does, on its (K, N) int8 plane rows ->
    (global tiles, M, N) int32, tile t holding the exact dot of the
    shard's rows inside macro tile t (zero for tiles it does not touch).
    Summed over the shards (an int32 all-reduce, exact in any order) the
    parts are the whole product's tile sums, ``cim_tile_merge``'s input."""
    if x.device.type == "cpu":
        return cim_tile_partials_plain(x, wq, qp, in_bits, k_off, k_total)
    if x.device.type != "cuda":
        raise ValueError(f"cim_tile_partials: unsupported device {x.device}")
    m, k = x.shape
    n = wq.shape[1]
    if wq.shape[0] != k or not 0 <= k_off <= k_total - k:
        raise ValueError(f"shard rows [{k_off}, {k_off + k}) of {k_total} "
                         f"and plane {tuple(wq.shape)} disagree")
    if x.dtype not in (torch.float32, torch.bfloat16) or wq.dtype != torch.int8:
        raise ValueError("x must be float32 or bfloat16 and wq int8")
    if in_bits > 8:
        raise ValueError(f"kernel takes in_bits <= 8, got {in_bits}")
    x, wq, qp = x.contiguous(), wq.contiguous(), qp.contiguous()
    if n % 4 or wq.data_ptr() % 4:
        raise ValueError(f"kernel needs N % 4 == 0 and an aligned plane, "
                         f"got N={n}")
    parts = torch.zeros((-(-k_total // MACRO_ROWS), m, n), dtype=torch.int32,
                        device=x.device)
    first, tiles = tile_span(k_off, k)
    rc = _build.library().cim_tile_partials(
        x.data_ptr(), 0 if x.dtype == torch.float32 else 1, wq.data_ptr(),
        qp.data_ptr(), parts.data_ptr(), m, k, n, k_off, quant.qmax(in_bits),
        first, tiles, _build.stream_ptr(x.device))
    _build.check(rc, "cim_tile_partials")
    cim_tile_partials.launches += 1
    return parts


cim_tile_partials.launches = 0


def cim_tile_merge_plain(parts: torch.Tensor, qp: torch.Tensor,
                         seed: Optional[prng.Seed], sigma: float,
                         row0: int = 0, col0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``cim_tile_merge``."""
    words = None if seed is None else prng.seed_words(seed)
    return _merge_tiles(list(parts), words, sigma, row0, col0) * qp[1]


def cim_tile_merge(parts: torch.Tensor, qp: torch.Tensor,
                   seed: Optional[prng.Seed], sigma: float, row0: int = 0,
                   col0: int = 0) -> torch.Tensor:
    """The second half of a row-parallel CIM product: the fused kernel's
    tile epilogue on (tiles, M, N) int32 tile sums -> (M, N) float32
    ``qp[1] * sum_t (float(S_t) + sigma * noise_t(row0 + m, col0 + n))``,
    bit-equal to ``cim_matmul_fused`` on the whole plane."""
    if parts.device.type == "cpu":
        return cim_tile_merge_plain(parts, qp, seed, sigma, row0, col0)
    if parts.device.type != "cuda":
        raise ValueError(f"cim_tile_merge: unsupported device {parts.device}")
    if parts.dtype != torch.int32 or qp.dtype != torch.float32:
        raise ValueError("parts must be int32 and qp float32")
    tiles, m, n = parts.shape
    parts, qp = parts.contiguous(), qp.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=parts.device)
    noise = seed is not None and sigma > 0.0
    seeds = seed_operand(seed, parts.device) if noise else None
    rc = _build.library().cim_tile_merge(
        parts.data_ptr(), qp.data_ptr(), out.data_ptr(), m, n, tiles,
        float(sigma) if noise else 0.0,
        None if seeds is None else seeds.data_ptr(), int(noise), int(row0),
        int(col0), _build.stream_ptr(parts.device))
    _build.check(rc, "cim_tile_merge")
    cim_tile_merge.launches += 1
    return out


cim_tile_merge.launches = 0


Seed = Union[None, int, Sequence[int]]


def resolve_seed(seed: Seed) -> Optional[Tuple[int, int]]:
    """The kernel's (seed0, seed1) words, as ``_resolve_seed`` of the JAX
    package reads them: None -> no noise, a scalar -> (s, 0), a pair as it
    is; each word taken as its uint32 bits (a negative int32 wraps)."""
    if seed is None:
        return None
    words = np.asarray(seed).reshape(-1).tolist()
    if len(words) not in (1, 2):
        raise ValueError(f"seed must be a scalar or a pair, got {seed!r}")
    if len(words) == 1:
        words.append(0)
    return int(words[0]) & prng.M32, int(words[1]) & prng.M32


def _scale_tensor(scale, device) -> torch.Tensor:
    if scale is None:
        return torch.ones((), dtype=torch.float32, device=device)
    if isinstance(scale, torch.Tensor):
        return scale.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(scale), dtype=torch.float32, device=device)


def cim_matmul_int8_plain(xq: torch.Tensor, wq: torch.Tensor, seed: Seed,
                          sigma: float, scale=None) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel: twin of
    ``ref.cim_matmul_prng_ref`` (exact integer tiles, the same noise)."""
    y = _tile_sums(xq, wq, resolve_seed(seed), sigma)
    return y if scale is None else y * _scale_tensor(scale, xq.device)


def cim_matmul_int8(xq: torch.Tensor, wq: torch.Tensor, seed: Seed,
                    sigma: float, scale=None) -> torch.Tensor:
    """(M, K) int8 ``xq`` @ (K, N) int8 ``wq`` through the macro model ->
    (M, N) float32 ``scale * sum_t (tile dot + sigma * noise_t)``."""
    if xq.device.type == "cpu":
        return cim_matmul_int8_plain(xq, wq, seed, sigma, scale)
    if xq.device.type != "cuda":
        raise ValueError(f"cim_matmul_int8: unsupported device {xq.device}")
    m, k = xq.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"shape mismatch {tuple(xq.shape)} @ {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"cim_matmul_int8 takes int8 operands, got "
                         f"{xq.dtype} and {wq.dtype}")
    if wq.device != xq.device:
        raise ValueError("xq and wq must be on one device")
    xq = xq.contiguous()
    wq = wq.contiguous()
    # a device scale is read by the kernel where it lies (no launch to
    # pack it); a host one travels as an argument
    sc = (_scale_tensor(scale, xq.device)
          if isinstance(scale, torch.Tensor) else None)
    words = resolve_seed(seed)
    noise = words is not None and sigma > 0.0
    s0, s1 = words if noise else (0, 0)
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    plan = cim_int8_plan(m, k, n, xq.data_ptr(), wq.data_ptr(), noise)
    rc = _build.library().cim_matmul_int8(
        xq.data_ptr(), wq.data_ptr(), None if sc is None else sc.data_ptr(),
        1.0 if scale is None or sc is not None else float(scale),
        out.data_ptr(), m, k, n, float(sigma) if noise else 0.0, s0, s1,
        int(noise), plan["block_m"], int(plan["aligned"]),
        _build.stream_ptr(xq.device))
    _build.check(rc, "cim_matmul_int8")
    cim_matmul_int8.launches += 1
    return out


cim_matmul_int8.launches = 0
