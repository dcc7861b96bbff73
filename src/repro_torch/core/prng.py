"""Counter-based Threefry PRNG, bit-compatible with ``jax.random``.

Twin of the JAX package's ``core/prng.py`` plus the pieces of
``jax.random`` the port must replay bit for bit (jax 0.9.0, partitionable
Threefry):

  * ``threefry2x32`` — Threefry-2x32-20 (Salmon et al., SC'11). One generic
    implementation serves Python ints (host-side key chains), int64 numpy
    arrays and int64 torch tensors: every word is held in a 64-bit lane and
    masked back to 32 bits after each add/shift, so the same code runs on
    the host, on the CPU and on the card.
  * ``tile_gaussian`` — the readout-noise contract of the CIM kernel: key
    ``(seed0 ^ DOMAIN_TILE_NOISE, seed1 ^ tile)``, counter = global
    ``(row, col)``, Box-Muller on the two output words.
  * ``PRNGKey``/``fold_in``/``split``/``random_bits``/``uniform``/
    ``normal``/``gumbel`` — the raw-key functions of ``jax.random``. A key is
    a ``(k0, k1)`` tuple of Python ints; the chain of keys lives on the host
    and never costs a device launch. ``fold_in(k, d)`` is
    ``threefry2x32(k, (0, d))``; ``split(k)[i]`` is ``threefry2x32(k, (0, i))``;
    ``random_bits`` xors the two words at counter ``(hi, lo)`` of the flat
    index.
  * ``seed_table`` — every CIM noise seed of one forward in one vectorized
    Threefry call, for a table that the kernels read from device memory
    (``SeedRow`` names one of its rows).
"""

from __future__ import annotations

import math
import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_THREEFRY_C240 = 0x1BD11BDA
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)

# per-consumer key domains, shared with the JAX package's contract
DOMAIN_TILE_NOISE = 0x7F4A7C15
DOMAIN_SAR = 0x9E3779B9

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 on uint32 words held in 64-bit lanes.

    Arguments are Python ints, int64 numpy arrays or int64 torch tensors
    with values in [0, 2^32); returns the two output words in the same
    representation."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_C240)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for block in range(5):
        rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & M32
    return x0, x1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits (int64 tensor) -> f32 in [1, 2) from the top 23 bits."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return _bits_to_unit(bits) - 1.0


def _bf16_uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits (int64 tensor) -> bf16 in [0, 1), as ``jax.random.uniform``
    draws bf16: 8 bits (the low byte, as XLA truncates the word), their top
    7 under the exponent of 1.0, minus 1."""
    b = ((bits & 0xFF) >> 1) | 0x3F80
    return b.to(torch.int16).view(torch.bfloat16) - torch.tensor(
        1.0, dtype=torch.bfloat16, device=bits.device)


def gaussian_from_bits(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Two u32 words -> one standard normal (Box-Muller, cosine branch)."""
    u1 = 2.0 - _bits_to_unit(b0)
    u2 = uniform_from_bits(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * math.pi) * u2)


def tile_gaussian(seed0: int, seed1: int, tile: int,
                  row_ids: torch.Tensor, col_ids: torch.Tensor) -> torch.Tensor:
    """Standard normals of one K tile at global (row, col) counters."""
    b0, b1 = threefry2x32((seed0 & M32) ^ DOMAIN_TILE_NOISE,
                          (seed1 & M32) ^ (tile & M32), row_ids, col_ids)
    return gaussian_from_bits(b0, b1)


# ------------------------------------------------------------ jax.random twins

def PRNGKey(seed: int) -> Key:
    """Raw key of ``jax.random.PRNGKey(seed)``: the 64-bit seed split into
    (hi, lo) words (a 32-bit seed has hi = 0)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & M32, seed & M32


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key: Key, num: int = 2) -> list:
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def key_words(key: Key) -> Key:
    return int(key[0]) & M32, int(key[1]) & M32


def seed_from_key(key: Key) -> Key:
    """Both key words as the (seed0, seed1) pair the CIM kernel takes."""
    return key_words(key)


@dataclasses.dataclass(frozen=True)
class SeedRow:
    """Row ``row`` of a (rows, 2) int32 seed table (the uint32 words
    ``(seed0, seed1)`` as their bits): the noise seed of one CIM call, read
    by the kernel from where the table lies."""

    table: torch.Tensor
    row: int


Seed = Union[Key, SeedRow]


def seed_words(seed: Seed) -> Key:
    """The (seed0, seed1) words of a pair or of a table row (read back to
    the host)."""
    if isinstance(seed, SeedRow):
        w0, w1 = seed.table[seed.row].tolist()
        return w0 & M32, w1 & M32
    return key_words(seed)


def seed_table(key: Key, n_layers: int, per_layer: int) -> np.ndarray:
    """(n_layers * per_layer, 2) int32: row ``l * per_layer + c - 1`` holds
    ``seed_from_key(fold_in(fold_in(key, l), c))`` for ``c = 1..per_layer``,
    the seed of the ``c``-th ``Ctx.next_key()`` of layer ``l`` in a forward
    keyed by ``key``; the words as int32 bits. Two vectorized Threefry
    calls instead of a host chain of ``n_layers * (per_layer + 1)``."""
    layers = np.arange(n_layers, dtype=np.int64)
    l0, l1 = threefry2x32(np.int64(key[0] & M32), np.int64(key[1] & M32),
                          np.zeros_like(layers), layers)
    calls = np.arange(1, per_layer + 1, dtype=np.int64)[None, :]
    s0, s1 = threefry2x32(l0[:, None], l1[:, None], np.zeros_like(calls),
                          calls)
    words = np.stack([s0, s1], axis=-1).reshape(-1, 2).astype(np.uint32)
    return words.view(np.int32)


def random_bits(key: Key, shape, device="cpu",
                start: int = 0) -> torch.Tensor:
    """32-bit ``jax.random.bits``: b0 ^ b1 at counter (hi, lo) of the flat
    index, as an int64 tensor of ``shape``. ``start`` offsets the flat
    index: the result is the slice ``[start, start + prod(shape))`` of the
    flat draw of a larger shape, bit for bit."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    return (b0 ^ b1).reshape(shape)


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu", start: int = 0,
            dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` in ``dtype`` (f32 or bf16): floats *
    (max - min) + min, then max(min, .), each op rounded to ``dtype``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"uniform in {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    bits = random_bits(key, shape, device, start)
    floats = (uniform_from_bits(bits) if dtype == torch.float32
              else _bf16_uniform_from_bits(bits))
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's f32 ErfInv (Giles, "Approximating the erfinv function"), so that
# normal() reproduces jax.random.normal up to the ulps of log1p/sqrt
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(
            lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype, device=x.device),
            torch.tensor(_ERFINV_GE5[i], dtype=x.dtype, device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, out)


def normal(key: Key, shape, device="cpu", start: int = 0) -> torch.Tensor:
    """f32 ``jax.random.normal``: sqrt(2) * erf_inv(U(-1, 1)); ``start`` as
    in ``random_bits`` (a slab of a larger draw)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device, start)
    return torch.tensor(np.float32(np.sqrt(2)), dtype=torch.float32,
                        device=device) * erf_inv(u)


def gumbel(key: Key, shape, device="cpu",
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (default mode) in ``dtype`` (f32 or bf16),
    each op rounded to ``dtype``: bit for bit what XLA gives in bf16."""
    tiny = float(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, device,
                                         dtype=dtype)))
