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
"""

from __future__ import annotations

import math
from typing import Tuple

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
            device="cpu", start: int = 0) -> torch.Tensor:
    """f32 ``jax.random.uniform``: floats * (max - min) + min, then max(min, .)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    floats = uniform_from_bits(random_bits(key, shape, device, start))
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


def gumbel(key: Key, shape, device="cpu") -> torch.Tensor:
    """f32 ``jax.random.gumbel`` (default mode)."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, device)))
