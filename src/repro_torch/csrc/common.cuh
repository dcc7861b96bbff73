// Shared device helpers of the port's kernels: element loads, the
// Threefry-2x32-20 counter PRNG and the Box-Muller transform of the CIM
// readout-noise contract (bit-compatible with repro_torch/core/prng.py).
//
// Float arithmetic that must round exactly like the plain PyTorch version
// uses the explicit-rounding intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn):
// nvcc contracts a plain a * b + c into one FMA, which rounds once instead
// of twice. The build never passes --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -1e30f;   // the masked score of the attention kernels

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32 with 20 rounds (Salmon et al., SC'11; Random123 KAT).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[(block & 1) * 4 + i]) ^ x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
}

constexpr uint32_t DOMAIN_TILE_NOISE = 0x7F4A7C15u;

// One standard normal of the CIM noise contract: key (seed0 ^ DOMAIN,
// seed1 ^ tile), counter = global (row, col), Box-Muller cosine branch.
__device__ __forceinline__ float tile_gaussian(uint32_t seed0, uint32_t seed1,
                                               uint32_t tile, uint32_t row,
                                               uint32_t col) {
  uint32_t b0 = row, b1 = col;
  threefry2x32(seed0 ^ DOMAIN_TILE_NOISE, seed1 ^ tile, b0, b1);
  const float u1 = __fsub_rn(2.0f, __uint_as_float((b0 >> 9) | 0x3F800000u));
  const float u2 = __fsub_rn(__uint_as_float((b1 >> 9) | 0x3F800000u), 1.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831853071795865f, u2)));
}

}  // namespace rt
