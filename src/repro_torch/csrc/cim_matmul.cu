// CIM matmul on a deployed int8 weight plane: one device body, two entries.
//
// cim_matmul_fused replaces the TPU kernel src/repro/kernels/cim_matmul.py
// cim_matmul_fused_pallas / _fused_kernel (pl.pallas_call at :340): float
// activations, quantized in the prologue. cim_matmul_int8 replaces
// cim_matmul_pallas / _kernel (pl.pallas_call at :275): activations that
// arrive already quantized as int8, with a scalar scale epilogue; it is the
// kernel of the straight-through ops.cim_matmul.
//
//   out[m, n] = out_scale * sum_t ( float(sum_{k in tile t} xq[m, k] * wq[k, n])
//                                   + sigma * N_t(m, n) )
//   xq = clip(rint(x / x_scale), -qmax, qmax)   (fused entry; half to even)
//   N_t(m, n) = Box-Muller(Threefry((seed0 ^ DOMAIN, seed1 ^ t), (m, n)))
//
// K is cut into macro tiles of 1024 rows (one readout-noise draw per tile,
// part of the macro model). The f32 sum over tiles runs in tile order.
//
// Bound on the H100. Decode (the fused entry, M = 1-8 rows): the int8
// weight stream. The kernel does about 2*M operations per weight byte, far
// below the card's ~590 int8 operations per byte of HBM: at decode one
// layer's seven planes (q, k, v, o, gate, up, down; 14.9 MB at qwen2-0.5b
// width) take at least 4.4 us at 3.35 TB/s. Training shapes (the int8
// entry, M = 1024): the readout noise. Every output element of every tile
// draws one normal, about 85 integer operations of Threefry on the CUDA
// cores (see PERF.md), which at qwen2-0.5b width outweighs both the int8
// products and the bytes.
// The design streams each weight byte once per block row: a block owns
// BN = 32 output columns and BM = 8 rows (M is not padded to 64; rows past M
// are zero in shared memory and never stored), reads the plane with 32-bit
// loads (4 columns of one row per thread, four rows in flight per step),
// transposes the bytes in registers (__byte_perm) and takes the int32 dot
// with __dp4a. A ragged plane (K or N not a multiple of 4, or an unaligned
// pointer; int8 entry only) takes byte loads masked at the edges into the
// same words. The int8 activations of the tile live in shared memory (the
// ragged last tile is zero-padded there, never in device memory). Inside one
// tile the int32 partial sums of the 32 k-slices reduce exactly (integers)
// through warp shuffles and shared memory; each thread then owns one (m, n)
// output, adds the tile's noise and keeps the f32 accumulator across tiles
// in a register. Nothing carries between blocks.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TILE = 1024;           // macro rows per K tile
constexpr int BM = 8;                // output rows per block
constexpr int BN = 32;               // output columns per block
constexpr int THREADS = 256;
constexpr int CG = BN / 4;           // column groups of 4 (one 32-bit load)
constexpr int KSL = THREADS / CG;    // k-slices, 4 rows each
constexpr int KSTEP = KSL * 4;       // rows swept per step
constexpr int WARPS = THREADS / 32;
static_assert(BM * BN == THREADS, "one output element per thread");
static_assert(KSL % 4 == 0 && CG == 8, "warp holds 4 k-slices of 8 groups");

// Four weight bytes of row k at columns col..col+3, zero past K or N.
__device__ __forceinline__ uint32_t ragged_word(const int8_t* __restrict__ wq,
                                                int k, bool row_ok, int col,
                                                int N) {
  uint32_t w = 0;
  if (row_ok)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < N)
        w |= (uint32_t)(uint8_t)__ldg(wq + (size_t)k * N + col + c) << (8 * c);
  return w;
}

// XT = float / bfloat16: quantize in the prologue (fused entry);
// XT = int8_t: activations as given (int8 entry). VEC: K % 4 == 0,
// N % 4 == 0 and an aligned plane, so the plane is read with 32-bit loads.
template <typename XT, bool VEC>
__global__ void __launch_bounds__(THREADS)
cim_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ qp, float* __restrict__ out, int M,
           int K, int N, int qmax, float sigma, uint32_t seed0,
           uint32_t seed1, int noise) {
  __shared__ __align__(16) int8_t xs[BM][TILE];
  __shared__ int red[WARPS][BM][BN];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cg = t % CG, ks = t / CG;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  constexpr bool QUANT = !std::is_same<XT, int8_t>::value;
  const int col = n0 + cg * 4;
  const int om = t / BN, on = t % BN;          // this thread's output
  const int mrows = min(BM, M - m0);
  const float x_scale = qp[0], out_scale = qp[1];
  const float fq = (float)qmax;
  const int n_tiles = (K + TILE - 1) / TILE;
  float acc = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kb = tile * TILE;
    const int len = min(TILE, K - kb);
    __syncthreads();                           // xs / red free again
    for (int i = t; i < BM * TILE; i += THREADS) {
      const int r = i / TILE, k = i % TILE;
      int8_t q = 0;
      if (r < mrows && k < len) {
        const XT v = x[(size_t)(m0 + r) * K + kb + k];
        if constexpr (QUANT)
          q = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(rt::to_float(v), x_scale)),
                                  -fq), fq);
        else
          q = v;
      }
      xs[r][k] = q;
    }
    __syncthreads();

    int part[BM][4];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0;
    if (col < N) {
#pragma unroll 2
      for (int k = ks * 4; k < len; k += KSTEP) {
        uint32_t w0, w1, w2, w3;
        if constexpr (VEC) {
          const int8_t* wp = wq + (size_t)(kb + k) * N + col;
          w0 = __ldg(reinterpret_cast<const uint32_t*>(wp));
          w1 = __ldg(reinterpret_cast<const uint32_t*>(wp + N));
          w2 = __ldg(reinterpret_cast<const uint32_t*>(wp + 2 * (size_t)N));
          w3 = __ldg(reinterpret_cast<const uint32_t*>(wp + 3 * (size_t)N));
        } else {
          w0 = ragged_word(wq, kb + k, k < len, col, N);
          w1 = ragged_word(wq, kb + k + 1, k + 1 < len, col, N);
          w2 = ragged_word(wq, kb + k + 2, k + 2 < len, col, N);
          w3 = ragged_word(wq, kb + k + 3, k + 3 < len, col, N);
        }
        // rows k..k+3 x columns c..c+3 -> per column the 4 bytes of k..k+3
        const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
        const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
        const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
        const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
        const int wc[4] = {(int)__byte_perm(t0, t1, 0x5410),
                           (int)__byte_perm(t0, t1, 0x7632),
                           (int)__byte_perm(t2, t3, 0x5410),
                           (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const int xw = *reinterpret_cast<const int*>(&xs[r][k]);
#pragma unroll
          for (int c = 0; c < 4; ++c) part[r][c] = __dp4a(xw, wc[c], part[r][c]);
        }
      }
    }
    // exact integer reduction: 4 k-slices per warp, then 8 warps
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int v = part[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < CG) red[warp][r][cg * 4 + c] = v;
      }
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][om][on];
    float sf = __int2float_rn(s);
    if (noise)
      sf = __fadd_rn(sf, __fmul_rn(sigma, rt::tile_gaussian(
               seed0, seed1, (uint32_t)tile, (uint32_t)(m0 + om),
               (uint32_t)(n0 + on))));
    acc = __fadd_rn(acc, sf);
  }
  if (om < mrows && n0 + on < N)
    out[(size_t)(m0 + om) * N + n0 + on] = __fmul_rn(acc, out_scale);
}

}  // namespace

// x: (M, K) float32 (x_dtype 0) or bfloat16 (1), row-major; wq: (K, N)
// int8 row-major; qp: device [x_scale, out_scale]; out: (M, N) float32.
// Requires K % 4 == 0, N % 4 == 0 and 4-byte aligned wq (checked by the
// Python wrapper). Returns cudaGetLastError() after the launch.
extern "C" int cim_matmul_fused(const void* x, int x_dtype, const void* wq,
                                const void* qp, void* out, int M, int K,
                                int N, int qmax, float sigma,
                                unsigned int seed0, unsigned int seed1,
                                int noise, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* q = static_cast<const float*>(qp);
  float* o = static_cast<float*>(out);
  if (x_dtype == 0)
    cim_kernel<float, true><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), w, q, o, M, K, N, qmax, sigma, seed0,
        seed1, noise);
  else
    cim_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, q, o, M, K, N, qmax, sigma,
        seed0, seed1, noise);
  return (int)cudaGetLastError();
}

// xq: (M, K) int8 row-major; wq: (K, N) int8 row-major; qp: device
// [unused, scale]; out: (M, N) float32. Any K, N and alignment: a ragged
// plane takes the masked byte loads. Returns cudaGetLastError() after the
// launch.
extern "C" int cim_matmul_int8(const void* xq, const void* wq,
                               const void* qp, void* out, int M, int K,
                               int N, float sigma, unsigned int seed0,
                               unsigned int seed1, int noise, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* q = static_cast<const float*>(qp);
  float* o = static_cast<float*>(out);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  if (vec)
    cim_kernel<int8_t, true><<<grid, THREADS, 0, s>>>(
        x, w, q, o, M, K, N, 0, sigma, seed0, seed1, noise);
  else
    cim_kernel<int8_t, false><<<grid, THREADS, 0, s>>>(
        x, w, q, o, M, K, N, 0, sigma, seed0, seed1, noise);
  return (int)cudaGetLastError();
}
