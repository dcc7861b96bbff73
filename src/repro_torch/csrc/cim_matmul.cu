// CIM matmul on a deployed int8 weight plane: two entries.
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
//
// The fused entry (decode shapes) streams each weight byte once per block
// row: a block owns BN = 32 output columns and BM = 8 rows (M is not padded
// to 64; rows past M are zero in shared memory and never stored), reads the
// plane with 32-bit loads (4 columns of one row per thread, four rows in
// flight per step), transposes the bytes in registers (__byte_perm) and
// takes the int32 dot with __dp4a. The quantized activations of the tile
// live in shared memory (the ragged last tile is zero-padded there, never
// in device memory). Inside one tile the int32 partial sums of the 32
// k-slices reduce exactly (integers) through warp shuffles and shared
// memory; each thread then owns one (m, n) output, adds the tile's noise
// and keeps the f32 accumulator across tiles in a register.
//
// The int8 entry (training shapes, M in the hundreds or thousands) runs on
// the int8 tensor cores. A block owns a BM x 128 output tile (BM = 32, 64
// or 128, the wrapper's plan), in warps of 32 x 32 (32 x 16 at BM = 32).
// It walks K in stages of 128 bytes (eight to a macro tile): activations
// and plane rows stream through a ring of four shared-memory stages with
// 16-byte cp.async copies, one barrier a stage. The plane stays (K, N)
// row-major in shared memory, its 16-byte chunks XOR-swizzled by row; the
// MMA wants B K-major, and ldmatrix.trans of 16-bit pairs with rows taken
// in the order {0, 1, 4, 5, 8, 9, 12, 13} (+ 2) hands each thread two k
// rows of two adjacent columns, so that two __byte_perm give it four
// consecutive k of one column: the B fragments of an even and an odd
// column, with no transpose pass. mma.sync.m16n8k32.s32.s8.s8 accumulates
// in int32, exact over a macro tile (|sum| <= 1024 * 127^2 < 2^31). Each
// thread draws sigma * N_t at exactly the (m, n) positions it owns (the
// Threefry on the INT32 lanes), a few positions a stage during the tile's
// main loop into its own shared-memory slots (left out of the launch
// without noise). At each macro-tile boundary it converts the int32
// values of its fragments to f32, adds the noise and adds the tile to its
// f32 accumulator in tile order; the int32 accumulators reset. K % 16 ==
// 0, N % 16 == 0 and 16-byte aligned operands take the cp.async path; any
// other shape takes byte loads masked at the edges into the same layout.
// On the H100 (tools/cim_int8_clock.py, PERF.md) a stage's data is
// already there when its barrier passes: a stage's time goes to issuing
// the copies of a later stage (about 480 cycles) and its ldmatrix and MMAs
// (about 680, the same at 16 or 32 MMAs a warp), not to waiting for bytes
// or to the tensor cores.
#include "attn_mma.cuh"
#include "common.cuh"

namespace {

constexpr int TILE = 1024;           // macro rows per K tile

// ------------------------------------------------ fused entry (decode)
constexpr int BM = 8;                // output rows per block
constexpr int BN = 32;               // output columns per block
constexpr int THREADS = 256;
constexpr int CG = BN / 4;           // column groups of 4 (one 32-bit load)
constexpr int KSL = THREADS / CG;    // k-slices, 4 rows each
constexpr int KSTEP = KSL * 4;       // rows swept per step
constexpr int WARPS = THREADS / 32;
static_assert(BM * BN == THREADS, "one output element per thread");
static_assert(KSL % 4 == 0 && CG == 8, "warp holds 4 k-slices of 8 groups");

// XT = float / bfloat16, quantized in the prologue. K % 4 == 0, N % 4 == 0
// and an aligned plane: the plane is read with 32-bit loads.
template <typename XT>
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
        const float v = rt::to_float(x[(size_t)(m0 + r) * K + kb + k]);
        q = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, x_scale)), -fq), fq);
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
        const int8_t* wp = wq + (size_t)(kb + k) * N + col;
        const uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(wp));
        const uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(wp + N));
        const uint32_t w2 =
            __ldg(reinterpret_cast<const uint32_t*>(wp + 2 * (size_t)N));
        const uint32_t w3 =
            __ldg(reinterpret_cast<const uint32_t*>(wp + 3 * (size_t)N));
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

// ------------------------------------- int8 entry (int8 tensor cores)
constexpr int KS = 128;              // K bytes a stage
constexpr int MN = 128;              // output columns a block
constexpr int WTM = 32;              // output rows a warp
constexpr int MI = WTM / 16;         // m16 fragments a warp
constexpr int A_PITCH = KS + 16;     // bytes an activation row in shared
                                     // memory: ldmatrix rows on distinct banks
static_assert(TILE % KS == 0, "a stage never straddles two macro tiles");

template <int TM>
struct I8Smem {
  static constexpr int NST = 4;            // stages in the ring
  // output columns a warp: 16 in 32-row blocks (eight warps, as many as
  // the larger blocks have, for the noise draws of a small grid), else 32
  static constexpr int WTN = TM == 32 ? 16 : 32;
  static constexpr int NI = WTN / 8;       // n8 fragments a warp
  static_assert(NI % 2 == 0, "B fragments come in pairs of n8 tiles");
  static constexpr int NFRAG = MI * NI * 4;   // accumulator values a thread
  static_assert(NFRAG % (TILE / KS) == 0, "the noise draws split evenly");
  static constexpr int THREADS = TM / WTM * (MN / WTN) * 32;
  static constexpr int A = TM * A_PITCH;   // one stage of activations
  static constexpr int RAW = KS * MN;      // one stage of plane rows (k-major)
  static constexpr int NOISE = NFRAG * THREADS * 4;   // a tile's noise, f32
  static constexpr int bytes_noiseless = NST * (A + RAW);
  static constexpr int bytes = bytes_noiseless + NOISE;
};

// c (16x8 s32) += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` of plane row k in a stage: chunks
// XOR-swizzled by k so that the eight rows of each ldmatrix matrix (k mod
// 16 in {0, 1, 4, 5, 8, 9, 12, 13} or that set + 2) fall on distinct banks
__device__ __forceinline__ int raw_off(int k, int chunk) {
  return k * MN + ((chunk ^ (((k >> 2) & 3) * 2 + (k & 1))) << 4);
}

// One TM x 128 output tile, warps of WTM x WTN (MI m16 by NI n8
// fragments; WTN by block height, I8Smem). ALIGNED: K % 16 == 0,
// N % 16 == 0 and 16-byte aligned operands (cp.async of whole 16-byte
// chunks); else masked byte loads. The plane stays k-major in shared
// memory: ldmatrix.trans of 16-bit pairs hands a thread two k rows of two
// adjacent columns, and the rows are so chosen (raw_off's order) that two
// __byte_perm give it four consecutive k of one column: the B fragments of
// an even and an odd column, so n8 fragment 2 np of a warp holds columns
// wn + 16 np + even and fragment 2 np + 1 the odd ones (ncol).
template <int TM, bool ALIGNED>
__global__ void __launch_bounds__(I8Smem<TM>::THREADS)
cim_int8_mma(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ scale_p, float scale_v,
             float* __restrict__ out, int M, int K, int N, float sigma,
             uint32_t seed0, uint32_t seed1, int noise) {
  using L = I8Smem<TM>;
  constexpr int NST = L::NST, NTHREADS = L::THREADS;
  constexpr int WTN = L::WTN, NI = L::NI, NFRAG = L::NFRAG;
  extern __shared__ __align__(16) unsigned char smem8[];
  unsigned char* as = smem8;                   // [NST][TM][A_PITCH]
  unsigned char* raw = as + NST * L::A;        // [NST][KS][MN], swizzled
  float* ns = reinterpret_cast<float*>(raw + NST * L::RAW);
                                               // [NFRAG][THREADS]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = blockIdx.x * MN, m0 = blockIdx.y * TM;
  const int wm = warp / (MN / WTN) * WTM, wn = warp % (MN / WTN) * WTN;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n_steps = (K + KS - 1) / KS;
  // the output column of n8 fragment ni, fragment element e (see above)
  auto ncol = [&](int ni, int e) {
    return n0 + wn + (ni >> 1) * 16 + 4 * t4 + 2 * (e & 1) + (ni & 1);
  };

  auto load = [&](int step) {
    const int k0 = step * KS;
    unsigned char* a_s = as + step % NST * L::A;
    unsigned char* r_s = raw + step % NST * L::RAW;
    if constexpr (ALIGNED) {
      for (int c = t; c < TM * (KS / 16); c += NTHREADS) {
        const int r = c / (KS / 16), ch = c % (KS / 16);
        const int m = m0 + r, kk = k0 + ch * 16;
        const bool ok = m < M && kk < K;
        rt::cp_async16(a_s + r * A_PITCH + ch * 16,
                       x + (ok ? (size_t)m * K + kk : 0), ok);
      }
      for (int c = t; c < KS * (MN / 16); c += NTHREADS) {
        const int r = c / (MN / 16), ch = c % (MN / 16);
        const int kk = k0 + r, n = n0 + ch * 16;
        const bool ok = kk < K && n < N;
        rt::cp_async16(r_s + raw_off(r, ch),
                       wq + (ok ? (size_t)kk * N + n : 0), ok);
      }
    } else {
      for (int e = t; e < TM * (KS / 4); e += NTHREADS) {
        const int r = e / (KS / 4), kk = k0 + (e % (KS / 4)) * 4;
        const int m = m0 + r;
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (m < M && kk + i < K)
            word |= (uint32_t)(uint8_t)x[(size_t)m * K + kk + i] << (8 * i);
        *reinterpret_cast<uint32_t*>(a_s + r * A_PITCH + (e % (KS / 4)) * 4) =
            word;
      }
      for (int e = t; e < KS * (MN / 4); e += NTHREADS) {
        const int r = e / (MN / 4), c4 = e % (MN / 4);
        const int kk = k0 + r, n = n0 + c4 * 4;
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kk < K && n + i < N)
            word |= (uint32_t)(uint8_t)wq[(size_t)kk * N + n + i] << (8 * i);
        *reinterpret_cast<uint32_t*>(r_s + raw_off(r, c4 >> 2) +
                                     (c4 & 3) * 4) = word;
      }
    }
  };
  // sigma * N_t(m, n) at fragment positions [i0, i1) of this thread's
  // NFRAG (idx = 4 (NI mi + ni) + e), into its own shared slots: a loop,
  // not NFRAG inlined copies of the generator, which would overflow the
  // instruction cache. The main loop draws NPS of them a step, while loads
  // are in flight; the tile's last step draws the rest.
  auto draw = [&](uint32_t tile, int i0, int i1) {
#pragma unroll 2
    for (int idx = i0; idx < i1; ++idx) {
      const int mi = idx / (4 * NI), ni = idx / 4 % NI, e = idx % 4;
      const int m = m0 + wm + mi * 16 + g8 + (e >> 1) * 8;
      const int n = ncol(ni, e);
      ns[idx * NTHREADS + t] =
          m < M && n < N
              ? __fmul_rn(sigma, rt::tile_gaussian(seed0, seed1, tile,
                                                   (uint32_t)m, (uint32_t)n))
              : 0.0f;
    }
  };
  constexpr int NPS = NFRAG / (TILE / KS);
  int drawn = 0;                               // of the current tile

  int acc[MI][NI][4];                          // [m16][n8][fragment]
  float accf[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        accf[mi][ni][e] = 0.0f;
      }

  // ldmatrix.trans rows of this lane: matrix j = lane / 8 takes k rows
  // 16 (j / 2) + 2 (j % 2) + {0, 1, 4, 5, 8, 9, 12, 13}, so that a thread
  // receives k = 4 t4 .. 4 t4 + 1 (matrices 0, 2) and 4 t4 + 2 .. + 3
  // (matrices 1, 3) of columns 2 g8, 2 g8 + 1
  const int lr = lane & 7, lj = lane >> 3;
  const int kl = 16 * (lj >> 1) + 2 * (lj & 1) + 4 * (lr >> 1) + (lr & 1);

  // one cp.async group per stage, empty past the last: before step s the
  // groups of stages up to s are complete, NST - 2 may be in flight
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_steps) load(i);
    rt::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    rt::cp_async_wait<NST - 2>();              // stage step
    __syncthreads();               // stage step visible; the slots of
                                   // stage step - 1 are free
    if (step + NST - 1 < n_steps) load(step + NST - 1);
    rt::cp_async_commit();
    const unsigned char* a_s = as + step % NST * L::A;
    const unsigned char* r_s = raw + step % NST * L::RAW;
#pragma unroll
    for (int kc = 0; kc < KS / 32; ++kc) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        rt::ldsm_x4(af[mi], a_s + (wm + mi * 16 + (lane & 15)) * A_PITCH +
                                kc * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t r[4];
        rt::ldsm_x4_t(r, r_s + raw_off(kc * 32 + kl, (wn >> 4) + np));
        bf[2 * np][0] = __byte_perm(r[0], r[1], 0x6420);
        bf[2 * np + 1][0] = __byte_perm(r[0], r[1], 0x7531);
        bf[2 * np][1] = __byte_perm(r[2], r[3], 0x6420);
        bf[2 * np + 1][1] = __byte_perm(r[2], r[3], 0x7531);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    const uint32_t tile = (uint32_t)(step / (TILE / KS));
    const bool tile_end =
        (step + 1) % (TILE / KS) == 0 || step + 1 == n_steps;
    if (noise) {
      const int upto = tile_end ? NFRAG : drawn + NPS;
      draw(tile, drawn, upto);
      drawn = tile_end ? 0 : upto;
    }
    // macro-tile boundary: the tile's exact sums, its noise, f32 in order
    if (tile_end) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float sf = __int2float_rn(acc[mi][ni][e]);
            acc[mi][ni][e] = 0;
            if (noise)
              sf = __fadd_rn(
                  sf, ns[((mi * NI + ni) * 4 + e) * NTHREADS + t]);
            accf[mi][ni][e] = __fadd_rn(accf[mi][ni][e], sf);
          }
    }
  }
  const float out_scale = scale_p != nullptr ? *scale_p : scale_v;
  // columns ncol(2 np, 0) .. + 3 of rows g8, g8 + 8: even, odd, even, odd
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int np = 0; np < NI / 2; ++np)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g8 + h * 8;
        const int n = ncol(2 * np, 0);
        if (m >= M) continue;
        const float y[4] = {
            __fmul_rn(accf[mi][2 * np][2 * h], out_scale),
            __fmul_rn(accf[mi][2 * np + 1][2 * h], out_scale),
            __fmul_rn(accf[mi][2 * np][2 * h + 1], out_scale),
            __fmul_rn(accf[mi][2 * np + 1][2 * h + 1], out_scale)};
        float* dst = out + (size_t)m * N + n;
        if (ALIGNED) {                         // n + 3 < N, 16-byte aligned
          if (n < N)
            *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2],
                                                          y[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (n + i < N) dst[i] = y[i];
        }
      }
}

template <int TM, bool ALIGNED>
int launch_int8(const int8_t* x, const int8_t* w, const float* scale_p,
                float scale_v, float* o, int M, int K, int N, float sigma,
                uint32_t seed0, uint32_t seed1, int noise, cudaStream_t s) {
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cim_int8_mma<TM, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, I8Smem<TM>::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // without noise the slots of the draws are left out (more blocks an SM)
  const int bytes =
      noise ? I8Smem<TM>::bytes : I8Smem<TM>::bytes_noiseless;
  const dim3 grid((N + MN - 1) / MN, (M + TM - 1) / TM);
  cim_int8_mma<TM, ALIGNED><<<grid, I8Smem<TM>::THREADS, bytes, s>>>(
      x, w, scale_p, scale_v, o, M, K, N, sigma, seed0, seed1, noise);
  return (int)cudaGetLastError();
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
    cim_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), w, q, o, M, K, N, qmax, sigma, seed0,
        seed1, noise);
  else
    cim_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, q, o, M, K, N, qmax, sigma,
        seed0, seed1, noise);
  return (int)cudaGetLastError();
}

// xq: (M, K) int8 row-major; wq: (K, N) int8 row-major; scale_p: a device
// float32 scalar, or null for the host value scale; out: (M, N) float32.
// block_m: 32, 64 or 128 output rows a block (128 columns). aligned:
// K % 16 == 0, N % 16 == 0 and both operands on 16 bytes (cp.async path);
// 0 takes masked byte loads, for any K, N and alignment. Returns
// cudaGetLastError() after the launch.
extern "C" int cim_matmul_int8(const void* xq, const void* wq,
                               const void* scale_p, float scale, void* out,
                               int M, int K, int N, float sigma,
                               unsigned int seed0, unsigned int seed1,
                               int noise, int block_m, int aligned,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* q = static_cast<const float*>(scale_p);
  float* o = static_cast<float*>(out);
  if (aligned && (K % 16 || N % 16 ||
                  reinterpret_cast<uintptr_t>(xq) % 16 ||
                  reinterpret_cast<uintptr_t>(wq) % 16))
    return (int)cudaErrorInvalidValue;
#define I8_ARGS x, w, q, scale, o, M, K, N, sigma, seed0, seed1, noise, s
  if (block_m == 128)
    return aligned ? launch_int8<128, true>(I8_ARGS)
                   : launch_int8<128, false>(I8_ARGS);
  if (block_m == 64)
    return aligned ? launch_int8<64, true>(I8_ARGS)
                   : launch_int8<64, false>(I8_ARGS);
  if (block_m == 32)
    return aligned ? launch_int8<32, true>(I8_ARGS)
                   : launch_int8<32, false>(I8_ARGS);
#undef I8_ARGS
  return (int)cudaErrorInvalidValue;
}
