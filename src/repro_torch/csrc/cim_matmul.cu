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
// The fused entry reads (seed0, seed1) from device memory (two uint32
// words, a row of the forward's seed table), so that a CUDA graph of a
// forward replays with the seeds staged before each replay; the int8
// entry takes them by value.
//
// Bound on the H100. Decode (the fused entry, M = 1-16 rows): the int8
// weight stream. The kernel does about 2*M operations per weight byte, far
// below the card's ~590 int8 operations per byte of HBM: at decode one
// layer's seven planes (q, k, v, o, gate, up, down; 14.9 MB at qwen2-0.5b
// width) take at least 4.4 us at 3.35 TB/s, and a launch of a small plane
// is bound by its latency chain (the plane's loads, the partials' write,
// the arrival, the merge), which the split shortens by spreading the plane
// over the grid. Training shapes (the int8 entry, M = 1024): the readout
// noise. Every output element of every tile draws one normal, about 85
// integer operations of Threefry on the CUDA cores (see PERF.md), which at
// qwen2-0.5b width outweighs both the int8 products and the bytes.
//
// The fused entry has two bodies, picked by the wrapper's plan
// (cim_fused_plan), both split over K inside macro tiles with the merge of
// cim_gemv.cuh in the same launch (the last block of a column unit to
// arrive sums the splits' int32 partials per tile, adds the tile's noise
// and sums the tiles in f32 in order). Decode (M <= 16 rows): the split-K
// GEMV of cim_gemv.cuh, activations quantized only for the rows that
// exist and the split's K range, while the plane's first loads are in
// flight. Prefill (M > 16): the int8 tensor-core tile of the int8 entry
// below, each block taking a K range of its column tile; the float
// activations are quantized (the same IEEE division, rintf and clamp) as
// they are staged into shared memory, one stage ahead through registers.
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
#include "cim_gemv.cuh"
#include "common.cuh"

#ifdef CIM_GEMV_CLOCK
// Stage probe of the decode GEMV (tools/cim_fused_time.py --clock builds
// with this flag; the main build never does): thread 0 of every block
// stamps %globaltimer at its start, once its activation is staged (the
// plane's first loads issued), after its partial's reduction, after the
// arrival and at its end (after the merge in the last block).
constexpr int GV_STAMPS = 5;
__device__ long long* gv_clock_p = nullptr;
#define GV_STAMP(i)                                                        \
  do {                                                                     \
    if (threadIdx.x == 0 && gv_clock_p != nullptr) {                       \
      long long g_;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));               \
      gv_clock_p[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * GV_STAMPS \
                 + (i)] = g_;                                              \
    }                                                                      \
  } while (0)
#else
#define GV_STAMP(i)
#endif

namespace {

constexpr int TILE = rt::MACRO_ROWS;  // macro rows per K tile

// ------------------------------------------------ fused entry (decode)
// One split of one column unit (blockIdx.x: unit, .y: split) of the
// (M <= MB, K) x (K, N) product; XT = float / bfloat16 activations.
template <typename XT, int MB, int VB, int NSPAN>
__global__ void __launch_bounds__(rt::GV_THREADS)
cim_gemv(const XT* __restrict__ x, const int8_t* __restrict__ wq,
         const float* __restrict__ qp, float* __restrict__ out, int M, int K,
         int N, int klen, int qmax, float sigma,
         const uint32_t* __restrict__ seeds, int noise,
         int* __restrict__ part, float* __restrict__ nz,
         int* __restrict__ counters) {
  __shared__ __align__(16) int8_t xs[MB * rt::MACRO_ROWS];   // [M][klen]
  // the partial's reduction, then the merge's group sums
  constexpr int RED_WORDS = MB * NSPAN > 4 * rt::GV_THREADS
                                ? MB * NSPAN
                                : 4 * rt::GV_THREADS;
  __shared__ __align__(16) int red[RED_WORDS];
  __shared__ int last_s;
  const rt::Splits sp = rt::Splits::make(K, klen);
  constexpr int nspan = NSPAN;
  const int unit = blockIdx.x, j = blockIdx.y, n0 = unit * nspan;
  const int t = threadIdx.x, P = M * nspan, tile = sp.tile(j);
  int k0, k1, lo, hi;
  sp.range(j, k0, k1);
  sp.noise_share(j, P, lo, hi);
  const float x_scale = qp[0], fq = (float)qmax;
  float* nz_unit = noise ? nz + (size_t)unit * sp.tiles * P : nullptr;
  const uint32_t seed0 = noise ? __ldg(seeds) : 0u,
                 seed1 = noise ? __ldg(seeds + 1) : 0u;
  GV_STAMP(0);
  using XV = typename std::conditional<sizeof(XT) == 4, float4, uint2>::type;
  rt::gemv_partial<true, MB, VB, NSPAN>(wq, N, k0, k1, n0, M, xs, klen, red,
                                        [&] {
    rt::stage_rows(
        M, k0, k1,
        [&](int r, int k) {
          return rt::widen4(
              __ldg(reinterpret_cast<const XV*>(x + (size_t)r * K + k)));
        },
        [&](int r, int k, const float4& v) {
          *reinterpret_cast<uint32_t*>(xs + r * klen + k) =
              rt::quant4(v, x_scale, fq);
        });
    if (noise)
      for (int p = lo + t; p < hi; p += rt::GV_THREADS) {
        const int m = p / nspan, n = n0 + p % nspan;
        nz_unit[(size_t)tile * P + p] =
            n < N ? __fmul_rn(sigma, rt::tile_gaussian(
                                         seed0, seed1, (uint32_t)tile,
                                         (uint32_t)m, (uint32_t)n))
                  : 0.0f;
      }
    GV_STAMP(1);
  });
  GV_STAMP(2);
  int* part_unit = part + (size_t)unit * sp.n_split * P;
  for (int e = t; e < P; e += rt::GV_THREADS)
    part_unit[(size_t)j * P + e] = red[e];
  const bool last = rt::arrive_last(&counters[unit], sp.n_split, &last_s);
  GV_STAMP(3);
  if (!last) {
    GV_STAMP(4);
    return;
  }
  const float out_scale = qp[1];
  rt::merge_unit(part_unit, nz_unit, sp, P, red, [&](int p, float v) {
    const int n = n0 + p % nspan;
    if (n < N) out[(size_t)(p / nspan) * N + n] = __fmul_rn(v, out_scale);
  });
  __syncthreads();
  GV_STAMP(4);
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

// The fused entry's prefill launches (SPLIT): each block takes the K range
// of split blockIdx.z of its column tile; the merge is cim_gemv.cuh's.
struct SplitArgs {
  const float* qp;         // device [x_scale, out_scale]
  int qmax, klen;
  int* part;               // [units][n_split][TM * 128] int32 partials
  float* nz;               // [units][tiles][TM * 128] noise, or null
  int* counters;           // [units], zero; left at zero
  const uint32_t* seeds;   // device (seed0, seed1), read when noise
};

// One TM x 128 output tile, warps of WTM x WTN (MI m16 by NI n8
// fragments; WTN by block height, I8Smem). ALIGNED: K % 16 == 0,
// N % 16 == 0 and 16-byte aligned operands (cp.async of whole 16-byte
// chunks); else masked byte loads. The plane stays k-major in shared
// memory: ldmatrix.trans of 16-bit pairs hands a thread two k rows of two
// adjacent columns, and the rows are so chosen (raw_off's order) that two
// __byte_perm give it four consecutive k of one column: the B fragments of
// an even and an odd column, so n8 fragment 2 np of a warp holds columns
// wn + 16 np + even and fragment 2 np + 1 the odd ones (ncol).
// XT: int8 activations as given (the int8 entry), or float / bfloat16
// ones (SPLIT, the fused entry's prefill), quantized against qp[0] while
// staged: fetched one stage ahead into registers, quantized and stored
// once the stage's MMAs are issued.
template <int TM, bool ALIGNED, typename XT = int8_t, bool SPLIT = false>
__global__ void __launch_bounds__(I8Smem<TM>::THREADS)
cim_int8_mma(const XT* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ scale_p, float scale_v,
             float* __restrict__ out, int M, int K, int N, float sigma,
             uint32_t seed0, uint32_t seed1, int noise, SplitArgs sa) {
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
  int k_begin = 0, k_end = K, split = 0;
  rt::Splits sp{};
  if constexpr (SPLIT) {
    sp = rt::Splits::make(K, sa.klen);
    split = blockIdx.z;
    sp.range(split, k_begin, k_end);
    if (noise) {                   // the fused entry's seeds lie on the card
      seed0 = __ldg(sa.seeds);
      seed1 = __ldg(sa.seeds + 1);
    }
  }
  const int n_steps = (k_end - k_begin + KS - 1) / KS;
  // the output column of n8 fragment ni, fragment element e (see above)
  auto ncol = [&](int ni, int e) {
    return n0 + wn + (ni >> 1) * 16 + 4 * t4 + 2 * (e & 1) + (ni & 1);
  };

  // SPLIT: x of a stage, 4 elements a chunk, XIT chunks a thread
  constexpr int XIT = SPLIT ? TM * (KS / 4) / NTHREADS : 1;
  using XV = typename std::conditional<sizeof(XT) == 4, float4, uint2>::type;
  XV xr[XIT];
  const float x_scale = SPLIT ? sa.qp[0] : 1.0f, fq = (float)sa.qmax;
  auto x_fetch = [&](int step) {
    const int k0 = k_begin + step * KS;
#pragma unroll
    for (int i = 0; i < XIT; ++i) {
      const int c = t + i * NTHREADS, r = c / (KS / 4);
      const int m = m0 + r, kk = k0 + (c % (KS / 4)) * 4;
      xr[i] = m < M && kk < k_end
                  ? __ldg(reinterpret_cast<const XV*>(x + (size_t)m * K + kk))
                  : XV{};
    }
  };
  auto x_store = [&](int step) {
    unsigned char* a_s = as + step % NST * L::A;
#pragma unroll
    for (int i = 0; i < XIT; ++i) {
      const int c = t + i * NTHREADS, r = c / (KS / 4);
      *reinterpret_cast<uint32_t*>(a_s + r * A_PITCH + (c % (KS / 4)) * 4) =
          rt::quant4(rt::widen4(xr[i]), x_scale, fq);
    }
  };

  auto load = [&](int step) {
    const int k0 = k_begin + step * KS;
    unsigned char* a_s = as + step % NST * L::A;
    unsigned char* r_s = raw + step % NST * L::RAW;
    if constexpr (ALIGNED) {
      if constexpr (!SPLIT) {
        for (int c = t; c < TM * (KS / 16); c += NTHREADS) {
          const int r = c / (KS / 16), ch = c % (KS / 16);
          const int m = m0 + r, kk = k0 + ch * 16;
          const bool ok = m < M && kk < K;
          rt::cp_async16(a_s + r * A_PITCH + ch * 16,
                         x + (ok ? (size_t)m * K + kk : 0), ok);
        }
      }
      for (int c = t; c < KS * (MN / 16); c += NTHREADS) {
        const int r = c / (MN / 16), ch = c % (MN / 16);
        const int kk = k0 + r, n = n0 + ch * 16;
        const bool ok = kk < k_end && n < N;
        rt::cp_async16(r_s + raw_off(r, ch),
                       wq + (ok ? (size_t)kk * N + n : 0), ok);
      }
    } else {
      if constexpr (!SPLIT) {
        for (int e = t; e < TM * (KS / 4); e += NTHREADS) {
          const int r = e / (KS / 4), kk = k0 + (e % (KS / 4)) * 4;
          const int m = m0 + r;
          uint32_t word = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (m < M && kk + i < K)
              word |= (uint32_t)(uint8_t)x[(size_t)m * K + kk + i] << (8 * i);
          *reinterpret_cast<uint32_t*>(a_s + r * A_PITCH +
                                       (e % (KS / 4)) * 4) = word;
        }
      }
      for (int e = t; e < KS * (MN / 4); e += NTHREADS) {
        const int r = e / (MN / 4), c4 = e % (MN / 4);
        const int kk = k0 + r, n = n0 + c4 * 4;
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kk < k_end && n + i < N)
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
    if (i < n_steps) {
      load(i);
      if constexpr (SPLIT) {
        x_fetch(i);
        x_store(i);
      }
    }
    rt::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    rt::cp_async_wait<NST - 2>();              // stage step
    __syncthreads();               // stage step visible; the slots of
                                   // stage step - 1 are free
    if (step + NST - 1 < n_steps) {
      load(step + NST - 1);
      if constexpr (SPLIT) x_fetch(step + NST - 1);
    }
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
    if constexpr (SPLIT) {
      if (step + NST - 1 < n_steps) x_store(step + NST - 1);
      continue;                    // one macro tile at most: no epilogue
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
  if constexpr (SPLIT) {
    // the split's int32 partial, its share of the tile's noise, arrive;
    // the unit's last block merges (cim_gemv.cuh)
    __shared__ int last_s;
    static_assert(NTHREADS == rt::GV_THREADS, "the merge's thread count");
    constexpr int P = TM * MN;
    const int unit = blockIdx.y * gridDim.x + blockIdx.x;
    int* part_unit = sa.part + (size_t)unit * sp.n_split * P;
    int* slot = part_unit + (size_t)split * P;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          slot[(wm + mi * 16 + g8 + (e >> 1) * 8) * MN + ncol(ni, e) - n0] =
              acc[mi][ni][e];
    float* nz_unit = noise ? sa.nz + (size_t)unit * sp.tiles * P : nullptr;
    if (noise) {
      int lo, hi;
      sp.noise_share(split, P, lo, hi);
      const int tile = sp.tile(split);
      for (int p = lo + t; p < hi; p += NTHREADS) {
        const int m = m0 + p / MN, n = n0 + p % MN;
        nz_unit[(size_t)tile * P + p] =
            m < M && n < N
                ? __fmul_rn(sigma, rt::tile_gaussian(seed0, seed1,
                                                     (uint32_t)tile,
                                                     (uint32_t)m, (uint32_t)n))
                : 0.0f;
      }
    }
    if (!rt::arrive_last(&sa.counters[unit], sp.n_split, &last_s)) return;
    const float out_scale = sa.qp[1];
    // the ring's stages are consumed: its first 4 KB hold the group sums
    rt::merge_unit(part_unit, nz_unit, sp, P, reinterpret_cast<int*>(smem8),
                   [&](int p, float v) {
      const int m = m0 + p / MN, n = n0 + p % MN;
      if (m < M && n < N) out[(size_t)m * N + n] = __fmul_rn(v, out_scale);
    });
    return;
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
      x, w, scale_p, scale_v, o, M, K, N, sigma, seed0, seed1, noise,
      SplitArgs{});
  return (int)cudaGetLastError();
}

// The fused entry's launches: grid (column units, splits) for the GEMV,
// (column tiles, row blocks, splits) for the tensor-core tile.
template <typename XT, int MB, int VB, int NSPAN>
int launch_gemv(const XT* x, const int8_t* w, float* o, int M, int K, int N,
                float sigma, int noise, const SplitArgs& sa, cudaStream_t s) {
  const rt::Splits sp = rt::Splits::make(K, sa.klen);
  const dim3 grid((N + NSPAN - 1) / NSPAN, sp.n_split);
  cim_gemv<XT, MB, VB, NSPAN><<<grid, rt::GV_THREADS, 0, s>>>(
      x, w, sa.qp, o, M, K, N, sa.klen, sa.qmax, sigma, sa.seeds, noise,
      sa.part, sa.nz, sa.counters);
  return (int)cudaGetLastError();
}

template <typename XT, int TM, bool ALIGNED>
int launch_split_mma(const XT* x, const int8_t* w, float* o, int M, int K,
                     int N, float sigma, int noise, const SplitArgs& sa,
                     cudaStream_t s) {
  constexpr int bytes = I8Smem<TM>::bytes_noiseless;   // no noise slots
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cim_int8_mma<TM, ALIGNED, XT, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const rt::Splits sp = rt::Splits::make(K, sa.klen);
  const dim3 grid((N + MN - 1) / MN, (M + TM - 1) / TM, sp.n_split);
  cim_int8_mma<TM, ALIGNED, XT, true><<<grid, I8Smem<TM>::THREADS, bytes,
                                         s>>>(
      x, w, nullptr, 0.0f, o, M, K, N, sigma, 0u, 0u, noise, sa);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_fused(const XT* x, const int8_t* w, float* o, int M, int K, int N,
                 float sigma, int noise, int block_m, int vec, int nspan,
                 int aligned, const SplitArgs& sa, cudaStream_t s) {
#define GEMV(MB, VB)                                                      \
  if (block_m == MB && vec == VB && nspan == 64)                          \
    return launch_gemv<XT, MB, VB, 64>(x, w, o, M, K, N, sigma, noise,    \
                                       sa, s);                            \
  if (block_m == MB && vec == VB && nspan == 32)                          \
    return launch_gemv<XT, MB, VB, 32>(x, w, o, M, K, N, sigma, noise,    \
                                       sa, s);
  GEMV(4, 16) GEMV(4, 8) GEMV(4, 4) GEMV(8, 8) GEMV(8, 4) GEMV(16, 4)
#undef GEMV
#define MMA(TM, AL)                                                       \
  if (block_m == TM && aligned == AL)                                     \
    return launch_split_mma<XT, TM, AL>(x, w, o, M, K, N, sigma, noise,   \
                                        sa, s);
  MMA(32, 1) MMA(32, 0) MMA(64, 1) MMA(64, 0)
#undef MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifdef CIM_GEMV_CLOCK
extern "C" int cim_gemv_clock_set(void* p) {
  return (int)cudaMemcpyToSymbol(gv_clock_p, &p, sizeof(p));
}
#endif

// x: (M, K) float32 (x_dtype 0) or bfloat16 (1), row-major, 16-byte
// aligned; wq: (K, N) int8 row-major; qp: device [x_scale, out_scale];
// out: (M, N) float32. The plan (kernels/cim_matmul.py cim_fused_plan):
// block_m 4, 8 or 16 (the GEMV's rows, M <= block_m; vec its load bytes,
// N % vec == 0 and wq on vec bytes; nspan, 64 or 32, columns a unit) or
// 32, 64 (the tensor-core tile's rows; aligned: K % 16 == 0, N % 16 == 0
// and wq on 16 bytes; 128 columns a unit); klen rows a split. seeds: the
// device words (seed0, seed1), read only with noise. part: int32 scratch
// of units x splits x (rows x columns of a unit); nz: f32 scratch of units
// x tiles x the same (noise only); counters: units ints, zero (left zero).
// Requires K % 4 == 0, N % 4 == 0 (checked by the Python wrapper). Returns
// cudaGetLastError() after the launch.
extern "C" int cim_matmul_fused(const void* x, int x_dtype, const void* wq,
                                const void* qp, void* out, int M, int K,
                                int N, int qmax, float sigma,
                                const void* seeds, int noise, void* part,
                                void* nz, void* counters, int block_m,
                                int vec, int nspan, int klen, int aligned,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  float* o = static_cast<float*>(out);
  const SplitArgs sa{static_cast<const float*>(qp), qmax, klen,
                     static_cast<int*>(part), static_cast<float*>(nz),
                     static_cast<int*>(counters),
                     static_cast<const uint32_t*>(seeds)};
  if (klen <= 0 || klen % 16 || (block_m > 16 && klen % KS) ||
      M > (block_m > 16 ? 1 << 30 : block_m) || (noise && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return launch_fused(static_cast<const float*>(x), w, o, M, K, N, sigma,
                        noise, block_m, vec, nspan, aligned, sa, s);
  return launch_fused(static_cast<const __nv_bfloat16*>(x), w, o, M, K, N,
                      sigma, noise, block_m, vec, nspan, aligned, sa, s);
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
