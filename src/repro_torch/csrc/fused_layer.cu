// One dense transformer layer's decode step as ONE cooperative kernel.
//
// Replaces the TPU kernel src/repro/kernels/fused_step.py fused_dense_layer
// / _kernel (pl.pallas_call at :327):
//
//   h1 = rmsnorm1(x);  q, k, v = proj(h1) + bias;  rope(q, k) at lens[b]
//   cache[b, lens[b]] <- k, v   (int8 codes + scale with an int8 cache)
//   a  = length-aware GQA attention of q over keys 0..lens[b] (the current
//        token included, read back from the cache as written)
//   x1 = x + proj_o(a);  h2 = rmsnorm2(x1)
//   out = x1 + proj_down(silu(proj_gate(h2)) * proj_up(h2))
//
// Each projection is the cim_matmul.cu contract (sim) or a plain f32 dot
// (off): xq = clip(rint(h / xs), +-qmax) with the batch-global activation
// scale xs = clip_k * (sqrt(mean(h^2)) + 1e-8) / qmax; an exact int32 dot
// per 1024-row macro tile; sigma * tile_gaussian(seed, tile, row, col) per
// tile; an f32 tile sum in tile order; times xs * ws. The seven noise
// seeds are the ctx.next_key() words in the order q, k, v, o, gate, up,
// down, read from device memory (seven rows of the forward's seed table,
// or a (7, 2) copy of host keys), so that a CUDA graph of the decode step
// replays with the seeds staged before each replay.
//
// Bound on the H100: the weight stream. At decode B <= 8 rows, so the layer
// moves its seven int8 planes (14.9 MB at qwen2-0.5b width) and does about
// 2 * B operations per weight byte: 4.5 us per layer at 3.35 TB/s. Every
// projection waits for the previous stage across the whole grid, because
// its activation scale is a reduction over the whole (B, K) input, so the
// layer is one cooperative launch (grid no larger than the co-resident
// block count) of five stages between four grid-wide barriers
// (cooperative_groups::this_grid().sync()), and each stage has to spread
// its bytes over every SM:
//
//   1. rmsnorm1 + q/k/v + bias + rope + the cache write at the old length;
//   2. attention, one item per (row, KV head, key range) with its G query
//      heads, online softmax over the live 32-key tiles of the range; the
//      last item of a (row, KV head) to arrive merges the ranges;
//   3. O + residual -> x1;
//   4. rmsnorm2 + gate and up, silu(g) * u -> hm;
//   5. down + residual -> out; lens += 1.
//
// Every projection stage runs the split-K GEMV of cim_gemv.cuh: a unit is
// 64 output columns (one head in stage 1, so rope's (j, j + 32) pairs and
// the int8 scale's max over the head stay in one block), its K axis cut in
// splits inside macro tiles (the wrapper's fused_layer_plan: units x
// planes x splits reach the SM count), one split a work item, the items
// dealt to the blocks in turn. Each item writes its partial (int32 in sim
// mode: exact) and its share of the tile noise to the scratch and arrives
// on its unit's counter (the shared arrival counters, left at zero); the
// last to arrive merges the splits in tile order and runs the unit's
// epilogue (rope and the cache write, the residual, silu(g) * u) at once,
// so no stage needs an extra barrier. The stage probe
// (tools/fused_layer_clock.py, H100 80GB HBM3 at 700 W) put the earlier
// design's 164 us a layer (one block a unit, no splits) at 19 (q/k/v), 44
// (attention: 8 blocks walking ~300 keys each), 12 (o), 25 (gate/up) and
// 58 us (down: 5 macro tiles in series in 28 blocks), about 1.2 us a
// barrier; every stage is now split over the grid.
//
// Every block that needs a scale computes it itself in one fixed order (f64
// sums over a fixed thread mapping; for down's input the f64 sums of hm^2
// that stage 4's merges write per unit, added in unit order), so all
// blocks hold the same value on every run; there are no float atomics.
// Data written inside the launch is read with __ldcg (L2), never through
// the non-coherent read-only path. The wrapper allocates the scratch (q,
// attention output, x1, hm, partials, noise, attention pieces) and the
// outputs; the kernel allocates nothing. Rounding follows the plain
// version through the explicit-rounding intrinsics; the build never passes
// --use_fast_math. Off mode sums its f32 splits in another order than the
// plain version's matmul.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "cim_gemv.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

#ifdef FUSED_LAYER_CLOCK
// Stage probe (tools/fused_layer_clock.py builds with this flag; the main
// build never does): thread 0 of every block stamps %globaltimer at the
// kernel's start, at the end of each stage's work and after each barrier.
constexpr int FL_STAMPS = 10;
__device__ long long* fl_clock_p = nullptr;
__device__ __forceinline__ void fl_stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0 && fl_clock_p != nullptr) {
    long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    fl_clock_p[(size_t)blockIdx.x * FL_STAMPS + i] = g;
  }
}
#define FL_STAMP(i) fl_stamp(i)
#else
#define FL_STAMP(i)
#endif

namespace {

constexpr int THREADS = rt::GV_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int BMAX = 8;          // batch rows (slots)
constexpr int HD = 64;           // head dim
constexpr int SPAN = 64;         // output columns of a projection unit
constexpr int BK = 32;           // keys of an attention tile
constexpr int GMAX = 8;          // query heads per KV head
constexpr int KLEN_MAX = rt::MACRO_ROWS;
static_assert(BMAX <= WARPS, "one warp per row in the row norms");
static_assert(SPAN == HD, "a q/k/v unit is one head");

struct Params {
  const float* x;          // (B, d) layer input
  const float* g1;         // (d,) rmsnorm1 gain
  const float* g2;         // (d,) rmsnorm2 gain
  const void* w[7];        // (K, N) row-major: int8 planes (sim) or f32 (off)
  const float* ws[7];      // plane scales (sim), 0-d f32 each
  const float* bias[3];    // q, k, v biases or null
  const float* freqs;      // (HD / 2,) rope inverse frequencies
  void* kc;                // (B, T, KV, HD) f32 or int8 cache, written in place
  void* vc;
  float* ksc;              // (B, T, KV) f32 scales (int8 cache) or null
  float* vsc;
  int* lens;               // (B,) old lengths, advanced by one in place
  float* q;                // scratch (B, H * HD): roped queries
  float* attn;             // scratch (B, H * HD): attention output
  float* x1;               // scratch (B, d): first residual
  float* hm;               // scratch (B, F): silu(g) * u
  float* out;              // (B, d) layer output
  float* scales;           // (7,) activation scales (0 in off mode)
  void* part;              // scratch: a stage's split partials (int32 / f32)
  float* nz;               // scratch: a stage's tile noise
  float* apart;            // scratch (B * KV, n_at, GMAX * HD): attention
  float* aml;              // scratch (B * KV, n_at, 2 * GMAX): its m and l
  double* ssq;             // scratch (F / SPAN,): sum of hm^2 per unit
  int* counters;           // zero; left zero: q/k/v, attention, o, mlp, down
  const unsigned int* seeds;  // (7, 2) device words (seed0, seed1), sim
  float sigma[7];
  int qmax[7];
  int klen[4];             // split rows: q/k/v, o, gate/up, down
  int B, d, H, KV, F, T;
  float eps, clip_k, attn_scale;
  int sim, int8;
  int grid;                // out: blocks launched
};

// ------------------------------------------------------------ sources
// A projection reads its input element (b, k) through one of these.

struct NormSrc {           // rmsnorm: (x * rinv[b]) * g
  const float* x;
  const float* g;
  const float* rinv;       // shared memory
  int K;
  bool coherent;           // x written inside this launch
  __device__ float4 vec4(int b, int k) const {    // elements k..k+3
    const float4* p = reinterpret_cast<const float4*>(x + (size_t)b * K + k);
    const float4 v = coherent ? __ldcg(p) : *p;
    const float4 w = __ldg(reinterpret_cast<const float4*>(g + k));
    const float r = rinv[b];
    return make_float4(__fmul_rn(__fmul_rn(v.x, r), w.x),
                       __fmul_rn(__fmul_rn(v.y, r), w.y),
                       __fmul_rn(__fmul_rn(v.z, r), w.z),
                       __fmul_rn(__fmul_rn(v.w, r), w.w));
  }
};

struct BufSrc {            // a scratch activation written in this launch
  const float* x;
  int K;
  __device__ float4 vec4(int b, int k) const {
    return __ldcg(reinterpret_cast<const float4*>(x + (size_t)b * K + k));
  }
};

// ------------------------------------------------------------ reductions

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v over its threads, in warp order (every thread).
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double tot = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) tot += red[w];
  __syncthreads();
  return tot;
}

__device__ __forceinline__ double sq4(const float4& v) {
  return (double)v.x * (double)v.x + (double)v.y * (double)v.y +
         (double)v.z * (double)v.z + (double)v.w * (double)v.w;
}

// rinv[b] = 1 / sqrt(mean_k x[b, k]^2 + eps), one warp per row, four
// 16-byte loads of a lane in flight at once. d % 4 == 0.
__device__ void row_rinv(const float* x, bool coherent, int B, int d,
                         float eps, float* rinv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < B) {
    const float4* row = reinterpret_cast<const float4*>(x + (size_t)warp * d);
    double s = 0.0;
    for (int k0 = lane; k0 < d / 4; k0 += 4 * 32) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * 32;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (k < d / 4) v[u] = coherent ? __ldcg(row + k) : row[k];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) s += sq4(v[u]);
    }
    s = warp_sum(s);
    if (lane == 0) {
      const float m = (float)(s / (double)d);
      rinv[warp] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(m, eps)));
    }
  }
  __syncthreads();
}

// layers._act_scale from the f64 sum of squares of n elements
__device__ float scale_of(double tot, int n, float clip_k, int qmax) {
  const float mean = (float)(tot / (double)n);
  const float rms = __fadd_rn(__fsqrt_rn(mean), 1e-8f);
  return __fdiv_rn(__fmul_rn(clip_k, rms), (float)qmax);
}

// The batch-global activation scale over all B * K elements of src, in one
// fixed order (the same in every block); four 16-byte loads of a thread in
// flight at once. K % 4 == 0.
template <class Src>
__device__ float act_scale(const Src& src, int B, int K, float clip_k,
                           int qmax, double* red) {
  const int K4 = K / 4, n = B * K4;
  double s = 0.0;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * THREADS) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, b = i / K4;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n) v[u] = src.vec4(b, (i - b * K4) * 4);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) s += sq4(v[u]);
  }
  return scale_of(block_sum(s, red), B * K, clip_k, qmax);
}

// ------------------------------------------------------------ shared memory
template <bool SIM>
__host__ __device__ constexpr size_t proj_bytes() {
  return (SIM ? 1 : 4) * BMAX * KLEN_MAX +
         4 * (SIM ? 1 : WARPS) * BMAX * SPAN;
}
__host__ __device__ constexpr size_t attn_bytes() {
  return 4 * (GMAX * HD + HD * (BK + 1) + BK * HD + GMAX * BK + 3 * GMAX);
}
constexpr size_t ACC_BYTES = 4 * 2 * BMAX * SPAN;   // two result tiles
// the merge's group sums: four values a thread
constexpr size_t MERGE_BYTES = 16 * THREADS;
__host__ __device__ constexpr size_t max2(size_t a, size_t b) {
  return a > b ? a : b;
}
template <bool SIM>
__host__ __device__ constexpr size_t work_bytes() {
  return max2(max2(proj_bytes<SIM>(), attn_bytes()), MERGE_BYTES);
}
// ------------------------------------------------------------ projection
// One work item of a projection stage: split j of plane idx at columns
// [n0, n0 + SPAN) of the (B, K) activation src. Writes the split's partial
// into its slot of part_unit ([n_split][B * SPAN]) and its share of the
// tile noise into nz_unit ([tiles][B * SPAN]), then arrives on counter
// (n_arrive arrivals a unit). Returns true in the unit's last block.
template <bool SIM, class Src>
__device__ bool project_split(const Params& p, int idx, const Src& src,
                              int K, int N, int n0, float xs, int klen, int j,
                              void* part_unit, float* nz_unit, int* counter,
                              int n_arrive, unsigned char* work, int* flag) {
  using AT = typename std::conditional<SIM, int, float>::type;
  using XT = typename std::conditional<SIM, int8_t, float>::type;
  constexpr int VB = SIM ? 8 : 16;       // 8 columns a thread either way
  XT* xt = reinterpret_cast<XT*>(work);                     // [B][klen]
  AT* red = reinterpret_cast<AT*>(work + sizeof(XT) * BMAX * KLEN_MAX);
  const rt::Splits sp = rt::Splits::make(K, klen);
  const int t = threadIdx.x, B = p.B, P = B * SPAN, tile = sp.tile(j);
  int k0, k1, lo, hi;
  sp.range(j, k0, k1);
  sp.noise_share(j, P, lo, hi);
  const float fq = (float)p.qmax[idx], sigma = p.sigma[idx];
  const bool noise = SIM && sigma > 0.0f;
  const uint32_t seed0 = noise ? __ldg(p.seeds + 2 * idx) : 0u,
                 seed1 = noise ? __ldg(p.seeds + 2 * idx + 1) : 0u;
  rt::gemv_partial<SIM, BMAX, VB, SPAN>(p.w[idx], N, k0, k1, n0, B, xt, klen,
                                        red, [&] {
    rt::stage_rows(
        B, k0, k1, [&](int r, int k) { return src.vec4(r, k); },
        [&](int r, int k, const float4& v) {
          if constexpr (SIM) {
            *reinterpret_cast<uint32_t*>(xt + r * klen + k) =
                rt::quant4(v, xs, fq);
          } else {
            *reinterpret_cast<float4*>(xt + r * klen + k) = v;
          }
        });
    if (noise)
      for (int q = lo + t; q < hi; q += THREADS)
        nz_unit[(size_t)tile * P + q] = __fmul_rn(
            sigma, rt::tile_gaussian(seed0, seed1,
                                     (uint32_t)tile, (uint32_t)(q / SPAN),
                                     (uint32_t)(n0 + q % SPAN)));
  });
  AT* slot = static_cast<AT*>(part_unit) + (size_t)j * P;
  for (int e = t; e < P; e += THREADS) slot[e] = red[e];
  return rt::arrive_last(counter, n_arrive, flag);
}

// The unit's projection (B x SPAN, bias included for q/k/v) into acc
// (shared), merged from its splits in tile order; in the last block.
// work: the merge's group sums (the staged activation is consumed).
template <bool SIM>
__device__ void project_merge(const Params& p, int idx, int K, int klen,
                              int n0, float xs, const void* part_unit,
                              const float* nz_unit, float* acc,
                              unsigned char* work) {
  using AT = typename std::conditional<SIM, int, float>::type;
  const rt::Splits sp = rt::Splits::make(K, klen);
  const bool noise = SIM && p.sigma[idx] > 0.0f;
  const float out_scale = SIM ? __fmul_rn(xs, *p.ws[idx]) : 1.0f;
  const float* bias = idx < 3 ? p.bias[idx] : nullptr;
  rt::merge_unit(static_cast<const AT*>(part_unit), noise ? nz_unit : nullptr,
                 sp, p.B * SPAN, reinterpret_cast<AT*>(work),
                 [&](int e, float y) {
    if (SIM) y = __fmul_rn(y, out_scale);
    if (bias != nullptr) y = __fadd_rn(y, bias[n0 + e % SPAN]);
    acc[e] = y;
  });
  __syncthreads();
}

// ------------------------------------------------------------ attention
// One item of stage 2: the G query heads of (row b, KV head h) against the
// live keys of key tiles [g * tps, (g + 1) * tps), online softmax in tiles
// of BK; writes the unnormalized output and its (m, l) per head, arrives,
// and the last item of (b, h) merges the n_as ranges into attn.
template <typename KVT>
__device__ void attend_split(const Params& p, int b, int h, int g, int n_as,
                             int n_t, int* counter, unsigned char* work,
                             int* flag) {
  constexpr bool INT8 = sizeof(KVT) == 1;
  constexpr int NOUT = GMAX * HD / THREADS;
  float* qs = reinterpret_cast<float*>(work);        // [GMAX][HD]
  float* kt = qs + GMAX * HD;                         // [HD][BK + 1]
  float* vsm = kt + HD * (BK + 1);                    // [BK][HD]
  float* ps = vsm + BK * HD;                          // [GMAX][BK]
  float* m_s = ps + GMAX * BK;                        // [GMAX]
  float* l_s = m_s + GMAX;
  float* a_s = l_s + GMAX;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = p.H / p.KV, T = p.T, KV = p.KV, unit = b * KV + h;
  const int n_live = min(p.lens[b] + 1, T);
  const int live_t = (n_live + BK - 1) / BK;
  const int tps = (n_t + n_as - 1) / n_as;
  const int t0 = g * tps, t1 = min(t0 + tps, live_t);
  float* po = p.apart + (size_t)unit * n_t * GMAX * HD;
  float* pml = p.aml + (size_t)unit * n_t * 2 * GMAX;
  if (t0 < t1) {
    __syncthreads();                                  // work free again
    static_assert(GMAX * HD / 4 <= THREADS, "one 16-byte q load a thread");
    if (t < GMAX * HD / 4) {
      const int r = t / (HD / 4);
      reinterpret_cast<float4*>(qs)[t] =
          r < G ? __ldcg(reinterpret_cast<const float4*>(
                      p.q + ((size_t)b * p.H + h * G) * HD) + t)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int r = t; r < GMAX; r += THREADS) {
      m_s[r] = rt::NEG_INF;
      l_s[r] = 0.0f;
    }
    float acc[NOUT];
#pragma unroll
    for (int u = 0; u < NOUT; ++u) acc[u] = 0.0f;
    for (int kt_i = t0; kt_i < t1; ++kt_i) {
      const int j0 = kt_i * BK;
      __syncthreads();                                // previous tile consumed
      if constexpr (INT8) {
        // 16 codes a thread: K by threads 0-127, V by 128-255
        const int e = t & 127, j = e / (HD / 16), c16 = e % (HD / 16);
        const bool is_v = t >= 128;
        float f[16];
        if (j0 + j < n_live) {
          const size_t row = ((size_t)b * T + j0 + j) * KV + h;
          const int4 raw = __ldcg(reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(is_v ? p.vc : p.kc) + row * HD) + c16);
          const float sc = __ldcg((is_v ? p.vsc : p.ksc) + row);
          const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int i = 0; i < 16; ++i) f[i] = __fmul_rn((float)c[i], sc);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) f[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int dd = c16 * 16 + i;
          if (is_v)
            vsm[j * HD + dd] = f[i];
          else
            kt[dd * (BK + 1) + j] = f[i];
        }
      } else {
        // 4 floats of K and of V a load, two loads of each a thread
        constexpr int NL = BK * HD / 4 / THREADS;
        float4 kr[NL], vr[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int e = t + i * THREADS, j = e / (HD / 4), d4 = e % (HD / 4);
          kr[i] = vr[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (j0 + j < n_live) {
            const size_t row = ((size_t)b * T + j0 + j) * KV + h;
            kr[i] = __ldcg(reinterpret_cast<const float4*>(
                static_cast<const float*>(p.kc) + row * HD) + d4);
            vr[i] = __ldcg(reinterpret_cast<const float4*>(
                static_cast<const float*>(p.vc) + row * HD) + d4);
          }
        }
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int e = t + i * THREADS, j = e / (HD / 4), dd = 4 * (e % (HD / 4));
          kt[(dd + 0) * (BK + 1) + j] = kr[i].x;
          kt[(dd + 1) * (BK + 1) + j] = kr[i].y;
          kt[(dd + 2) * (BK + 1) + j] = kr[i].z;
          kt[(dd + 3) * (BK + 1) + j] = kr[i].w;
          *reinterpret_cast<float4*>(vsm + j * HD + dd) = vr[i];
        }
      }
      __syncthreads();
      for (int e = t; e < G * BK; e += THREADS) {
        const int r = e / BK, j = e % BK;
        float s = 0.0f;
#pragma unroll 16
        for (int dd = 0; dd < HD; ++dd)
          s = fmaf(qs[r * HD + dd], kt[dd * (BK + 1) + j], s);
        ps[r * BK + j] = j0 + j < n_live ? __fmul_rn(s, p.attn_scale)
                                         : rt::NEG_INF;
      }
      __syncthreads();
      for (int r = warp; r < G; r += WARPS) {
        float mx = ps[r * BK + lane];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float pj = expf(ps[r * BK + lane] - m_new);
        ps[r * BK + lane] = pj;
        float sum = pj;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[r] = l_s[r] * alpha + sum;
          a_s[r] = alpha;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < NOUT; ++u) {
        const int e = t + u * THREADS, r = e / HD, dd = e % HD;
        if (r < G) {
          float pv = 0.0f;
#pragma unroll 8
          for (int j = 0; j < BK; ++j)
            pv = fmaf(ps[r * BK + j], vsm[j * HD + dd], pv);
          acc[u] = acc[u] * a_s[r] + pv;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NOUT; ++u) {
      const int e = t + u * THREADS;
      if (e / HD < G) po[(size_t)g * GMAX * HD + e] = acc[u];
    }
    if (t < G) {
      pml[(size_t)g * 2 * GMAX + t] = m_s[t];
      pml[(size_t)g * 2 * GMAX + GMAX + t] = l_s[t];
    }
  }
  if (!rt::arrive_last(counter, n_as, flag)) return;
  // merge the ranges that hold live keys, in range order, RB ranges' loads
  // issued at a time
  constexpr int RB = 8;
  const int ns = (live_t + tps - 1) / tps;
  for (int e = t; e < G * HD; e += THREADS) {
    const int r = e / HD;
    float mx = rt::NEG_INF;
    for (int s0 = 0; s0 < ns; s0 += RB) {
      float mv[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u)
        mv[u] = s0 + u < ns ? __ldcg(pml + (size_t)(s0 + u) * 2 * GMAX + r)
                            : rt::NEG_INF;
#pragma unroll
      for (int u = 0; u < RB; ++u) mx = fmaxf(mx, mv[u]);
    }
    float l = 0.0f, o = 0.0f;
    for (int s0 = 0; s0 < ns; s0 += RB) {
      float mv[RB], lv[RB], ov[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const size_t s = s0 + u;
        mv[u] = lv[u] = ov[u] = 0.0f;
        if (s0 + u < ns) {
          mv[u] = __ldcg(pml + s * 2 * GMAX + r);
          lv[u] = __ldcg(pml + s * 2 * GMAX + GMAX + r);
          ov[u] = __ldcg(po + s * GMAX * HD + e);
        }
      }
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        if (s0 + u < ns) {
          const float w = expf(mv[u] - mx);
          l += w * lv[u];
          o += w * ov[u];
        }
      }
    }
    p.attn[((size_t)b * p.H + h * G) * HD + e] = o / fmaxf(l, 1e-30f);
  }
}

// ------------------------------------------------------------ the layer

template <bool SIM>
constexpr size_t smem_bytes() {
  return ACC_BYTES + work_bytes<SIM>();
}

// The most work items of a stage: the grid needs no more blocks.
int most_items(const Params& p) {
  auto splits = [&](int k, int i) {
    return rt::Splits::make(k, p.klen[i]).n_split;
  };
  return std::max({(p.H + 2 * p.KV) * splits(p.d, 0),
                   p.d / SPAN * splits(p.H * HD, 1),
                   2 * (p.F / SPAN) * splits(p.d, 2),
                   p.d / SPAN * splits(p.F, 3),
                   p.B * p.KV * ((p.T + BK - 1) / BK)});
}

template <bool SIM, typename KVT>
__global__ void __launch_bounds__(THREADS, 2)
fused_layer_kernel(const Params p) {
  constexpr bool INT8 = sizeof(KVT) == 1;
  using AT = typename std::conditional<SIM, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rinv[BMAX];
  __shared__ double red[WARPS];
  __shared__ int last_s;
  float* acc_a = reinterpret_cast<float*>(smem);
  float* acc_b = acc_a + BMAX * SPAN;
  unsigned char* work = smem + ACC_BYTES;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int B = p.B, d = p.d, H = p.H, KV = p.KV, F = p.F, T = p.T;
  const int HQ = H * HD, P = B * SPAN;
  // each stage rebuilds its split geometry and counter offsets from p (the
  // kernel's constant parameters) rather than keeping them in registers
  const int u_qkv = H + 2 * KV, u_o = d / SPAN, u_mlp = F / SPAN;
  float xs_qkv = 0.0f, xs_o = 0.0f, xs_mlp = 0.0f, xs_down = 0.0f;
  FL_STAMP(0);

  // ---- stage 1: rmsnorm1, q/k/v per head, bias, rope, cache write
  {
    const rt::Splits sp = rt::Splits::make(d, p.klen[0]);
    const int ns = sp.n_split, items = u_qkv * ns;
    if ((int)blockIdx.x < items) {
      row_rinv(p.x, false, B, d, p.eps, rinv);
      const NormSrc src{p.x, p.g1, rinv, d, false};
      if (SIM) xs_qkv = act_scale(src, B, d, p.clip_k, p.qmax[0], red);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int u = it / ns, j = it % ns;
        const int idx = u < H ? 0 : (u < H + KV ? 1 : 2);
        const int head = u < H ? u : (u < H + KV ? u - H : u - H - KV);
        const int N = idx == 0 ? HQ : KV * HD;
        void* part_u = static_cast<AT*>(p.part) + (size_t)u * ns * P;
        float* nz_u = p.nz + (size_t)u * sp.tiles * P;
        if (!project_split<SIM>(p, idx, src, d, N, head * HD, xs_qkv,
                                p.klen[0], j, part_u, nz_u, p.counters + u, ns,
                                work, &last_s))
          continue;
        project_merge<SIM>(p, idx, d, p.klen[0], head * HD, xs_qkv, part_u,
                           nz_u, acc_a, work);
        if (idx < 2) {           // rope at the query position lens[b]
          for (int e = t; e < B * (HD / 2); e += THREADS) {
            const int r = e / (HD / 2), j2 = e % (HD / 2);
            const float ang = __fmul_rn((float)p.lens[r], p.freqs[j2]);
            const float c = cosf(ang), s = sinf(ang);
            const float x1 = acc_a[r * HD + j2], x2 = acc_a[r * HD + j2 + HD / 2];
            acc_a[r * HD + j2] = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
            acc_a[r * HD + j2 + HD / 2] =
                __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
          }
          __syncthreads();
        }
        if (idx == 0) {
          for (int e = t; e < B * HD; e += THREADS)
            p.q[(size_t)(e / HD) * HQ + head * HD + e % HD] = acc_a[e];
        } else if (warp < B) {   // one warp per row writes the cache row
          const int r = warp;
          const int pos = min(p.lens[r], T - 1);
          const size_t row = ((size_t)r * T + pos) * KV + head;
          KVT* dst = static_cast<KVT*>(idx == 1 ? p.kc : p.vc) + row * HD;
          const float v0 = acc_a[r * HD + lane], v1 = acc_a[r * HD + lane + 32];
          if constexpr (INT8) {
            float mx = fmaxf(fabsf(v0), fabsf(v1));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float sc = fmaxf(__fdiv_rn(mx, 127.0f), 1e-8f);
            dst[lane] = (KVT)fminf(fmaxf(rintf(__fdiv_rn(v0, sc)), -127.0f), 127.0f);
            dst[lane + 32] = (KVT)fminf(fmaxf(rintf(__fdiv_rn(v1, sc)), -127.0f), 127.0f);
            if (lane == 0) (idx == 1 ? p.ksc : p.vsc)[row] = sc;
          } else {
            dst[lane] = (KVT)v0;
            dst[lane + 32] = (KVT)v1;
          }
        }
      }
    }
  }
  FL_STAMP(1);
  grid.sync();
  FL_STAMP(2);

  // ---- stage 2: attention, key ranges split over the grid
  {
    const int n_t = (T + BK - 1) / BK;
    const int n_as = min(n_t, max(1, (int)gridDim.x / (B * KV)));
    for (int it = blockIdx.x; it < B * KV * n_as; it += gridDim.x) {
      const int unit = it / n_as, g = it % n_as;
      attend_split<KVT>(p, unit / KV, unit % KV, g, n_as, n_t,
                        p.counters + u_qkv + unit, work, &last_s);
    }
  }
  FL_STAMP(3);
  grid.sync();
  FL_STAMP(4);

  // ---- stage 3: O + residual
  {
    const rt::Splits sp = rt::Splits::make(HQ, p.klen[1]);
    const int ns = sp.n_split, items = u_o * ns;
    if ((int)blockIdx.x < items) {
      const BufSrc src{p.attn, HQ};
      if (SIM) xs_o = act_scale(src, B, HQ, p.clip_k, p.qmax[3], red);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int u = it / ns, j = it % ns;
        void* part_u = static_cast<AT*>(p.part) + (size_t)u * ns * P;
        float* nz_u = p.nz + (size_t)u * sp.tiles * P;
        if (!project_split<SIM>(p, 3, src, HQ, d, u * SPAN, xs_o, p.klen[1],
                                j, part_u, nz_u,
                                p.counters + u_qkv + B * KV + u, ns, work,
                                &last_s))
          continue;
        project_merge<SIM>(p, 3, HQ, p.klen[1], u * SPAN, xs_o, part_u, nz_u,
                           acc_a, work);
        for (int e = t; e < P; e += THREADS) {
          const size_t o = (size_t)(e / SPAN) * d + u * SPAN + e % SPAN;
          p.x1[o] = __fadd_rn(p.x[o], acc_a[e]);
        }
      }
    }
  }
  FL_STAMP(5);
  grid.sync();
  FL_STAMP(6);

  // ---- stage 4: rmsnorm2, gate and up, silu(g) * u, hm's sums of squares
  {
    const rt::Splits sp = rt::Splits::make(d, p.klen[2]);
    const int ns = sp.n_split, items = 2 * u_mlp * ns;
    if ((int)blockIdx.x < items) {
      row_rinv(p.x1, true, B, d, p.eps, rinv);
      const NormSrc src{p.x1, p.g2, rinv, d, true};
      if (SIM) xs_mlp = act_scale(src, B, d, p.clip_k, p.qmax[4], red);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int u = it / (2 * ns), pl = it / ns % 2, j = it % ns;
        void* part_u = static_cast<AT*>(p.part) + (size_t)u * 2 * ns * P;
        float* nz_u = p.nz + (size_t)u * 2 * sp.tiles * P;
        if (!project_split<SIM>(
                p, 4 + pl, src, d, F, u * SPAN, xs_mlp, p.klen[2], j,
                static_cast<AT*>(part_u) + (size_t)pl * ns * P,
                nz_u + (size_t)pl * sp.tiles * P,
                p.counters + u_qkv + B * KV + u_o + u, 2 * ns,
                work, &last_s))
          continue;
        project_merge<SIM>(p, 4, d, p.klen[2], u * SPAN, xs_mlp, part_u, nz_u,
                           acc_a, work);
        project_merge<SIM>(p, 5, d, p.klen[2], u * SPAN, xs_mlp,
                           static_cast<AT*>(part_u) + (size_t)ns * P,
                           nz_u + (size_t)sp.tiles * P, acc_b, work);
        double s = 0.0;
        for (int e = t; e < P; e += THREADS) {
          const float g = acc_a[e];
          const float silu = __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
          const float hv = __fmul_rn(silu, acc_b[e]);
          p.hm[(size_t)(e / SPAN) * F + u * SPAN + e % SPAN] = hv;
          s += (double)hv * (double)hv;
        }
        s = block_sum(s, red);
        if (t == 0) p.ssq[u] = s;
      }
    }
  }
  FL_STAMP(7);
  grid.sync();
  FL_STAMP(8);

  // ---- stage 5: down + residual, advance the lengths
  {
    const rt::Splits sp = rt::Splits::make(F, p.klen[3]);
    const int ns = sp.n_split, items = u_o * ns;
    if ((int)blockIdx.x < items) {
      const BufSrc src{p.hm, F};
      if (SIM) {
        double s = 0.0;                  // stage 4's unit sums, fixed order
        for (int u = t; u < u_mlp; u += THREADS) s += __ldcg(p.ssq + u);
        xs_down = scale_of(block_sum(s, red), B * F, p.clip_k, p.qmax[6]);
      }
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int u = it / ns, j = it % ns;
        void* part_u = static_cast<AT*>(p.part) + (size_t)u * ns * P;
        float* nz_u = p.nz + (size_t)u * sp.tiles * P;
        if (!project_split<SIM>(p, 6, src, F, d, u * SPAN, xs_down,
                                p.klen[3], j, part_u, nz_u,
                                p.counters + u_qkv + B * KV + u_o + u_mlp + u,
                                ns,
                                work, &last_s))
          continue;
        project_merge<SIM>(p, 6, F, p.klen[3], u * SPAN, xs_down, part_u,
                           nz_u, acc_a, work);
        for (int e = t; e < P; e += THREADS) {
          const size_t o = (size_t)(e / SPAN) * d + u * SPAN + e % SPAN;
          p.out[o] = __fadd_rn(__ldcg(p.x1 + o), acc_a[e]);
        }
      }
    }
    if (blockIdx.x == 0) {
      // nothing reads lens after the fourth barrier
      if (t < B) p.lens[t] += 1;
      if (t == 0) {
        const float s7[7] = {xs_qkv, xs_qkv, xs_qkv, xs_o, xs_mlp, xs_mlp, xs_down};
        for (int i = 0; i < 7; ++i) p.scales[i] = s7[i];
      }
    }
  }
  FL_STAMP(9);
}

template <bool SIM, typename KVT>
int launch(Params* p, cudaStream_t s) {
  auto kern = fused_layer_kernel<SIM, KVT>;
  constexpr size_t smem = smem_bytes<SIM>();
  static int max_blocks = -1;          // co-resident blocks of this variant
  if (max_blocks < 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    max_blocks = per_sm * sms;
  }
  for (int i = 0; i < 4; ++i)
    if (p->klen[i] <= 0 || p->klen[i] % 16 || p->klen[i] > KLEN_MAX)
      return (int)cudaErrorInvalidValue;
  const int grid = std::min(most_items(*p), max_blocks);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  p->grid = grid;
  Params arg = *p;
  void* args[] = {&arg};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(grid), dim3(THREADS), args,
      smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef FUSED_LAYER_CLOCK
extern "C" int fused_layer_clock_set(void* p) {
  return (int)cudaMemcpyToSymbol(fl_clock_p, &p, sizeof(p));
}
#endif

// One layer's decode step; p is a host struct (see Params), p->grid is set
// to the blocks launched. Requires B <= 8, head dim 64, H / KV <= 8,
// d % 64 == 0, F % 64 == 0, 8-byte aligned int8 planes or 16-byte aligned
// f32 weights, 16-byte aligned cache rows, klen[i] a multiple of 16 and at
// most 1024, scratch sized by kernels/fused_step.py fused_layer_plan
// (checked by the Python wrapper). Returns the launch's CUDA error code (a
// refused cooperative launch included), 0 on success.
extern "C" int fused_dense_layer(void* params, void* stream) {
  Params* p = static_cast<Params*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->sim && p->int8) return launch<true, int8_t>(p, s);
  if (p->sim) return launch<true, float>(p, s);
  if (p->int8) return launch<false, int8_t>(p, s);
  return launch<false, float>(p, s);
}
