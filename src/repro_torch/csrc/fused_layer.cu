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
// per 1024-row macro tile (__dp4a); sigma * tile_gaussian(seed, tile, row,
// col) per tile; an f32 tile sum in tile order; times xs * ws. The seven
// noise seeds are the ctx.next_key() words in the order q, k, v, o, gate,
// up, down.
//
// Bound on the H100: the weight stream. At decode B <= 8 rows, so the layer
// moves its seven int8 planes (14.9 MB at qwen2-0.5b width) and does about
// 2 * B operations per weight byte: 4.5 us per layer at 3.35 TB/s. The TPU
// kernel keeps every row resident and walks its kv grid in order on one
// core; here the work has to spread over all SMs, and every projection
// waits for the previous stage across the whole grid, because its
// activation scale is a reduction over the whole (B, K) input. The design:
// one cooperative launch (grid no larger than the co-resident block
// count), five stages separated by four grid-wide barriers
// (cooperative_groups::this_grid().sync()):
//
//   1. rmsnorm1 + q/k/v (one unit = one head of 64 columns, so rope's
//      (j, j + 32) pairs and the int8 scale's max over the head stay in
//      one block) + bias + rope + the cache write at the old length;
//   2. attention, one unit per (row, KV head) with its G query heads,
//      online softmax over the live key blocks only;
//   3. O (units of 32 columns) + residual -> x1;
//   4. rmsnorm2 + gate and up of the same 32 columns + silu(g) * u -> hm;
//   5. down (32 columns, 5 macro tiles) + residual -> out; lens += 1.
//
// Every block that needs a scale computes it itself from the whole
// activation in one fixed order (f64 sums over a fixed thread mapping), so
// all blocks hold the same value on every run; there are no float atomics.
// Data written inside the launch is read with __ldcg (L2), never through
// the non-coherent read-only path. The wrapper allocates the scratch (q,
// attention output, x1, hm) and the outputs; the kernel allocates nothing.
// Rounding follows the plain version through the explicit-rounding
// intrinsics; the build never passes --use_fast_math.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BMAX = 8;          // batch rows (slots)
constexpr int TILE = 1024;       // macro rows per K tile
constexpr int HD = 64;           // head dim
constexpr int BK = 64;           // keys per attention step
constexpr int GMAX = 8;          // query heads per KV head
constexpr int NC_QKV = 64;       // columns per q/k/v unit (one head)
constexpr int NC = 32;           // columns per o/gate/up/down unit
constexpr float NEG_INF = -1e30f;
static_assert(BMAX <= WARPS, "one warp per row in the row norms");

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
  unsigned int seed0[7];
  unsigned int seed1[7];
  float sigma[7];
  int qmax[7];
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
  __device__ float operator()(int b, int k) const {
    const float* p = x + (size_t)b * K + k;
    const float v = coherent ? __ldcg(p) : *p;
    return __fmul_rn(__fmul_rn(v, rinv[b]), g[k]);
  }
};

struct BufSrc {            // a scratch activation written in this launch
  const float* x;
  int K;
  __device__ float operator()(int b, int k) const {
    return __ldcg(x + (size_t)b * K + k);
  }
};

// ------------------------------------------------------------ reductions

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rinv[b] = 1 / sqrt(mean_k x[b, k]^2 + eps), one warp per row.
__device__ void row_rinv(const float* x, bool coherent, int B, int d,
                         float eps, float* rinv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < B) {
    double s = 0.0;
    for (int k = lane; k < d; k += 32) {
      const float* p = x + (size_t)warp * d + k;
      const float v = coherent ? __ldcg(p) : *p;
      s += (double)v * (double)v;
    }
    s = warp_sum(s);
    if (lane == 0) {
      const float m = (float)(s / (double)d);
      rinv[warp] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(m, eps)));
    }
  }
  __syncthreads();
}

// The batch-global activation scale of layers._act_scale over all B * K
// elements of src, in one fixed order (the same in every block).
template <class Src>
__device__ float act_scale(const Src& src, int B, int K, float clip_k,
                           int qmax, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double s = 0.0;
  for (int i = threadIdx.x; i < B * K; i += THREADS) {
    const float v = src(i / K, i % K);
    s += (double)v * (double)v;
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  double tot = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) tot += red[w];
  __syncthreads();
  const float mean = (float)(tot / (double)(B * K));
  const float rms = __fadd_rn(__fsqrt_rn(mean), 1e-8f);
  return __fdiv_rn(__fmul_rn(clip_k, rms), (float)qmax);
}

// ------------------------------------------------------------ projection
// acc[b * NCOL + c] = projection idx of src at columns n0 .. n0 + NCOL - 1
// for every row b < B (bias included for q/k/v). sim: the CIM contract of
// cim_matmul.cu; off: an f32 dot. work: shared memory for the staged
// activation tile and the cross-warp partial sums.
template <bool SIM, int NCOL, class Src>
__device__ void project(const Params& p, int idx, const Src& src, int K,
                        int N, int n0, float xs, float* acc,
                        unsigned char* work) {
  using AT = typename std::conditional<SIM, int, float>::type;
  using XT = typename std::conditional<SIM, int8_t, float>::type;
  constexpr int CG = NCOL / 4;           // column groups of 4
  constexpr int KSL = THREADS / CG;      // k-slices, 4 rows each
  constexpr int KSTEP = KSL * 4;
  XT* xt = reinterpret_cast<XT*>(work);                           // [BMAX][TILE]
  AT* red = reinterpret_cast<AT*>(work + sizeof(XT) * BMAX * TILE);  // [WARPS][BMAX][NCOL]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cgi = t % CG, ks = t / CG;
  const int col = n0 + cgi * 4;
  const int B = p.B;
  const float fq = (float)p.qmax[idx];
  const float sigma = p.sigma[idx];
  const bool noise = SIM && sigma > 0.0f;
  __syncthreads();                         // acc free again
  for (int e = t; e < B * NCOL; e += THREADS) acc[e] = 0.0f;
  const int n_tiles = (K + TILE - 1) / TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kb = tile * TILE;
    const int len = min(TILE, K - kb);
    __syncthreads();                       // xt / red free again
    for (int i = t; i < B * TILE; i += THREADS) {
      const int r = i / TILE, k = i % TILE;
      const float v = k < len ? src(r, kb + k) : 0.0f;
      if constexpr (SIM)
        xt[i] = (XT)fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -fq), fq);
      else
        xt[i] = (XT)v;
    }
    __syncthreads();
    AT part[BMAX][4];
#pragma unroll
    for (int r = 0; r < BMAX; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0;
    for (int k = ks * 4; k < len; k += KSTEP) {
      if constexpr (SIM) {
        const int8_t* wp = static_cast<const int8_t*>(p.w[idx]) +
                           (size_t)(kb + k) * N + col;
        const uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(wp));
        const uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(wp + N));
        const uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(wp + 2 * (size_t)N));
        const uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(wp + 3 * (size_t)N));
        const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
        const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
        const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
        const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
        const int wc[4] = {(int)__byte_perm(t0, t1, 0x5410),
                           (int)__byte_perm(t0, t1, 0x7632),
                           (int)__byte_perm(t2, t3, 0x5410),
                           (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int r = 0; r < BMAX; ++r) {
          if (r < B) {
            const int xw = *reinterpret_cast<const int*>(
                reinterpret_cast<const int8_t*>(xt) + r * TILE + k);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part[r][c] = (AT)__dp4a(xw, wc[c], (int)part[r][c]);
          }
        }
      } else {
        const float* wp = static_cast<const float*>(p.w[idx]) +
                          (size_t)(kb + k) * N + col;
        float4 wr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wr[i] = __ldg(reinterpret_cast<const float4*>(wp + i * (size_t)N));
#pragma unroll
        for (int r = 0; r < BMAX; ++r) {
          if (r < B) {
            const float* xr = reinterpret_cast<const float*>(xt) + r * TILE + k;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xv = xr[i];
              part[r][0] = fmaf(xv, wr[i].x, (float)part[r][0]);
              part[r][1] = fmaf(xv, wr[i].y, (float)part[r][1]);
              part[r][2] = fmaf(xv, wr[i].z, (float)part[r][2]);
              part[r][3] = fmaf(xv, wr[i].w, (float)part[r][3]);
            }
          }
        }
      }
    }
    // lanes of one column group hold different k-slices: fold them, then
    // the warps (integers in sim mode: exact in any order)
#pragma unroll
    for (int r = 0; r < BMAX; ++r) {
      if (r < B) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          AT v = part[r][c];
#pragma unroll
          for (int o = CG; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane < CG) red[(warp * BMAX + r) * NCOL + cgi * 4 + c] = v;
        }
      }
    }
    __syncthreads();
    for (int e = t; e < B * NCOL; e += THREADS) {
      const int r = e / NCOL, c = e % NCOL;
      AT s = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * BMAX + r) * NCOL + c];
      float sf = SIM ? __int2float_rn((int)s) : (float)s;
      if (noise)
        sf = __fadd_rn(sf, __fmul_rn(sigma, rt::tile_gaussian(
                 p.seed0[idx], p.seed1[idx], (uint32_t)tile, (uint32_t)r,
                 (uint32_t)(n0 + c))));
      acc[e] = __fadd_rn(acc[e], sf);
    }
  }
  const float out_scale = SIM ? __fmul_rn(xs, *p.ws[idx]) : 1.0f;
  const float* bias = idx < 3 ? p.bias[idx] : nullptr;
  for (int e = t; e < B * NCOL; e += THREADS) {
    float y = SIM ? __fmul_rn(acc[e], out_scale) : acc[e];
    if (bias != nullptr) y = __fadd_rn(y, bias[n0 + e % NCOL]);
    acc[e] = y;
  }
  __syncthreads();
}

// ------------------------------------------------------------ attention
// One (row b, KV head h) unit: the G query heads of the group against keys
// 0 .. n_live - 1 of the cache, online softmax in key blocks of BK.
template <typename KVT>
__device__ void attend(const Params& p, int b, int h, unsigned char* work) {
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
  const int G = p.H / p.KV, T = p.T, KV = p.KV;
  const int n_live = min(p.lens[b] + 1, T);
  const KVT* kc = static_cast<const KVT*>(p.kc);
  const KVT* vc = static_cast<const KVT*>(p.vc);
  __syncthreads();                                    // work free again
  for (int e = t; e < GMAX * HD; e += THREADS) {
    const int r = e / HD, dd = e % HD;
    qs[e] = r < G ? __ldcg(p.q + ((size_t)b * p.H + h * G + r) * HD + dd)
                  : 0.0f;
  }
  for (int r = t; r < GMAX; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }
  float acc[NOUT];
#pragma unroll
  for (int u = 0; u < NOUT; ++u) acc[u] = 0.0f;
  for (int j0 = 0; j0 < n_live; j0 += BK) {
    __syncthreads();                                  // previous block consumed
    for (int e = t; e < BK * HD; e += THREADS) {
      const int j = e / HD, dd = e % HD;
      float kf = 0.0f, vf = 0.0f;
      if (j0 + j < n_live) {
        const size_t row = ((size_t)b * T + j0 + j) * KV + h;
        if constexpr (INT8) {
          kf = __fmul_rn((float)__ldcg(reinterpret_cast<const signed char*>(kc) + row * HD + dd),
                         __ldcg(p.ksc + row));
          vf = __fmul_rn((float)__ldcg(reinterpret_cast<const signed char*>(vc) + row * HD + dd),
                         __ldcg(p.vsc + row));
        } else {
          kf = __ldcg(reinterpret_cast<const float*>(kc) + row * HD + dd);
          vf = __ldcg(reinterpret_cast<const float*>(vc) + row * HD + dd);
        }
      }
      kt[dd * (BK + 1) + j] = kf;
      vsm[j * HD + dd] = vf;
    }
    __syncthreads();
    for (int e = t; e < G * BK; e += THREADS) {
      const int r = e / BK, j = e % BK;
      float s = 0.0f;
#pragma unroll 16
      for (int dd = 0; dd < HD; ++dd)
        s = fmaf(qs[r * HD + dd], kt[dd * (BK + 1) + j], s);
      ps[r * BK + j] = j0 + j < n_live ? __fmul_rn(s, p.attn_scale) : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < G; r += WARPS) {
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ps[r * BK + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float pj = expf(ps[r * BK + j] - m_new);
        sum += pj;
        ps[r * BK + j] = pj;
      }
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
        for (int j = 0; j < BK; ++j) pv = fmaf(ps[r * BK + j], vsm[j * HD + dd], pv);
        acc[u] = acc[u] * a_s[r] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NOUT; ++u) {
    const int e = t + u * THREADS, r = e / HD, dd = e % HD;
    if (r < G)
      p.attn[((size_t)b * p.H + h * G + r) * HD + dd] =
          acc[u] / fmaxf(l_s[r], 1e-30f);
  }
}

// ------------------------------------------------------------ the layer

template <bool SIM>
constexpr size_t proj_bytes() {
  return (SIM ? 1 : 4) * BMAX * TILE + 4 * WARPS * BMAX * NC_QKV;
}
constexpr size_t attn_bytes() {
  return 4 * (GMAX * HD + HD * (BK + 1) + BK * HD + GMAX * BK + 3 * GMAX);
}
constexpr size_t ACC_BYTES = 4 * 2 * BMAX * NC_QKV;   // two result tiles
template <bool SIM>
constexpr size_t smem_bytes() {
  return ACC_BYTES + (proj_bytes<SIM>() > attn_bytes() ? proj_bytes<SIM>()
                                                       : attn_bytes());
}

template <bool SIM, typename KVT>
__global__ void __launch_bounds__(THREADS) fused_layer_kernel(const Params p) {
  constexpr bool INT8 = sizeof(KVT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rinv[BMAX];
  __shared__ double red[WARPS];
  float* acc_a = reinterpret_cast<float*>(smem);
  float* acc_b = acc_a + BMAX * NC_QKV;
  unsigned char* work = smem + ACC_BYTES;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int B = p.B, d = p.d, H = p.H, KV = p.KV, F = p.F, T = p.T;
  const int HQ = H * HD;
  float xs_qkv = 0.0f, xs_o = 0.0f, xs_mlp = 0.0f, xs_down = 0.0f;

  // ---- stage 1: rmsnorm1, q/k/v per head, bias, rope, cache write
  {
    const int units = H + 2 * KV;
    if ((int)blockIdx.x < units) {
      row_rinv(p.x, false, B, d, p.eps, rinv);
      const NormSrc src{p.x, p.g1, rinv, d, false};
      if (SIM) xs_qkv = act_scale(src, B, d, p.clip_k, p.qmax[0], red);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int idx = u < H ? 0 : (u < H + KV ? 1 : 2);
        const int head = u < H ? u : (u < H + KV ? u - H : u - H - KV);
        const int N = idx == 0 ? HQ : KV * HD;
        project<SIM, NC_QKV>(p, idx, src, d, N, head * HD, xs_qkv, acc_a, work);
        if (idx < 2) {           // rope at the query position lens[b]
          for (int e = t; e < B * (HD / 2); e += THREADS) {
            const int r = e / (HD / 2), j = e % (HD / 2);
            const float ang = __fmul_rn((float)p.lens[r], p.freqs[j]);
            const float c = cosf(ang), s = sinf(ang);
            const float x1 = acc_a[r * HD + j], x2 = acc_a[r * HD + j + HD / 2];
            acc_a[r * HD + j] = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
            acc_a[r * HD + j + HD / 2] = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
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
        __syncthreads();
      }
    }
  }
  grid.sync();

  // ---- stage 2: attention
  for (int u = blockIdx.x; u < B * KV; u += gridDim.x)
    attend<KVT>(p, u / KV, u % KV, work);
  grid.sync();

  // ---- stage 3: O + residual
  {
    const int units = d / NC;
    if ((int)blockIdx.x < units) {
      const BufSrc src{p.attn, HQ};
      if (SIM) xs_o = act_scale(src, B, HQ, p.clip_k, p.qmax[3], red);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        project<SIM, NC>(p, 3, src, HQ, d, u * NC, xs_o, acc_a, work);
        for (int e = t; e < B * NC; e += THREADS) {
          const size_t o = (size_t)(e / NC) * d + u * NC + e % NC;
          p.x1[o] = __fadd_rn(p.x[o], acc_a[e]);
        }
      }
    }
  }
  grid.sync();

  // ---- stage 4: rmsnorm2, gate and up, silu(g) * u
  {
    const int units = F / NC;
    if ((int)blockIdx.x < units) {
      row_rinv(p.x1, true, B, d, p.eps, rinv);
      const NormSrc src{p.x1, p.g2, rinv, d, true};
      if (SIM) xs_mlp = act_scale(src, B, d, p.clip_k, p.qmax[4], red);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        project<SIM, NC>(p, 4, src, d, F, u * NC, xs_mlp, acc_a, work);
        project<SIM, NC>(p, 5, src, d, F, u * NC, xs_mlp, acc_b, work);
        for (int e = t; e < B * NC; e += THREADS) {
          const float g = acc_a[e];
          const float silu = __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
          p.hm[(size_t)(e / NC) * F + u * NC + e % NC] = __fmul_rn(silu, acc_b[e]);
        }
      }
    }
  }
  grid.sync();

  // ---- stage 5: down + residual, advance the lengths
  {
    const int units = d / NC;
    if ((int)blockIdx.x < units) {
      const BufSrc src{p.hm, F};
      if (SIM) xs_down = act_scale(src, B, F, p.clip_k, p.qmax[6], red);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        project<SIM, NC>(p, 6, src, F, d, u * NC, xs_down, acc_a, work);
        for (int e = t; e < B * NC; e += THREADS) {
          const size_t o = (size_t)(e / NC) * d + u * NC + e % NC;
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
  const int units = std::max(std::max(p->H + 2 * p->KV, p->B * p->KV),
                             std::max(p->d / NC, p->F / NC));
  const int grid = std::min(units, max_blocks);
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

// One layer's decode step; p is a host struct (see Params), p->grid is set
// to the blocks launched. Requires B <= 8, head dim 64, H / KV <= 8,
// d % 32 == 0, F % 32 == 0, 4-byte aligned int8 planes or 16-byte aligned
// f32 weights (checked by the Python wrapper). Returns the launch's CUDA
// error code (a refused cooperative launch included), 0 on success.
extern "C" int fused_dense_layer(void* params, void* stream) {
  Params* p = static_cast<Params*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->sim && p->int8) return launch<true, int8_t>(p, s);
  if (p->sim) return launch<true, float>(p, s);
  if (p->int8) return launch<false, int8_t>(p, s);
  return launch<false, float>(p, s);
}
