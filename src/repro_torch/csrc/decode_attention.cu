// Length-aware GQA decode attention against the slot cache, split over the
// key axis (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// decode_attention / _kernel (pl.pallas_call at :185): one query token per
// batch row, lens[b] valid keys (the current token's key included), keys at
// or past lens[b] never read, lens[b] == 0 -> a zero output row, int8 cache
// dequantized in-kernel with its per-key f32 scales.
//
// Bound on the H100: bytes. A decode step reads the live cache rows once
// (2 * lens * D * bytes per KV head, plus the f32 scales when int8) and does
// about 4 * G * D operations per key, a few per byte - so the least time is
// the live cache bytes over 3.35 TB/s (under a microsecond at the serving
// engine's lengths).
//
// Launch floor: a 4-slot decode step meets the cost of a launch itself (a
// few microseconds from launch to the last block's exit: a one-element
// kernel queued back to back takes about 2) long before the bytes; what
// the design fights is serial latency. A row whose keys span several
// blocks adds one chain to it - the partials' write, a fence, an atomic,
// the last block's read through L2 - which costs about as much again as a
// launch whose rows fit one block (chip_smoke.py phase time). The design:
//  - the key axis is split over blocks: grid (split, KV head h, row b), each
//    block owning `split` keys (a multiple of the 16-key tile) of one
//    (b, h) and all G grouped query heads; the wrapper sizes the split so
//    that the grid holds about two blocks per SM. Blocks whose keys start
//    at or past lens[b] exit at once.
//  - the block's tiles stream with 16-byte cp.async copies into a
//    double-buffered shared tile (neighbouring threads on neighbouring
//    16-byte chunks of a key row), the next tile in flight while the
//    current one is used; keys past lens[b] are zero-filled, never read.
//  - scores: a group of D * bytes / 16 lanes holds one key row (16 bytes a
//    lane) and all G query heads' dot products, reduced by shuffles; where
//    that count does not divide a warp (head dims 96 and 112: 6, 7, 12,
//    14, 24 or 28 lanes) the group is padded to the next power of two,
//    its extra lanes adding zeros, so that groups still tile a warp; online
//    softmax per head by one warp; p @ V with one output element per thread
//    and head, f32 on the CUDA cores (a few operations per byte: no tensor
//    core needed).
//  - each block keeps its range's running max m, denominator l and
//    unnormalised accumulator; a row with one live split writes its output
//    directly. Otherwise the block writes (m, l, acc) to scratch, and the
//    last block of the (b, h) to arrive (an atomic counter) merges them
//    with exp(m_i - m) weights in f32, in the same launch: the weights
//    first, then the accumulators, each step with its loads in flight at
//    once (a merge that walked the splits one load after another cost more
//    than the rest of the launch).
// Numerics: scores are (q . k) * scale, an int8 key's scale applied after
// the dot (exact products, f32 sums). With a bf16 cache p is rounded to
// bf16 before p @ V, as the reference's p.astype(v.dtype) does, but against
// the running max of the block's own key range rather than the whole row's;
// the denominator sums the unrounded p. The plain version's tolerance
// (2^-6 of each head's row max) covers the difference.
#include "attn_mma.cuh"

namespace {

constexpr int THREADS = 128, TK = 16, GMAX = 8;
constexpr int MAX_SPLITS = 64;   // blocks a (row, KV head) at most

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
              const KVT* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ lens,
              QT* __restrict__ out, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int* __restrict__ counters, int T,
              int H, int KV, int G, int split, int n_split, float scale) {
  constexpr bool INT8 = sizeof(KVT) == 1;
  constexpr bool ROUND_P = sizeof(KVT) == 2;   // bf16 cache
  constexpr int ROWB = D * (int)sizeof(KVT);    // bytes of one key row
  constexpr int CH = ROWB / 16;                 // 16-byte chunks a key row
  constexpr int CHP = CH <= 1 ? 1 : CH <= 2 ? 2 : CH <= 4 ? 4
                      : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;   // lanes a key
  constexpr int VEC = 16 / (int)sizeof(KVT);    // values a lane
  constexpr int KPP = THREADS / CHP;            // keys a pass of the block
  constexpr int PASSES = (TK + KPP - 1) / KPP;
  constexpr int NOUT = GMAX * D / THREADS;      // outputs a thread
  static_assert(ROWB % 16 == 0 && CH <= 32, "a key row within one warp");
  static_assert(GMAX * D % THREADS == 0, "outputs split evenly");

  __shared__ __align__(16) unsigned char kbuf[2][TK * ROWB];
  __shared__ __align__(16) unsigned char vbuf[2][TK * ROWB];
  __shared__ float ksc[2][TK], vsc[2][TK];
  __shared__ __align__(16) float qs[GMAX][D];
  __shared__ float ps[GMAX][TK];
  __shared__ float m_s[GMAX], l_s[GMAX], a_s[GMAX];
  __shared__ float w_s[MAX_SPLITS * GMAX], l_s_merge[MAX_SPLITS * GMAX];
  __shared__ int last_s;

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int len = min(lens[b], T);
  QT* o = out + ((size_t)b * H + (size_t)h * G) * D;
  if (len <= 0) {                   // recycled slot: exact zeros
    if (s == 0)
      for (int e = t; e < G * D; e += THREADS) rt::store(&o[e], 0.0f);
    return;
  }
  const int j_begin = s * split;
  if (j_begin >= len) return;       // a split past the live keys
  const int j_end = min(j_begin + split, len);
  const int n_live = (len + split - 1) / split;
  const int n_t = (j_end - j_begin + TK - 1) / TK;

  auto load_tile = [&](int j0, int st) {
    for (int c = t; c < TK * CH; c += THREADS) {
      const int j = c / CH, ch = c % CH;
      const bool ok = j0 + j < j_end;
      const size_t row = ((size_t)b * T + (ok ? j0 + j : 0)) * KV + h;
      const size_t off = row * ROWB + ch * 16;
      rt::cp_async16(&kbuf[st][j * ROWB + ch * 16],
                     reinterpret_cast<const unsigned char*>(k) + off, ok);
      rt::cp_async16(&vbuf[st][j * ROWB + ch * 16],
                     reinterpret_cast<const unsigned char*>(v) + off, ok);
    }
    if constexpr (INT8) {
      if (t < TK) {
        const bool ok = j0 + t < j_end;
        const size_t row = ((size_t)b * T + (ok ? j0 + t : 0)) * KV + h;
        rt::cp_async4(&ksc[st][t], ks + row, ok);
        rt::cp_async4(&vsc[st][t], vs + row, ok);
      }
    }
    rt::cp_async_commit();
  };

  load_tile(j_begin, 0);
  for (int e = t; e < GMAX * D; e += THREADS) {
    const int g = e / D;
    qs[g][e % D] = g < G ? rt::to_float(q[((size_t)b * H + h * G) * D + e])
                         : 0.0f;
  }
  if (t < GMAX) {
    m_s[t] = rt::NEG_INF;
    l_s[t] = 0.0f;
  }
  float acc[NOUT];
#pragma unroll
  for (int u = 0; u < NOUT; ++u) acc[u] = 0.0f;

  const int lane = t & 31, warp = t >> 5;
  const int lane_in = t % CHP, grp = t / CHP;
  const bool chunk = lane_in < CH;    // a padding lane of the group adds 0
  for (int it = 0; it < n_t; ++it) {
    const int st = it & 1;
    const int j0 = j_begin + it * TK;
    if (it + 1 < n_t) {
      load_tile(j0 + TK, st ^ 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    // scores: each lane group holds one key row, 16 bytes a lane
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int j = grp + pass * KPP;
      const int jj = j < TK ? j : 0;
      const int li = CHP == CH || chunk ? lane_in : 0;
      float kf[VEC];
      rt::unpack16<KVT>(&kbuf[st][jj * ROWB + li * 16], kf);
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float4* qv = reinterpret_cast<const float4*>(&qs[g][li * VEC]);
        float sum = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qq = qv[e];
          sum = fmaf(qq.x, kf[4 * e], sum);
          sum = fmaf(qq.y, kf[4 * e + 1], sum);
          sum = fmaf(qq.z, kf[4 * e + 2], sum);
          sum = fmaf(qq.w, kf[4 * e + 3], sum);
        }
        if (CHP != CH && !chunk) sum = 0.0f;
#pragma unroll
        for (int off = CHP / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        part[g] = sum;
      }
      if (j < TK && lane_in == 0) {
        const bool live = j0 + j < j_end;
        const float ksj = INT8 ? ksc[st][j] : 1.0f;
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) ps[g][j] = live ? part[g] * ksj * scale : rt::NEG_INF;
      }
    }
    __syncthreads();
    // online softmax, one warp per query head
    for (int g = warp; g < G; g += THREADS / 32) {
      const bool live = lane < TK && j0 + lane < j_end;
      const float sc = live ? ps[g][lane] : rt::NEG_INF;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = live ? expf(sc - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < TK) ps[g][lane] = ROUND_P ? rt::bf16_round(p) : p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // p @ V: one output element (head g, dim d) a thread and u
#pragma unroll
    for (int u = 0; u < NOUT; ++u) {
      const int e = t + u * THREADS, g = e / D, d = e % D;
      if (g < G) {
        float pv = 0.0f;
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          float vf = rt::to_float(
              reinterpret_cast<const KVT*>(&vbuf[st][j * ROWB])[d]);
          if (INT8) vf = __fmul_rn(vf, vsc[st][j]);
          pv = fmaf(ps[g][j], vf, pv);
        }
        acc[u] = acc[u] * a_s[g] + pv;
      }
    }
    __syncthreads();                 // tile st consumed
  }

  if (n_live == 1) {
#pragma unroll
    for (int u = 0; u < NOUT; ++u) {
      const int e = t + u * THREADS, g = e / D;
      if (g < G) rt::store(&o[e], acc[u] / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }
  const int bh = b * KV + h;
  float* pa = part_acc + ((size_t)bh * n_split + s) * GMAX * D;
  float* pm = part_ml + ((size_t)bh * n_split + s) * GMAX * 2;
#pragma unroll
  for (int u = 0; u < NOUT; ++u) {
    const int e = t + u * THREADS;
    if (e / D < G) pa[e] = acc[u];
  }
  if (t < G) {
    pm[2 * t] = m_s[t];
    pm[2 * t + 1] = l_s[t];
  }
  if (!rt::arrive_last(&counters[bh], n_live, &last_s)) return;
  constexpr int J = (GMAX * D / 4 + THREADS - 1) / THREADS;
  float4 r[J];
  rt::merge_splits<THREADS, J, J == 1 ? 24 : 8>(
      part_ml + (size_t)bh * n_split * GMAX * 2, GMAX * 2,
      part_acc + (size_t)bh * n_split * GMAX * D, (size_t)GMAX * D, n_live,
      G, G * D / 4, D / 4, w_s, l_s_merge, r);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = 4 * (t + j * THREADS);
    if (e < G * D) {
      rt::store(&o[e], r[j].x);
      rt::store(&o[e + 1], r[j].y);
      rt::store(&o[e + 2], r[j].z);
      rt::store(&o[e + 3], r[j].w);
    }
  }
}

template <typename QT, typename KVT, int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lens, void* out, void* part_acc,
           void* part_ml, void* counters, int B, int T, int H, int KV,
           int split, int n_split, float scale, cudaStream_t s) {
  decode_kernel<QT, KVT, D><<<dim3(n_split, KV, B), THREADS, 0, s>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<QT*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(counters), T, H, KV,
      H / KV, split, n_split, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lens, void* out, void* part_acc,
             void* part_ml, void* counters, int B, int T, int H, int KV,
             int D, int split, int n_split, float scale, cudaStream_t s) {
#define LAUNCH_D(DD)                                                      \
  if (D == DD)                                                            \
    return launch<QT, KVT, DD>(q, k, v, ks, vs, lens, out, part_acc,      \
                               part_ml, counters, B, T, H, KV, split,     \
                               n_split, scale, s);
  LAUNCH_D(64)
  LAUNCH_D(96)
  LAUNCH_D(112)
  LAUNCH_D(128)
#undef LAUNCH_D
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, H, D); k, v: (B, T, KV, D); ks, vs: (B, T, KV) f32 or null;
// lens: (B,) int32 on the device; out: (B, H, D) in q's dtype.
// part_acc: (B * KV, n_split, 8, D) f32 and part_ml: (B * KV, n_split, 8,
// 2) f32 scratch; counters: (B * KV,) int32, zero before the launch and
// left zero after it. split: keys a block, a multiple of 16; n_split =
// ceil(T / split) <= 64. q_dtype: 0 f32, 1 bf16; kv_dtype: 0 f32, 1 bf16, 2 int8.
// D is 64, 96, 112 or 128, H / KV <= 8, and every row of k and v starts on
// 16 bytes (checked by the Python wrapper).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* lens, void* out, void* part_acc,
                                void* part_ml, void* counters, int B, int T,
                                int H, int KV, int D, int split, int n_split,
                                int q_dtype, int kv_dtype, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, ks, vs, lens, out, part_acc, part_ml, counters, B, T, \
             H, KV, D, split, n_split, scale, s
  if (q_dtype == 0 && kv_dtype == 0) return launch_d<float, float>(ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch_d<float, int8_t>(ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_d<__nv_bfloat16, int8_t>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
