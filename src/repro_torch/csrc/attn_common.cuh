// The CUDA-core block body of the f32-query GQA flash prefill
// (flash_gqa.cu), and NEG_INF, the masked score of every attention kernel.
//
// One block serves one (batch row b, KV head h, query block qb): its
// R = BQ * G query rows (row r = query position qb*BQ + r / G, grouped head
// h*G + r % G) against the f32 or int8 slot cache, streamed in storage
// layout (B, T, KV, D) - no head replication, int8 dequantized on load with
// the per-key (B, T, KV) scales. Key j counts iff j < kv_end and
// j <= start + i for the query at absolute position start + i; the caller
// gives kv_end = min(T, start + S) (the _cached_mask contract: recycled
// slots keep stale keys past the written prefix). Key blocks past the
// causal frontier of the query block are never read. Online softmax over
// the visited blocks, in order from block 0 (which holds key 0, live in
// every row, so a masked score of -1e30 always meets a finite running
// max): running max m, denominator l and accumulator acc, updated as
// l = l * alpha + sum(p), acc = acc * alpha + p @ V, all in f32.
#pragma once

#include "common.cuh"

namespace rt {

constexpr float NEG_INF = -1e30f;

template <typename KVT, int RMAX, int BK, int D, int THREADS>
__device__ __forceinline__ void gqa_attend(
    const float* __restrict__ q, const KVT* __restrict__ k,
    const KVT* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, float* __restrict__ out,
    int* __restrict__ counts, int b, int h, int qb, int n_q, int BQ, int G,
    int S, int T, int H, int KV, int start, int kv_end, float scale) {
  constexpr bool INT8 = sizeof(KVT) == 1;
  constexpr int NOUT = RMAX * D / THREADS;      // outputs per thread
  static_assert(RMAX * D % THREADS == 0, "outputs split evenly");
  static_assert(THREADS % D == 0, "a warp shares one output row");

  __shared__ float qs[RMAX][D];
  __shared__ float kt[D][BK + 1];              // transposed, padded
  __shared__ float vsm[BK][D];
  __shared__ float ps[RMAX][BK];
  __shared__ float m_s[RMAX], l_s[RMAX], a_s[RMAX];

  const int t = threadIdx.x;
  const int R = BQ * G;
  const int i0 = qb * BQ;
  // rows whose query position lies past S are padding: never computed
  const int rows = min(R, (S - i0) * G);
  const int q_abs_max = start + min(i0 + BQ, S) - 1;
  const int j_end = min(q_abs_max + 1, kv_end);

  for (int e = t; e < RMAX * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float val = 0.0f;
    if (r < rows) {
      const int i = i0 + r / G, head = h * G + r % G;
      val = to_float(q[(((size_t)b * S + i) * H + head) * D + d]);
    }
    qs[r][d] = val;
  }
  for (int r = t; r < RMAX; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }
  float acc[NOUT];
#pragma unroll
  for (int u = 0; u < NOUT; ++u) acc[u] = 0.0f;

  int visited = 0;
  for (int j0 = 0; j0 < j_end; j0 += BK) {
    ++visited;
    __syncthreads();                           // previous block consumed
    for (int e = t; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D;
      float kf = 0.0f, vf = 0.0f;
      if (j0 + j < T) {
        const size_t off = (((size_t)b * T + j0 + j) * KV + h) * D + d;
        kf = to_float(k[off]);
        vf = to_float(v[off]);
        if (INT8) {
          const size_t so = ((size_t)b * T + j0 + j) * KV + h;
          kf = __fmul_rn(kf, ks[so]);
          vf = __fmul_rn(vf, vs[so]);
        }
      }
      kt[d][j] = kf;
      vsm[j][d] = vf;
    }
    __syncthreads();
    // scores (rows x BK), masked
    for (int e = t; e < rows * BK; e += THREADS) {
      const int r = e / BK, j = e % BK;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], kt[d][j], s);
      s = __fmul_rn(s, scale);
      const int kj = j0 + j, pos = start + i0 + r / G;
      ps[r][j] = (kj <= pos && kj < kv_end) ? s : NEG_INF;
    }
    __syncthreads();
    // online softmax, one warp per row
    const int lane = t & 31, warp = t >> 5;
    for (int r = warp; r < rows; r += THREADS / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ps[r][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(ps[r][j] - m_new);
        sum += p;
        ps[r][j] = p;
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
      const int e = t + u * THREADS, r = e / D, d = e % D;
      if (r < rows) {
        float pv = 0.0f;
        for (int j = 0; j < BK; ++j) pv = fmaf(ps[r][j], vsm[j][d], pv);
        acc[u] = acc[u] * a_s[r] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NOUT; ++u) {
    const int e = t + u * THREADS, r = e / D, d = e % D;
    if (r < rows) {
      const int i = i0 + r / G, head = h * G + r % G;
      out[(((size_t)b * S + i) * H + head) * D + d] =
          acc[u] / fmaxf(l_s[r], 1e-30f);
    }
  }
  if (counts != nullptr && t == 0)
    counts[((size_t)b * KV + h) * n_q + qb] = visited;
}

}  // namespace rt
