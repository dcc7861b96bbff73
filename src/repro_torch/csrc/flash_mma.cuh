// Tensor-core flash attention body of the GQA prefill (flash_gqa.cu, bf16
// queries) and of MHA flash attention (flash_mha.cu, bf16), FlashAttention-2
// style:
//  - a block holds 64 query rows, four warps of 16 (row r = query position
//    r / G of the q block, grouped head r % G; MHA is G = 1, one head), and
//    a range of MBK-key blocks; the wrappers split the key blocks over
//    blocks where (q blocks x KV heads x rows) alone would give a grid of
//    under about two blocks per SM.
//  - key j is live iff j < kv_end and, when CAUSAL, j <= start + i for the
//    query at absolute position start + i; kv_end = min(T, start + S) when
//    CAUSAL (the written prefix of a slot cache), T when not. Causal key
//    blocks past the q block's frontier are never read; a key block below
//    every row's frontier and kv_end skips the mask.
//  - K and V tiles stream with 16-byte cp.async copies into double-buffered
//    shared tiles (an int8 tile as bytes, then widened to bf16 - int8
//    values are exact in bf16); keys at or past kv_end are zero-filled,
//    never read.
//  - S = Q K^T per warp with mma.sync m16n8k16 (bf16 in, f32 out), Q
//    fragments held in registers and K fragments from ldmatrix; masking and
//    the online softmax in registers, the scores in log2 units (scale *
//    log2(e)) so that each p is one exp2; P @ V with the score fragments
//    re-packed to bf16 as the A operand and V fragments from ldmatrix.trans.
//  - int8 cache: scores are (q . k_int) * ks_j * scale (exact products, f32
//    sums, the scale after the dot). For P @ V the value scale folds into p
//    (p'_j = p_j * vs_j in f32), and p' runs as two bf16 MMAs, hi = bf16(p')
//    and lo = bf16(p' - hi): about 16 bits of p', where the reference keeps
//    p in f32 for an int8 cache.
//  - bf16 cache: p is rounded to bf16 before P @ V, as the reference's
//    p.astype(v.dtype) does, against the running max of the block's key
//    range; the denominator sums the unrounded p.
//  - a q block whose key blocks span several blocks merges their (m, l,
//    acc) partials with exp(m_i - m) weights in f32: the last block to
//    arrive (an atomic counter) does it, in the same launch, the weights
//    first and then the accumulators, each step with its loads in flight
//    at once.
#pragma once

#include "attn_mma.cuh"

namespace {

constexpr int MWARPS = 4, MTHREADS = 32 * MWARPS, MROWS = 16 * MWARPS;
// keys a key block: on the H100 a 64-key tile measured slower for MHA
// (0.272 against 0.223 ms over its five shapes, PERF.md)
constexpr int MBK = 32;

template <int D, bool INT8>
struct MmaSmem {
  static constexpr int BK = MBK;
  static constexpr int P = D + 8;          // bf16 pitch of a row: ldmatrix
                                           // rows land on distinct banks
  static constexpr int Q = MROWS * P;      // elements; after the loop, the
                                           // merge weights (2 * 16 * 64 f32)
  static constexpr int STAGES = INT8 ? 1 : 2;   // bf16 K, V tiles
  static constexpr int TILE = BK * P;      // elements of one K or V tile
  static constexpr int RAW = INT8 ? 2 * BK * D : 0;   // int8 bytes, 2 stages
  static constexpr int bytes =
      (Q + 2 * STAGES * TILE) * 2 + 2 * RAW + (INT8 ? 4 * BK * 4 : 0);
};

// q: (B, S, H, D) bf16; k, v: (B, T, KV, D) in KVT; start_p: (B,) or null
// (every start 0); out: (B, S, H, D) bf16; counts: (B, KV, n_q), summed
// over the splits, or null. Grid (n_split, n_q, B * KV).
template <int D, typename KVT, bool CAUSAL>
__global__ void __launch_bounds__(MTHREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const KVT* __restrict__ k, const KVT* __restrict__ v,
                 const float* __restrict__ ks, const float* __restrict__ vs,
                 const int* __restrict__ start_p,
                 __nv_bfloat16* __restrict__ out, int* __restrict__ counts,
                 float* __restrict__ part_o, float* __restrict__ part_ml,
                 int* __restrict__ counters, int S, int T, int H, int KV,
                 int G, int BQ, int n_q, int kbps, int n_split, float scale) {
  constexpr bool INT8 = sizeof(KVT) == 1;
  using L = MmaSmem<D, INT8>;
  constexpr int BK = MBK;
  constexpr int P = L::P, NKT = D / 16, NDT = D / 8, NT = BK / 8;
  static_assert(BK % 16 == 0, "P @ V steps 16 keys");
  static_assert(2 * rt::FLASH_MAX_SPLITS * MROWS * 4 <= L::Q * 2,
                "the merge weights fit the Q tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kt = qs + L::Q;
  __nv_bfloat16* vt = kt + L::STAGES * L::TILE;
  unsigned char* kraw =
      reinterpret_cast<unsigned char*>(vt + L::STAGES * L::TILE);
  unsigned char* vraw = kraw + L::RAW;
  float* ksc = reinterpret_cast<float*>(vraw + L::RAW);   // [2][BK]
  float* vsc = ksc + 2 * BK;                               // [2][BK]
  __shared__ int last_s;

  const int sp = blockIdx.x, qb = blockIdx.y;
  const int h = blockIdx.z % KV, b = blockIdx.z / KV;
  const int start = start_p != nullptr ? start_p[b] : 0;
  const int i0 = qb * BQ;
  const int npos = min(BQ, S - i0);
  const int rows = npos * G;                   // live rows of this block
  const int kv_end = CAUSAL ? min(T, start + S) : T;
  // key blocks up to the causal frontier of the q block
  const int nkb = ((CAUSAL ? min(start + i0 + npos, kv_end) : kv_end) + BK -
                   1) / BK;
  const int kb0 = sp * kbps;
  if (kb0 >= nkb) return;                      // past the frontier
  const int n_t = min(kb0 + kbps, nkb) - kb0;
  const int n_live = (nkb + kbps - 1) / kbps;

  const int t = threadIdx.x, lane = t & 31, wr = (t >> 5) * 16;
  for (int c = t; c < MROWS * (D / 8); c += MTHREADS) {
    const int r = c / (D / 8), ch = c % (D / 8);
    const bool ok = r < rows;
    const size_t src =
        ok ? (((size_t)b * S + i0 + r / G) * H + h * G + r % G) * D + ch * 8
           : 0;
    rt::cp_async16(qs + r * P + ch * 8, q + src, ok);
  }
  auto load_kv = [&](int kb, int st) {
    const int j0 = kb * BK;
    if constexpr (INT8) {
      constexpr int CPR = D / 16;              // 16-byte chunks a key row
      for (int c = t; c < BK * CPR; c += MTHREADS) {
        const int j = c / CPR, ch = c % CPR;
        const bool ok = j0 + j < kv_end;
        const size_t off =
            (((size_t)b * T + (ok ? j0 + j : 0)) * KV + h) * D + ch * 16;
        const int dst = (st * BK + j) * D + ch * 16;
        rt::cp_async16(kraw + dst, k + off, ok);
        rt::cp_async16(vraw + dst, v + off, ok);
      }
      if (t < BK) {
        const bool ok = j0 + t < kv_end;
        const size_t row = ((size_t)b * T + (ok ? j0 + t : 0)) * KV + h;
        rt::cp_async4(ksc + st * BK + t, ks + row, ok);
        rt::cp_async4(vsc + st * BK + t, vs + row, ok);
      }
    } else {
      constexpr int CPR = D / 8;
      for (int c = t; c < BK * CPR; c += MTHREADS) {
        const int j = c / CPR, ch = c % CPR;
        const bool ok = j0 + j < kv_end;
        const size_t off =
            (((size_t)b * T + (ok ? j0 + j : 0)) * KV + h) * D + ch * 8;
        const int dst = st * L::TILE + j * P + ch * 8;
        rt::cp_async16(kt + dst, k + off, ok);
        rt::cp_async16(vt + dst, v + off, ok);
      }
    }
    rt::cp_async_commit();
  };

  // scores in log2 units: p = 2^(s log2(e) - m) = e^(s - m ln 2) by one
  // exp2 (MUFU) instead of expf's extra range reduction
  const float scale_log2 = scale * 1.4426950408889634f;
  // rows of this thread in the warp's C fragments: g8 and g8 + 8
  const int g8 = lane >> 2, t4 = lane & 3;
  const int pos_a = start + i0 + (wr + g8) / G;
  const int pos_b = start + i0 + (wr + g8 + 8) / G;
  uint32_t qf[NKT][4];
  float o[NDT][4];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
  float m_r[2] = {rt::NEG_INF, rt::NEG_INF}, l_r[2] = {0.0f, 0.0f};

  load_kv(kb0, 0);                             // one group with the Q tile
  for (int it = 0; it < n_t; ++it) {
    const int st = it & 1;
    if (it + 1 < n_t) {
      load_kv(kb0 + it + 1, st ^ 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (INT8) {                      // widen the int8 tile to bf16
      constexpr int CPR = D / 16;
      for (int c = t; c < 2 * BK * CPR; c += MTHREADS) {
        const int which = c / (BK * CPR), e = c % (BK * CPR);
        const int j = e / CPR, ch = e % CPR;
        const int4 raw = *reinterpret_cast<const int4*>(
            (which ? vraw : kraw) + (st * BK + j) * D + ch * 16);
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = rt::pack_bf16((float)x[2 * i], (float)x[2 * i + 1]);
        uint4* dst = reinterpret_cast<uint4*>((which ? vt : kt) + j * P +
                                              ch * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
    }
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk)
        rt::ldsm_x4(qf[kk], qs + (wr + (lane & 15)) * P + kk * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* kS = kt + (INT8 ? 0 : st * L::TILE);
    const __nv_bfloat16* vS = vt + (INT8 ? 0 : st * L::TILE);
    const int j0 = (kb0 + it) * BK;
    // every key of the block live for every row of the q block
    const bool full =
        j0 + BK <= kv_end && (!CAUSAL || j0 + BK - 1 <= start + i0);
    if (wr < rows) {                           // warps of padding rows idle
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          rt::ldsm_x4(bf, kS + (np * 16 + (lane & 7) + (lane >> 4) * 8) * P +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          rt::mma_bf16(sc[2 * np], qf[kk], bf[0], bf[1]);
          rt::mma_bf16(sc[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }
      // mask, scale, running max per row (4 lanes share a row)
      float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = nt * 8 + 2 * t4 + (e & 1), key = j0 + jj;
          const bool ok =
              full || (key < kv_end &&
                       (!CAUSAL || key <= ((e < 2) ? pos_a : pos_b)));
          float s = sc[nt][e];
          if (INT8) s *= ksc[st * BK + jj];
          s *= scale_log2;
          sc[nt][e] = ok ? s : rt::NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = exp2f(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sc[nt][e];
          const float p = s == rt::NEG_INF ? 0.0f : exp2f(s - m_r[e >> 1]);
          l_r[e >> 1] += p;
          sc[nt][e] = INT8 ? p * vsc[st * BK + nt * 8 + 2 * t4 + (e & 1)]
                           : p;
        }
      }
#pragma unroll
      for (int dn = 0; dn < NDT; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }
      // P @ V over BK / 16 steps of 16 keys
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        // A fragment: keys 2 t4, +1 of n-tile 2 kc (rows g8, g8 + 8),
        // then keys 8 + 2 t4, +1 (n-tile 2 kc + 1)
        uint32_t a[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sc[2 * kc + (i >> 1)][2 * (i & 1)];
          const float y = sc[2 * kc + (i >> 1)][2 * (i & 1) + 1];
          a[i] = rt::pack_bf16(x, y);
          if (INT8)                            // p' - bf16(p')
            alo[i] = rt::pack_bf16(x - rt::bf16_round(x),
                                   y - rt::bf16_round(y));
        }
#pragma unroll
        for (int dp = 0; dp < NDT / 2; ++dp) {
          uint32_t bf[4];
          rt::ldsm_x4_t(bf, vS + (kc * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * P +
                                dp * 16 + (lane >> 4) * 8);
          rt::mma_bf16(o[2 * dp], a, bf[0], bf[1]);
          rt::mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
          if (INT8) {
            rt::mma_bf16(o[2 * dp], alo, bf[0], bf[1]);
            rt::mma_bf16(o[2 * dp + 1], alo, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();                           // tiles of stage st consumed
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (counts != nullptr && t == 0)
    atomicAdd(&counts[((size_t)b * KV + h) * n_q + qb], n_t);

  const size_t bhq = ((size_t)b * KV + h) * n_q + qb;
  if (n_live == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr + g8 + 8 * r;
      if (row >= rows) continue;
      const float inv = 1.0f / fmaxf(l_r[r], 1e-30f);
      __nv_bfloat16* dst =
          out + (((size_t)b * S + i0 + row / G) * H + h * G + row % G) * D;
#pragma unroll
      for (int dn = 0; dn < NDT; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    }
    return;
  }
  const size_t slot = bhq * n_split + sp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g8 + 8 * r;
    if (row >= rows) continue;
    float* po = part_o + (slot * MROWS + row) * D;
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn)
      *reinterpret_cast<float2*>(po + dn * 8 + 2 * t4) =
          make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
    if (t4 == 0) {
      // the merge weighs exp(m_i - m): the running max in natural units
      part_ml[(slot * MROWS + row) * 2] = m_r[r] * 0.6931471805599453f;
      part_ml[(slot * MROWS + row) * 2 + 1] = l_r[r];
    }
  }
  if (!rt::arrive_last(&counters[bhq], n_live, &last_s)) return;
  // the Q tile is spent: its shared memory holds the merge weights
  float* w_s = reinterpret_cast<float*>(smem);
  constexpr int J = MROWS * D / 4 / MTHREADS;    // float4 outputs a thread
  float4 r[J];
  rt::merge_splits<MTHREADS, J, D == 64 ? 2 : 1>(
      part_ml + bhq * n_split * MROWS * 2, MROWS * 2,
      part_o + bhq * n_split * MROWS * D, (size_t)MROWS * D, n_live, rows,
      rows * (D / 4), D / 4, w_s, w_s + rt::FLASH_MAX_SPLITS * MROWS, r);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = t + j * MTHREADS;
    if (e >= rows * (D / 4)) continue;
    const int row = e / (D / 4), d = (e % (D / 4)) * 4;
    __nv_bfloat16* dst =
        out + (((size_t)b * S + i0 + row / G) * H + h * G + row % G) * D + d;
    reinterpret_cast<__nv_bfloat162*>(dst)[0] =
        __floats2bfloat162_rn(r[j].x, r[j].y);
    reinterpret_cast<__nv_bfloat162*>(dst)[1] =
        __floats2bfloat162_rn(r[j].z, r[j].w);
  }
}

template <typename KVT, int D, bool CAUSAL>
int launch_mma(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* start, void* out, void* counts,
               void* part_o, void* part_ml, void* counters, int B, int S,
               int T, int H, int KV, int BQ, int kbps, int n_split,
               float scale, cudaStream_t s) {
  constexpr int bytes = MmaSmem<D, sizeof(KVT) == 1>::bytes;
  auto kernel = flash_mma_kernel<D, KVT, CAUSAL>;
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (bytes > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_q = (S + BQ - 1) / BQ;
  kernel<<<dim3(n_split, n_q, B * KV), MTHREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(start),
      static_cast<__nv_bfloat16*>(out), static_cast<int*>(counts),
      static_cast<float*>(part_o), static_cast<float*>(part_ml),
      static_cast<int*>(counters), S, T, H, KV, H / KV, BQ, n_q, kbps,
      n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace
