// Register-tiled f32 flash attention body of MHA flash attention
// (flash_mha.cu, f32) and of the GQA prefill (flash_gqa.cu, f32 queries),
// on the CUDA cores (TF32 tensor cores would not hold the f32 checks):
//  - a block holds 64 query rows (row r = query position r / G of the q
//    block, grouped head r % G; MHA is G = 1, one head) and a range of
//    64-key blocks; the wrappers split the key blocks of a q block over
//    blocks where (q blocks x KV heads) alone would give a grid of under
//    about two blocks per SM, and the last block to arrive merges the
//    partials in the same launch (rt::merge_splits, as flash_mma.cuh).
//  - key j is live iff j < kv_end and, when CAUSAL, j <= start + i for the
//    query at absolute position start + i; kv_end = min(T, start + S) when
//    CAUSAL (the written prefix of a slot cache), T when not. Causal key
//    blocks past the q block's frontier are never read; keys at or past
//    kv_end are zero-filled, never read.
//  - 256 threads, 16 x 16: thread (ty, tx) holds a 4 x 4 tile of scores
//    (rows ty + 16 i, keys tx + 16 j: the float4 loads of a warp fall on
//    distinct banks) and a 4 x 4 NC tile of outputs (columns 64 c + 4 tx,
//    NC = ceil(D / 64)), so every shared load feeds four FMAs. At head
//    dims 96 and 112 the last 64-column chunk is partly past D: the
//    threads whose columns lie there skip it (8 or 4 of the 16 columns
//    idle for that chunk). Q, K and V tiles in shared memory by cp.async,
//    K and V of the next key block in flight while the current one is
//    used. The online softmax runs in registers (row max by shuffles over
//    the 16 threads of a row); p goes through shared memory to the P @ V
//    tile.
//  - arithmetic as the reference's: f32 scores times 1/sqrt(D), masked to
//    -1e30, p = exp(s - m) in f32, l = l * alpha + sum(p), acc = acc *
//    alpha + p @ V, the output acc / max(l, 1e-30). An int8 cache is
//    staged as raw bytes and its per-key f32 scales, then dequantized into
//    the f32 tile as (float)k * ks (the reference's k.astype(f32) * ks); p
//    stays f32.
#pragma once

#include "attn_mma.cuh"

namespace {

constexpr int FBQ = 64, FBK = 64, FTHREADS = 256;

template <int D, bool INT8>
struct F32Smem {
  static constexpr int P = D + 4;        // floats a q, k or v row
  static constexpr int PP = FBK + 16;    // floats a p row
  static constexpr int RAW = INT8 ? FBK * D : 0;   // int8 bytes of a tile
  static constexpr int bytes = ((FBQ + 2 * FBK) * P + FBQ * PP) * 4 +
                               2 * RAW + (INT8 ? 2 * FBK * 4 : 0);
};

// q: (B, S, H, D) f32; k, v: (B, T, KV, D) in KVT (f32, or int8 with ks,
// vs: (B, T, KV) f32); start_p: (B,) or null (every start 0); out: (B, S,
// H, D) f32; counts: (B, KV, n_q), summed over the splits, or null. Grid
// (n_split, n_q, B * KV).
template <int D, typename KVT, bool CAUSAL>
__global__ void __launch_bounds__(FTHREADS, 1)
flash_f32_kernel(const float* __restrict__ q, const KVT* __restrict__ k,
                 const KVT* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs,
                 const int* __restrict__ start_p, float* __restrict__ out,
                 int* __restrict__ counts, float* __restrict__ part_o,
                 float* __restrict__ part_ml, int* __restrict__ counters,
                 int S, int T, int H, int KV, int G, int BQ, int n_q,
                 int kbps, int n_split, float scale) {
  constexpr bool INT8 = sizeof(KVT) == 1;
  using L = F32Smem<D, INT8>;
  constexpr int P = L::P, PP = L::PP, NC = (D + 63) / 64;
  static_assert(D % 16 == 0, "whole 16-byte chunks of a row");
  static_assert(FBQ == 64 && FBK == 64 && FTHREADS == 256,
                "16 x 16 threads, 4 x 4 scores each");
  static_assert(2 * rt::FLASH_MAX_SPLITS * FBQ <= FBQ * P,
                "the merge weights fit the Q tile");
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ksm = qs + FBQ * P;
  float* vsm = ksm + FBK * P;
  float* ps = vsm + FBK * P;
  unsigned char* kraw = reinterpret_cast<unsigned char*>(ps + FBQ * PP);
  unsigned char* vraw = kraw + L::RAW;
  float* ksc = reinterpret_cast<float*>(vraw + L::RAW);   // [FBK]
  float* vsc = ksc + FBK;                                  // [FBK]
  __shared__ int last_s;

  const int sp = blockIdx.x;
  // causal: the q blocks with the most key blocks start first
  const int qb = CAUSAL ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int h = blockIdx.z % KV, b = blockIdx.z / KV;
  const int start = start_p != nullptr ? start_p[b] : 0;
  const int i0 = qb * BQ, npos = min(BQ, S - i0);
  const int rows = npos * G;                   // live rows of this block
  const int kv_end = CAUSAL ? min(T, start + S) : T;
  const int nkb =
      ((CAUSAL ? min(start + i0 + npos, kv_end) : kv_end) + FBK - 1) / FBK;
  const int kb0 = sp * kbps;
  if (kb0 >= nkb) return;                      // past the frontier
  const int kb1 = min(kb0 + kbps, nkb);
  const int n_live = (nkb + kbps - 1) / kbps;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  // columns 64 c + 4 tx .. + 3 of the output tile lie below D
  auto col_ok = [&](int c) { return D % 64 == 0 || c * 64 + 4 * tx < D; };

  for (int c = t; c < FBQ * (D / 4); c += FTHREADS) {
    const int r = c / (D / 4), ch = c % (D / 4);
    const bool ok = r < rows;
    const size_t src =
        ok ? (((size_t)b * S + i0 + r / G) * H + h * G + r % G) * D + ch * 4
           : 0;
    rt::cp_async16(qs + r * P + ch * 4, q + src, ok);
  }
  rt::cp_async_commit();
  // the K or V tile of key block kb (keys >= kv_end zero-filled): f32 rows
  // straight into the tile, int8 rows and their scales into the raw stage
  auto load = [&](float* dst, unsigned char* raw, float* sc, const KVT* src,
                  const float* scales, int kb) {
    const int j0 = kb * FBK;
    if constexpr (INT8) {
      for (int c = t; c < FBK * (D / 16); c += FTHREADS) {
        const int j = c / (D / 16), ch = c % (D / 16);
        const bool ok = j0 + j < kv_end;
        const size_t off =
            (((size_t)b * T + (ok ? j0 + j : 0)) * KV + h) * D + ch * 16;
        rt::cp_async16(raw + j * D + ch * 16, src + off, ok);
      }
      if (t < FBK) {
        const bool ok = j0 + t < kv_end;
        rt::cp_async4(sc + t,
                      scales + ((size_t)b * T + (ok ? j0 + t : 0)) * KV + h,
                      ok);
      }
    } else {
      for (int c = t; c < FBK * (D / 4); c += FTHREADS) {
        const int j = c / (D / 4), ch = c % (D / 4);
        const bool ok = j0 + j < kv_end;
        const size_t off =
            (((size_t)b * T + (ok ? j0 + j : 0)) * KV + h) * D + ch * 4;
        rt::cp_async16(dst + j * P + ch * 4, src + off, ok);
      }
    }
    rt::cp_async_commit();
  };
  // int8: the staged tile, dequantized into the f32 tile (then a barrier)
  auto widen = [&](float* dst, const unsigned char* raw, const float* sc) {
    if constexpr (INT8) {
      for (int c = t; c < FBK * (D / 16); c += FTHREADS) {
        const int j = c / (D / 16), ch = c % (D / 16);
        const int4 w = *reinterpret_cast<const int4*>(raw + j * D + ch * 16);
        const int8_t* x = reinterpret_cast<const int8_t*>(&w);
        const float s = sc[j];
        float4* o = reinterpret_cast<float4*>(dst + j * P + ch * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = make_float4(__fmul_rn((float)x[4 * e], s),
                             __fmul_rn((float)x[4 * e + 1], s),
                             __fmul_rn((float)x[4 * e + 2], s),
                             __fmul_rn((float)x[4 * e + 3], s));
      }
      __syncthreads();
    }
  };
  load(ksm, kraw, ksc, k, ks, kb0);
  load(vsm, vraw, vsc, v, vs, kb0);

  float o[4][NC][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] =
        o[i][c][3] = 0.0f;
  }
  for (int kb = kb0; kb < kb1; ++kb) {
    const int j0 = kb * FBK;
    rt::cp_async_wait<1>();                    // Q and K of this block
    __syncthreads();
    widen(ksm, kraw, ksc);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * P + d);
        c[i] = *reinterpret_cast<const float4*>(ksm + (tx + 16 * i) * P + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }
    // every key of the block live for every row of the q block
    const bool full =
        j0 + FBK <= kv_end && (!CAUSAL || j0 + FBK - 1 <= start + i0);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = start + i0 + (ty + 16 * i) / G;
      float mx = rt::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + tx + 16 * j;
        const bool ok =
            full || (key < kv_end && (!CAUSAL || key <= pos));
        s[i][j] = ok ? __fmul_rn(s[i][j], scale) : rt::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == rt::NEG_INF ? 0.0f : expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);
    }
    __syncthreads();                           // K consumed, P written
    if (kb + 1 < kb1) {
      load(ksm, kraw, ksc, k, ks, kb + 1);
      rt::cp_async_wait<1>();                  // V of this block
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    widen(vsm, vraw, vsc);
    float pv[4][NC][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) pv[i][c][0] = pv[i][c][1] = pv[i][c][2] =
          pv[i][c][3] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < FBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!col_ok(c)) continue;
          const float4 w = *reinterpret_cast<const float4*>(
              vsm + (j + jj) * P + c * 64 + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y
                            : jj == 2 ? pa[i].z : pa[i].w;
            pv[i][c][0] = fmaf(p, w.x, pv[i][c][0]);
            pv[i][c][1] = fmaf(p, w.y, pv[i][c][1]);
            pv[i][c][2] = fmaf(p, w.z, pv[i][c][2]);
            pv[i][c][3] = fmaf(p, w.w, pv[i][c][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[i][c][e] = __fadd_rn(__fmul_rn(o[i][c][e], alpha[i]), pv[i][c][e]);
    __syncthreads();                           // V and P consumed
    if (kb + 1 < kb1) load(vsm, vraw, vsc, v, vs, kb + 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }
  const size_t bhq = ((size_t)b * KV + h) * n_q + qb;
  if (counts != nullptr && t == 0) atomicAdd(&counts[bhq], kb1 - kb0);
  // row r of the block in q / out: position i0 + r / G, head h G + r % G
  auto row_ptr = [&](int r) {
    return out + (((size_t)b * S + i0 + r / G) * H + h * G + r % G) * D;
  };
  if (n_live == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows) continue;
      const float den = fmaxf(l[i], 1e-30f);
      float* dst = row_ptr(r) + 4 * tx;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (col_ok(c))
          *reinterpret_cast<float4*>(dst + c * 64) = make_float4(
              __fdiv_rn(o[i][c][0], den), __fdiv_rn(o[i][c][1], den),
              __fdiv_rn(o[i][c][2], den), __fdiv_rn(o[i][c][3], den));
    }
    return;
  }
  const size_t slot = bhq * n_split + sp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    float* po = part_o + (slot * FBQ + r) * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_ok(c))
        *reinterpret_cast<float4*>(po + c * 64) =
            make_float4(o[i][c][0], o[i][c][1], o[i][c][2], o[i][c][3]);
    if (tx == 0) {
      part_ml[(slot * FBQ + r) * 2] = m[i];
      part_ml[(slot * FBQ + r) * 2 + 1] = l[i];
    }
  }
  if (!rt::arrive_last(&counters[bhq], n_live, &last_s)) return;
  // the Q tile is spent: its shared memory holds the merge weights
  constexpr int J = FBQ * D / 4 / FTHREADS;    // float4 outputs a thread
  float4 r4[J];
  rt::merge_splits<FTHREADS, J, D == 64 ? 2 : 1>(
      part_ml + bhq * n_split * FBQ * 2, FBQ * 2,
      part_o + bhq * n_split * FBQ * D, (size_t)FBQ * D, n_live, rows,
      rows * (D / 4), D / 4, fsm, fsm + rt::FLASH_MAX_SPLITS * FBQ, r4);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = t + j * FTHREADS;
    if (e >= rows * (D / 4)) continue;
    *reinterpret_cast<float4*>(row_ptr(e / (D / 4)) + (e % (D / 4)) * 4) =
        r4[j];
  }
}

template <typename KVT, int D, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* start, void* out, void* counts,
               void* part_o, void* part_ml, void* counters, int B, int S,
               int T, int H, int KV, int BQ, int kbps, int n_split,
               float scale, cudaStream_t s) {
  constexpr int bytes = F32Smem<D, sizeof(KVT) == 1>::bytes;
  auto kernel = flash_f32_kernel<D, KVT, CAUSAL>;
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_q = (S + BQ - 1) / BQ;
  kernel<<<dim3(n_split, n_q, B * KV), FTHREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(start),
      static_cast<float*>(out), static_cast<int*>(counts),
      static_cast<float*>(part_o), static_cast<float*>(part_ml),
      static_cast<int*>(counters), S, T, H, KV, H / KV, BQ, n_q, kbps,
      n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace
