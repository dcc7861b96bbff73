// MHA flash attention: (BH, S, D) queries against (BH, T, D) keys/values.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention / _kernel (pl.pallas_call at :204), the training and
// cross-attention shapes with heads folded into rows. Key j counts for
// query i of row b iff j < T and, when causal, j <= start[b] + i and
// j < start[b] + S (start offsets exist only with causal; without them
// start = 0). Causal query blocks never read key blocks past their
// frontier; non-causal blocks visit every key block below T. Masked scores
// are -1e30, scores are f32 times 1/sqrt(D), p is rounded to v's dtype
// before p @ V with f32 sums, the denominator is max(l, 1e-30), and the
// output is written in q's dtype. Optional (BH, n_q) counts of the key
// blocks each query block visited (this kernel's blocks, summed over the
// blocks a q block's key range is split over).
//
// Bound on the H100: the operations at long rows, the bytes at short ones.
// Per live (query, key) pair the kernel does 4 * D operations against
// (2 S + 2 T) * D elements read and written per row, so at S = T = 128
// (qwen2-0.5b's training attention) about 64 bf16 operations per byte: the
// bytes bound it; at S = T = 2048 about 1000 per byte: the operations
// bound it (PERF.md states both terms per shape).
//
// bf16: the tensor-core body of flash_mma.cuh (shared with the GQA
// prefill) with one head per row (G = KV = H = 1): 64 query rows per
// block, 32-key blocks (MBK; 64 measured slower), Q in registers, K by
// ldmatrix, V by ldmatrix.trans, mma.sync m16n8k16 with f32 sums, the
// online softmax in registers, causal or not; the key blocks split over
// blocks with the in-launch merge where (BH x q blocks) alone leaves the
// grid under about two blocks per SM.
//
// f32: a register-tiled body on the CUDA cores (TF32 would not hold the
// f32 tolerance). A block of 256 threads holds 64 queries against 64-key
// blocks: Q, K and V tiles in shared memory (cp.async, K and V of the next
// block in flight while the current one is used), each thread a 4 x 4 tile
// of scores (queries ty + 16 i, keys tx + 16 j: the float4 loads of a warp
// fall on distinct banks) and a 4 x D/16 tile of outputs, so every shared
// load feeds four FMAs. The online softmax runs in registers (row max by
// shuffles over the 16 threads of a row); p goes through shared memory to
// the P @ V tile.
#include "attn_common.cuh"
#include "flash_mma.cuh"

namespace {

// ------------------------------------------------ f32 (CUDA cores)
constexpr int FBQ = 64, FBK = 64, FTHREADS = 256;

template <int D>
struct F32Smem {
  static constexpr int P = D + 4;        // floats a q, k or v row
  static constexpr int PP = FBK + 16;    // floats a p row
  static constexpr int bytes = ((FBQ + 2 * FBK) * P + FBQ * PP) * 4;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FTHREADS, 1)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ start_p,
               float* __restrict__ out, int* __restrict__ counts, int S,
               int T, int n_q, float scale) {
  using L = F32Smem<D>;
  constexpr int P = L::P, PP = L::PP, CPR = D / 4, NC = D / 64;
  static_assert(FBQ == 64 && FBK == 64 && FTHREADS == 256,
                "16 x 16 threads, 4 x 4 scores each");
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ksm = qs + FBQ * P;
  float* vsm = ksm + FBK * P;
  float* ps = vsm + FBK * P;
  // causal: the q blocks with the most key blocks start first
  const int qb = CAUSAL ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int b = blockIdx.y;
  const int start = start_p != nullptr ? start_p[b] : 0;
  const int i0 = qb * FBQ, npos = min(FBQ, S - i0);
  const int kv_end = CAUSAL ? min(T, start + S) : T;
  const int nkb =
      ((CAUSAL ? min(start + i0 + npos, kv_end) : kv_end) + FBK - 1) / FBK;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const float* kb_ = k + (size_t)b * T * D;
  const float* vb_ = v + (size_t)b * T * D;

  // 64 rows of D floats from src; rows >= lim zero-filled, never read
  auto load = [&](float* dst, const float* src, int lim) {
    for (int c = t; c < 64 * CPR; c += FTHREADS) {
      const int r = c / CPR, ch = c % CPR;
      const bool ok = r < lim;
      rt::cp_async16(dst + r * P + ch * 4,
                     src + (ok ? (size_t)r * D + ch * 4 : 0), ok);
    }
    rt::cp_async_commit();
  };
  load(qs, q + ((size_t)b * S + i0) * D, npos);
  load(ksm, kb_, kv_end);
  load(vsm, vb_, kv_end);

  float o[4][NC][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] =
        o[i][c][3] = 0.0f;
  }
  for (int kb = 0; kb < nkb; ++kb) {
    const int j0 = kb * FBK;
    rt::cp_async_wait<1>();                    // Q and K of this block
    __syncthreads();
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
    // every key of the block live for every query of the q block
    const bool full =
        j0 + FBK <= kv_end && (!CAUSAL || j0 + FBK - 1 <= start + i0);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = start + i0 + ty + 16 * i;
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
    if (kb + 1 < nkb) {
      load(ksm, kb_ + (size_t)(j0 + FBK) * D, kv_end - j0 - FBK);
      rt::cp_async_wait<1>();                  // V of this block
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
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
    if (kb + 1 < nkb)
      load(vsm, vb_ + (size_t)(j0 + FBK) * D, kv_end - j0 - FBK);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int r = ty + 16 * i;
    if (r >= npos) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* dst = out + ((size_t)b * S + i0 + r) * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(dst + c * 64) = make_float4(
          __fdiv_rn(o[i][c][0], den), __fdiv_rn(o[i][c][1], den),
          __fdiv_rn(o[i][c][2], den), __fdiv_rn(o[i][c][3], den));
  }
  if (counts != nullptr && t == 0) counts[(size_t)b * n_q + qb] = nkb;
}

template <int D, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v,
               const void* start, void* out, void* counts, int BH, int S,
               int T, float scale, cudaStream_t s) {
  constexpr int bytes = F32Smem<D>::bytes;
  auto kernel = mha_f32_kernel<D, CAUSAL>;
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_q = (S + FBQ - 1) / FBQ;
  kernel<<<dim3(n_q, BH), FTHREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(start),
      static_cast<float*>(out), static_cast<int*>(counts), S, T, n_q, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* start, void* out, void* counts, void* part_o,
                void* part_ml, void* counters, int BH, int S, int T,
                int causal, int kbps, int n_split, float scale,
                cudaStream_t s) {
  auto launch = causal ? launch_mma<__nv_bfloat16, D, true>
                       : launch_mma<__nv_bfloat16, D, false>;
  return launch(q, k, v, nullptr, nullptr, start, out, counts, part_o,
                part_ml, counters, BH, S, T, 1, 1, MROWS, kbps, n_split,
                scale, s);
}

}  // namespace

// q: (BH, S, D); k, v: (BH, T, D), all float32 (dtype 0) or bfloat16 (1),
// contiguous, rows on 16 bytes; start: (BH,) int32 on the device or null
// (every start 0; only with causal); out: (BH, S, D) in q's dtype; counts:
// (BH, ceil(S / 64)) int32, zero before the launch, or null. bf16: key
// blocks of MBK (32) keys, those of a q block in groups of kbps
// over n_split <= 16 blocks; part_o (BH * n_q * n_split, 64, D) and
// part_ml (.., 64, 2) f32 scratch and counters (BH * n_q,) int32, zero
// before the launch and left zero after it, when n_split > 1 (else null).
// f32: 64-key blocks and n_split 1. D must be 64 or 128 (checked by the
// Python wrapper). Returns cudaGetLastError() after the launch.
extern "C" int flash_mha(const void* q, const void* k, const void* v,
                         const void* start, void* out, void* counts,
                         void* part_o, void* part_ml, void* counters, int BH,
                         int S, int T, int D, int causal, int dtype,
                         int kbps, int n_split, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && n_split == 1) {
    if (D == 64)
      return causal ? launch_f32<64, true>(q, k, v, start, out, counts, BH,
                                           S, T, scale, s)
                    : launch_f32<64, false>(q, k, v, start, out, counts, BH,
                                            S, T, scale, s);
    if (D == 128)
      return causal ? launch_f32<128, true>(q, k, v, start, out, counts, BH,
                                            S, T, scale, s)
                    : launch_f32<128, false>(q, k, v, start, out, counts,
                                             BH, S, T, scale, s);
  }
#define BF16_ARGS q, k, v, start, out, counts, part_o, part_ml, counters, \
                  BH, S, T, causal, kbps, n_split, scale, s
  if (dtype == 1) {
    if (D == 64) return launch_bf16<64>(BF16_ARGS);
    if (D == 128) return launch_bf16<128>(BF16_ARGS);
  }
#undef BF16_ARGS
  return (int)cudaErrorInvalidValue;
}
