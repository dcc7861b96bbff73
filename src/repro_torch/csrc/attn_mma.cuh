// Device helpers of the split-key attention kernels (decode_attention.cu,
// the flash bodies flash_mma.cuh and flash_f32.cuh, mla_decode.cu):
// 16-byte cp.async copies into shared memory with zero fill, ldmatrix
// loads, the bf16 m16n8k16 tensor-core product with f32 accumulation, and
// the partial merge of a key range split over blocks.
//
// cp.async with a source size of 0 writes zeros: keys at or past a row's
// bound are never read from device memory, and the shared tile holds zeros
// there (never stale values, which times p = 0 could give NaN).
#pragma once

#include "common.cuh"

namespace rt {

// blocks the key range of a flash q block splits over, at most (the merge
// weights' buffer; kernels/flash_attention.py MAX_SPLITS)
constexpr int FLASH_MAX_SPLITS = 16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zeros when !pred (src must be valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared; zeros when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l addresses row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8x8 b16 matrices; lanes 0-15 address rows of matrix lane / 8
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of KVT as floats (16 / sizeof(KVT) of them)
template <typename KVT>
__device__ __forceinline__ void unpack16(const unsigned char* p, float* f) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const KVT* e = reinterpret_cast<const KVT*>(&w);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(KVT); ++i) f[i] = to_float(e[i]);
}

// Merge weights of the partials of n <= 64 splits over R rows: split i's
// running max and denominator of row r at ml[i * stride + 2 r] and +1,
// read through L2 (__ldcg: other blocks wrote them during this launch)
// into shared memory, every load of the block in flight at once; then a
// group of lanes (the power of two >= n, at most a warp) takes one row,
// max and sum by shuffles. Leaves w[i * R + r] = exp(m_ir - m_r) /
// sum_j exp(m_jr - m_r) l_jr (m_r = max_i m_ir; l holds n * R floats of
// scratch), so that row r's output is sum_i w[i * R + r] acc_i.
template <int THREADS>
__device__ __forceinline__ void merge_weights(const float* ml, int stride,
                                              int n, int R, float* w,
                                              float* l) {
  for (int idx = threadIdx.x; idx < n * R; idx += THREADS) {
    const float* p = ml + (size_t)(idx / R) * stride + 2 * (idx % R);
    w[idx] = __ldcg(p);
    l[idx] = __ldcg(p + 1);
  }
  __syncthreads();
  int lpr = 1;
  while (lpr < n && lpr < 32) lpr <<= 1;
  const int sub = threadIdx.x % lpr, grp = threadIdx.x / lpr;
  for (int r0 = 0; r0 < R; r0 += THREADS / lpr) {
    const int r = r0 + grp;
    float mv[2], m = -1e30f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = sub + k * lpr;
      mv[k] = r < R && i < n ? w[i * R + r] : -1e30f;
      m = fmaxf(m, mv[k]);
    }
    for (int off = lpr / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off, lpr));
    float e[2], den = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = sub + k * lpr;
      e[k] = expf(mv[k] - m);
      if (r < R && i < n) den = fmaf(e[k], l[i * R + r], den);
    }
    for (int off = lpr / 2; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off, lpr);
    const float inv = 1.0f / fmaxf(den, 1e-30f);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = sub + k * lpr;
      if (r < R && i < n) w[i * R + r] = e[k] * inv;
    }
  }
  __syncthreads();
}

// The merged outputs of this thread, sum_i w[i * R + row] acc[i * stride +
// 4 e .. + 3] for its float4 outputs e = threadIdx.x + j * THREADS < n4
// (row = e / per_row), over n splits: splits [i0, i0 + BATCH) loaded at
// once through L2 into a (load_splits), then added into out (add_splits).
// A caller issues the first batch before merge_weights, so that the two
// steps' loads overlap.
template <int THREADS, int J, int BATCH>
__device__ __forceinline__ void load_splits(const float* acc, size_t stride,
                                            int i0, int n, int n4,
                                            float4 (&a)[BATCH][J]) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = threadIdx.x + j * THREADS;
      a[k][j] = (i0 + k < n && e < n4)
                    ? __ldcg(reinterpret_cast<const float4*>(
                          acc + (size_t)(i0 + k) * stride + 4 * e))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

template <int THREADS, int J, int BATCH>
__device__ __forceinline__ void add_splits(const float4 (&a)[BATCH][J],
                                           const float* w, int R, int i0,
                                           int n, int n4, int per_row,
                                           float4 (&out)[J]) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = threadIdx.x + j * THREADS;
      if (i0 + k < n && e < n4) {
        const float x = w[(i0 + k) * R + e / per_row];
        out[j].x = fmaf(x, a[k][j].x, out[j].x);
        out[j].y = fmaf(x, a[k][j].y, out[j].y);
        out[j].z = fmaf(x, a[k][j].z, out[j].z);
        out[j].w = fmaf(x, a[k][j].w, out[j].w);
      }
    }
  }
}

// The whole merge of a block that arrived last: weights and accumulators.
template <int THREADS, int J, int BATCH>
__device__ __forceinline__ void merge_splits(const float* ml, int ml_stride,
                                             const float* acc,
                                             size_t acc_stride, int n, int R,
                                             int n4, int per_row, float* w,
                                             float* l, float4 (&out)[J]) {
  float4 a[BATCH][J];
#pragma unroll
  for (int j = 0; j < J; ++j) out[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  load_splits<THREADS, J, BATCH>(acc, acc_stride, 0, n, n4, a);
  merge_weights<THREADS>(ml, ml_stride, n, R, w, l);
  add_splits<THREADS, J, BATCH>(a, w, R, 0, n, n4, per_row, out);
  for (int i0 = BATCH; i0 < n; i0 += BATCH) {
    load_splits<THREADS, J, BATCH>(acc, acc_stride, i0, n, n4, a);
    add_splits<THREADS, J, BATCH>(a, w, R, i0, n, n4, per_row, out);
  }
}

// Called by every thread of a block after it wrote its partials: returns
// true in the one block of the group of n that arrives last (the counter
// is left at 0 for the next launch on the stream). The writes of every
// block of the group are visible to the last one.
__device__ __forceinline__ bool arrive_last(int* counter, int n,
                                            int* flag_smem) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(counter, 1);
    const bool last = prev == n - 1;
    if (last) *counter = 0;
    *flag_smem = last;
  }
  __syncthreads();
  const bool last = *flag_smem != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace rt
