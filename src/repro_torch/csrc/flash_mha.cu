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
// blocks each query block visited (this kernel's blocks).
//
// The block body is rt::gqa_attend (attn_common.cuh) with one query head
// per KV head: the (BH, S, D) layout is its (B = BH, S, H = 1, D). One
// block per (row, query block of BQ positions) holds its queries in shared
// memory, walks the key blocks of BK = 32 keys, loads K (transposed) and V
// once per key block for all BQ queries and keeps the online-softmax state
// in shared memory and the accumulators in registers.
//
// Bound on the H100: the operations at long rows, the bytes at short ones.
// Per live (query, key) pair the kernel does 4 * D operations against
// (2 S + 2 T) * D elements read and written per row, so at S = T = 128
// (qwen2-0.5b's training attention) about 64 bf16 operations per byte: the
// bytes bound it; at S = T = 2048 about 1000 per byte: the tensor cores'
// operations bound it (PERF.md states both terms per shape). The products
// run on the CUDA cores in f32, not on the tensor cores: a first version
// that is right; PERF.md records its time against the bound.
#include "attn_common.cuh"

namespace {

constexpr int BK = 32, THREADS = 256;

// BQ query rows per block: 32 at D = 64 (28.7 KB of shared memory), 16 at
// D = 128 (43.3 KB, under the 48 KB of static shared memory).
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS)
mha_kernel(const T* q, const T* k, const T* v, const int* start, T* out,
           int* counts, int S, int Tk, int n_q, int causal, int bounded,
           float scale) {
  const int qb = blockIdx.x, b = blockIdx.y;
  const int st = bounded ? start[b] : 0;
  const int kv_end = causal ? min(Tk, st + S) : Tk;
  rt::gqa_attend<T, T, BQ, BK, D, THREADS>(
      q, k, v, nullptr, nullptr, out, counts, b, 0, qb, n_q, BQ, 1, S, Tk,
      1, 1, st, kv_end, causal != 0, scale);
}

template <typename T, int D, int BQ>
int launch(const void* q, const void* k, const void* v, const void* start,
           void* out, void* counts, int BH, int S, int Tk, int causal,
           int bounded, float scale, cudaStream_t s) {
  const int n_q = (S + BQ - 1) / BQ;
  mha_kernel<T, D, BQ><<<dim3(n_q, BH), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(start),
      static_cast<T*>(out), static_cast<int*>(counts), S, Tk, n_q, causal,
      bounded, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* start,
             void* out, void* counts, int BH, int S, int Tk, int D,
             int causal, int bounded, float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64, 32>(q, k, v, start, out, counts, BH, S, Tk, causal,
                             bounded, scale, s);
  if (D == 128)
    return launch<T, 128, 16>(q, k, v, start, out, counts, BH, S, Tk,
                              causal, bounded, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (BH, S, D); k, v: (BH, T, D), all float32 (dtype 0) or bfloat16 (1),
// contiguous; start: (BH,) int32 on the device, read only when bounded;
// out: (BH, S, D) in q's dtype; counts: (BH, ceil(S / BQ)) int32 or null
// (BQ = 32 at D = 64, 16 at D = 128). D must be 64 or 128 (checked by the
// Python wrapper). Returns cudaGetLastError() after the launch.
extern "C" int flash_mha(const void* q, const void* k, const void* v,
                         const void* start, void* out, void* counts, int BH,
                         int S, int Tk, int D, int causal, int bounded,
                         int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, start, out, counts, BH, S, Tk, D, causal,
                           bounded, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, start, out, counts, BH, S, Tk, D,
                                   causal, bounded, scale, s);
  return (int)cudaErrorInvalidValue;
}
