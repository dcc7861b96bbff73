// Causal GQA flash prefill against the slot cache, per-row start offsets.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_gqa_attention / _gqa_kernel (pl.pallas_call at :409): queries
// (B, S, H, D) of the S freshly written tokens, query i of row b at
// absolute position start[b] + i, key j visible iff j <= start[b] + i and
// j < start[b] + S; causal block pruning; int8 cache dequantized in-kernel;
// optional per-(row, KV head, q block) count of key blocks visited.
//
// Bound on the H100: for one 32-token chunk each live key costs at most
// 4 * S * H * D = 115k operations against 2 * KV * D * 2 = 512 bytes of
// bf16 cache - under ~220 operations per byte, below the ~295 at which the
// bf16 tensor cores rather than HBM would bound it - so the cache bytes
// bound it. The design: one block per (row b, KV head h, q block of BQ
// query positions) holding its BQ * G query rows (56 at G = 7) in shared
// memory; it walks the key blocks (32 keys) up to the causal frontier of
// its q block only, loads K (transposed) and V once per key block for all
// rows, and keeps the online-softmax state in shared memory and the
// accumulators in registers.
// The products run on the CUDA cores in f32, not on the tensor cores: a
// first version that is right; PERF.md records its time against the bound.
#include "attn_common.cuh"

namespace {

constexpr int D = 64, BK = 32, THREADS = 256, RMAX = 56;

template <typename QT, typename KVT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const QT* q, const KVT* k, const KVT* v, const float* ks,
             const float* vs, const int* start, QT* out, int* counts, int S,
             int T, int H, int KV, int G, int BQ, int n_q, float scale) {
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  rt::gqa_attend<QT, KVT, RMAX, BK, D, THREADS>(
      q, k, v, ks, vs, out, counts, b, h, qb, n_q, BQ, G, S, T, H, KV,
      start[b], min(T, start[b] + S), true, scale);
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* start, void* out, void* counts,
           int B, int S, int T, int H, int KV, int BQ, float scale,
           cudaStream_t s) {
  const int n_q = (S + BQ - 1) / BQ;
  flash_kernel<QT, KVT><<<dim3(n_q, KV, B), THREADS, 0, s>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(start),
      static_cast<QT*>(out), static_cast<int*>(counts), S, T, H, KV, H / KV,
      BQ, n_q, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, S, H, D); k, v: (B, T, KV, D); ks, vs: (B, T, KV) f32 or null;
// start: (B,) int32 on the device; out: (B, S, H, D) in q's dtype; counts:
// (B, KV, ceil(S / BQ)) int32 or null. q_dtype: 0 f32, 1 bf16; kv_dtype:
// 0 f32, 1 bf16, 2 int8. D must be 64 and BQ * (H / KV) <= 56 (checked by
// the Python wrapper).
extern "C" int flash_gqa(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* start,
                         void* out, void* counts, int B, int S, int T, int H,
                         int KV, int BQ, int q_dtype, int kv_dtype,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, ks, vs, start, out, counts, B, S, T, H, KV, BQ, scale, s);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t>(q, k, v, ks, vs, start, out, counts, B, S, T, H, KV, BQ, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, start, out, counts, B, S, T, H, KV, BQ, scale, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, start, out, counts, B, S, T, H, KV, BQ, scale, s);
  return (int)cudaErrorInvalidValue;
}
