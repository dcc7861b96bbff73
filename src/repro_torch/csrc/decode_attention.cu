// Length-aware GQA decode attention against the slot cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// decode_attention / _kernel (pl.pallas_call at :185): one query token per
// batch row, lens[b] valid keys (the current token's key included), keys at
// or past lens[b] never read, lens[b] == 0 -> a zero output row, int8 cache
// dequantized in-kernel.
//
// Bound on the H100: bytes. The block reads the live cache rows once
// (2 * lens * D * bytes per KV head, plus the f32 scales when int8) and
// does about 4 * G * D operations per key, a few per byte - so the least
// time is the live cache bytes over 3.35 TB/s. The design: one block per
// (row b, KV head h) holding its G grouped query heads in shared memory; it
// walks only the key blocks below lens[b] (64 keys each), loads K
// (transposed) and V into shared memory once per block for all G heads,
// and keeps the online-softmax state in shared memory and the output
// accumulator in registers. No split over the key axis yet: at the
// serving engine's lengths (a few hundred keys) the grid of B * KV blocks
// is latency-bound, which PERF.md records.
#include "attn_common.cuh"

namespace {

constexpr int D = 64, BK = 64, THREADS = 128, RMAX = 8;

template <typename QT, typename KVT>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const QT* q, const KVT* k, const KVT* v, const float* ks,
              const float* vs, const int* lens, QT* out, int T, int H,
              int KV, int G, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  // one query at absolute position lens - 1: S = 1, start = lens - 1
  rt::gqa_attend<QT, KVT, RMAX, BK, D, THREADS>(
      q, k, v, ks, vs, out, nullptr, b, h, 0, 1, 1, G, 1, T, H, KV,
      lens[b] - 1, min(T, lens[b]), true, scale);
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lens, void* out, int B, int T, int H,
           int KV, float scale, cudaStream_t s) {
  decode_kernel<QT, KVT><<<dim3(KV, B), THREADS, 0, s>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<QT*>(out), T, H, KV, H / KV, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, D); k, v: (B, T, KV, D); ks, vs: (B, T, KV) f32 or null;
// lens: (B,) int32 on the device; out: (B, H, D) in q's dtype.
// q_dtype: 0 f32, 1 bf16; kv_dtype: 0 f32, 1 bf16, 2 int8. D must be 64
// and H / KV <= 8 (checked by the Python wrapper).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* lens, void* out, int B, int T,
                                int H, int KV, int q_dtype, int kv_dtype,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, ks, vs, lens, out, B, T, H, KV, scale, s);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t>(q, k, v, ks, vs, lens, out, B, T, H, KV, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, lens, out, B, T, H, KV, scale, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, lens, out, B, T, H, KV, scale, s);
  return (int)cudaErrorInvalidValue;
}
