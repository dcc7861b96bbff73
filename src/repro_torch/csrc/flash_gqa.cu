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
// bound it (about a microsecond a layer). What a serving chunk really
// meets is latency: one launch, a few hundred live keys, 17 MFLOP.
//
// bf16 queries (the bf16 and int8 caches of the bf16 serving path) run on
// the tensor cores: the body of flash_mma.cuh (shared with MHA flash
// attention) at 32-key blocks, causal, 64 query rows per block (query
// position r / G, grouped head r % G); the wrapper splits the key blocks
// over blocks where (q blocks x KV heads x rows) alone would give a grid
// of under about two blocks per SM, and the last block to arrive merges.
// f32 queries (the prefill of the float32 model) keep the CUDA-core body
// rt::gqa_attend of attn_common.cuh: TF32 tensor cores would not hold the
// f32 checks of the fused cells.
#include "attn_common.cuh"
#include "flash_mma.cuh"

namespace {

// ------------------------------------------------ f32 queries (CUDA cores)
constexpr int BK = 32, F32_THREADS = 256;

template <typename KVT, int D, int RMAX>
__global__ void __launch_bounds__(F32_THREADS)
flash_kernel(const float* q, const KVT* k, const KVT* v, const float* ks,
             const float* vs, const int* start, float* out, int* counts,
             int S, int T, int H, int KV, int G, int BQ, int n_q,
             float scale) {
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  rt::gqa_attend<KVT, RMAX, BK, D, F32_THREADS>(
      q, k, v, ks, vs, out, counts, b, h, qb, n_q, BQ, G, S, T, H, KV,
      start[b], min(T, start[b] + S), scale);
}

template <typename KVT, int D, int RMAX>
int launch_f32(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* start, void* out, void* counts,
               int B, int S, int T, int H, int KV, int BQ, float scale,
               cudaStream_t s) {
  const int n_q = (S + BQ - 1) / BQ;
  flash_kernel<KVT, D, RMAX><<<dim3(n_q, KV, B), F32_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(start),
      static_cast<float*>(out), static_cast<int*>(counts), S, T, H, KV,
      H / KV, BQ, n_q, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, S, H, D); k, v: (B, T, KV, D); ks, vs: (B, T, KV) f32 or null;
// start: (B,) int32 on the device; out: (B, S, H, D) in q's dtype; counts:
// (B, KV, ceil(S / BQ)) int32, zero before the launch, or null.
// q_dtype 1 (bf16, the tensor-core body): BQ * (H / KV) <= 64; the key
// blocks of a q block split into groups of kbps over n_split <= 16 blocks;
// part_o (B * KV * n_q * n_split, 64, D) and part_ml (.., 64, 2) f32
// scratch and counters (B * KV * n_q,) int32, zero before the launch and
// left zero after it, when n_split > 1 (else null). q_dtype 0 (f32, the
// CUDA-core body): BQ * (H / KV) <= 56 at D 64 and <= 16 at D 128, and
// n_split == 1. kv_dtype: 0 f32, 1 bf16, 2 int8 (a bf16 or int8 cache
// with bf16 queries, an f32 or int8 one with f32 queries). D is 64 or 128
// and every row of q, k and v starts on 16 bytes (checked by the Python
// wrapper).
extern "C" int flash_gqa(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* start,
                         void* out, void* counts, void* part_o,
                         void* part_ml, void* counters, int B, int S, int T,
                         int H, int KV, int D, int BQ, int kbps, int n_split,
                         int q_dtype, int kv_dtype, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F32_ARGS q, k, v, ks, vs, start, out, counts, B, S, T, H, KV, BQ, \
                 scale, s
#define MMA_ARGS q, k, v, ks, vs, start, out, counts, part_o, part_ml, \
                 counters, B, S, T, H, KV, BQ, kbps, n_split, scale, s
  if (q_dtype == 0 && n_split == 1) {
    if (kv_dtype == 0 && D == 64) return launch_f32<float, 64, 56>(F32_ARGS);
    if (kv_dtype == 0 && D == 128) return launch_f32<float, 128, 16>(F32_ARGS);
    if (kv_dtype == 2 && D == 64) return launch_f32<int8_t, 64, 56>(F32_ARGS);
    if (kv_dtype == 2 && D == 128)
      return launch_f32<int8_t, 128, 16>(F32_ARGS);
  }
  if (q_dtype == 1) {
    if (kv_dtype == 1 && D == 64)
      return launch_mma<__nv_bfloat16, 64, true>(MMA_ARGS);
    if (kv_dtype == 1 && D == 128)
      return launch_mma<__nv_bfloat16, 128, true>(MMA_ARGS);
    if (kv_dtype == 2 && D == 64)
      return launch_mma<int8_t, 64, true>(MMA_ARGS);
    if (kv_dtype == 2 && D == 128)
      return launch_mma<int8_t, 128, true>(MMA_ARGS);
  }
#undef F32_ARGS
#undef MMA_ARGS
  return (int)cudaErrorInvalidValue;
}
