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
// Both bodies hold 64 query rows a block (query position r / G of the q
// block, grouped head r % G: 64 / G positions), stream the cache as
// stored (int8 dequantized in-kernel) and split the key blocks of a q
// block over blocks where (q blocks x KV heads) alone would give a grid of
// under about two blocks per SM; the last block to arrive merges the
// partials in the same launch.
//  - bf16 queries (the bf16 and int8 caches of the bf16 serving path): the
//    tensor-core body of flash_mma.cuh (shared with MHA flash attention)
//    at 32-key blocks.
//  - f32 queries (the prefill of the float32 model, f32 and int8 caches):
//    the register-tiled CUDA-core body of flash_f32.cuh (shared with MHA
//    flash attention in f32) at 64-key blocks: TF32 tensor cores would not
//    hold the f32 checks of the fused cells.
#include "flash_f32.cuh"
#include "flash_mma.cuh"

// q: (B, S, H, D); k, v: (B, T, KV, D); ks, vs: (B, T, KV) f32 or null;
// start: (B,) int32 on the device; out: (B, S, H, D) in q's dtype; counts:
// (B, KV, ceil(S / BQ)) int32, zero before the launch, or null.
// BQ * (H / KV) <= 64; the key blocks (32 keys with bf16 queries, 64 with
// f32) of a q block split into groups of kbps over n_split <= 16 blocks;
// part_o (B * KV * n_q * n_split, 64, D) and part_ml (.., 64, 2) f32
// scratch and counters (B * KV * n_q,) int32, zero before the launch and
// left zero after it, when n_split > 1 (else null). q_dtype 0 f32 (the
// CUDA-core body), 1 bf16 (the tensor-core body). kv_dtype: 0 f32, 1 bf16,
// 2 int8 (a bf16 or int8 cache with bf16 queries, an f32 or int8 one with
// f32 queries). D is 64, 96, 112 or 128 and every row of q, k and v starts
// on 16 bytes (checked by the Python wrapper).
extern "C" int flash_gqa(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* start,
                         void* out, void* counts, void* part_o,
                         void* part_ml, void* counters, int B, int S, int T,
                         int H, int KV, int D, int BQ, int kbps, int n_split,
                         int q_dtype, int kv_dtype, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, ks, vs, start, out, counts, part_o, part_ml, counters, \
             B, S, T, H, KV, BQ, kbps, n_split, scale, s
#define BY_D(DD)                                                         \
  if (D == DD) {                                                         \
    if (q_dtype == 0 && kv_dtype == 0)                                   \
      return launch_f32<float, DD, true>(ARGS);                          \
    if (q_dtype == 0 && kv_dtype == 2)                                   \
      return launch_f32<int8_t, DD, true>(ARGS);                         \
    if (q_dtype == 1 && kv_dtype == 1)                                   \
      return launch_mma<__nv_bfloat16, DD, true>(ARGS);                  \
    if (q_dtype == 1 && kv_dtype == 2)                                   \
      return launch_mma<int8_t, DD, true>(ARGS);                         \
  }
  BY_D(64)
  BY_D(96)
  BY_D(112)
  BY_D(128)
#undef BY_D
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
