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
// f32: the register-tiled CUDA-core body of flash_f32.cuh (shared with the
// f32-query GQA prefill) with one head per row: 64 queries against 64-key
// blocks, 4 x 4 register tiles a thread, K and V of the next block in
// flight by cp.async; one block per q block (no split), TF32 would not
// hold the f32 tolerance.
#include "flash_f32.cuh"
#include "flash_mma.cuh"

namespace {

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
// f32: 64-key blocks and n_split 1. D must be 64, 96, 112 or 128 (checked
// by the Python wrapper). Returns cudaGetLastError() after the launch.
extern "C" int flash_mha(const void* q, const void* k, const void* v,
                         const void* start, void* out, void* counts,
                         void* part_o, void* part_ml, void* counters, int BH,
                         int S, int T, int D, int causal, int dtype,
                         int kbps, int n_split, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BF16_ARGS q, k, v, start, out, counts, part_o, part_ml, counters, \
                  BH, S, T, causal, kbps, n_split, scale, s
#define BY_D(DD)                                                          \
  if (D == DD && dtype == 0 && n_split == 1)                              \
    return (causal ? launch_f32<float, DD, true>                          \
                   : launch_f32<float, DD, false>)(                       \
        q, k, v, nullptr, nullptr, start, out, counts, nullptr, nullptr,  \
        nullptr, BH, S, T, 1, 1, FBQ, kbps, 1, scale, s);                 \
  if (D == DD && dtype == 1) return launch_bf16<DD>(BF16_ARGS);
  BY_D(64)
  BY_D(96)
  BY_D(112)
  BY_D(128)
#undef BY_D
#undef BF16_ARGS
  return (int)cudaErrorInvalidValue;
}
