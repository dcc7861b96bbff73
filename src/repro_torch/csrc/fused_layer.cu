// One dense transformer layer's decode step as ONE cooperative kernel.
//
// Replaces the TPU kernel src/repro/kernels/fused_step.py fused_dense_layer
// / _kernel (pl.pallas_call at :327):
//
//   h1 = rmsnorm1(x);  q, k, v = proj(h1) + bias;  rope(q, k) at lens[b]
//   cache[b, lens[b]] <- k, v   (int8 codes + scale with an int8 cache)
//   a  = length-aware GQA attention of q over keys 0..lens[b] (the current
//        token included, read back from the cache as written)
//   x1 = x + proj_o(a);  h2 = rmsnorm2(x1)
//   out = x1 + proj_down(silu(proj_gate(h2)) * proj_up(h2))
//
// Each projection is the cim_matmul.cu contract (sim) or a plain f32 dot
// (off): xq = clip(rint(h / xs), +-qmax) with the batch-global activation
// scale xs = clip_k * (sqrt(mean(h^2)) + 1e-8) / qmax; an exact int32 dot
// per 1024-row macro tile; sigma * tile_gaussian(seed, tile, row, col) per
// tile; an f32 tile sum in tile order; times xs * ws. The seven noise
// seeds are the ctx.next_key() words in the order q, k, v, o, gate, up,
// down, read from device memory (seven rows of the forward's seed table,
// or a (7, 2) copy of host keys), so that a CUDA graph of the decode step
// replays with the seeds staged before each replay.
//
// Bound on the H100: the weight stream. At decode B <= 8 rows, so the layer
// moves its seven int8 planes and does about 2 * B operations per weight
// byte: at 3.35 TB/s 4.5 us a layer at qwen2-0.5b width (14.9 MB), 207 us
// at deepseek-67b's (692 MB). Every
// projection waits for the previous stage across the whole grid, because
// its activation scale is a reduction over the whole (B, K) input, so the
// layer is one cooperative launch (grid no larger than the co-resident
// block count) of five stages between four grid-wide barriers
// (cooperative_groups::this_grid().sync()), and each stage has to spread
// its bytes over every SM:
//
//   1. rmsnorm1 + q/k/v + bias + rope + the cache write at the old length;
//   2. attention, one item per (row, KV head, key range) with its G query
//      heads, online softmax over the live 32-key tiles of the range; the
//      last item of a (row, KV head) to arrive merges the ranges;
//   3. O + residual -> x1;
//   4. rmsnorm2 + gate and up, silu(g) * u -> hm;
//   5. down + residual -> out; lens += 1.
//
// Every projection stage runs the split-K GEMV of cim_gemv.cuh: a unit is
// 64 output columns in stages 3-5 and one head of hd columns in stage 1
// (so rope's (j, j + hd / 2) pairs and the int8 scale's max over the head
// stay in one block; heads of 96 and 112 columns ride a 128-column GEMV
// span whose lanes past the head load nothing), its K axis cut in
// splits inside macro tiles (the wrapper's fused_layer_plan: units x
// planes x splits reach the SM count), one split a work item, the items
// dealt to the blocks in turn. Each item writes its partial (int32 in sim
// mode: exact) and its share of the tile noise to the scratch and arrives
// on its unit's counter (the shared arrival counters, left at zero); the
// last to arrive merges the splits in tile order and runs the unit's
// epilogue (rope and the cache write, the residual, silu(g) * u) at once,
// so no stage needs an extra barrier. The stage probe
// (tools/fused_layer_clock.py, H100 80GB HBM3 at 700 W) put the earlier
// design's 164 us a layer (one block a unit, no splits) at 19 (q/k/v), 44
// (attention: 8 blocks walking ~300 keys each), 12 (o), 25 (gate/up) and
// 58 us (down: 5 macro tiles in series in 28 blocks), about 1.2 us a
// barrier; every stage is now split over the grid.
//
// Every block that needs a scale computes it itself in one fixed order (f64
// sums over a fixed thread mapping; for down's input the f64 sums of hm^2
// that stage 4's merges write per unit, added in unit order), so all
// blocks hold the same value on every run; there are no float atomics.
// Data written inside the launch is read with __ldcg (L2), never through
// the non-coherent read-only path. The wrapper allocates the scratch (q,
// attention output, x1, hm, partials, noise, attention pieces) and the
// outputs; the kernel allocates nothing. Rounding follows the plain
// version through the explicit-rounding intrinsics; the build never passes
// --use_fast_math. Off mode sums its f32 splits in another order than the
// plain version's matmul.
//
// The kernel's body is fused_layer.cuh, templated on the head dim (64, 96,
// 112, 128); this file compiles head dim 64 and holds the entry point,
// fused_layer_hd96.cu, fused_layer_hd112.cu and fused_layer_hd128.cu the
// other three.
#include "fused_layer.cuh"

FUSED_LAYER_INSTANCE(64)

#ifdef FUSED_LAYER_CLOCK
// The stage probe's stamp buffer, set in every head dim's file.
extern "C" int fused_layer_clock_set(void* p) {
  int e = fl::clock_set_hd64(p);
  if (e == 0) e = fl::clock_set_hd96(p);
  if (e == 0) e = fl::clock_set_hd112(p);
  if (e == 0) e = fl::clock_set_hd128(p);
  return e;
}
#endif

// One layer's decode step; p is a host struct (see fl::Params), p->grid is
// set to the blocks launched. Requires B <= 8, head dim p->hd one of 64, 96,
// 112 and 128, H / KV <= 8, d % 64 == 0, F % 64 == 0, 8-byte aligned int8
// planes or 16-byte aligned f32 weights, 16-byte aligned cache rows, klen[i]
// a multiple of 16 and at most 1024, scratch sized by
// kernels/fused_step.py fused_layer_plan (checked by the Python wrapper).
// Returns the launch's CUDA error code (a refused cooperative launch or a
// head dim outside the four included), 0 on success.
extern "C" int fused_dense_layer(void* params, void* stream) {
  fl::Params* p = static_cast<fl::Params*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->hd) {
    case 64: return fl::launch_hd64(p, s);
    case 96: return fl::launch_hd96(p, s);
    case 112: return fl::launch_hd112(p, s);
    case 128: return fl::launch_hd128(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
