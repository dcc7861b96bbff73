// Split-K decode GEMV on a weight plane, and the in-launch merge of its
// splits: the body shared by the fused CIM kernel (cim_matmul.cu, M <= 16
// rows) and every projection stage of the fused decode layer
// (fused_layer.cu).
//
// At decode the product has M = 1-16 rows, so a block does about 2 M
// operations per weight byte: the bound is the plane's bytes, and the
// design's one job is to keep enough of them in flight on every SM. The
// output columns are cut into units of NSPAN columns (32 or 64) and
// each unit's K axis into splits of `klen` rows (a multiple of 16) that
// never straddle a 1024-row macro tile (Splits); the wrapper's plan picks
// both so that the grid of units x splits reaches the SM count. A block
// runs one split: its threads read the plane with VB-byte vector loads
// (VB = 16, 8 or 4: 4 consecutive rows x VB bytes a thread, NSPAN / CPT
// threads across a row span), all loads of a batch (128 bytes a thread)
// in flight together, and the activation rows of the split are staged
// (quantized in sim mode) while those loads are on their way. int8 planes
// take __dp4a after a byte transpose in registers (__byte_perm); f32
// planes (the fused layer's off mode) take FMAs.
//
// The thread-rows of a warp fold their sums by shuffles, the warps
// through shared memory.
// Each split writes its partial (M x NSPAN, int32: exact) to its own slot
// of a scratch the wrapper allocates with torch.empty, draws its share of
// the unit's readout noise for its tile into a second scratch, and
// arrives on the unit's counter (rt::arrive_last, left at zero). The last
// block to arrive merges, all its threads at once (merge_unit): per
// output, in tile order, the tile's integer sum over its splits (any
// order: integers), then float(sum) + sigma * N_t, accumulated in f32.
// That is the rounding sequence of the plain version, so the noiseless
// result is bit-identical to it.
#pragma once

#include <type_traits>

#include "attn_mma.cuh"
#include "common.cuh"

namespace rt {

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int MACRO_ROWS = 1024;     // K rows of one macro tile

// How a unit's K axis is cut (mirrors kernels/cim_matmul.py
// split_geometry): split j covers rows [k0, k1) of macro tile j / spt;
// klen rows a split, spt = ceil(1024 / klen) splits a full tile, and
// ceil(len / klen) for the last, possibly shorter, tile.
struct Splits {
  int K, klen, spt, n_split, tiles;
  __host__ __device__ static Splits make(int K, int klen) {
    Splits s;
    s.K = K;
    s.klen = klen;
    s.spt = (MACRO_ROWS + klen - 1) / klen;
    s.tiles = (K + MACRO_ROWS - 1) / MACRO_ROWS;
    const int last = K - (s.tiles - 1) * MACRO_ROWS;
    s.n_split = (s.tiles - 1) * s.spt + (last + klen - 1) / klen;
    return s;
  }
  __device__ int tile(int j) const { return j / spt; }
  __device__ void range(int j, int& k0, int& k1) const {
    const int t = j / spt;
    k0 = t * MACRO_ROWS + (j - t * spt) * klen;
    k1 = min(k0 + klen, min((t + 1) * MACRO_ROWS, K));
  }
  __device__ int count(int t) const { return min(spt, n_split - t * spt); }
  // positions [lo, hi) of a unit's P outputs whose tile noise split j draws
  __device__ void noise_share(int j, int P, int& lo, int& hi) const {
    const int t = j / spt, n = count(t), jj = j - t * spt;
    lo = jj * P / n;
    hi = (jj + 1) * P / n;
  }
};

template <int VB> struct VecT;
template <> struct VecT<16> { using T = uint4; };
template <> struct VecT<8> { using T = uint2; };
template <> struct VecT<4> { using T = uint32_t; };

template <typename V>
__device__ __forceinline__ uint32_t word(const V& v, int i) {
  return reinterpret_cast<const uint32_t*>(&v)[i];
}

// One split's partial over plane rows [k0, k1) at columns [n0, n0 + NSPAN):
//   red[m * NSPAN + c] = sum_{k0 <= k < k1} xs[m][k - k0] * w[k][n0 + c]
// for m < M <= MB. SIM: int8 plane (K, N) row-major, xs the quantized
// activation (int8, row pitch xpitch bytes), int32 sums; else an f32
// plane and activation (row pitch xpitch floats), f32 sums. N % CPT == 0;
// k1 - k0 % 4 == 0. red: M * NSPAN values (SIM) or GV_WARPS * MB * NSPAN
// (f32: one slot a warp, summed in warp order). stage() runs once the
// first batch's loads are issued and before the barrier that publishes
// its shared-memory writes (the staged activation). NCOL < NSPAN: only
// columns [n0, n0 + NCOL) are read (a unit narrower than the power-of-two
// span, such as one head of 96 or 112 columns: the lanes past it load
// nothing and their sums stay 0).
template <bool SIM, int MB, int VB, int NSPAN, int NCOL = NSPAN, class Stage>
__device__ __forceinline__ void gemv_partial(const void* wv, int N, int k0,
                                             int k1, int n0, int M,
                                             const void* xsv, int xpitch,
                                             void* redv, Stage&& stage) {
  using AT = typename std::conditional<SIM, int, float>::type;
  using V = typename VecT<VB>::T;
  constexpr int ESZ = SIM ? 1 : 4;
  constexpr int CPT = VB / ESZ;          // columns a thread
  constexpr int U = 32 / VB;             // quads a batch: 128 bytes a thread
  constexpr int L = NSPAN / CPT;           // lanes across a row span
  constexpr int TR = GV_THREADS / L;       // thread-rows of the block
  constexpr int NV = MB * CPT;             // sums a thread
  static_assert(SIM || VB == 16, "f32 planes take 16-byte loads");
  static_assert(L >= 1 && L <= 32, "a row span within a warp");
  AT* red = static_cast<AT*>(redv);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = t % L, tr = t / L;
  const int col = n0 + c * CPT;
  static_assert(NCOL <= NSPAN && NCOL % CPT == 0, "whole lanes of the span");
  const bool col_ok = col < N && (NCOL == NSPAN || c * CPT < NCOL);
  const int nq = (k1 - k0) >> 2;
  const char* wb = static_cast<const char*>(wv);

  V w[U][4];
  auto load = [&](int q0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * TR;
      if (q < nq && col_ok) {
        const char* p = wb + ((size_t)(k0 + 4 * q) * N + col) * ESZ;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[u][i] = __ldg(reinterpret_cast<const V*>(p + (size_t)i * N * ESZ));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[u][i] = V{};
      }
    }
  };

  AT acc[NV];                              // [MB][CPT]
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0;

  __syncthreads();                     // xs and red free (earlier use)
  load(tr);
  if constexpr (SIM)
    for (int e = t; e < M * NSPAN; e += GV_THREADS) red[e] = 0;
  stage();
  __syncthreads();

  for (int q0 = tr; q0 < nq; q0 += U * TR) {
    if (q0 != tr) load(q0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + u * TR;
      if (q >= nq) break;
      if constexpr (SIM) {
        const int8_t* xq = static_cast<const int8_t*>(xsv) + 4 * q;
#pragma unroll
        for (int g = 0; g < VB / 4; ++g) {
          const uint32_t w0 = word(w[u][0], g), w1 = word(w[u][1], g);
          const uint32_t w2 = word(w[u][2], g), w3 = word(w[u][3], g);
          // rows k..k+3 x columns 4g..4g+3 -> per column the 4 k bytes
          const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
          const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
          const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
          const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
          const int wc[4] = {(int)__byte_perm(t0, t1, 0x5410),
                             (int)__byte_perm(t0, t1, 0x7632),
                             (int)__byte_perm(t2, t3, 0x5410),
                             (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            if (m < M) {
              const int xw =
                  *reinterpret_cast<const int*>(xq + (size_t)m * xpitch);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[m * CPT + 4 * g + j] =
                    __dp4a(xw, wc[j], acc[m * CPT + 4 * g + j]);
            }
          }
        }
      } else {
        const float* xf = static_cast<const float*>(xsv) + 4 * q;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if (m < M) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xv = xf[(size_t)m * xpitch + i];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[m * CPT + j] = fmaf(
                    xv, __uint_as_float(word(w[u][i], j)), acc[m * CPT + j]);
            }
          }
        }
      }
    }
  }

  // fold the thread-rows of a warp (lanes L apart): one shuffle step for
  // all the values at a time
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  // then the warps
  if (lane < L) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int m = i / CPT, col = c * CPT + i % CPT;
      if (m < M) {
        if constexpr (SIM)
          atomicAdd(&red[m * NSPAN + col], acc[i]);   // integers: exact
        else
          red[(warp * MB + m) * NSPAN + col] = acc[i];
      }
    }
  }
  __syncthreads();
  if constexpr (!SIM) {
    for (int e = t; e < M * NSPAN; e += GV_THREADS) {
      float s = red[e];
#pragma unroll
      for (int w2 = 1; w2 < GV_WARPS; ++w2) s += red[w2 * MB * NSPAN + e];
      red[e] = s;
    }
    __syncthreads();
  }
}

// Stage rows [0, M) x [k0, k1) of an activation into shared memory, four
// elements a step: ld4(r, k) returns the float4 at row r, columns k..k+3;
// put(r, k - k0, v) stores it. Each thread issues its loads of up to four
// steps before it stores any, so the staging costs one round trip.
// (k1 - k0) % 4 == 0.
template <class Ld4, class Put>
__device__ __forceinline__ void stage_rows(int M, int k0, int k1, Ld4&& ld4,
                                           Put&& put) {
  const int len4 = (k1 - k0) >> 2, n = M * len4;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * GV_THREADS) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * GV_THREADS, r = i / len4;
      if (i < n) v[u] = ld4(r, k0 + (i - r * len4) * 4);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * GV_THREADS, r = i / len4;
      if (i < n) put(r, (i - r * len4) * 4, v[u]);
    }
  }
}

// Quantize four activations (clip(rint(v / xs), +-q), IEEE division, half
// to even) into one int8 word.
__device__ __forceinline__ uint32_t quant4(const float4& v, float xs,
                                           float q) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w |= (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(__fdiv_rn(e[i], xs)),
                                                -q), q)
         << (8 * i);
  return w;
}

__device__ __forceinline__ float4 widen4(const float4& v) { return v; }
__device__ __forceinline__ float4 widen4(const uint2& v) {   // 4 bf16
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}

template <typename AT> struct Vec4Of;
template <> struct Vec4Of<int> { using T = int4; };
template <> struct Vec4Of<float> { using T = float4; };

// The unit's P outputs (P % 4 == 0) merged from its splits by the whole
// block: for each tile in order, G groups of threads sum disjoint sets of
// the tile's splits, four outputs a thread (16-byte loads, four of a
// thread's issued at a time), the group sums are added in group order
// through shared memory (red: GV_THREADS * 4 values), and group 0
// converts, adds the tile's noise (nz null: none) and accumulates in f32:
// sum_t (float(sum_{j in t} part[j]) + nz[t]). Where a group holds at most
// one split of a tile (G = spt), each thread loads its values one tile
// ahead. store(p, value) receives every output. part: [n_split][P]; nz:
// [tiles][P]; both written in this launch.
//
// CIM_DROP_SPLIT and CIM_TILE0_NOISE build two wrong merges (each tile's
// last split left out; every tile's sum given the first tile's noise) that
// tests/test_torch_gpu.py builds to show that its checks catch them; the
// port's build never sets them. (A merge that pairs each tile with another
// tile's noise, or sums the tiles out of order, differs from the right one
// only by f32 rounding: the same values are summed.)
template <typename AT, class Store>
__device__ __forceinline__ void merge_unit(const AT* part, const float* nz,
                                           const Splits& sp, int P, AT* red,
                                           Store&& store) {
  using V = typename Vec4Of<AT>::T;
  const int t = threadIdx.x, P4 = P >> 2;
  const int G = min(P4 >= GV_THREADS ? 1 : GV_THREADS / P4, sp.spt);
  const bool ahead = G == sp.spt;
  const int g = G > 1 ? t / P4 : 0;
  auto n_of = [&](int tile) {
#ifdef CIM_DROP_SPLIT
    return sp.count(tile) - (sp.count(tile) > 1);
#else
    return sp.count(tile);
#endif
  };
  auto noise_of = [&](int tile, int q) {
#ifdef CIM_TILE0_NOISE
    tile = 0;
#endif
    return __ldcg(reinterpret_cast<const float4*>(nz + (size_t)tile * P) + q);
  };
  for (int q0 = 0; q0 < P4; q0 += GV_THREADS) {
    const int q = q0 + (G > 1 ? t % P4 : t);
    const bool active = q < P4 && g < G;
    auto split_ptr = [&](int tile, int j) {
      return reinterpret_cast<const V*>(part + ((size_t)tile * sp.spt + j) *
                                                   P) + q;
    };
    const V zero{};
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // one tile ahead: this thread's split of the next tile and its noise
    V nv = zero;
    float4 nzv = zero4;
    if (ahead && active) {
      if (g < n_of(0)) nv = __ldcg(split_ptr(0, g));
      if (g == 0 && nz != nullptr) nzv = noise_of(0, q);
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int tile = 0; tile < sp.tiles; ++tile) {
      AT s[4] = {0, 0, 0, 0};
      float4 z = zero4;
      if (ahead) {
        s[0] = nv.x;
        s[1] = nv.y;
        s[2] = nv.z;
        s[3] = nv.w;
        z = nzv;
        nv = zero;
        if (active && tile + 1 < sp.tiles) {
          if (g < n_of(tile + 1)) nv = __ldcg(split_ptr(tile + 1, g));
          if (g == 0 && nz != nullptr) nzv = noise_of(tile + 1, q);
        }
      } else if (active) {
        const int n = n_of(tile);
        if (g == 0 && nz != nullptr) z = noise_of(tile, q);
        for (int j0 = g; j0 < n; j0 += 4 * G) {
          V v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + u * G;
            v[u] = j < n ? __ldcg(split_ptr(tile, j)) : zero;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            s[0] += v[u].x;
            s[1] += v[u].y;
            s[2] += v[u].z;
            s[3] += v[u].w;
          }
        }
      }
      if (G > 1) {
        __syncthreads();
        if (active) {
          for (int i = 0; i < 4; ++i) red[(g * P4 + q) * 4 + i] = s[i];
        }
        __syncthreads();
        if (active && g == 0) {
          for (int gg = 1; gg < G; ++gg) {
            for (int i = 0; i < 4; ++i) s[i] += red[(gg * P4 + q) * 4 + i];
          }
        }
      }
      if (active && g == 0) {
        const float zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sf;
          if constexpr (std::is_same<AT, int>::value)
            sf = __int2float_rn(s[i]);
          else
            sf = s[i];
          if (nz != nullptr) sf = __fadd_rn(sf, zs[i]);
          acc[i] = __fadd_rn(acc[i], sf);
        }
      }
    }
    if (active && g == 0) {
      for (int i = 0; i < 4; ++i) store(4 * q + i, acc[i]);
    }
  }
}

}  // namespace rt
