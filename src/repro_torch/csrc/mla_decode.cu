// Absorbed MLA decode attention over the latent cache (deepseek-v2).
//
// Replaces the TPU kernel src/repro/kernels/mla_decode.py
// mla_decode_attention / _kernel (pl.pallas_call at :144). One query token
// per batch row, W_uk already folded into the query by the caller:
//
//   s[h, j]  = (q_lat[b, h] . ckv[b, j] + q_rope[b, h] . krope[b, j]) * scale
//   out[b, h] = sum_j softmax_j(s[h, :lens[b]]) * ckv[b, j]      (f32)
//
// keys at or past lens[b] are never read, lens[b] == 0 gives a zero row,
// the output is divided by max(l, 1e-30) and written in the queries' dtype.
//
// Bound on the H100: operations. Per head and live key the kernel does
// 2 * (L + R) operations for the score and 2 * L for the weighted latent
// row, all in f32 as the reference computes them (about 208 M at
// deepseek-v2 width, B = 4 and the serving lengths: 3.1 us at 67 TFLOP/s),
// against about 2 MB of live cache, queries and output (0.6 us at
// 3.35 TB/s).
//
// Design: one block per (group of HG = 4 heads, batch row); it walks the
// key tiles of BK = 32 rows below lens[b]. Each latent tile (32 x L) and
// rope tile (32 x R) is loaded into shared memory once, as f32 with 16-byte
// loads and a padded row stride (conflict-free for 32 lanes on 32 rows),
// and used twice: for the scores of all the block's heads and as the value
// operand - the one-pass structure of the Pallas kernel. The score dot is
// split over the four warps by latent column range (each thread: one key,
// all four heads, register-reused key values), the four partials summed in
// order; each warp then keeps one head's running max and denominator in
// registers (warp shuffles), and every thread holds the f32 accumulator of
// L / 128 latent columns for all four heads in registers. A head group
// re-reads the latent rows from L2 (H / 4 = 32 times at full width); that
// traffic is not in the bound. No split over keys and no tensor cores yet.
#include "common.cuh"

namespace {

constexpr int HG = 4;                  // heads per block
constexpr int NW = 4;                  // warps; warp w runs head w's softmax
constexpr int THREADS = NW * 32;
constexpr int BK = 32;                 // keys per tile, one per lane
constexpr int LMAX = 512, RMAX = 64;   // widths the buffers are sized for
constexpr int KC = LMAX / THREADS;     // latent columns per thread
constexpr float NEG_INF = -1e30f;
static_assert(HG == NW, "one warp per head in the softmax");

constexpr size_t smem_floats(int L, int R) {
  return (size_t)HG * (L + R) + (size_t)BK * (L + 4) + (size_t)BK * (R + 4)
         + (size_t)NW * HG * BK + (size_t)HG * BK + 2 * HG;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;          // elements per 16-byte load
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* v) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// Rows [0, live) of a row-major (BK, W) tile in device memory -> shared
// memory as f32 with row stride ld; rows past live are zero and never read.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int live,
                                          int W, float* __restrict__ dst,
                                          int ld) {
  constexpr int V = Vec<T>::N, U = 4;  // U loads in flight per thread
  const int per_row = W / V, total = BK * per_row;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int base = threadIdx.x; base < total; base += U * THREADS) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && i / per_row < live) raw[u] = __ldg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int j = i / per_row, c = (i - j * per_row) * V;
        float v[V];
        Vec<T>::unpack(raw[u], v);
#pragma unroll
        for (int k = 0; k < V; k += 4)
          *reinterpret_cast<float4*>(dst + j * ld + c + k) =
              make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
    }
  }
}

__device__ __forceinline__ void dot4(float* part, const float* q, int qw,
                                     float4 c) {
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    const float4 qv = *reinterpret_cast<const float4*>(q + h * qw);
    part[h] = fmaf(qv.x, c.x, part[h]);
    part[h] = fmaf(qv.y, c.y, part[h]);
    part[h] = fmaf(qv.z, c.z, part[h]);
    part[h] = fmaf(qv.w, c.w, part[h]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ ckv, const T* __restrict__ krope,
                  const int* __restrict__ lens, T* __restrict__ out, int H,
                  int Tn, int L, int R, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int QW = L + R, LP = L + 4, RP = R + 4;
  float* qs = smem;                    // [HG][QW] queries in f32
  float* ck = qs + HG * QW;            // [BK][LP] latent tile
  float* kr = ck + BK * LP;            // [BK][RP] rope-key tile
  float* sp = kr + BK * RP;            // [NW][HG][BK] partial scores
  float* ps = sp + NW * HG * BK;       // [HG][BK] probabilities
  float* a_s = ps + HG * BK;           // [HG] accumulator rescale
  float* l_s = a_s + HG;               // [HG] final denominators

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int h0 = blockIdx.x * HG, b = blockIdx.y;
  const int live = min(max(lens[b], 0), Tn);

  for (int e = t; e < HG * QW; e += THREADS) {
    const int hh = e / QW, d = e - hh * QW, head = h0 + hh;
    float v = 0.0f;
    if (head < H)
      v = d < L ? rt::to_float(q_lat[((size_t)b * H + head) * L + d])
                : rt::to_float(q_rope[((size_t)b * H + head) * R + d - L]);
    qs[e] = v;
  }
  float acc[KC][HG];
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int h = 0; h < HG; ++h) acc[k][h] = 0.0f;
  float m = NEG_INF, l = 0.0f;         // softmax state of head h0 + warp
  const int dl = L / NW, dr = R / NW;  // this warp's share of the dot
  const T* ckv_b = ckv + (size_t)b * Tn * L;
  const T* kr_b = krope + (size_t)b * Tn * R;

  for (int j0 = 0; j0 < live; j0 += BK) {
    const int nk = min(BK, live - j0);
    __syncthreads();                   // the previous tile is consumed
    load_tile<T>(ckv_b + (size_t)j0 * L, nk, L, ck, LP);
    load_tile<T>(kr_b + (size_t)j0 * R, nk, R, kr, RP);
    __syncthreads();
    {                                  // partial scores: key = lane
      float part[HG];
#pragma unroll
      for (int h = 0; h < HG; ++h) part[h] = 0.0f;
      const float* c = ck + lane * LP + warp * dl;
      const float* q = qs + warp * dl;
      for (int d = 0; d < dl; d += 4)
        dot4(part, q + d, QW, *reinterpret_cast<const float4*>(c + d));
      const float* kk = kr + lane * RP + warp * dr;
      const float* qr = qs + L + warp * dr;
      for (int d = 0; d < dr; d += 4)
        dot4(part, qr + d, QW, *reinterpret_cast<const float4*>(kk + d));
#pragma unroll
      for (int h = 0; h < HG; ++h) sp[(warp * HG + h) * BK + lane] = part[h];
    }
    __syncthreads();
    {                                  // online softmax of head h0 + warp
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += sp[(w * HG + warp) * BK + lane];
      s = lane < nk ? s * scale : NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m - m_new);
      l = l * alpha + sum;
      m = m_new;
      ps[warp * BK + lane] = p;
      if (lane == 0) a_s[warp] = alpha;
    }
    __syncthreads();
    float pv[KC][HG];                  // this tile's p @ ckv
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int h = 0; h < HG; ++h) pv[k][h] = 0.0f;
    for (int j = 0; j < nk; ++j) {
      float pj[HG];
#pragma unroll
      for (int h = 0; h < HG; ++h) pj[h] = ps[h * BK + j];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c = t + k * THREADS;
        if (c < L) {
          const float v = ck[j * LP + c];
#pragma unroll
          for (int h = 0; h < HG; ++h) pv[k][h] = fmaf(pj[h], v, pv[k][h]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int h = 0; h < HG; ++h)
        acc[k][h] = acc[k][h] * a_s[h] + pv[k][h];
  }
  if (lane == 0) l_s[warp] = l;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = t + k * THREADS;
    if (c < L) {
#pragma unroll
      for (int h = 0; h < HG; ++h)
        if (h0 + h < H)
          rt::store(&out[((size_t)b * H + h0 + h) * L + c],
                    acc[k][h] / fmaxf(l_s[h], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* lens, void* out, int B, int H,
           int Tn, int L, int R, float scale, cudaStream_t s) {
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(LMAX, RMAX) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((H + HG - 1) / HG, B);
  mla_decode_kernel<T><<<grid, THREADS, smem_floats(L, R) * sizeof(float),
                         s>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<const int*>(lens), static_cast<T*>(out), H, Tn, L, R,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat: (B, H, L); q_rope: (B, H, R); ckv: (B, T, L); krope: (B, T, R),
// all of one dtype (0 f32, 1 bf16), contiguous and 16-byte aligned;
// lens: (B,) int32 on the device; out: (B, H, L) in that dtype.
// L % 32 == 0, L <= 512, R % 16 == 0, R <= 64 (checked by the wrapper).
extern "C" int mla_decode_attention(const void* q_lat, const void* q_rope,
                                    const void* ckv, const void* krope,
                                    const void* lens, void* out, int B, int H,
                                    int T, int L, int R, int dtype,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L % 32 || L > LMAX || R % 16 || R > RMAX || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q_lat, q_rope, ckv, krope, lens, out, B, H, T, L, R,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_lat, q_rope, ckv, krope, lens, out, B, H,
                                 T, L, R, scale, s);
  return (int)cudaErrorInvalidValue;
}
