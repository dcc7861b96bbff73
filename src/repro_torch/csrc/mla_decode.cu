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
// Bound on the H100. Per head and live key the function does 2 (L + R)
// operations for the score and 2 L for the weighted latent row; at
// deepseek-v2 width, B = 4 and the serving lengths that is about 208 M a
// step (4 layers): 3.1 us in f32 at 67 TFLOP/s, 0.2 us on the bf16 tensor
// cores (twice that with p as two bf16 halves), against about 7.9 MB a
// step of live cache, queries and outputs (2.4 us at 3.35 TB/s). So on the
// tensor cores the bytes bound it, and what one launch meets is latency.
//
// bf16 operands (the full-width model, cell F): the tensor-core body. Per
// batch row the H heads are the M dimension of two products against the
// same key tile: S = [q_lat | q_rope] . [ckv | krope]^T and O += P . ckv.
//  - a block holds 16 heads (one m16 tile; head rows past H zero, never
//    written) of one batch row and a range of 32-key tiles; the key tiles
//    of a row split over blocks until the grid (n_split, head groups, B)
//    reaches about two blocks per SM (mla_decode_plan), and the last block
//    of a (row, head group) to arrive merges the f32 (m, l, acc) partials
//    in the same launch (rt::merge_splits, as the flash kernels do).
//  - each key tile ([ckv | krope] rows, 32 x (L + R) bf16) goes into
//    shared memory once per block by cp.async, in a ring of three (the
//    next two tiles in flight while this one is used: at the split of cell
//    F every tile of a block is in flight from its start); all 16 heads
//    use it, as the score operand and (its ckv columns) as the value
//    operand.
//  - eight warps: warp w scores keys 8 (w % 4)..+7 of the tile for all 16
//    heads over half w / 4 of the depth L + R (mma.sync m16n8k16, bf16
//    in, f32 sums: products of bf16 operands are exact in f32, as the
//    reference's astype(f32) products are; Q fragments by ldmatrix once,
//    then held in registers, K by ldmatrix a tile); the two
//    halves meet in shared memory, and every warp runs the same online
//    softmax over the whole tile in registers (log2 units, one exp2 a
//    score). Warp w holds the 16-column slices w, w + 8, .. of O (16 heads
//    x 64 columns at L 512: 32 f32 registers a thread); P @ V takes ckv by
//    ldmatrix.trans and p as two bf16 MMAs, hi = bf16(p) and lo =
//    bf16(p - hi): about 16 bits of p, where the reference keeps p in f32.
//
// f32 operands (the reduced float32 model): the CUDA-core body. One block
// per (group of HG = 4 heads, batch row) walks the key tiles of BK = 32
// rows below lens[b]. Each latent tile (32 x L) and rope tile (32 x R) is
// loaded into shared memory once, with 16-byte loads and a padded row
// stride, and used twice: for the scores of all the block's heads and as
// the value operand. The score dot is split over the four warps by latent
// column range (each thread: one key, all four heads), the four partials
// summed in order; each warp then keeps one head's running max and
// denominator in registers, and every thread holds the f32 accumulator of
// L / 128 latent columns for all four heads.
#include "attn_mma.cuh"

namespace {

constexpr int LMAX = 512, RMAX = 64;   // widths the buffers are sized for

// ------------------------------------------------ f32 operands (CUDA cores)
constexpr int HG = 4;                  // heads per block
constexpr int NW = 4;                  // warps; warp w runs head w's softmax
constexpr int THREADS = NW * 32;
constexpr int BK = 32;                 // keys per tile, one per lane
constexpr int KC = LMAX / THREADS;     // latent columns per thread
static_assert(HG == NW, "one warp per head in the softmax");

constexpr size_t smem_floats(int L, int R) {
  return (size_t)HG * (L + R) + (size_t)BK * (L + 4) + (size_t)BK * (R + 4)
         + (size_t)NW * HG * BK + (size_t)HG * BK + 2 * HG;
}

// Rows [0, live) of a row-major (BK, W) f32 tile in device memory -> shared
// memory with row stride ld; rows past live are zero and never read.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int live, int W,
                                          float* __restrict__ dst, int ld) {
  constexpr int U = 4;                 // loads in flight per thread
  const int per_row = W / 4, total = BK * per_row;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int base = threadIdx.x; base < total; base += U * THREADS) {
    float4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      raw[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < total && i / per_row < live) raw[u] = __ldg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int j = i / per_row, c = (i - j * per_row) * 4;
        *reinterpret_cast<float4*>(dst + j * ld + c) = raw[u];
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

__global__ void __launch_bounds__(THREADS)
mla_f32_kernel(const float* __restrict__ q_lat,
               const float* __restrict__ q_rope,
               const float* __restrict__ ckv, const float* __restrict__ krope,
               const int* __restrict__ lens, float* __restrict__ out, int H,
               int Tn, int L, int R, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int QW = L + R, LP = L + 4, RP = R + 4;
  float* qs = smem;                    // [HG][QW] queries
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
      v = d < L ? q_lat[((size_t)b * H + head) * L + d]
                : q_rope[((size_t)b * H + head) * R + d - L];
    qs[e] = v;
  }
  float acc[KC][HG];
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int h = 0; h < HG; ++h) acc[k][h] = 0.0f;
  float m = rt::NEG_INF, l = 0.0f;     // softmax state of head h0 + warp
  const int dl = L / NW, dr = R / NW;  // this warp's share of the dot
  const float* ckv_b = ckv + (size_t)b * Tn * L;
  const float* kr_b = krope + (size_t)b * Tn * R;

  for (int j0 = 0; j0 < live; j0 += BK) {
    const int nk = min(BK, live - j0);
    __syncthreads();                   // the previous tile is consumed
    load_tile(ckv_b + (size_t)j0 * L, nk, L, ck, LP);
    load_tile(kr_b + (size_t)j0 * R, nk, R, kr, RP);
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
      s = lane < nk ? s * scale : rt::NEG_INF;
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
          out[((size_t)b * H + h0 + h) * L + c] =
              acc[k][h] / fmaxf(l_s[h], 1e-30f);
    }
  }
}

int launch_f32(const void* q_lat, const void* q_rope, const void* ckv,
               const void* krope, const void* lens, void* out, int B, int H,
               int Tn, int L, int R, float scale, cudaStream_t s) {
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(LMAX, RMAX) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((H + HG - 1) / HG, B);
  mla_f32_kernel<<<grid, THREADS, smem_floats(L, R) * sizeof(float), s>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const float*>(ckv), static_cast<const float*>(krope),
      static_cast<const int*>(lens), static_cast<float*>(out), H, Tn, L, R,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------- bf16 operands (tensor cores)
constexpr int TH = 16;                 // heads a block: the MMA's 16 rows
constexpr int TW = 8;                  // warps
constexpr int TTHREADS = 32 * TW;
constexpr int TBK = 32;                // keys a tile: 4 n-tiles of 8 keys
constexpr int TST = 3;                 // key tiles in shared memory: the ring
constexpr int SP = TBK + 8;            // floats a row of a score tile
constexpr int TMAX_SPLITS = 16;        // blocks a (row, head group) at most
constexpr int NPMAX = LMAX / 16 / TW;  // 16-column slices of O a warp, at most
constexpr int KSH = (LMAX + RMAX) / 32;  // k-steps of half the depth, most
static_assert(2 * TBK == 8 * TW, "warp w: keys 8 (w % 4).., half w / 4");

// bf16 elements a row of the Q and key tiles: ldmatrix rows land on
// distinct banks
__host__ __device__ constexpr int tc_pitch(int L, int R) { return L + R + 8; }

constexpr size_t tc_smem(int L, int R) {
  return (size_t)(TH + TST * TBK) * tc_pitch(L, R) * 2 +
         (size_t)2 * TH * SP * 4;
}

// q_lat (B, H, L), q_rope (B, H, R), ckv (B, Tn, L), krope (B, Tn, R),
// out (B, H, L), all bf16; grid (n_split, ceil(H / TH), B).
__global__ void __launch_bounds__(TTHREADS, 1)
mla_mma_kernel(const __nv_bfloat16* __restrict__ q_lat,
               const __nv_bfloat16* __restrict__ q_rope,
               const __nv_bfloat16* __restrict__ ckv,
               const __nv_bfloat16* __restrict__ krope,
               const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
               float* __restrict__ part_o, float* __restrict__ part_ml,
               int* __restrict__ counters, int H, int Tn, int L, int R,
               int kbps, int n_split, float scale) {
  extern __shared__ __align__(16) unsigned char tsm[];
  const int W = L + R, P = tc_pitch(L, R);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tsm);   // [TH][P]
  __nv_bfloat16* kt = qs + TH * P;             // [TST][TBK][P] ckv | krope
  float* ss = reinterpret_cast<float*>(kt + TST * TBK * P);  // [2][TH][SP]
  __shared__ float w_s[TMAX_SPLITS * TH], l_s[TMAX_SPLITS * TH];
  __shared__ int last_s;

  const int sp = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int h0 = hg * TH, rows = min(TH, H - h0);
  const int live = min(max(lens[b], 0), Tn);
  const int nkb = (live + TBK - 1) / TBK;
  const int kb0 = sp * kbps;
  // past the live keys; a row with none: block 0 writes its zeros
  if (kb0 >= nkb && sp > 0) return;
  const int n_t = max(min(kb0 + kbps, nkb) - kb0, 0);
  const int n_live = max((nkb + kbps - 1) / kbps, 1);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  // 16-byte chunks of a [lat | rope] row: L / 8 from the latent part
  const int cpr = W / 8, cl = L / 8;
  // 8 threads a row, neighbouring chunks: no division in the address
  for (int r = t >> 3; r < TH; r += TTHREADS >> 3) {
    const bool ok = r < rows;
    const size_t row = (size_t)b * H + (ok ? h0 + r : 0);
    for (int ch = t & 7; ch < cpr; ch += 8) {
      const __nv_bfloat16* src = ch < cl ? q_lat + row * L + ch * 8
                                         : q_rope + row * R + (ch - cl) * 8;
      rt::cp_async16(qs + r * P + ch * 8, src, ok);
    }
  }
  auto load_keys = [&](int kb, int st) {
    const int j0 = kb * TBK;
    __nv_bfloat16* dst = kt + st * TBK * P;
    for (int j = t >> 3; j < TBK; j += TTHREADS >> 3) {
      const bool ok = j0 + j < live;
      const size_t row = (size_t)b * Tn + (ok ? j0 + j : 0);
      for (int ch = t & 7; ch < cpr; ch += 8) {
        const __nv_bfloat16* src = ch < cl ? ckv + row * L + ch * 8
                                           : krope + row * R + (ch - cl) * 8;
        rt::cp_async16(dst + j * P + ch * 8, src, ok);
      }
    }
  };
  // the ring's fill: tiles 0 .. TST - 2 in flight, one commit group each
  // (the first with the Q tile; a group past the block's tiles is empty)
#pragma unroll
  for (int i = 0; i < TST - 1; ++i) {
    if (i < n_t) load_keys(kb0 + i, i);
    rt::cp_async_commit();
  }

  const float scale_log2 = scale * 1.4426950408889634f;
  // scores: warp w takes keys 8 (w % 4) .. + 7 over half w / 4 of the
  // k-steps; O: warp w holds the 16-column slices w, w + 8, .. of L
  const int kg = warp & 3, dh = warp >> 2, nks = W / 16;
  const int ks0 = dh ? nks / 2 : 0, ks1 = dh ? nks : nks / 2;
  const int n_sl = L / 16;
  uint32_t qf[KSH][4];                         // this warp's Q fragments
  float o[NPMAX][2][4];
#pragma unroll
  for (int i = 0; i < NPMAX; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] =
        o[i][n][3] = 0.0f;
  float m_r[2] = {rt::NEG_INF, rt::NEG_INF}, l_r[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_t; ++it) {
    const int st = it % TST;
    // tile it + TST - 1 into the stage that tile it - 1 left
    if (it + TST - 1 < n_t)
      load_keys(kb0 + it + TST - 1, (it + TST - 1) % TST);
    rt::cp_async_commit();
    rt::cp_async_wait<TST - 1>();              // tile it
    __syncthreads();
    const __nv_bfloat16* kS = kt + st * TBK * P;
    const int j0 = (kb0 + it) * TBK;
    if (it == 0) {                             // the Q tile has landed
      const __nv_bfloat16* qa = qs + (lane & 15) * P + (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < KSH; ++i)
        if (ks0 + i < ks1) rt::ldsm_x4(qf[i], qa + (ks0 + i) * 16);
    }
    {                                          // partial scores
      // two accumulators, the even and the odd k-steps (two chains of
      // dependent MMAs instead of one), summed at the end
      float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const __nv_bfloat16* kr = kS + (kg * 8 + (lane & 7)) * P + ks0 * 16;
#pragma unroll
      for (int i = 0; i < KSH; i += 2) {
        if (ks0 + i + 1 < ks1) {               // two k-steps
          uint32_t bf[4];
          rt::ldsm_x4(bf, kr + i * 16 + (lane >> 3) * 8);
          rt::mma_bf16(c[0], qf[i], bf[0], bf[1]);
          rt::mma_bf16(c[1], qf[i + 1], bf[2], bf[3]);
        } else if (ks0 + i < ks1) {            // an odd last k-step
          uint32_t bf[2];
          rt::ldsm_x2(bf, kr + i * 16 + ((lane >> 3) & 1) * 8);
          rt::mma_bf16(c[0], qf[i], bf[0], bf[1]);
        }
      }
      float* sh = ss + dh * TH * SP;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(sh + (g8 + 8 * r) * SP + kg * 8 + 2 * t4) =
            make_float2(c[0][2 * r] + c[1][2 * r],
                        c[0][2 * r + 1] + c[1][2 * r + 1]);
    }
    __syncthreads();
    // every warp: the online softmax of the 16 rows over the whole tile,
    // in the C-fragment layout (n-tile nt: keys 8 nt + 2 t4, +1; rows g8,
    // g8 + 8), the two halves summed in order: identical in every warp
    float sc[TBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TBK / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (g8 + 8 * r) * SP + nt * 8 + 2 * t4;
        const float2 x = *reinterpret_cast<const float2*>(ss + off);
        const float2 y = *reinterpret_cast<const float2*>(ss + TH * SP + off);
        const int key = j0 + nt * 8 + 2 * t4;
        sc[nt][2 * r] = key < live ? (x.x + y.x) * scale_log2 : rt::NEG_INF;
        sc[nt][2 * r + 1] =
            key + 1 < live ? (x.y + y.y) * scale_log2 : rt::NEG_INF;
      }
    float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
    for (int nt = 0; nt < TBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < TBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sc[nt][e];
        const float p = s == rt::NEG_INF ? 0.0f : exp2f(s - m_r[e >> 1]);
        l_r[e >> 1] += p;
        sc[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < NPMAX; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        o[i][n][0] *= alpha[0];
        o[i][n][1] *= alpha[0];
        o[i][n][2] *= alpha[1];
        o[i][n][3] *= alpha[1];
      }
    // P @ V over 16 keys a step; V = the tile's ckv columns of this warp
#pragma unroll
    for (int kc = 0; kc < TBK / 16; ++kc) {
      uint32_t a[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = sc[2 * kc + (i >> 1)][2 * (i & 1)];
        const float y = sc[2 * kc + (i >> 1)][2 * (i & 1) + 1];
        a[i] = rt::pack_bf16(x, y);
        alo[i] = rt::pack_bf16(x - rt::bf16_round(x), y - rt::bf16_round(y));
      }
      const __nv_bfloat16* vrow =
          kS + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
          (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < NPMAX; ++i) {
        const int sl = warp + TW * i;
        if (sl < n_sl) {
          uint32_t bf[4];
          rt::ldsm_x4_t(bf, vrow + sl * 16);
          rt::mma_bf16(o[i][0], a, bf[0], bf[1]);
          rt::mma_bf16(o[i][1], a, bf[2], bf[3]);
          rt::mma_bf16(o[i][0], alo, bf[0], bf[1]);
          rt::mma_bf16(o[i][1], alo, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                           // the stage and scores consumed
  }
  rt::cp_async_wait<0>();     // nothing in flight at exit (a row of no key)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const size_t bh = (size_t)b * gridDim.y + hg;
  if (n_live == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g8 + 8 * r;
      if (row >= rows) continue;
      const float inv = 1.0f / fmaxf(l_r[r], 1e-30f);
      __nv_bfloat16* dst = out + ((size_t)b * H + h0 + row) * L + 2 * t4;
#pragma unroll
      for (int i = 0; i < NPMAX; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          if (warp + TW * i < n_sl)
            *reinterpret_cast<__nv_bfloat162*>(
                dst + (warp + TW * i) * 16 + n * 8) =
                __floats2bfloat162_rn(o[i][n][2 * r] * inv,
                                      o[i][n][2 * r + 1] * inv);
    }
    return;
  }
  const size_t slot = bh * n_split + sp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g8 + 8 * r;
    if (row >= rows) continue;
    float* po = part_o + (slot * TH + row) * L + 2 * t4;
#pragma unroll
    for (int i = 0; i < NPMAX; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        if (warp + TW * i < n_sl)
          *reinterpret_cast<float2*>(po + (warp + TW * i) * 16 + n * 8) =
              make_float2(o[i][n][2 * r], o[i][n][2 * r + 1]);
    if (warp == 0 && t4 == 0) {
      // the merge weighs exp(m_i - m): the running max in natural units
      part_ml[(slot * TH + row) * 2] = m_r[r] * 0.6931471805599453f;
      part_ml[(slot * TH + row) * 2 + 1] = l_r[r];
    }
  }
  if (!rt::arrive_last(&counters[bh], n_live, &last_s)) return;
  constexpr int J = TH * LMAX / 4 / TTHREADS;  // float4 outputs a thread
  const int n4 = rows * (L / 4);
  float4 r4[J];
  rt::merge_splits<TTHREADS, J, 2>(
      part_ml + bh * n_split * TH * 2, TH * 2,
      part_o + bh * n_split * TH * L, (size_t)TH * L, n_live, rows, n4,
      L / 4, w_s, l_s, r4);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = t + j * TTHREADS;
    if (e >= n4) continue;
    const int row = e / (L / 4), c = (e % (L / 4)) * 4;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * H + h0 + row) * L + c);
    dst[0] = __floats2bfloat162_rn(r4[j].x, r4[j].y);
    dst[1] = __floats2bfloat162_rn(r4[j].z, r4[j].w);
  }
}

int launch_mma(const void* q_lat, const void* q_rope, const void* ckv,
               const void* krope, const void* lens, void* out, void* part_o,
               void* part_ml, void* counters, int B, int H, int Tn, int L,
               int R, int kbps, int n_split, float scale, cudaStream_t s) {
  static bool attr_set = false;        // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_smem(LMAX, RMAX));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(n_split, (H + TH - 1) / TH, B);
  mla_mma_kernel<<<grid, TTHREADS, tc_smem(L, R), s>>>(
      static_cast<const __nv_bfloat16*>(q_lat),
      static_cast<const __nv_bfloat16*>(q_rope),
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml),
      static_cast<int*>(counters), H, Tn, L, R, kbps, n_split, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat: (B, H, L); q_rope: (B, H, R); ckv: (B, T, L); krope: (B, T, R),
// all of one dtype (0 f32, 1 bf16), contiguous and 16-byte aligned;
// lens: (B,) int32 on the device; out: (B, H, L) in that dtype.
// L % 32 == 0, L <= 512, R % 16 == 0, R <= 64 (checked by the wrapper).
// bf16: the 32-key tiles of a batch row in groups of kbps over n_split <=
// 16 blocks; part_o (B * ceil(H / 16) * n_split, 16, L) and part_ml (.., 16,
// 2) f32 scratch and counters (B * ceil(H / 16),) int32, zero before the
// launch and left zero after it, when n_split > 1 (else null). f32: one
// block per (4 heads, batch row), n_split 1.
extern "C" int mla_decode_attention(const void* q_lat, const void* q_rope,
                                    const void* ckv, const void* krope,
                                    const void* lens, void* out, void* part_o,
                                    void* part_ml, void* counters, int B,
                                    int H, int T, int L, int R, int dtype,
                                    int kbps, int n_split, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L % 32 || L > LMAX || R % 16 || R > RMAX || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && n_split == 1)
    return launch_f32(q_lat, q_rope, ckv, krope, lens, out, B, H, T, L, R,
                      scale, s);
  if (dtype == 1 && n_split >= 1 && n_split <= TMAX_SPLITS)
    return launch_mma(q_lat, q_rope, ckv, krope, lens, out, part_o, part_ml,
                      counters, B, H, T, L, R, kbps, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
