// One mamba2 selective-scan decode step: conv-window roll, depthwise conv
// + bias, SiLU, state recurrence and readout.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py ssm_decode_step /
// _kernel (pl.pallas_call at :140). Per slot row b and head h:
//   conv[c]  = sum_w win[w, c] * conv_w[w, c] + conv_b[c]   (w = 0..width-1,
//              the cached rows then the current xbc row), all in f32
//   u[c]     = conv[c] * sigmoid(conv[c])
//   da       = exp(dt[b, h] * A[h])
//   state'   = state * da + (dt * x[p]) * B[n]              (P x N per head)
//   y[p]     = sum_n state'[p, n] * C[n] + D[h] * x[p]
// and the rolled window (cached rows 1.., then xbc) in the window's dtype.
// B and C are group 0's (ngroups == 1 in every config; the reference reads
// group 0 too). conv_w and conv_b come in f32 or in the window's dtype and
// are widened here, as the TPU kernel widens them (bf16 -> f32 is exact).
//
// Bound on the H100: bytes. The f32 state is read once and written once
// (2 * B * H * P * N * 4 bytes, 6.3 MB per layer at mamba2-130m's width
// and B = 4) and the step does five float operations per state element,
// far below the f32 peak. At that size a launch is a chain of latencies,
// and what lengthens it is the number of load requests a block waits on
// (tools/ssm_decode_time.py measures both), so the design issues
// every load at once and as few of them as it can:
//
// - A block takes `rows` state rows p of one (head, slot row): grid heads
//   x row groups by slot rows (ssm_decode_plan in kernels/ssm_scan.py; 384
//   blocks of 16 rows at mamba2-130m's B = 4, all resident). LANES lanes
//   stream a row (min(32, N)); lane l owns n = l, l + LANES, ...; a thread
//   holds up to MAX_RPT rows.
// - Every thread issues all of its loads before its first store, with
//   compile-time counts (N a template parameter for 16, 64 and 128, the
//   rows a thread holds predicated up to MAX_RPT): the state first, then
//   the conv operands, which arrive and are used under the state's
//   latency. Any other N takes the same body in chunks of LANES *
//   GENERIC_NL elements a row, each chunk's loads issued before its stores.
// - The conv: a block needs its rows' x channels and the 2N shared B and C
//   channels (every block recomputes B and C). A thread takes VW adjacent
//   channels of that list with one 8- or 16-byte load per tap, weight and
//   bias when the operands are aligned (else one channel, 4-byte loads):
//   18 requests a block at mamba2-130m instead of 72. SiLU'd values go to
//   shared memory. The rolled window is written from the same registers:
//   a block its x channels, block 0 of the slot row the B/C channels.
// - The state may be updated in place (state_out == state): each element
//   is read and written by one thread, and all of a thread's loads of a
//   chunk precede its stores.
// - y[p] sums over the lanes with the xor shuffle tree in one fixed order,
//   the order of the first design (lane l sums its n in ascending order,
//   then offsets LANES/2 .. 1), so y is what it was.
//
// Arithmetic keeps the reference's operation order with explicit rounding
// (no FMA contraction): (dt * x) * B, then state * da + upd; expf and IEEE
// division in the sigmoid, as torch computes them.
#include "common.cuh"

#ifdef SSM_CLOCK
// Stage probe (tools/ssm_decode_time.py --clock builds with this flag; the
// main build never does): thread 0 of every block reads %globaltimer at
// its start, after the prologue's barrier, once its state stores are
// issued and at its end, and writes the four stamps at the end (no store
// before the state loads).
constexpr int SSM_STAMPS = 4;
__device__ long long* ssm_clock_p = nullptr;
#define SSM_STAMP(i) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(clk_[i]))
#define SSM_CLOCK_WRITE()                                                  \
  do {                                                                     \
    if (threadIdx.x == 0 && ssm_clock_p != nullptr)                        \
      for (int i_ = 0; i_ < SSM_STAMPS; ++i_)                              \
        ssm_clock_p[((size_t)blockIdx.y * gridDim.x + blockIdx.x) *        \
                        SSM_STAMPS + i_] = clk_[i_];                       \
  } while (0)
#else
#define SSM_STAMP(i)
#define SSM_CLOCK_WRITE()
#endif

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RPT = 2;      // state rows a thread holds at most
constexpr int GENERIC_NL = 4;   // elements a lane holds per row: other N
constexpr int TAPS = 4;         // conv taps loaded together
constexpr int VW = 4;           // conv channels a thread takes, wide loads

// CPT adjacent elements of T in one load (CPT 1 or VW: 8 or 16 bytes)
template <typename T, int CPT> struct Raw { using type = T; };
template <> struct Raw<float, VW> { using type = float4; };
template <> struct Raw<__nv_bfloat16, VW> { using type = uint2; };

template <typename T, int CPT>
__device__ __forceinline__ typename Raw<T, CPT>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, CPT>::type*>(p);
}
template <typename T>
__device__ __forceinline__ void widen(const T& q, float (&v)[1]) {
  v[0] = rt::to_float(q);
}
__device__ __forceinline__ void widen(const float4& q, float (&v)[VW]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void widen(const uint2& q, float (&v)[VW]) {
  using bf2 = __nv_bfloat162;
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const bf2*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const bf2*>(&q.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// lanes on a row and elements a lane holds per row (per chunk for NT == 0)
template <int NT>
struct Geometry {
  static constexpr int LANES = NT == 0 ? 32 : (NT < 32 ? NT : 32);
  static constexpr int NL = NT == 0 ? GENERIC_NL : NT / LANES;
};

struct Args {
  const void *conv, *xbc, *conv_w, *conv_b;
  const float *dt, *a, *dskip, *state;
  float* y;
  void* conv_out;
  float* state_out;
  int H, P, N, G, conv_dim, win, groups, rows, rpt;
  bool vec;   // conv operands aligned for VW-wide loads
};

// taps TAPS..win of a channel (pointers at the channel) added to acc in
// window order: a conv wider than TAPS taps
template <typename T, typename WT>
__device__ float more_taps(const T* cwc, const T* xrc, const WT* wc,
                           int conv_dim, int win, float acc) {
  for (int w = TAPS; w <= win; ++w)
    acc = __fadd_rn(acc, __fmul_rn(rt::to_float(w < win ? cwc[w * conv_dim]
                                                        : *xrc),
                                   rt::to_float(wc[w * conv_dim])));
  return acc;
}

__device__ __forceinline__ float silu_bias(float acc, float bias) {
  acc = __fadd_rn(acc, bias);
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-acc)));
  return __fmul_rn(acc, sig);
}

template <typename T, typename WT, int NT, bool VEC>
__global__ void __launch_bounds__(THREADS)
ssm_decode_kernel(const T* conv, const T* xbc, const WT* conv_w,
                  const WT* conv_b, const float* dt, const float* a,
                  const float* dskip, const float* state, float* y,
                  T* conv_out, float* state_out, int H, int P, int N_, int G,
                  int conv_dim, int win, int groups, int rows, int rpt) {
  constexpr int LANES = Geometry<NT>::LANES, NL = Geometry<NT>::NL;
  constexpr int CHUNK = LANES * NL;
  constexpr int SLICES = THREADS / LANES;   // rows a block streams at once
  constexpr int CPT = VEC ? VW : 1;         // conv channels a thread loads
  const int N = NT ? NT : N_;
#ifdef SSM_CLOCK
  long long clk_[SSM_STAMPS];
#endif
  SSM_STAMP(0);
  // the block's conv channels: its rows' x channels, then B, then C
  extern __shared__ float sm[];
  float* xs = sm;              // (rows,) SiLU'd x of the block's rows
  float* bm = sm + rows;       // (N,) B
  float* cm = bm + N;          // (N,) C
  const int n_ch = rows + 2 * N;
  const int h = blockIdx.x / groups, p0 = (blockIdx.x % groups) * rows;
  const int b = blockIdx.y;
  const int slice = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int d_inner = H * P;
  const T* cw = conv + (size_t)b * win * conv_dim;
  const T* xr = xbc + (size_t)b * conv_dim;
  T* co = conv_out + (size_t)b * win * conv_dim;
  auto channel = [&](int i) {
    return i < rows ? h * P + p0 + i
                    : d_inner + (i < rows + N ? i - rows
                                              : G * N + (i - rows - N));
  };
  // a block writes the rolled window of its x channels; block 0 of the slot
  // row that of B and C
  auto rolls = [&](int i) { return i < rows || blockIdx.x == 0; };
  // this thread's state elements: rows p0 + r * SLICES + slice, elements
  // n0 + k * LANES + lane (compile-time offsets from one base for NT > 0)
  const size_t base = (((size_t)b * H + h) * P + p0 + slice) * N + lane;
  const float* src = state + base;
  float* dst = state_out + base;
  bool row_ok[MAX_RPT];
#pragma unroll
  for (int r = 0; r < MAX_RPT; ++r)
    row_ok[r] = r < rpt && p0 + r * SLICES + slice < P;

  // 1. every load of the block in flight before any store: the state rows
  // (the first chunk), the scalars, then the taps, weights and bias of this
  // thread's CPT conv channels (with aligned operands one 8- or 16-byte
  // load each). Taps past the window's end read as 0 (a 0 added changes no
  // sum).
  float s[MAX_RPT][NL];
  auto load = [&](int n0) {
#pragma unroll
    for (int r = 0; r < MAX_RPT; ++r) {
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const bool in = NT || n0 + k * LANES + lane < N;
        s[r][k] = row_ok[r] && in ? src[r * SLICES * N + n0 + k * LANES]
                                  : 0.0f;
      }
    }
  };
  load(0);
  const float dt1 = dt[b * H + h];
  const float ah = a[h], dsk = dskip[h];

  const int i0 = threadIdx.x * CPT;   // this thread's first conv channel
  const bool mine = i0 < n_ch && (i0 >= rows || p0 + i0 < P);
  const int c0 = channel(i0);
  typename Raw<T, CPT>::type tv[TAPS] = {};
  typename Raw<WT, CPT>::type tw[TAPS] = {}, tb{};
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    if (mine && t <= win) {
      tv[t] = load_raw<T, CPT>(t < win ? cw + t * conv_dim + c0 : xr + c0);
      tw[t] = load_raw<WT, CPT>(conv_w + t * conv_dim + c0);
    }
  }
  if (mine) tb = load_raw<WT, CPT>(conv_b + c0);

  // 2. conv + SiLU into shared memory (taps summed in window order), and
  // the rolled window: row t - 1 takes tap t
  if (mine) {
    float acc[CPT], v[CPT], w[CPT];
    widen(tv[0], v);
    widen(tw[0], w);
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[k] = __fmul_rn(v[k], w[k]);
#pragma unroll
    for (int t = 1; t < TAPS; ++t) {
      widen(tv[t], v);
      widen(tw[t], w);
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], w[k]));
      if (t <= win && rolls(i0))
        *reinterpret_cast<typename Raw<T, CPT>::type*>(
            co + (t - 1) * conv_dim + c0) = tv[t];
    }
    widen(tb, w);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (win >= TAPS)
        acc[k] = more_taps(cw + c0 + k, xr + c0 + k, conv_w + c0 + k,
                           conv_dim, win, acc[k]);
      sm[i0 + k] = silu_bias(acc[k], w[k]);
    }
  }
  // what one pass does not cover: a window wider than TAPS, more channels
  // than the block's threads take
  if (win >= TAPS && mine && rolls(i0)) {
    for (int k = 0; k < CPT; ++k)
      for (int t = TAPS; t <= win; ++t)
        co[(t - 1) * conv_dim + c0 + k] =
            t < win ? cw[t * conv_dim + c0 + k] : xr[c0 + k];
  }
  for (int i = THREADS * CPT + threadIdx.x; i < n_ch; i += THREADS) {
    if (i < rows && p0 + i >= P) continue;
    const int c = channel(i);
    float acc = 0.0f;
    for (int t = 0; t <= win; ++t) {
      const T v = t < win ? cw[t * conv_dim + c] : xr[c];
      if (t > 0 && rolls(i)) co[(t - 1) * conv_dim + c] = v;
      const float p = __fmul_rn(rt::to_float(v),
                                rt::to_float(conv_w[t * conv_dim + c]));
      acc = t == 0 ? p : __fadd_rn(acc, p);
    }
    sm[i] = silu_bias(acc, rt::to_float(conv_b[c]));
  }
  __syncthreads();
  SSM_STAMP(1);

  // 3. the recurrence and the lanes' partial readouts, chunk by chunk
  const float da = expf(__fmul_rn(dt1, ah));
  float ya[MAX_RPT];
#pragma unroll
  for (int r = 0; r < MAX_RPT; ++r) ya[r] = 0.0f;
  const int n_chunks = NT ? 1 : (N + CHUNK - 1) / CHUNK;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int n0 = ch * CHUNK;
    if (ch > 0) load(n0);
#pragma unroll
    for (int r = 0; r < MAX_RPT; ++r) {
      if (row_ok[r]) {
        const float dx = __fmul_rn(dt1, xs[r * SLICES + slice]);
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          const int n = n0 + k * LANES + lane;
          if (NT || n < N) {
            const float v = __fadd_rn(__fmul_rn(s[r][k], da),
                                      __fmul_rn(dx, bm[n]));
            dst[r * SLICES * N + n0 + k * LANES] = v;
            ya[r] = __fadd_rn(ya[r], __fmul_rn(v, cm[n]));
          }
        }
      }
    }
  }
  SSM_STAMP(2);

  // 4. y: the shuffle tree over a row's lanes (offsets outermost, so the
  // rows' shuffles of one step are independent); r < rpt is warp-uniform
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < MAX_RPT; ++r) {
      if (r < rpt)
        ya[r] = __fadd_rn(ya[r], __shfl_xor_sync(0xffffffffu, ya[r], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAX_RPT; ++r) {
      const int pl = r * SLICES + slice;
      if (row_ok[r])
        y[(size_t)b * d_inner + h * P + p0 + pl] =
            __fadd_rn(ya[r], __fmul_rn(dsk, xs[pl]));
    }
  }
  SSM_STAMP(3);
  SSM_CLOCK_WRITE();
}

template <typename T, typename WT, int NT>
int launch(const Args& g, int B, cudaStream_t s) {
  const size_t smem = (size_t)(g.rows + 2 * g.N) * sizeof(float);
  auto kernel = g.vec ? ssm_decode_kernel<T, WT, NT, true>
                      : ssm_decode_kernel<T, WT, NT, false>;
  kernel<<<dim3(g.H * g.groups, B), THREADS, smem, s>>>(
      static_cast<const T*>(g.conv), static_cast<const T*>(g.xbc),
      static_cast<const WT*>(g.conv_w), static_cast<const WT*>(g.conv_b),
      g.dt, g.a, g.dskip, g.state, g.y, static_cast<T*>(g.conv_out),
      g.state_out, g.H, g.P, g.N, g.G, g.conv_dim, g.win, g.groups, g.rows,
      g.rpt);
  return (int)cudaGetLastError();
}

template <int NT>
int by_dtype(const Args& g, int B, int conv_dtype, int w_dtype,
             cudaStream_t s) {
  if (conv_dtype == 0 && w_dtype == 0)
    return launch<float, float, NT>(g, B, s);
  if (conv_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float, NT>(g, B, s);
  if (conv_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, NT>(g, B, s);
  return (int)cudaErrorInvalidValue;
}

template <int NT>
int plan_ok(int N, int lanes, int threads, int rows, int rpt) {
  return (NT == 0 || NT == N) && lanes == Geometry<NT>::LANES &&
         threads == THREADS && rpt >= 1 && rpt <= MAX_RPT &&
         rows == rpt * (THREADS / lanes);
}

template <int NT>
int run(const Args& g, int B, int conv_dtype, int w_dtype, int lanes,
        int threads, cudaStream_t s) {
  if (!plan_ok<NT>(g.N, lanes, threads, g.rows, g.rpt))
    return (int)cudaErrorInvalidValue;
  return by_dtype<NT>(g, B, conv_dtype, w_dtype, s);
}

}  // namespace

#ifdef SSM_CLOCK
extern "C" int ssm_clock_set(void* p) {
  return (int)cudaMemcpyToSymbol(ssm_clock_p, &p, sizeof(p));
}
#endif

// conv: (B, win, conv_dim) and xbc: (B, 1, conv_dim), both in one dtype
// (0 f32, 1 bf16); conv_w: (win + 1, conv_dim) and conv_b: (conv_dim,) in
// one dtype, f32 or the window's (w_dtype, same codes); dt: (B, H) f32
// (softplus applied); a, d: (H,) f32; state, state_out: (B, H, P, N) f32,
// may be the same buffer; y: (B, H * P) f32; conv_out: (B, win, conv_dim),
// not aliasing conv. All contiguous (checked by the Python wrapper). The
// launch plan (ssm_decode_plan): grid (H * groups, B), threads, rows a
// block and lanes a row; a plan that does not fit N's body is refused.
extern "C" int ssm_decode_step(const void* conv, const void* xbc,
                               const void* conv_w, const void* conv_b,
                               const void* dt, const void* a, const void* d,
                               const void* state, void* y, void* conv_out,
                               void* state_out, int B, int H, int P, int N,
                               int G, int conv_dim, int win, int conv_dtype,
                               int w_dtype, int grid_x, int grid_y,
                               int threads, int rows, int lanes,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid_y != B || grid_x % H != 0 || lanes <= 0 || threads % lanes != 0 ||
      rows % (threads / lanes) != 0 || (long)(grid_x / H) * rows < P)
    return (int)cudaErrorInvalidValue;
  // VW-wide conv loads: every tap row, a head's x channels and the B and
  // C halves start on a VW-element boundary (rows is a multiple of 8), and
  // the bases are aligned to VW elements
  const int ts = conv_dtype == 1 ? 2 : 4, ws = w_dtype == 1 ? 2 : 4;
  auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = N % VW == 0 && P % VW == 0 && conv_dim % VW == 0 &&
                   aligned(conv, VW * ts) && aligned(xbc, VW * ts) &&
                   aligned(conv_out, VW * ts) && aligned(conv_w, VW * ws) &&
                   aligned(conv_b, VW * ws);
  const Args g{conv, xbc, conv_w, conv_b, static_cast<const float*>(dt),
               static_cast<const float*>(a), static_cast<const float*>(d),
               static_cast<const float*>(state), static_cast<float*>(y),
               conv_out, static_cast<float*>(state_out), H, P, N, G,
               conv_dim, win, grid_x / H, rows, rows / (threads / lanes),
               vec};
  switch (N) {
    case 16: return run<16>(g, B, conv_dtype, w_dtype, lanes, threads, s);
    case 64: return run<64>(g, B, conv_dtype, w_dtype, lanes, threads, s);
    case 128: return run<128>(g, B, conv_dtype, w_dtype, lanes, threads, s);
    default: return run<0>(g, B, conv_dtype, w_dtype, lanes, threads, s);
  }
}
