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
// group 0 too).
//
// Bound on the H100: bytes. The f32 state is read once and written once
// (2 * B * H * P * N * 4 bytes, 6.3 MB per layer at mamba2-130m's width
// and B = 4) and the step does five float operations per state element,
// far below the f32 peak. The design: one block per (head, row), 96 blocks
// at full width. The block first computes the conv + SiLU for its head's P
// x-channels and for the shared B and C channels into shared memory (every
// head recomputes B and C, 256 channels of 4 taps: cheap), then each warp
// takes state rows p in turn: its 32 lanes stream the row's N elements
// (coalesced 128-byte accesses), update them in registers, write them back
// and reduce y[p] over the lanes with a shuffle tree in one fixed order.
// The state may be updated in place (state_out == state): each element is
// read and written by one thread. The window is written to a separate
// buffer, because every head reads the B/C channels of the old window;
// head h writes its x-channels, head 0 the rest.
//
// Arithmetic keeps the reference's operation order with explicit rounding
// (no FMA contraction): (dt * x) * B, then state * da + upd; expf and IEEE
// division in the sigmoid, as torch computes them.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_decode_kernel(const T* conv, const T* xbc, const float* conv_w,
                  const float* conv_b, const float* dt, const float* a,
                  const float* dskip, const float* state, float* y,
                  T* conv_out, float* state_out, int H, int P, int N, int G,
                  int conv_dim, int win) {
  extern __shared__ float sm[];
  float* xs = sm;          // (P,) SiLU'd x channels of this head
  float* bm = sm + P;      // (N,) B
  float* cm = bm + N;      // (N,) C
  const int h = blockIdx.x, b = blockIdx.y;
  const int d_inner = H * P;
  const T* cw = conv + (size_t)b * win * conv_dim;
  const T* xr = xbc + (size_t)b * conv_dim;
  T* co = conv_out + (size_t)b * win * conv_dim;

  for (int i = threadIdx.x; i < P + 2 * N; i += blockDim.x) {
    const int c = i < P ? h * P + i
                        : (i < P + N ? d_inner + (i - P)
                                     : d_inner + G * N + (i - P - N));
    float acc = 0.0f;
#pragma unroll 4
    for (int w = 0; w <= win; ++w) {
      const float v = rt::to_float(w < win ? cw[(size_t)w * conv_dim + c]
                                           : xr[c]);
      const float p = __fmul_rn(v, conv_w[(size_t)w * conv_dim + c]);
      acc = w == 0 ? p : __fadd_rn(acc, p);
    }
    acc = __fadd_rn(acc, conv_b[c]);
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-acc)));
    sm[i] = __fmul_rn(acc, sig);
  }

  // the rolled window: row w takes cached row w + 1, the last row xbc
  for (int i = threadIdx.x; i < win * P; i += blockDim.x) {
    const int w = i / P, c = h * P + i % P;
    co[(size_t)w * conv_dim + c] =
        w + 1 < win ? cw[(size_t)(w + 1) * conv_dim + c] : xr[c];
  }
  if (h == 0) {
    const int rest = conv_dim - d_inner;
    for (int i = threadIdx.x; i < win * rest; i += blockDim.x) {
      const int w = i / rest, c = d_inner + i % rest;
      co[(size_t)w * conv_dim + c] =
          w + 1 < win ? cw[(size_t)(w + 1) * conv_dim + c] : xr[c];
    }
  }
  __syncthreads();

  const float dt1 = dt[b * H + h];
  const float da = expf(__fmul_rn(dt1, a[h]));
  const float dsk = dskip[h];
  const size_t base = ((size_t)b * H + h) * P * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int p = warp; p < P; p += nwarps) {
    const float dx = __fmul_rn(dt1, xs[p]);
    const float* src = state + base + (size_t)p * N;
    float* dst = state_out + base + (size_t)p * N;
    float acc = 0.0f;
#pragma unroll 4
    for (int n = lane; n < N; n += 32) {
      const float s = __fadd_rn(__fmul_rn(src[n], da), __fmul_rn(dx, bm[n]));
      dst[n] = s;
      acc = __fadd_rn(acc, __fmul_rn(s, cm[n]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0)
      y[(size_t)b * d_inner + h * P + p] = __fadd_rn(acc, __fmul_rn(dsk, xs[p]));
  }
}

template <typename T>
int launch(const void* conv, const void* xbc, const void* conv_w,
           const void* conv_b, const void* dt, const void* a, const void* d,
           const void* state, void* y, void* conv_out, void* state_out, int B,
           int H, int P, int N, int G, int conv_dim, int win, cudaStream_t s) {
  const size_t smem = (size_t)(P + 2 * N) * sizeof(float);
  ssm_decode_kernel<T><<<dim3(H, B), THREADS, smem, s>>>(
      static_cast<const T*>(conv), static_cast<const T*>(xbc),
      static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(d), static_cast<const float*>(state),
      static_cast<float*>(y), static_cast<T*>(conv_out),
      static_cast<float*>(state_out), H, P, N, G, conv_dim, win);
  return (int)cudaGetLastError();
}

}  // namespace

// conv: (B, win, conv_dim) and xbc: (B, 1, conv_dim), both in one dtype
// (0 f32, 1 bf16); conv_w: (win + 1, conv_dim) f32; conv_b: (conv_dim,)
// f32; dt: (B, H) f32 (softplus applied); a, d: (H,) f32; state, state_out:
// (B, H, P, N) f32, may be the same buffer; y: (B, H * P) f32; conv_out:
// (B, win, conv_dim), not aliasing conv. All contiguous (checked by the
// Python wrapper).
extern "C" int ssm_decode_step(const void* conv, const void* xbc,
                               const void* conv_w, const void* conv_b,
                               const void* dt, const void* a, const void* d,
                               const void* state, void* y, void* conv_out,
                               void* state_out, int B, int H, int P, int N,
                               int G, int conv_dim, int win, int conv_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conv_dtype == 0)
    return launch<float>(conv, xbc, conv_w, conv_b, dt, a, d, state, y,
                         conv_out, state_out, B, H, P, N, G, conv_dim, win, s);
  if (conv_dtype == 1)
    return launch<__nv_bfloat16>(conv, xbc, conv_w, conv_b, dt, a, d, state,
                                 y, conv_out, state_out, B, H, P, N, G,
                                 conv_dim, win, s);
  return (int)cudaErrorInvalidValue;
}
