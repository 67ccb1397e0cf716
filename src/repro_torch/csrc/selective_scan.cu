// Hopper (sm_90a) Mamba-1 selective scan: kernel K8 of the port.
//
// Replaces src/repro/kernels/selective_scan.py:_scan_kernel (and the
// pallas_call in selective_scan() that grids it).  For every batch row b
// and channel d, from the state h0[b, d, :] (zeros when absent):
//   dt = softplus(dt_raw[b, t, d]) = max(v, 0) + log1p(exp(-|v|))
//   h[n] = exp(dt * A[d, n]) * h[n] + (dt * xi[b, t, d]) * B[b, t, n]
//   y[b, t, d] = sum_n h[n] * C[b, t, n]
// over t = 0 .. S-1, and hT[b, d, :] = h after the last step.  Everything
// is float32 inside.  xi, dt_raw, B and C are each float32 or bfloat16 on
// their own (the model hands over bf16 xi, B, C and f32 dt_raw); A, h0 and
// hT are float32; y is written in the dtype the caller asks for.  softplus
// is JAX's form (logaddexp(v, 0)), not a thresholded one.
//
// Layout.  xi, dt_raw, B, C and y are addressed through their own (batch,
// time) strides in elements, with a unit stride along the last dim, so
// the model's B and C -- column slices of one (batch, S, R + 2N) tensor --
// are read in place, with no copy.  A is (Din, N) and h0, hT (batch, Din,
// N), contiguous.  hT may be the same memory as h0 (a decode step updates
// the layer's cache slice in place): each thread reads its own state once
// before it writes it once.
//
// Design.  The TPU kernel walks sequence chunks as a sequential grid axis
// and keeps a (d_blk, N) state in VMEM scratch between them.  CUDA blocks
// run in no order, so here each thread owns one (b, d) channel and walks
// the whole sequence itself, its N <= 16 states and its row of A in
// registers.  A CTA of 128 threads covers 128 channels of one batch row.
// Every round of kT = 16 steps, the CTA stages B[b, t, :] and C[b, t, :]
// for those steps in shared memory (read by all its channels), and each
// thread issues its 16 loads of xi and dt_raw at once (coalesced along d)
// before it runs the 16 steps, so one load latency covers 16 steps.  The
// sum over n stays in the thread.  y is stored each step, coalesced.
//
// Known weakness: occupancy.  At the model's shape (B 4, Din 8192) there
// are only 32 768 channels, 256 CTAs of 4 warps: about 8 warps an SM, so
// the exponentials and the per-step instruction stream are hidden only by
// the 16 independent states of each thread.  Splitting N across lanes (or
// the sequence into chunks with a second pass to carry the states) would
// fill the card; that is later work.
//
// Bound.  At the model's shape (S 2048, N 16; bf16 xi, B, C; f32 dt_raw
// and y) a launch moves about 0.67 GB (0.20 ms at 3.35 TB/s) and evaluates
// 1.07e9 exponentials exp(dt * A) on the special-function units (16 per SM
// per clock on sm_90), which at the 1.98 GHz boost clock take about 0.26 ms:
// the exponentials bound it.  Each exp is computed once and nothing but y
// and hT is written.
//
// Built without --use_fast_math (expf, log1pf).  The entry point launches
// on the caller's stream, allocates nothing and returns cudaGetLastError();
// the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;   // channels per CTA
constexpr int kT = 16;          // time steps per staged round

struct Strides {
  long long b, t;
};

// dtype codes: 0 float32, 1 bfloat16 (the branch is uniform across a warp)
__device__ __forceinline__ float ld(const void* p, long long i, int code) {
  return code == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void st(void* p, long long i, int code, float v) {
  if (code == 0)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
selective_scan_k(const void* __restrict__ xi, const void* __restrict__ dt,
                 const void* __restrict__ bm, const void* __restrict__ cm,
                 const float* __restrict__ A, const float* h0, void* __restrict__ y,
                 float* hT, int S, int Din, int N, Strides xs, Strides ds,
                 Strides bs, Strides cs, Strides ys, int xi_code, int dt_code,
                 int b_code, int c_code, int y_code) {
  __shared__ float sB[kT][NT];
  __shared__ float sC[kT][NT];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < Din;
  const long long state = ((long long)b * Din + d) * N;

  float a[NT], h[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bool in = live && n < N;
    a[n] = in ? A[(long long)d * N + n] : 0.f;
    h[n] = (in && h0 != nullptr) ? h0[state + n] : 0.f;
  }

  const long long xb = b * xs.b + d, db = b * ds.b + d, yb = b * ys.b + d;
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int nt = min(kT, S - t0);
    __syncthreads();   // the last round's reads of sB / sC are done
    for (int e = threadIdx.x; e < kT * NT; e += kThreads) {
      const int tt = e / NT, n = e % NT;
      const bool in = tt < nt && n < N;
      const long long t = t0 + tt;
      sB[tt][n] = in ? ld(bm, b * bs.b + t * bs.t + n, b_code) : 0.f;
      sC[tt][n] = in ? ld(cm, b * cs.b + t * cs.t + n, c_code) : 0.f;
    }
    float xr[kT], dr[kT];
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const bool in = live && tt < nt;
      const long long t = t0 + tt;
      xr[tt] = in ? ld(xi, xb + t * xs.t, xi_code) : 0.f;
      dr[tt] = in ? ld(dt, db + t * ds.t, dt_code) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      if (tt < nt) {   // uniform across the CTA
        const float v = dr[tt];
        const float dtv = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
        const float dx = dtv * xr[tt];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          h[n] = expf(dtv * a[n]) * h[n] + dx * sB[tt][n];
          acc += h[n] * sC[tt][n];
        }
        if (live) st(y, yb + (long long)(t0 + tt) * ys.t, y_code, acc);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < N) hT[state + n] = h[n];
  }
}

template <int NT>
int launch(const void* xi, const void* dt, const void* bm, const void* cm,
           const float* A, const float* h0, void* y, float* hT, int B, int S,
           int Din, int N, Strides xs, Strides ds, Strides bs, Strides cs,
           Strides ys, int xi_code, int dt_code, int b_code, int c_code,
           int y_code, cudaStream_t stream) {
  const dim3 grid((Din + kThreads - 1) / kThreads, B);
  selective_scan_k<NT><<<grid, kThreads, 0, stream>>>(
      xi, dt, bm, cm, A, h0, y, hT, S, Din, N, xs, ds, bs, cs, ys, xi_code,
      dt_code, b_code, c_code, y_code);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h0 may be null (zero state).  Codes: 0 float32, 1 bfloat16.
int repro_selective_scan(const void* xi, const void* dt, const void* bm,
                         const void* cm, const void* A, const void* h0,
                         void* y, void* hT, int B, int S, int Din, int N,
                         long long xs_b, long long xs_t, long long ds_b,
                         long long ds_t, long long bs_b, long long bs_t,
                         long long cs_b, long long cs_t, long long ys_b,
                         long long ys_t, int xi_code, int dt_code, int b_code,
                         int c_code, int y_code, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || Din <= 0 || N <= 0 || N > 16)
    return (int)cudaErrorInvalidValue;
  const int codes[5] = {xi_code, dt_code, b_code, c_code, y_code};
  for (int c : codes)
    if (c != 0 && c != 1) return (int)cudaErrorInvalidValue;
  const Strides xs{xs_b, xs_t}, ds{ds_b, ds_t}, bs{bs_b, bs_t};
  const Strides cs{cs_b, cs_t}, ys{ys_b, ys_t};
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 4)
    return launch<4>(xi, dt, bm, cm, Af, h0f, y, hTf, B, S, Din, N, xs, ds, bs,
                     cs, ys, xi_code, dt_code, b_code, c_code, y_code, st);
  if (N <= 8)
    return launch<8>(xi, dt, bm, cm, Af, h0f, y, hTf, B, S, Din, N, xs, ds, bs,
                     cs, ys, xi_code, dt_code, b_code, c_code, y_code, st);
  return launch<16>(xi, dt, bm, cm, Af, h0f, y, hTf, B, S, Din, N, xs, ds, bs,
                    cs, ys, xi_code, dt_code, b_code, c_code, y_code, st);
}

}  // extern "C"
