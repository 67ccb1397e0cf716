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
// the layer's cache slice in place): each thread reads its own states once
// before it writes them once.
//
// Design.  The TPU kernel walks sequence chunks as a sequential grid axis
// and keeps a (d_blk, N) state in VMEM scratch between them.  CUDA blocks
// run in no order, so the sequence is walked inside the block, whole (no
// chunks with a carry pass: that would compute every exp(dt * A) twice).
// To fill the card, each channel's N <= 16 states are split over kLanes = 4
// neighbouring lanes, NS <= 4 states a lane, with their slice of A in
// registers: at the model's shape (B 4, Din 8192) that is 131 072 threads,
// one resident wave of about 31 warps an SM (64 registers a thread, 4 CTAs
// an SM), where one thread a channel left 8.  A CTA of 256 threads covers
// 64 channels of one batch row and walks the sequence in rounds of kT = 16
// steps:
//   * staging, all threads together: xi and dt_raw of the round's steps and
//     channels, read coalesced along d one round ahead (into registers, so
//     the loads fly during the previous round's scan), become softplus(dt)
//     and dt * xi once per (step, channel) in shared memory -- the 4 lanes
//     of a channel then read the same word, a broadcast; B and C of the
//     round's steps go to shared memory too.  Each load reads float32 or
//     bfloat16 at its own width, picked by the array's dtype code;
//   * the scan: each lane updates its states step by step, exp(dt * A) as
//     one 2^x on the special-function unit of dt * (A log2 e), A scaled once
//     at the start; its NS-term partial of y goes to shared memory;
//   * the round's y -- the 4 partials summed -- goes out coalesced along d
//     during the next staging.
// What holds it back: the per-step chain (shared loads, the multiply-adds,
// the partial's store) at a fixed ~31 warps an SM; 64 registers, the most
// that keeps the grid in one wave, leave the compiler no room to overlap
// steps.  The exponentials are not the limit: a variant without them is
// hardly faster.  More lanes a channel (more threads, fewer registers
// each) is the next lever.

// Bound.  At the model's shape (S 2048, N 16; bf16 xi, B, C; f32 dt_raw
// and y) a launch moves about 0.67 GB (0.20 ms at 3.35 TB/s) and evaluates
// 1.2e9 exp / log on the special-function units (16 per SM per clock on
// sm_90), which at the 1.98 GHz boost clock take about 0.29 ms: the
// exponentials set the bound.
//
// Built without --use_fast_math (the scan's 2^x is the explicit
// ex2.approx.ftz; softplus keeps expf and log1pf).  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                  // lanes per channel
constexpr int kCh = 64;                    // channels per CTA
constexpr int kThreads = kCh * kLanes;     // 256
constexpr int kT = 16;                     // time steps per staged round
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t;
};

// Element i of a float32 (code 0) or bfloat16 (code 1) array, as float32:
// one address for both, then one load of the element's own width (bf16 is
// the top half of a float32).  The code is a kernel argument, the same in
// every thread, so the select costs no divergence.
__device__ __forceinline__ float ld(const void* p, long long i, int code) {
  const char* at = static_cast<const char*>(p) + (i << (2 - code));
  return code == 0 ? *reinterpret_cast<const float*>(at)
                   : __uint_as_float(uint32_t(*reinterpret_cast<const uint16_t*>(at)) << 16);
}

// 2^x on the special-function unit; a result below 2^-126 flushes to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int NS>
__device__ __forceinline__ void ld_states(const float* p, float (&out)[NS]) {
  if constexpr (NS == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (NS == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// NS states a lane: N <= kLanes * NS.
template <int NS>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_k(const void* __restrict__ xi, const void* __restrict__ dt,
                 const void* __restrict__ bm, const void* __restrict__ cm,
                 const float* __restrict__ A, const float* h0, void* __restrict__ y,
                 float* hT, int S, int Din, int N, Strides xs, Strides ds,
                 Strides bs, Strides cs, Strides ys, int xi_code, int dt_code,
                 int b_code, int c_code, int y_code) {
  constexpr int NP = kLanes * NS;                  // states padded
  constexpr int kRows = kThreads / kCh;            // steps staged in one pass of the CTA
  constexpr int kPer = kT / kRows;                 // (step, channel) cells a thread stages
  constexpr int kPerBC = (kT * NP + kThreads - 1) / kThreads;
  __shared__ float2 sDX[kT][kCh];                  // (softplus(dt), softplus(dt) * xi)
  // partial sums of y, one row per lane, padded against bank conflicts
  __shared__ float sY[kT][kLanes][kCh + 16];
  __shared__ __align__(16) float sB[kT][NP];
  __shared__ __align__(16) float sC[kT][NP];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = d0 + c;
  const bool live = d < Din;
  const long long state = ((long long)b * Din + d) * N;

  float a[NS], h[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int n = lane * NS + i;
    const bool in = live && n < N;
    a[i] = in ? A[(long long)d * N + n] * kLog2e : 0.f;
    h[i] = (in && h0 != nullptr) ? h0[state + n] : 0.f;
  }

  // A thread stages the cells (tq + kRows r, cq) of a round, r < kPer: the
  // warp's 32 neighbouring channels of one step at a time, coalesced.
  const int cq = threadIdx.x % kCh, tq = threadIdx.x / kCh;
  const bool cq_live = d0 + cq < Din;

  // y of the round that starts at t0 (nt steps), from sY
  auto y_of = [&](int tt) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v += sY[tt][l][cq];
    return v;
  };
  auto store_y = [&](int t0, int nt) {
    const long long at = b * ys.b + (long long)(t0 + tq) * ys.t + d0 + cq;
    if (y_code == 0) {
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (cq_live && tq + kRows * r < nt)
          static_cast<float*>(y)[at + r * kRows * ys.t] = y_of(tq + kRows * r);
    } else {
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (cq_live && tq + kRows * r < nt)
          static_cast<__nv_bfloat16*>(y)[at + r * kRows * ys.t] =
              __float2bfloat16(y_of(tq + kRows * r));
    }
  };
  // this thread's share of a round's inputs, loaded into registers one
  // round ahead so that the loads are in flight during the scan
  float rdt[kPer], rx[kPer], rb[kPerBC], rc[kPerBC];
  auto prefetch = [&](int t0) {
    const int nt = min(kT, S - t0);
    const long long at_d = b * ds.b + (long long)(t0 + tq) * ds.t + d0 + cq;
    const long long at_x = b * xs.b + (long long)(t0 + tq) * xs.t + d0 + cq;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const bool in = cq_live && tq + kRows * r < nt;
      rdt[r] = in ? ld(dt, at_d + r * kRows * ds.t, dt_code) : 0.f;
      rx[r] = in ? ld(xi, at_x + r * kRows * xs.t, xi_code) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kPerBC; ++r) {
      const int e = r * kThreads + threadIdx.x;
      const int tt = e / NP, n = e % NP;
      const bool in = e < kT * NP && tt < nt && n < N;
      const long long t = t0 + tt;
      rb[r] = in ? ld(bm, b * bs.b + t * bs.t + n, b_code) : 0.f;
      rc[r] = in ? ld(cm, b * cs.b + t * cs.t + n, c_code) : 0.f;
    }
  };

  if (S > 0) prefetch(0);
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int nt = min(kT, S - t0);
    __syncthreads();   // the last round's scan is done with sDX, sB, sC and sY
    if (t0 > 0) store_y(t0 - kT, kT);
    // softplus(dt) and dt * xi once per (step, channel)
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float v = rdt[r];
      const float dtv = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
      sDX[tq + kRows * r][cq] = make_float2(dtv, dtv * rx[r]);
    }
#pragma unroll
    for (int r = 0; r < kPerBC; ++r) {
      const int e = r * kThreads + threadIdx.x;
      if (e < kT * NP) {
        sB[e / NP][e % NP] = rb[r];
        sC[e / NP][e % NP] = rc[r];
      }
    }
    if (t0 + kT < S) prefetch(t0 + kT);
    __syncthreads();

    auto step = [&](int tt) {
      const float2 dx = sDX[tt][c];
      float bv[NS], cv[NS];
      ld_states<NS>(&sB[tt][lane * NS], bv);
      ld_states<NS>(&sC[tt][lane * NS], cv);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        h[i] = ex2(dx.x * a[i]) * h[i] + dx.y * bv[i];
        acc = fmaf(h[i], cv[i], acc);
      }
      sY[tt][lane][c] = acc;
    };
    if (nt == kT) {   // nt is uniform across the CTA
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < nt; ++tt) step(tt);
    }
  }
  __syncthreads();
  if (S > 0) {
    const int last = (S - 1) / kT * kT;
    store_y(last, S - last);
  }

#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int n = lane * NS + i;
    if (live && n < N) hT[state + n] = h[i];
  }
}

template <int NS>
int launch(const void* xi, const void* dt, const void* bm, const void* cm,
           const float* A, const float* h0, void* y, float* hT, int B, int S,
           int Din, int N, Strides xs, Strides ds, Strides bs, Strides cs,
           Strides ys, int xi_code, int dt_code, int b_code, int c_code,
           int y_code, cudaStream_t stream) {
  const dim3 grid((Din + kCh - 1) / kCh, B);
  selective_scan_k<NS><<<grid, kThreads, 0, stream>>>(
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
  if (N <= kLanes)
    return launch<1>(xi, dt, bm, cm, Af, h0f, y, hTf, B, S, Din, N, xs, ds, bs,
                     cs, ys, xi_code, dt_code, b_code, c_code, y_code, st);
  if (N <= 2 * kLanes)
    return launch<2>(xi, dt, bm, cm, Af, h0f, y, hTf, B, S, Din, N, xs, ds, bs,
                     cs, ys, xi_code, dt_code, b_code, c_code, y_code, st);
  return launch<4>(xi, dt, bm, cm, Af, h0f, y, hTf, B, S, Din, N, xs, ds, bs,
                   cs, ys, xi_code, dt_code, b_code, c_code, y_code, st);
}

}  // extern "C"
