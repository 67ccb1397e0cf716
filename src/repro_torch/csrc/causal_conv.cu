// Hopper (sm_90a) depthwise causal conv with its bias and SiLU, fused: the
// Mamba-1 mixer's conv of the port.
//
// It replaces no TPU kernel: the JAX package's mixer runs this conv as
// plain XLA operations, which the TPU compiler fuses on its own.  The
// port's plain version (models/layers.py causal_conv1d, then F.silu) is a
// dozen separate passes over (B, S, C): a cat of the state and x, a zero
// fill, a multiply and an add per tap, the bias add, the SiLU.  At
// falcon-mamba-7b's C 8192 they took about half of the mixer's elementwise
// device time.  The conv's width is 4, every Mamba config's.  For every
// batch row b, time step t and channel c, with xp the state's 3 rows (zeros
// when absent) followed by x:
//   acc = +0
//   acc = rnd(acc + rnd(w[i, c] * xp[b, t + i, c]))   for i = 0 .. 3
//   acc = rnd(acc + bias[c])                           (when given)
//   y[b, t, c] = rnd(acc / (1 + exp(-acc)))
// rnd rounding to x's dtype (float32 or bfloat16), which the state shares;
// w and bias (each float32 or bfloat16) are rounded to it first.  That is
// the plain composition step for step: taps from the oldest input, each
// product and partial sum rounded, ATen's SiLU formula in float32, so the
// result is the plain one bit for bit.  With float32 x the steps are
// __fmul_rn and __fadd_rn, which nvcc does not contract into an FMA.  With
// bf16 x the plain version computes each product and sum in float32 and
// rounds it to bf16; here they are bf16 operations on pairs of channels
// (PTX mul.rn.bf16x2, add.rn.bf16x2), each rounded once from the exact
// result.  The two agree for every bf16 input: rounding first to
// float32's 24 bits and then to bf16's 8 is the same as rounding once, for
// +, - and *, whenever 24 >= 2 * 8 + 2 (Figueroa, "When is double rounding
// innocuous?", SIGNUM 1995).  Only the SiLU leaves bf16, for float32's expf
// and division, and rounds back once.
//
// Layout.  x is read through its (batch, time) strides with a unit stride
// along C, so the mixer's xi -- the first half of each row of xz -- goes in
// without a copy; the state is (B, 3, C) through its own (batch, time)
// strides; w (4, C) and bias (C) are contiguous; y is a contiguous
// (B, S, C) tensor.  The kernel only reads the state: the caller
// writes the new one after it on the same stream.
//
// Bound.  The conv must read x once and write y once: 2U bytes, U one
// (B, S, C) tensor in x's dtype.  At falcon-mamba-7b's bf16 C 8192 that is
// 268 MB at B 1 x S 8192 (0.080 ms at 3.35 TB/s) and 2.15 GB at B 32 x S
// 2048 (0.64 ms).  The arithmetic comes close: the SiLU's expf and division
// are two special-function results an element (16 an SM a clock: 0.26 ms
// at B 32 x S 2048) and about twenty other instructions; the bf16 taps, in
// pairs, are a few.  Measured on an H100 at 700 W: 0.165 ms and 1.04 ms
// (48 % and 62 % of the byte bound), against 1.84 and 15.1 ms for the
// plain composition.
//
// Design.  A thread owns VEC neighbouring channels, one 16-byte load a row
// (8 bf16 or 4 float32 channels), so a warp reads 512 contiguous bytes of
// a row.  A CTA of 128 threads covers 128 * VEC channels over a tile of
// kTile = 64 time steps and walks the tile in chunks of kU = 8 rows: the
// chunk's 8 loads are in flight together, then the outputs are computed
// from a window of the last 4 rows held in registers and stored, 16
// bytes a row.  Each row of x is read from device memory once, plus 3
// rows a tile to start its window (under 5 % more, mostly from L2); the
// first tile's window comes from the state.  The grid,
// (C / (128 VEC)) * (S / 64) CTAs by B, is 1 024 CTAs at B 1 x S 8192 and
// 8 192 at B 32 x S 2048; at 96 registers a thread, 5 CTAs (20 warps) fit
// on an SM.  When C is not a multiple of VEC, or x's base or strides are
// not 16-byte aligned, the same kernel runs with one channel a thread.
//
// Built without --use_fast_math (expf and the IEEE division are ATen's).
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;      // time steps a CTA
constexpr int kU = 8;          // rows loaded together
constexpr int kW = 4;          // the conv's width

// Element i of a float32 (code 0) or bfloat16 (code 1) array, as float32.
__device__ __forceinline__ float ld(const void* p, long long i, int code) {
  return code == 0 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The unit of arithmetic: a float32, or a pair of neighbouring bf16
// channels on the vector path (a lone bf16 on the one-channel path).
template <typename T, int VEC> struct Lanes {
  using E = T;
  static constexpr int kN = VEC;
};
template <> struct Lanes<__nv_bfloat16, 8> {
  using E = __nv_bfloat162;
  static constexpr int kN = 4;
};

// Rounded once, to nearest even, from float32 values (one per lane of E).
template <typename E> __device__ __forceinline__ E cvt(const float* v);
template <> __device__ __forceinline__ float cvt<float>(const float* v) { return v[0]; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(const float* v) {
  return __float2bfloat16_rn(v[0]);
}
template <> __device__ __forceinline__ __nv_bfloat162 cvt<__nv_bfloat162>(const float* v) {
  return __floats2bfloat162_rn(v[0], v[1]);
}

// Products and sums, each rounded to nearest even.  An explicit .rn (the
// _rn intrinsics for float32, inline PTX for bf16) keeps the optimizer from
// fusing a product and a sum into one FMA, which rounds once where the
// plain version rounds twice; __hmul2 / __hadd2 carry no such guard.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d)
      : "h"(__bfloat16_as_ushort(a)), "h"(__bfloat16_as_ushort(b)));
  return __ushort_as_bfloat16(d);
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d)
      : "h"(__bfloat16_as_ushort(a)), "h"(__bfloat16_as_ushort(b)));
  return __ushort_as_bfloat16(d);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}
__device__ __forceinline__ __nv_bfloat162 pair(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof(u));
  return v;
}
__device__ __forceinline__ __nv_bfloat162 mul(__nv_bfloat162 a, __nv_bfloat162 b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return pair(d);
}
__device__ __forceinline__ __nv_bfloat162 add(__nv_bfloat162 a, __nv_bfloat162 b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return pair(d);
}

// ATen's SiLU in float32, rounded to the lane's type.
__device__ __forceinline__ float silu(float v) { return __fdiv_rn(v, __fadd_rn(1.f, expf(-v))); }
__device__ __forceinline__ __nv_bfloat16 silu(__nv_bfloat16 v) {
  return __float2bfloat16_rn(silu(__bfloat162float(v)));
}
__device__ __forceinline__ __nv_bfloat162 silu(__nv_bfloat162 v) {
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(silu(f.x), silu(f.y));
}

// N lanes of one row: one 16-byte access on the vector path.
template <typename E, int N>
struct alignas(N * sizeof(E)) Row {
  E v[N];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
causal_conv_silu_k(const T* __restrict__ x, const T* __restrict__ state,
                   const void* __restrict__ w, const void* __restrict__ bias,
                   T* __restrict__ y, int S, int C, int c_blocks, long long xs_b,
                   long long xs_t, long long ss_b, long long ss_t, int w_code,
                   int b_code) {
  using E = typename Lanes<T, VEC>::E;
  constexpr int N = Lanes<T, VEC>::kN;
  constexpr int kPer = VEC / N;    // channels a lane
  using R = Row<E, N>;
  const int b = blockIdx.y;
  const int cb = blockIdx.x % c_blocks;
  const int t0 = blockIdx.x / c_blocks * kTile;
  const int c0 = (cb * kThreads + threadIdx.x) * VEC;
  if (c0 >= C) return;   // VEC divides C on the vector path

  float f[kPer] = {};
  const E zero = cvt<E>(f);   // +0
  E wt[kW][N], bv[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[j] = ld(w, (long long)i * C + c0 + n * kPer + j, w_code);
      wt[i][n] = cvt<E>(f);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      f[j] = bias != nullptr ? ld(bias, c0 + n * kPer + j, b_code) : 0.f;
    bv[n] = cvt<E>(f);
  }

  const T* xb = x + b * xs_b + c0;
  // rows t0 - (kW - 1) .. t0 - 1: from x, or at t < 0 from the state
  R win[kW - 1 + kU];
#pragma unroll
  for (int r = 0; r < kW - 1; ++r) {
    const int t = t0 - (kW - 1) + r;
    if (t >= 0) {
      win[r] = *reinterpret_cast<const R*>(xb + t * xs_t);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          f[j] = state != nullptr
              ? to_f(state[b * ss_b + (t + kW - 1) * ss_t + c0 + n * kPer + j])
              : 0.f;
        win[r].v[n] = cvt<E>(f);
      }
    }
  }

  T* yb = y + ((long long)b * S) * C + c0;
  const int t_end = min(t0 + kTile, S);
  for (int tc = t0; tc < t_end; tc += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (tc + u < t_end) win[kW - 1 + u] = *reinterpret_cast<const R*>(xb + (tc + u) * xs_t);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      R out;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        // from +0, which turns a first product of -0 into +0 as the plain sum does
        E acc = add(zero, mul(wt[0][n], win[u].v[n]));
#pragma unroll
        for (int i = 1; i < kW; ++i) acc = add(acc, mul(wt[i][n], win[u + i].v[n]));
        if (bias != nullptr) acc = add(acc, bv[n]);
        out.v[n] = silu(acc);
      }
      if (tc + u < t_end) *reinterpret_cast<R*>(yb + (long long)(tc + u) * C) = out;
    }
#pragma unroll
    for (int r = 0; r < kW - 1; ++r) win[r] = win[kU + r];
  }
}

template <typename T, int VEC>
int launch(const T* x, const T* state, const void* w, const void* bias, T* y, int B,
           int S, int C, long long xs_b, long long xs_t, long long ss_b, long long ss_t,
           int w_code, int b_code, cudaStream_t stream) {
  const int c_blocks = (C + kThreads * VEC - 1) / (kThreads * VEC);
  const long long t_tiles = (S + kTile - 1) / kTile;
  if (c_blocks * t_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(c_blocks * t_tiles), B);
  causal_conv_silu_k<T, VEC><<<grid, kThreads, 0, stream>>>(
      x, state, w, bias, y, S, C, c_blocks, xs_b, xs_t, ss_b, ss_t, w_code, b_code);
  return (int)cudaGetLastError();
}

template <typename T>
int by_vec(const void* x, const void* state, const void* w, const void* bias, void* y,
           int B, int S, int C, long long xs_b, long long xs_t, long long ss_b,
           long long ss_t, int w_code, int b_code, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = C % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && xs_b % kVec == 0 && xs_t % kVec == 0;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(state);
  T* yt = static_cast<T*>(y);
  return vec ? launch<T, kVec>(xt, st, w, bias, yt, B, S, C, xs_b, xs_t, ss_b, ss_t,
                               w_code, b_code, stream)
             : launch<T, 1>(xt, st, w, bias, yt, B, S, C, xs_b, xs_t, ss_b, ss_t,
                            w_code, b_code, stream);
}

}  // namespace

extern "C" {

// x, state and y share one dtype; state and bias may be null (a zero
// state, no bias); w is (4, C).  Codes: 0 float32, 1 bfloat16.  S 0
// launches nothing.
int repro_causal_conv_silu(const void* x, const void* state, const void* w,
                           const void* bias, void* y, int B, int S, int C,
                           long long xs_b, long long xs_t, long long ss_b,
                           long long ss_t, int x_code, int w_code, int b_code,
                           void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int codes[3] = {x_code, w_code, b_code};
  for (int c : codes)
    if (c != 0 && c != 1) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_code == 0
      ? by_vec<float>(x, state, w, bias, y, B, S, C, xs_b, xs_t, ss_b, ss_t, w_code,
                      b_code, st)
      : by_vec<__nv_bfloat16>(x, state, w, bias, y, B, S, C, xs_b, xs_t, ss_b, ss_t,
                              w_code, b_code, st);
}

}  // extern "C"
