// Hopper (sm_90a) RMSNorm and fused residual RMSNorm: kernels K6 and K7 of
// the port.
//
// K6 replaces src/repro/kernels/rmsnorm.py:_rmsnorm_kernel:
//   out = x * rsqrt(mean(x^2) + eps) * scale
// K7 replaces src/repro/kernels/rmsnorm.py:_rmsnorm_residual_kernel:
//   h = x + r (float32);  out = h * rsqrt(mean(h^2) + eps) * scale;  h_out = h
// The sum of squares, the rsqrt and the scaling are float32; each output is
// cast once, on its store, to x's dtype.  K7 normalises the float32 h, as
// the Pallas kernel does, not h rounded to x's dtype.  x (and r) are
// float32 or bfloat16, scale float32 or bfloat16 on its own.
//
// Layout.  x, r and both outputs are (rows, d), contiguous; scale is (d,).
// Any row count and any d: no block-size divisibility, no fallback.
//
// Design.  The TPU kernel tiles rows over its grid and keeps d whole in
// VMEM.  Here one CTA owns one row and keeps d whole as well: its threads
// stride over the row in 16-byte vectors (8 bf16 or 4 f32 values; the
// wrapper picks scalar accesses when a pointer or d does not allow them),
// reduce the sum of squares with warp shuffles and one shared-memory pass
// across warps, and then read the row again to scale and store it.  A row
// is at most a few tens of KB, so the second read comes from L1/L2; device
// memory sees each input once and each output once.
//
// Bound.  At the model's shape (8192 rows x 4096, bf16 x, f32 scale) K6
// moves 134 MB and K7 268 MB, about 3 operations per byte at most: both are
// bound by memory bandwidth (0.040 ms and 0.080 ms at 3.35 TB/s).  The
// design moves each byte once and keeps every load 16 bytes wide.
//
// Built without --use_fast_math.  The entry points launch on the caller's
// stream, allocate nothing and return cudaGetLastError(); the Python
// wrappers raise when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive values at p (VEC * sizeof(T) bytes, aligned to that size
// or to 16 bytes, whichever is smaller), widened to float32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[k * kPer + j] = to_f32(e[j]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f32(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(in[j]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f32<T>(in[j]);
  }
}

// Sum of v over the CTA; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = lane < n_warps ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One CTA per row.  RES: K7 (r, h_out present) or K6.  VEC: values per
// access (16 / sizeof(TX) on the vector path, 1 on the scalar one).
template <typename TX, typename TS, int VEC, bool RES>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_k(const TX* __restrict__ x, const TX* __restrict__ r,
          const TS* __restrict__ scale, TX* __restrict__ out,
          TX* __restrict__ h_out, int d, float eps) {
  __shared__ float red[kMaxThreads / 32];
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  const TX* rr = RES ? r + row * d : nullptr;
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[VEC];
    load_vec<TX, VEC>(xr + i * VEC, v);
    if constexpr (RES) {
      float w[VEC];
      load_vec<TX, VEC>(rr + i * VEC, w);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] += w[j];
      store_vec<TX, VEC>(h_out + row * d + i * VEC, v);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = fmaf(v[j], v[j], ss);
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);

  TX* o = out + row * d;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[VEC], s[VEC];
    load_vec<TX, VEC>(xr + i * VEC, v);
    if constexpr (RES) {
      float w[VEC];
      load_vec<TX, VEC>(rr + i * VEC, w);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] += w[j];
    }
    load_vec<TS, VEC>(scale + i * VEC, s);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = v[j] * inv * s[j];
    store_vec<TX, VEC>(o + i * VEC, v);
  }
}

int threads_for(int nvec) {
  int t = ((nvec + 1) / 2 + 31) / 32 * 32;   // about two accesses a thread
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename TX, typename TS, bool RES>
int launch(const void* x, const void* r, const void* scale, void* out,
           void* h_out, int rows, int d, float eps, int vec,
           cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(TX);
  const TX* xp = static_cast<const TX*>(x);
  const TX* rp = static_cast<const TX*>(r);
  const TS* sp = static_cast<const TS*>(scale);
  TX* op = static_cast<TX*>(out);
  TX* hp = static_cast<TX*>(h_out);
  if (vec) {
    rmsnorm_k<TX, TS, kVec, RES><<<rows, threads_for(d / kVec), 0, stream>>>(
        xp, rp, sp, op, hp, d, eps);
  } else {
    rmsnorm_k<TX, TS, 1, RES><<<rows, threads_for(d), 0, stream>>>(
        xp, rp, sp, op, hp, d, eps);
  }
  return (int)cudaGetLastError();
}

template <bool RES>
int dispatch(const void* x, const void* r, const void* scale, void* out,
             void* h_out, int rows, int d, float eps, int x_dtype,
             int scale_dtype, int vec, cudaStream_t st) {
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float, RES>(x, r, scale, out, h_out, rows, d, eps, vec, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16, RES>(x, r, scale, out, h_out, rows, d, eps, vec, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float, RES>(x, r, scale, out, h_out, rows, d, eps, vec, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, RES>(x, r, scale, out, h_out, rows, d,
                                                     eps, vec, st);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int rows, int d, int vec, int x_dtype) {
  const int kVec = x_dtype == 0 ? 4 : 8;
  return rows <= 0 || d <= 0 || (vec && d % kVec != 0);
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16.  vec: 1 when every pointer is 16-byte
// aligned and d is a multiple of 16 / sizeof(x's dtype), else 0.
int repro_rmsnorm(const void* x, const void* scale, void* out, int rows, int d,
                  float eps, int x_dtype, int scale_dtype, int vec, void* stream) {
  if (bad_shape(rows, d, vec, x_dtype)) return (int)cudaErrorInvalidValue;
  return dispatch<false>(x, nullptr, scale, out, nullptr, rows, d, eps, x_dtype,
                         scale_dtype, vec, static_cast<cudaStream_t>(stream));
}

int repro_rmsnorm_residual(const void* x, const void* r, const void* scale,
                           void* out, void* h_out, int rows, int d, float eps,
                           int x_dtype, int scale_dtype, int vec, void* stream) {
  if (bad_shape(rows, d, vec, x_dtype)) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, r, scale, out, h_out, rows, d, eps, x_dtype,
                        scale_dtype, vec, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
