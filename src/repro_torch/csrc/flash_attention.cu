// Hopper (sm_90a) flash-attention forward: kernel K5 of the port.
//
// Replaces src/repro/kernels/flash_attention.py:_attn_kernel (and the
// pallas_call in flash_attention() that grids it): softmax attention with
// GQA (query head h reads KV head h / (H / K)), causal and sliding-window
// masks (q - k < window), scale 1/sqrt(D) unless the caller gives one, an
// online softmax whose running (m, l, acc) stay in float32, and rows with
// no live key written as 0.  Inputs are float32 or bfloat16; the output has
// q's dtype.
//
// Layout.  q is (B, H, S, D), k and v are (B, K, T, D), o is (B, H, S, D),
// each addressed through its own (batch, head, position) strides in
// elements with a unit stride along D.  So the model hands over its
// (B, S, H, D) projections as transposed views and gets its output back in
// (B, S, H, D) memory order: the transposes around the TPU call
// (src/repro/models/layers.py:344-347) cost no copy here.
//
// Design.  The TPU kernel blocks 128 x 128 in VMEM and carries (m, l, acc)
// across a sequential grid axis.  Hopper blocks run in no order, so here
// one CTA of 256 threads owns one (b, h, 64-row query tile) and loops over
// the key tiles itself.  The loop visits only the tiles the causal and
// window limits leave live -- the TPU kernel's whole-tile skip, turned into
// loop bounds -- and query tiles are issued heaviest first.  Q^T stays in
// shared memory for the CTA's life; each 64-key tile of K^T and V is staged
// in shared memory (float32, converted on load), and P^T reuses K^T's space.
// Each thread owns a 4 x 4 block of the score tile and a 4 x (D/16) block
// of the output, read from shared memory as float4.  Rows and columns past
// S, T and D are masked or zero-padded in the kernel, so no shape needs to
// divide a block size.  Masked scores never enter the sums (p = 0), which
// leaves l == 0 exactly for rows with no live key.
//
// Bound.  At the model's shape (B 4, H 32, K 2, S = T 2048, D 128, bf16)
// the causal work is 1.4e11 operations against 143 MB of traffic: the card's
// tensor-core rate bounds it.  This first kernel computes Q K^T and P V with
// float32 FMAs on the CUDA cores (a quarter of that rate at most, 67 TFLOP/s
// peak); moving both products to bf16 mma/wgmma is the next step.
//
// Built without --use_fast_math (expf, IEEE division).  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBKV = 64;            // keys per tile
constexpr int kThreads = 256;       // 16 x 16; thread (ty, tx) owns rows 4ty.., keys 4tx..
constexpr int kLd = kBQ + 4;        // row stride of the transposed tiles (float4-aligned)
constexpr float kNegBig = -1e30f;   // the TPU kernel's NEG_INF

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in floats, for a head dim padded to DP.
template <int DP>
constexpr int smem_floats() {
  return DP * kLd      // Q^T
         + DP * kLd    // K^T, then P^T
         + kBKV * DP;  // V
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
flash_attention_k(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int group,
                  int S, int Tk, int D, Strides qs, Strides ks, Strides vs,
                  Strides os, int causal, int has_window, int window,
                  float scale) {
  static_assert(DP % 64 == 0, "head dim is padded to a multiple of 64");
  constexpr int NC = DP / 64;       // float4 column groups a thread owns in V / o
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // Qt[d * kLd + r] = Q[r][d]
  float* Kt = Qt + DP * kLd;                     // Kt[d * kLd + c] = K[c][d]
  float* Pt = Kt;                                // Pt[c * kLd + r] = P[r][c]
  float* Vs = Kt + DP * kLd;                     // Vs[c * DP + d]  = V[c][d]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    const int qi = q0 + r;
    Qt[d * kLd + r] = (qi < S && d < D) ? to_f32(qb[qi * qs.s + d]) : 0.f;
  }

  // live keys of this tile's rows: [kv_lo, kv_hi)
  int kv_hi = Tk;
  if (causal) kv_hi = min(kv_hi, min(q0 + kBQ, S));
  int kv_lo = 0;
  if (has_window) kv_lo = max(0, q0 - window + 1);
  const int t_begin = kv_lo / kBKV;
  const int t_end = (kv_hi + kBKV - 1) / kBKV;

  float m_r[4], l_r[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegBig;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();   // Q^T staged; the last tile's P^T and V reads done
    for (int e = tid; e < kBKV * DP; e += kThreads) {
      const int c = e / DP, d = e % DP;
      const int kj = k0 + c;
      const bool in = kj < Tk && d < D;
      Kt[d * kLd + c] = in ? to_f32(kb[kj * ks.s + d]) : 0.f;
      Vs[c * DP + d] = in ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLd + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&Kt[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, scale and the online-softmax update of rows 4ty..4ty+3
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool live[4];
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        live[j] = kj < Tk && (!causal || kj <= qi) &&
                  (!has_window || qi - kj < window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_r[i] = alpha * l_r[i] + rs;
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();   // every thread is done reading K^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kLd + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * kLd + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[c * DP + g * 64 + tx * 4]);
        const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][g * 4 + jj] = fmaf(pv[i], vw[jj], acc[i][g * 4 + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float l = l_r[i];
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + tx * 4 + jj;
        if (d < D)
          ob[qi * os.s + d] = from_f32<T>(l == 0.f ? 0.f : acc[i][g * 4 + jj] / l);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int S, int Tk, int D, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DP>() * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_k<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_k<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KH, S, Tk, D, qs, ks,
      vs, os, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KH, int S, int Tk, int D, Strides qs, Strides ks,
             Strides vs, Strides os, int causal, int has_window, int window,
             float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KH, S, Tk, D, qs, ks, vs, os,
                         causal, has_window, window, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, KH, S, Tk, D, qs, ks, vs, os,
                          causal, has_window, window, scale, stream);
  if (D <= 192)
    return launch<T, 192>(q, k, v, o, B, H, KH, S, Tk, D, qs, ks, vs, os,
                          causal, has_window, window, scale, stream);
  return launch<T, 256>(q, k, v, o, B, H, KH, S, Tk, D, qs, ks, vs, os,
                        causal, has_window, window, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  window is read only when has_window.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                          int B, int H, int KH, int S, int Tk, int D,
                          long long q_sb, long long q_sh, long long q_ss,
                          long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss,
                          long long o_sb, long long o_sh, long long o_ss,
                          int causal, int has_window, int window, float scale,
                          int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || Tk < 0 ||
      D <= 0 || D > 256 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KH, S, Tk, D, qs, ks, vs, os,
                           causal, has_window, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KH, S, Tk, D, qs, ks, vs,
                                   os, causal, has_window, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
