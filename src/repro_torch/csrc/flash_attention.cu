// Hopper (sm_90a) flash-attention forward in float32 FMAs: kernel K5 of the
// port, for every call the tensor-core kernel (flash_attention_sm90.cu)
// does not take.
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
// Bound.  At the model's float32 shape (B 4, H 32, K 2, S = T 2048, D 128,
// causal) the work is 1.4e11 operations against 285 MB of traffic, so the
// card's float32 FMA rate bounds it (67 TFLOP/s: 2.05 ms).  Q K^T and P V
// stay float32 FMAs (TF32 would miss the 2e-4 tolerance), so the design is
// an SGEMM's: keep the FMA pipe fed from registers, and keep shared-memory
// traffic, barriers and staging off its critical path.
//
// Design.  One CTA of 256 threads (16 x 16) owns one (b, h, query tile)
// and loops over the 64-key tiles the causal and window limits leave live
// -- the TPU kernel's whole-tile skip, turned into loop bounds.  The grid
// is flat and issues every head's heaviest query tile first.  Thread
// (ty, tx) owns rows ty + 16 i (i < TM) and keys tx + 16 j (j < 4) of the
// score tile and the same TM rows x D/16 columns of the output, in
// registers: at head dims up to 128 a query tile is 128 rows (TM 8: 32
// scores and, at D 128, 64 outputs a thread; 128 FMAs for 12 shared loads
// of 16 bytes in Q K^T, 64 for 4 in P V); above 128 it is 64 rows (TM 4),
// so that the output block and the tiles still fit.
//   Shared memory (165 888 B at D 128, 215 040 B at D 256; one CTA an SM,
//   whose registers it fills):
//   * Q^T, staged once, converted to float32, with the rows in the threads'
//     order (Qt[d][ty * TM + i] = Q[ty + 16 i][d]), so a thread reads its
//     rows of one d as TM / 4 float4 and a warp touches two addresses;
//   * one K tile and one V tile, each copied while the other is read: V
//     of tile t during tile t's Q K^T and softmax, K of tile t + 1 during
//     tile t's P V, with one __syncthreads before each of the two phases
//     (it publishes the copy and frees the buffer the next copy writes).
//     The copy is a 16-byte cp.async.cg (zero-filled past T and D) when
//     the tensors are float32 with 16-byte-aligned rows; otherwise
//     (bfloat16, converted on the way, and unaligned bases or strides) an
//     element-wise copy through registers inside the same kernel, chosen
//     per CTA from the pointers.  K rows are padded by 4 floats so the 16
//     keys a warp reads at one d fall in distinct banks;
//   * P, written and read by the warp that owns its rows (padded rows, so
//     its stores are free of conflicts), so it needs no block barrier.
// The softmax folds scale * log2(e) into one multiply and uses exp2f; the
// output is divided by l once at the end (IEEE division).  Masked scores
// never enter the sums (p = 0), which leaves l == 0 exactly for rows with
// no live key.  Rows and columns past S, T and D are masked or zero-filled
// in the kernel, so no shape needs to divide a block size.
//
// Built without --use_fast_math.  The entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError(); the Python
// wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr float kNegBig = -1e30f;   // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

// Tile shapes of the instantiation for a head dim padded to DP.
template <int DP>
struct Tile {
  static_assert(DP % 64 == 0 && DP <= 256, "head dim is padded to 64 / 128 / 192 / 256");
  static constexpr int TM = DP <= 128 ? 8 : 4;   // query rows a thread owns
  static constexpr int TN = 4;                   // keys a thread owns in a tile
  static constexpr int BQ = 16 * TM;             // query rows a CTA
  static constexpr int BKV = 16 * TN;            // keys a tile
  static constexpr int NC = DP / 64;             // float4 column groups of the output
  static constexpr int CH = DP / 4;              // 16-byte chunks a row
  static constexpr int KLD = DP + 4;             // padded K row
  static constexpr int PLD = BQ + 4;             // padded P row (one key)
  static constexpr int Q_FLOATS = DP * BQ;
  static constexpr int K_FLOATS = BKV * KLD;
  static constexpr int V_FLOATS = BKV * DP;
  static constexpr int P_FLOATS = BKV * PLD;
  static constexpr int SMEM_BYTES = 4 * (Q_FLOATS + K_FLOATS + V_FLOATS + P_FLOATS);
  static_assert(BQ * CH % kThreads == 0 && BKV * CH % kThreads == 0,
                "the staging loops have no ragged trip");
  static_assert(SMEM_BYTES <= 232448, "a CTA's shared memory on sm_90");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float lane(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Q^T of rows [q0, q0 + BQ) in the threads' row order, zero past S and D.
// A warp's 32 lanes take 32 consecutive positions of one d-chunk, so the
// transposed stores are free of conflicts.
template <typename T, int DP>
__device__ __forceinline__ void stage_q(float* Qt, const T* qb, long long ss,
                                        int q0, int S, int D, bool vec) {
  using L = Tile<DP>;
  constexpr int N = L::BQ * L::CH / kThreads;
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int p = e % L::BQ, d0 = (e / L::BQ) * 4;
    const int qi = q0 + p / L::TM + 16 * (p % L::TM);
    float y[4] = {0.f, 0.f, 0.f, 0.f};
    if (qi < S) {
      const T* row = qb + qi * ss + d0;
      if (sizeof(T) == 4 && vec && d0 < D) {
        const float4 w = *reinterpret_cast<const float4*>(row);
        y[0] = w.x; y[1] = w.y; y[2] = w.z; y[3] = w.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (d0 + k < D) y[k] = to_f32(row[k]);
      }
    }
    x[n] = make_float4(y[0], y[1], y[2], y[3]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int p = e % L::BQ, d0 = (e / L::BQ) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) Qt[(d0 + k) * L::BQ + p] = lane(x[n], k);
  }
}

// Rows [k0, k0 + BKV) of K or V (row stride LD floats in shared memory),
// zero past T and D: 16-byte cp.async when ASYNC (float32 only), else an
// element-wise copy through registers, converted to float32, four chunks
// at a time so that it holds few registers.
template <typename T, int DP, int LD, bool ASYNC>
__device__ __forceinline__ void stage_kv(float* dst, const T* src, long long ss,
                                         int k0, int Tk, int D) {
  using L = Tile<DP>;
  constexpr int N = L::BKV * L::CH / kThreads;
  if constexpr (ASYNC && sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(src);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int r = e / L::CH, d0 = (e % L::CH) * 4;
      const int kj = k0 + r;
      const bool in = kj < Tk && d0 < D;
      cp_async16(dst + r * LD + d0, in ? f + kj * ss + d0 : f, in ? 16 : 0);
    }
  } else {
    constexpr int G = 4;
    static_assert(N % G == 0, "whole groups");
#pragma unroll 1
    for (int n0 = 0; n0 < N; n0 += G) {
      float4 x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e = threadIdx.x + (n0 + g) * kThreads;
        const int r = e / L::CH, d0 = (e % L::CH) * 4;
        const int kj = k0 + r;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (kj < Tk) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (d0 + k < D) a[k] = to_f32(src[kj * ss + d0 + k]);
        }
        x[g] = make_float4(a[0], a[1], a[2], a[3]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e = threadIdx.x + (n0 + g) * kThreads;
        const int r = e / L::CH, d0 = (e % L::CH) * 4;
        *reinterpret_cast<float4*>(dst + r * LD + d0) = x[g];
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_k(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int group,
                  int S, int Tk, int D, Strides qs, Strides ks, Strides vs,
                  Strides os, int causal, int has_window, int window,
                  float scale_log2e) {
  using L = Tile<DP>;
  constexpr int TM = L::TM, TN = L::TN, BQ = L::BQ, BKV = L::BKV, NC = L::NC;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Ks = Qt + L::Q_FLOATS;     // Ks[c * KLD + d] = K[k0 + c][d]
  float* Vs = Ks + L::K_FLOATS;     // Vs[c * DP + d] = V[k0 + c][d]
  float* Ps = Vs + L::V_FLOATS;     // Ps[c * PLD + ty * TM + i] = P[ty + 16 i][k0 + c]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // flat grid: every (b, h)'s heaviest query tile first
  const int nq = (S - 1) / BQ + 1;
  const int heads = gridDim.x / nq;
  const int q0 = (nq - 1 - blockIdx.x / heads) * BQ;
  const int hb = blockIdx.x % heads;
  const int h = hb % H, b = hb / H;
  const int kh = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  // live keys of this tile's rows: [kv_lo, kv_hi)
  int kv_hi = Tk;
  if (causal) kv_hi = min(kv_hi, min(q0 + BQ, S));
  int kv_lo = 0;
  if (has_window) kv_lo = max(0, q0 - window + 1);
  const int t_begin = kv_lo / BKV;
  const int t_end = (kv_hi + BKV - 1) / BKV;

  const bool f32 = sizeof(T) == 4 && D % 4 == 0;
  const bool async_k = f32 && aligned16(kb) && ks.s % 4 == 0;
  const bool async_v = f32 && aligned16(vb) && vs.s % 4 == 0;
  stage_q<T, DP>(Qt, qb, qs.s, q0, S, D, f32 && aligned16(qb) && qs.s % 4 == 0);
  if (t_begin < t_end) {
    if (async_k) stage_kv<T, DP, L::KLD, true>(Ks, kb, ks.s, t_begin * BKV, Tk, D);
    else stage_kv<T, DP, L::KLD, false>(Ks, kb, ks.s, t_begin * BKV, Tk, D);
  }
  cp_async_commit();

  float m_r[TM], l_r[TM], acc[TM][4 * NC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_r[i] = kNegBig;
    l_r[i] = 0.f;
#pragma unroll
    for (int n = 0; n < 4 * NC; ++n) acc[i][n] = 0.f;
  }
  const float* qcol = Qt + ty * TM;
  float* prow = Ps + ty * TM;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    cp_async_wait_all();
    __syncthreads();   // K of tile t in place; every thread done with V of tile t - 1
    if (async_v) stage_kv<T, DP, DP, true>(Vs, vb, vs.s, k0, Tk, D);
    else stage_kv<T, DP, DP, false>(Vs, vb, vs.s, k0, Tk, D);
    cp_async_commit();

    // S = Q K^T, d in order
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int d0 = 0; d0 < DP; d0 += 4) {
      float4 kf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * L::KLD + d0]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float a[TM];
#pragma unroll
        for (int f = 0; f < TM / 4; ++f) {
          const float4 x = *reinterpret_cast<const float4*>(&qcol[(d0 + dd) * BQ + 4 * f]);
          a[4 * f] = x.x; a[4 * f + 1] = x.y; a[4 * f + 2] = x.z; a[4 * f + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float kv = lane(kf[j], dd);
#pragma unroll
          for (int i = 0; i < TM; ++i) s[i][j] = fmaf(a[i], kv, s[i][j]);
        }
      }
    }

    // mask, scale (in log2 units) and the online-softmax update of the rows
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool live[TN];
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kj = k0 + tx + 16 * j;
        live[j] = kj < Tk && (!causal || kj <= qi) &&
                  (!has_window || qi - kj < window);
        s[i][j] = live[j] ? s[i][j] * scale_log2e : kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = exp2f(m_r[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = live[j] ? exp2f(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_r[i] = alpha * l_r[i] + rs;
      m_r[i] = m_new;
#pragma unroll
      for (int n = 0; n < 4 * NC; ++n) acc[i][n] *= alpha;
    }

    cp_async_wait_all();
    __syncthreads();   // V of tile t in place; every thread done with K of tile t
    const bool next = t + 1 < t_end;
    if (next && async_k) stage_kv<T, DP, L::KLD, true>(Ks, kb, ks.s, k0 + BKV, Tk, D);
    cp_async_commit();

    // P to this warp's rows of the P tile, then O += P V
    __syncwarp();   // the warp's reads of the last tile's P are done
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int f = 0; f < TM / 4; ++f)
        *reinterpret_cast<float4*>(&prow[(tx + 16 * j) * L::PLD + 4 * f]) =
            make_float4(s[4 * f][j], s[4 * f + 1][j], s[4 * f + 2][j], s[4 * f + 3][j]);
    __syncwarp();
#pragma unroll 4
    for (int kc = 0; kc < BKV; ++kc) {
      float pa[TM];
#pragma unroll
      for (int f = 0; f < TM / 4; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(&prow[kc * L::PLD + 4 * f]);
        pa[4 * f] = x.x; pa[4 * f + 1] = x.y; pa[4 * f + 2] = x.z; pa[4 * f + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[kc * DP + g * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * g + e] = fmaf(pa[i], lane(vv, e), acc[i][4 * g + e]);
      }
    }
    // the element-wise copy waits for its loads: after P V, where the
    // scores no longer hold registers
    if (next && !async_k) stage_kv<T, DP, L::KLD, false>(Ks, kb, ks.s, k0 + BKV, Tk, D);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float l = l_r[i];
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < D)
          ob[qi * os.s + d] = from_f32<T>(l == 0.f ? 0.f : acc[i][4 * g + e] / l);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int S, int Tk, int D, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
  using L = Tile<DP>;
  const long long blocks = (long long)((S - 1) / L::BQ + 1) * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_k<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_attention_k<T, DP><<<(unsigned)blocks, kThreads, L::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KH, S, Tk, D, qs,
      ks, vs, os, causal, has_window, window, scale * kLog2e);
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

// Dynamic shared memory, in bytes, of the instantiation that takes head
// dim D (0 when D is out of range): chip_smoke.py logs it beside ptxas's
// registers.
int repro_flash_attention_smem_bytes(int D) {
  if (D <= 0 || D > 256) return 0;
  if (D <= 64) return Tile<64>::SMEM_BYTES;
  if (D <= 128) return Tile<128>::SMEM_BYTES;
  if (D <= 192) return Tile<192>::SMEM_BYTES;
  return Tile<256>::SMEM_BYTES;
}

}  // extern "C"
