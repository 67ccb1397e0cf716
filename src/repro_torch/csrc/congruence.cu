// Hopper (sm_90a) kernels of the congruence sweep path.
//
// Each kernel computes the same function as one Pallas TPU kernel of the
// JAX package, in float32 as the TPU kernel does, with a layout chosen for
// this card rather than the TPU's 512-wide VMEM tiles:
//
//   congruence_k     replaces src/repro/core/kernels_pallas.py:_congruence_body
//                    (K1: gamma, three alphas, LBCS/HRCS/ICS, aggregate)
//   step_time_k      replaces src/repro/core/kernels_pallas.py:_step_time_body (K2)
//   default_beta_k   replaces src/repro/core/kernels_pallas.py:_default_beta_body (K3)
//   sweep_stats_k +  replace src/repro/core/kernels_pallas.py:PallasBackend
//   stats_merge_k    .sharded_stats.local_stats (K4: fused K1 reduced to the
//                    per-variant mean and per-app min/argmin)
//
// Layouts (row-major, float32): the profile stack p is (rows, A) with rows
// flops, mem_bytes, collective_bytes, pod_collective_bytes, model_flops,
// num_devices[, beta]; the machine stack m is (8, V) with rows peak_flops,
// hbm_bw, ici_bw, ici_links, inter_pod_bw, scale_compute, scale_memory,
// scale_interconnect; K1's output is (8, A, V) with rows gamma,
// alpha_compute, alpha_memory, alpha_interconnect, LBCS, HRCS, ICS,
// aggregate.
//
// Build without --use_fast_math: Eq. 1 relies on IEEE division and on the
// exact denom == 0, pod != 0 and valid branches of the shared math
// (src/repro_torch/core/kernels_xp.py).  NaN propagates through max/min as
// it does through torch.maximum/minimum and np.clip.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;        // one thread per variant
constexpr int kWarps = kThreads / 32;
constexpr int kAppTile = 1024;       // K1/K2: apps staged per block, 7 * 4 KB
constexpr int kStatTile = 256;       // K4: apps staged per pass, 7 KB + 16 KB partials

struct Machine {
  float peak, hbm, ici_total, inter_pod, sc, sm, si;
};

__device__ __forceinline__ Machine load_machine(const float* __restrict__ m,
                                                int V, int v) {
  Machine mm;
  mm.peak = m[v];
  mm.hbm = m[(size_t)V + v];
  mm.ici_total = m[2 * (size_t)V + v] * m[3 * (size_t)V + v];
  mm.inter_pod = m[4 * (size_t)V + v];
  mm.sc = m[5 * (size_t)V + v];
  mm.sm = m[6 * (size_t)V + v];
  mm.si = m[7 * (size_t)V + v];
  return mm;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float combine(float tc, float tm, float ti,
                                         bool overlap) {
  return overlap ? nan_max(nan_max(tc, tm), ti) : (tc + tm) + ti;
}

// Unscaled roofline terms of app row a of a profile stack with row stride s.
__device__ __forceinline__ void raw_terms(const float* p, int s, int a,
                                          const Machine& mm, float& rc,
                                          float& rm, float& ri) {
  const float pod = p[3 * s + a];
  rc = p[a] / mm.peak;
  rm = p[s + a] / mm.hbm;
  const float t_pod = (pod != 0.0f) ? pod / mm.inter_pod : 0.0f;
  ri = (p[2 * s + a] - pod) / mm.ici_total + t_pod;
}

__device__ __forceinline__ float eq1(float alpha, float gamma, float beta,
                                     bool clamp) {
  const float denom = gamma - beta;
  float s = (denom == 0.0f) ? 0.0f : 1.0f - (alpha - beta) / denom;
  if (clamp) s = (s < 0.0f) ? 0.0f : ((s > 1.0f) ? 1.0f : s);
  return s;
}

struct Cell {
  float gamma, alpha[3], score[3], aggregate;
};

__device__ __forceinline__ Cell congruence_cell(float rc, float rm, float ri,
                                                const Machine& mm, float beta,
                                                bool overlap, float eps,
                                                bool clamp) {
  Cell c;
  const float tc = mm.sc * rc, tm = mm.sm * rm, ti = mm.si * ri;
  c.gamma = combine(tc, tm, ti, overlap);
  c.alpha[0] = combine(eps * rc, tm, ti, overlap);
  c.alpha[1] = combine(tc, eps * rm, ti, overlap);
  c.alpha[2] = combine(tc, tm, eps * ri, overlap);
  for (int k = 0; k < 3; ++k) c.score[k] = eq1(c.alpha[k], c.gamma, beta, clamp);
  c.aggregate = sqrtf(c.score[0] * c.score[0] + c.score[1] * c.score[1] +
                      c.score[2] * c.score[2]);
  return c;
}

// np.argmin's order on (value, index) pairs: a NaN is the minimum, the
// lower index wins a tie (and between two NaNs).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

// Stage rows [0, rows) x apps [a0, a0 + na) of p (row stride A) into
// shared memory with row stride `tile`.
__device__ __forceinline__ void stage(float* sp, const float* __restrict__ p,
                                      int rows, int A, int a0, int na,
                                      int tile) {
  for (int i = threadIdx.x; i < rows * na; i += blockDim.x) {
    const int r = i / na, a = i - r * na;
    sp[r * tile + a] = p[(size_t)r * A + a0 + a];
  }
}

// K1.  Bound on this card by the 32 bytes per (app, variant) cell it
// writes (8 float rows); it reads 28 bytes per app and 32 per variant.
// One thread per variant keeps that variant's machine in registers and
// walks the apps of its block's tile, which sit in shared memory, so each
// (r, a) row of the output is stored by consecutive threads to consecutive
// addresses: every store is a full 128-byte line per warp.
__global__ void __launch_bounds__(kThreads)
congruence_k(const float* __restrict__ p, int A, const float* __restrict__ m,
             int V, float* __restrict__ out, int overlap, float eps,
             int clamp) {
  __shared__ float sp[7 * kAppTile];
  const int a0 = blockIdx.y * kAppTile;
  const int na = min(kAppTile, A - a0);
  stage(sp, p, 7, A, a0, na, kAppTile);
  __syncthreads();
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const Machine mm = load_machine(m, V, v);
  const size_t plane = (size_t)A * V;
  for (int a = 0; a < na; ++a) {
    float rc, rm, ri;
    raw_terms(sp, kAppTile, a, mm, rc, rm, ri);
    const Cell c = congruence_cell(rc, rm, ri, mm, sp[6 * kAppTile + a],
                                   overlap, eps, clamp);
    const size_t o = (size_t)(a0 + a) * V + v;
    out[o] = c.gamma;
    out[plane + o] = c.alpha[0];
    out[2 * plane + o] = c.alpha[1];
    out[3 * plane + o] = c.alpha[2];
    out[4 * plane + o] = c.score[0];
    out[5 * plane + o] = c.score[1];
    out[6 * plane + o] = c.score[2];
    out[7 * plane + o] = c.aggregate;
  }
}

// K2.  Bound by the 4 bytes per cell it writes; K1's loop with one output.
__global__ void __launch_bounds__(kThreads)
step_time_k(const float* __restrict__ p, int A, const float* __restrict__ m,
            int V, float* __restrict__ out, int overlap) {
  __shared__ float sp[4 * kAppTile];
  const int a0 = blockIdx.y * kAppTile;
  const int na = min(kAppTile, A - a0);
  stage(sp, p, 4, A, a0, na, kAppTile);
  __syncthreads();
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const Machine mm = load_machine(m, V, v);
  for (int a = 0; a < na; ++a) {
    float rc, rm, ri;
    raw_terms(sp, kAppTile, a, mm, rc, rm, ri);
    out[(size_t)(a0 + a) * V + v] =
        combine(mm.sc * rc, mm.sm * rm, mm.si * ri, overlap);
  }
}

// K3.  A few bytes per app: bound by the launch itself.  One block, one
// thread per app, against machine column 0 (serial baseline, as the
// shared default_beta_kernel).
__global__ void default_beta_k(const float* __restrict__ p, int A,
                               const float* __restrict__ m,
                               float* __restrict__ out) {
  const Machine mm = load_machine(m, 1, 0);
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    float rc, rm, ri;
    raw_terms(p, A, a, mm, rc, rm, ri);
    const float gamma_ref = (mm.sc * rc + mm.sm * rm) + mm.si * ri;
    const float mf = p[4 * A + a], nd = p[5 * A + a];
    out[a] = (mf > 0.0f && nd > 0.0f)
                 ? nan_min(mf / (nd * mm.peak), 0.5f * gamma_ref)
                 : 0.05f * gamma_ref;
  }
}

// K4, first pass.  Bound by its arithmetic (about 50 float operations per
// cell against 4 bytes per variant): the (A, V) tile never reaches device
// memory.  Each thread sums its variant's aggregates in app order (no
// atomics), and each app's (value, index) minimum is reduced by warp
// shuffles, then across the block's warps in warp order, into one partial
// per (block, app).  Threads past V carry (+inf, INT_MAX), which loses to
// every real variant.
__global__ void __launch_bounds__(kThreads)
sweep_stats_k(const float* __restrict__ p, int A,
              const float* __restrict__ m, int V, int overlap, float eps,
              int clamp, float* __restrict__ mean_out,
              float* __restrict__ part_val, int* __restrict__ part_idx) {
  __shared__ float sp[7 * kStatTile];
  __shared__ float wv[kStatTile * kWarps];
  __shared__ int wi[kStatTile * kWarps];
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool live = v < V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Machine mm = {};
  if (live) mm = load_machine(m, V, v);
  float sum = 0.0f;
  for (int a0 = 0; a0 < A; a0 += kStatTile) {
    const int na = min(kStatTile, A - a0);
    __syncthreads();  // the previous tile's readers are done
    stage(sp, p, 7, A, a0, na, kStatTile);
    __syncthreads();
    for (int a = 0; a < na; ++a) {
      float bv = INFINITY;
      int bi = INT_MAX;
      if (live) {
        float rc, rm, ri;
        raw_terms(sp, kStatTile, a, mm, rc, rm, ri);
        bv = congruence_cell(rc, rm, ri, mm, sp[6 * kStatTile + a], overlap,
                             eps, clamp).aggregate;
        bi = v;
        sum += bv;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        wv[a * kWarps + warp] = bv;
        wi[a * kWarps + warp] = bi;
      }
    }
    __syncthreads();
    for (int a = threadIdx.x; a < na; a += kThreads) {
      float bv = wv[a * kWarps];
      int bi = wi[a * kWarps];
      for (int w = 1; w < kWarps; ++w) {
        if (better(wv[a * kWarps + w], wi[a * kWarps + w], bv, bi)) {
          bv = wv[a * kWarps + w];
          bi = wi[a * kWarps + w];
        }
      }
      part_val[(size_t)blockIdx.x * A + a0 + a] = bv;
      part_idx[(size_t)blockIdx.x * A + a0 + a] = bi;
    }
  }
  if (live) mean_out[v] = sum / (float)A;
}

// K4, second pass: merge the (num_blocks, A) partials in block order.
__global__ void stats_merge_k(const float* __restrict__ part_val,
                              const int* __restrict__ part_idx, int nblocks,
                              int A, float* __restrict__ app_min,
                              long long* __restrict__ app_idx) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  float bv = part_val[a];
  int bi = part_idx[a];
  for (int b = 1; b < nblocks; ++b) {
    const float v = part_val[(size_t)b * A + a];
    const int i = part_idx[(size_t)b * A + a];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  app_min[a] = bv;
  app_idx[a] = bi;
}

int grid_x(int V) { return (V + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int repro_threads_per_block() { return kThreads; }

int repro_congruence(const float* p, int A, const float* m, int V, float* out,
                     int overlap, float eps, int clamp, void* stream) {
  const dim3 grid(grid_x(V), (A + kAppTile - 1) / kAppTile);
  congruence_k<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      p, A, m, V, out, overlap, eps, clamp);
  return (int)cudaGetLastError();
}

int repro_step_time(const float* p, int A, const float* m, int V, float* out,
                    int overlap, void* stream) {
  const dim3 grid(grid_x(V), (A + kAppTile - 1) / kAppTile);
  step_time_k<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, A, m, V, out,
                                                           overlap);
  return (int)cudaGetLastError();
}

int repro_default_beta(const float* p, int A, const float* m, float* out,
                       void* stream) {
  const int threads = A < 1024 ? ((A + 31) / 32) * 32 : 1024;
  default_beta_k<<<1, threads, 0, (cudaStream_t)stream>>>(p, A, m, out);
  return (int)cudaGetLastError();
}

int repro_sweep_stats(const float* p, int A, const float* m, int V,
                      int overlap, float eps, int clamp, float* mean_out,
                      float* part_val, int* part_idx, float* app_min,
                      long long* app_idx, void* stream) {
  const int nblocks = grid_x(V);
  sweep_stats_k<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, A, m, V, overlap, eps, clamp, mean_out, part_val, part_idx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge_k<<<(A + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part_val, part_idx, nblocks, A, app_min, app_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
