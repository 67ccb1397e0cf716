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
// K1, K2 and K4 are instantiated for each timing model (K1 and K4 also
// for each clamp setting), so their per-cell loops carry no branch on
// either.  K1, K2 and K3 round every operation where and as their plain
// float32 versions do, so they equal them bit for bit, NaN included.
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

constexpr int kThreads = 256;        // K1-K2, K4: threads a block
constexpr int kAppGroup = 4;         // K1: apps per block
constexpr int kOutRows = 8;          // K1: output rows, one warp each
constexpr int kTile = kThreads - 32;   // K1: variants a block writes a row
constexpr int kTileRow = kThreads + 4;  // K1: a row of the shared tile
constexpr int kStepApps = 16;        // K2: apps per block
constexpr int kStatVariants = 64;    // K4: variants per block ...
constexpr int kStatGroups = kThreads / kStatVariants;  // ... x 4 app groups
constexpr int kStatPass = 64;        // K4: apps staged and reduced per pass
constexpr int kStatRow = kStatVariants + 4;  // padded row of the pass's tile
constexpr int kStatSplit = kThreads / kStatPass;  // threads per app in a reduction
static_assert(kOutRows * 32 == kThreads, "K1 block shape");
static_assert(kStatGroups * kStatVariants == kThreads, "K4 block shape");
static_assert(kStatSplit * kStatPass == kThreads && 32 % kStatSplit == 0,
              "K4 reduction shape");

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
// The guarded quotients (pod != 0 here, denom == 0 in eq1) are computed
// either way and then selected, which gives the same values as a branch
// and keeps the cell loop free of branches around each division.
__device__ __forceinline__ void raw_terms(float flops, float mem, float coll,
                                          float pod, const Machine& mm,
                                          float& rc, float& rm, float& ri) {
  rc = flops / mm.peak;
  rm = mem / mm.hbm;
  const float q_pod = pod / mm.inter_pod;
  const float t_pod = (pod != 0.0f) ? q_pod : 0.0f;
  ri = (coll - pod) / mm.ici_total + t_pod;
}

__device__ __forceinline__ void raw_terms(const float* p, int s, int a,
                                          const Machine& mm, float& rc,
                                          float& rm, float& ri) {
  raw_terms(p[a], p[s + a], p[2 * s + a], p[3 * s + a], mm, rc, rm, ri);
}

// The serial or overlapped step time of one cell, each scaled term
// rounded on its own as the plain version rounds it.
__device__ __forceinline__ float step_cell(float rc, float rm, float ri,
                                           const Machine& mm, bool overlap) {
  return combine(__fmul_rn(mm.sc, rc), __fmul_rn(mm.sm, rm),
                 __fmul_rn(mm.si, ri), overlap);
}

__device__ __forceinline__ float eq1(float alpha, float gamma, float beta,
                                     bool clamp) {
  const float denom = gamma - beta;
  const float q = (alpha - beta) / denom;
  float s = (denom == 0.0f) ? 0.0f : 1.0f - q;
  if (clamp) s = (s < 0.0f) ? 0.0f : ((s > 1.0f) ? 1.0f : s);
  return s;
}

struct Cell {
  float gamma, alpha[3], score[3], aggregate;
};

// Every product is rounded on its own (__fmul_rn is never contracted into
// an FMA), as the plain version rounds it: near gamma == beta Eq. 1 turns
// one unit in the last place of gamma into a large change of the score.
__device__ __forceinline__ Cell congruence_cell(float rc, float rm, float ri,
                                                const Machine& mm, float beta,
                                                bool overlap, float eps,
                                                bool clamp) {
  Cell c;
  const float tc = __fmul_rn(mm.sc, rc), tm = __fmul_rn(mm.sm, rm),
              ti = __fmul_rn(mm.si, ri);
  c.gamma = combine(tc, tm, ti, overlap);
  c.alpha[0] = combine(__fmul_rn(eps, rc), tm, ti, overlap);
  c.alpha[1] = combine(tc, __fmul_rn(eps, rm), ti, overlap);
  c.alpha[2] = combine(tc, tm, __fmul_rn(eps, ri), overlap);
  for (int k = 0; k < 3; ++k) c.score[k] = eq1(c.alpha[k], c.gamma, beta, clamp);
  c.aggregate = sqrtf(__fmul_rn(c.score[0], c.score[0]) +
                      __fmul_rn(c.score[1], c.score[1]) +
                      __fmul_rn(c.score[2], c.score[2]));
  return c;
}

// K1: where output row (r, a) starts within its 128-byte line, in floats:
// (r * A + a) * V modulo 32 (unsigned arithmetic wraps modulo 2^32, which
// keeps the residue).
__device__ __forceinline__ int row_shift(int r, int A, int a, int V) {
  return (int)((((unsigned)r * (unsigned)A + (unsigned)a) * (unsigned)V) & 31u);
}

// np.argmin's order on (value, index) pairs: a NaN is the minimum, the
// lower index wins a tie (and between two NaNs).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

// Join the (value, index) pairs of each group of `width` neighbouring lanes
// (a power of 2) by better(), in an xor shuffle tree: every lane of a
// group ends with the group's best.
__device__ __forceinline__ void merge_lanes(float& bv, int& bi, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
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
// Each output row (r, a) starts wherever (r * A + a) * V puts it.  At an
// odd V a warp storing its 32 variants straight from registers covers two
// 128-byte lines with a partial 32-byte sector at each end, and the card
// writes such rows at half the rate of aligned ones; any store that leaves
// part of a sector to another block costs it too.  So a block owns, in
// every row, the kTile (224) variants between two line boundaries of that
// row, which lie up to 31 variants before its tile: its 256 threads
// compute variants t * 224 - 32 ... t * 224 + 223 (one a thread, the
// machine in registers, 1/8 of the cells computed twice), for a group of
// kAppGroup apps staged in shared memory, into a shared (row, app,
// variant) tile.  Warp r then copies output row r of each app from the
// tile in 16-byte streaming stores (st.global.cs: the output outgrows the
// 50 MB L2 and is read next by the host's copy) that fill whole lines;
// only the ends of each row share a sector with another row.  The 1-D grid
// walks the app groups fastest, so the blocks that read one variant
// tile's machine columns run side by side and find them in L2.
template <bool kOverlap, bool kClamp>
__global__ void __launch_bounds__(kThreads)
congruence_k(const float* __restrict__ p, int A, const float* __restrict__ m,
             int V, float* __restrict__ out, float eps, int ngroups) {
  __shared__ float sp[7 * kAppGroup];
  __shared__ __align__(16) float tile[kOutRows * kAppGroup * kTileRow];
  const int a0 = (blockIdx.x % ngroups) * kAppGroup;
  const int na = min(kAppGroup, A - a0);
  const int t = blockIdx.x / ngroups;
  const int first = t * kTile;                // this block's tile of variants
  const bool last = first + kTile >= V;
  stage(sp, p, 7, A, a0, na, kAppGroup);
  __syncthreads();
  const int j = threadIdx.x;
  const int v = first - 32 + j;
  if (v >= 0 && v < V) {
    const Machine mm = load_machine(m, V, v);
    for (int a = 0; a < na; ++a) {
      float rc, rm, ri;
      raw_terms(sp, kAppGroup, a, mm, rc, rm, ri);
      const Cell c = congruence_cell(rc, rm, ri, mm, sp[6 * kAppGroup + a],
                                     kOverlap, eps, kClamp);
      const float row[kOutRows] = {c.gamma,    c.alpha[0], c.alpha[1],
                                   c.alpha[2], c.score[0], c.score[1],
                                   c.score[2], c.aggregate};
#pragma unroll
      for (int r = 0; r < kOutRows; ++r) {
        const int shift = row_shift(r, A, a0 + a, V);
        tile[(r * kAppGroup + a) * kTileRow + (shift & 3) + j] = row[r];
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, r = threadIdx.x / 32;
  for (int a = 0; a < na; ++a) {
    // the row's line boundaries fall on variants == -shift (mod 32); this
    // block writes variants [first - shift, first + kTile - shift) of it,
    // clipped to [0, V), and the last block on to V
    const int shift = row_shift(r, A, a0 + a, V);
    const int start = first - shift;
    const int k0 = max(0, -start);
    const int k1 = (last ? V : min(V, start + kTile)) - start;
    // element k of the range is variant start + k, tile slot k + 32 - shift
    const float* src = tile + (r * kAppGroup + a) * kTileRow + 32 - (shift & ~3);
    float* dst = out + ((size_t)r * A + a0 + a) * V + start;  // a line boundary
    for (int k = 4 * lane; k < k1; k += 128) {
      if (k >= k0 && k + 4 <= k1) {
        __stcs(reinterpret_cast<float4*>(dst + k),
               *reinterpret_cast<const float4*>(src + k));
      } else {
        for (int e = max(k, k0); e < min(k + 4, k1); ++e) __stcs(dst + e, src[e]);
      }
    }
  }
}

// K2: the (A, V) step times.  Bound on this card by its instructions: 4
// IEEE divisions a cell (MUFU.RCP, FCHK, five FFMAs and a branch past the
// slow path each) put its SASS instruction bound above its 4-byte-a-cell
// byte bound.  Thread per variant, the machine in registers, a block's 16
// apps staged in shared memory as float4s (one broadcast load a cell, the
// output walked by a pointer): the fewest instructions a cell of the
// designs measured on the H100.  Its rows start wherever a * V puts them,
// so a warp's 32 stores split two lines; there those stores cost it
// nothing measurable, and two whole-line designs (K1's staged tile, and
// line stores from a staged machine), with more instructions a cell, ran
// slower (PERF.md).  The 1-D grid walks the app groups fastest, so the
// blocks that read one variant tile's machine columns run side by side.
template <bool kOverlap>
__global__ void __launch_bounds__(kThreads)
step_time_k(const float* __restrict__ p, int A, const float* __restrict__ m,
            int V, float* __restrict__ out, int ngroups) {
  __shared__ float4 sp[kStepApps];
  const int a0 = (blockIdx.x % ngroups) * kStepApps;
  const int na = min(kStepApps, A - a0);
  if ((int)threadIdx.x < na) {
    const int a = a0 + threadIdx.x;
    sp[threadIdx.x] = make_float4(p[a], p[A + a], p[2 * (size_t)A + a],
                                  p[3 * (size_t)A + a]);
  }
  __syncthreads();
  const int v = (blockIdx.x / ngroups) * kThreads + threadIdx.x;
  if (v >= V) return;
  const Machine mm = load_machine(m, V, v);
  float* o = out + (size_t)a0 * V + v;
  for (int a = 0; a < na; ++a, o += V) {
    const float4 q = sp[a];
    float rc, rm, ri;
    raw_terms(q.x, q.y, q.z, q.w, mm, rc, rm, ri);
    *o = step_cell(rc, rm, ri, mm, kOverlap);
  }
}

// K3.  A few bytes per app: bound by the launch itself (PERF.md measures
// the least launch beside it).  One block, one thread per app, against
// machine column 0 (serial baseline, as the shared default_beta_kernel).
// A thread issues all of its global loads before its first division, so
// they overlap rather than wait one behind another.
__global__ void default_beta_k(const float* __restrict__ p, int A,
                               const float* __restrict__ m,
                               float* __restrict__ out) {
  const Machine mm = load_machine(m, 1, 0);
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float flops = p[a], mem = p[A + a], coll = p[2 * A + a],
                pod = p[3 * A + a], mf = p[4 * A + a], nd = p[5 * A + a];
    float rc, rm, ri;
    raw_terms(flops, mem, coll, pod, mm, rc, rm, ri);
    const float gamma_ref = (__fmul_rn(mm.sc, rc) + __fmul_rn(mm.sm, rm)) +
                            __fmul_rn(mm.si, ri);
    out[a] = (mf > 0.0f && nd > 0.0f)
                 ? nan_min(mf / __fmul_rn(nd, mm.peak), __fmul_rn(0.5f, gamma_ref))
                 : __fmul_rn(0.05f, gamma_ref);
  }
}

// The least launch: one block of 32 threads that writes one float.  No
// sweep path runs it; it is timed beside K3 as the floor under any launch
// on the card.
__global__ void launch_floor_k(float* __restrict__ out) {
  if (threadIdx.x == 0) out[0] = 0.0f;
}

// K4, first pass.  Bound by its arithmetic (about 50 float operations per
// cell against 4 bytes per variant): the (A, V) tile never reaches device
// memory.  A block is 64 variants x 4 app groups: thread (g, j) keeps
// variant v0 + j's machine in registers and computes the cells of apps
// a == g (mod 4), 64 apps staged per pass, so a 62 501-variant shard runs
// 977 blocks of 8 warps, one wave at 8 blocks an SM (32 registers).  Each
// pass's aggregates go to a shared (app, variant) tile, which 4 threads an
// app reduce in parallel: thread q scans variants q, q + 4, ... (a padded
// row, so the 32 lanes of a warp hit 32 banks), then a 2-step shuffle tree
// joins the four, giving one (value, index) partial per (app, block).
// better() is a strict total order, so any tree returns the serial walk's
// answer.  A variant past V carries +inf at an index above every live one
// of its block, so it never wins.  The per-variant mean sums, in float32,
// each group's apps in increasing order, then the four group sums in group
// order, and divides by A.
template <bool kOverlap, bool kClamp>
__global__ void __launch_bounds__(kThreads, 8)
sweep_stats_k(const float* __restrict__ p, int A,
              const float* __restrict__ m, int V, float eps,
              float* __restrict__ mean_out,
              float* __restrict__ part_val, int* __restrict__ part_idx) {
  __shared__ float sp[7 * kStatPass];
  __shared__ float tile[kStatPass * kStatRow];
  const int j = threadIdx.x % kStatVariants, g = threadIdx.x / kStatVariants;
  const int v = blockIdx.x * kStatVariants + j;
  const bool live = v < V;
  Machine mm = {};
  if (live) mm = load_machine(m, V, v);
  float sum = 0.0f;
  for (int a0 = 0; a0 < A; a0 += kStatPass) {
    const int na = min(kStatPass, A - a0);
    __syncthreads();  // the previous pass's readers are done
    stage(sp, p, 7, A, a0, na, kStatPass);
    __syncthreads();
    for (int a = g; a < na; a += kStatGroups) {
      float x = INFINITY;
      if (live) {
        float rc, rm, ri;
        raw_terms(sp, kStatPass, a, mm, rc, rm, ri);
        x = congruence_cell(rc, rm, ri, mm, sp[6 * kStatPass + a], kOverlap,
                            eps, kClamp).aggregate;
        sum += x;
      }
      tile[a * kStatRow + j] = x;
    }
    __syncthreads();
    // the reduction's view: app ra of the pass, scanned by thread rq
    const int ra = threadIdx.x / kStatSplit, rq = threadIdx.x % kStatSplit;
    float bv = INFINITY;
    int bi = INT_MAX;
    if (ra < na) {
      // indices rise along the scan, so better() reduces to: a NaN beats
      // a number, a lower value wins, and a tie keeps the earlier one
      const float* row = tile + ra * kStatRow;
      bv = row[rq];
      bi = rq;
#pragma unroll
      for (int k = rq + kStatSplit; k < kStatVariants; k += kStatSplit) {
        const float x = row[k];
        if (!(x >= bv) && bv == bv) {
          bv = x;
          bi = k;
        }
      }
    }
    merge_lanes(bv, bi, kStatSplit);
    if (rq == 0 && ra < na) {
      const size_t o = (size_t)(a0 + ra) * gridDim.x + blockIdx.x;
      part_val[o] = bv;
      part_idx[o] = blockIdx.x * kStatVariants + bi;
    }
  }
  __syncthreads();  // the last pass's readers are done
  tile[g * kStatRow + j] = sum;
  __syncthreads();
  if (g == 0 && live) {
    float total = tile[j];
    for (int k = 1; k < kStatGroups; ++k) total += tile[k * kStatRow + j];
    mean_out[v] = total / (float)A;
  }
}

// K4, second pass: one block per app merges that app's row of the (A,
// nblocks) partials.  Thread i walks blocks i, i + 256, ... in order; a
// 5-step shuffle tree joins each warp's lanes, and warp 0 joins the 8
// warps' results in a 3-step tree.
__global__ void __launch_bounds__(kThreads)
stats_merge_k(const float* __restrict__ part_val,
              const int* __restrict__ part_idx, int nblocks,
              float* __restrict__ app_min, long long* __restrict__ app_idx) {
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  const int a = blockIdx.x, lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const float* vals = part_val + (size_t)a * nblocks;
  const int* idxs = part_idx + (size_t)a * nblocks;
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int b = threadIdx.x; b < nblocks; b += kThreads) {
    if (better(vals[b], idxs[b], bv, bi)) {
      bv = vals[b];
      bi = idxs[b];
    }
  }
  merge_lanes(bv, bi, 32);
  if (lane == 0) {
    wv[w] = bv;
    wi[w] = bi;
  }
  __syncthreads();
  if (w == 0) {
    bv = lane < kThreads / 32 ? wv[lane] : INFINITY;
    bi = lane < kThreads / 32 ? wi[lane] : INT_MAX;
    merge_lanes(bv, bi, kThreads / 32);
    if (lane == 0) {
      app_min[a] = bv;
      app_idx[a] = bi;
    }
  }
}

}  // namespace

extern "C" {

int repro_stats_blocks(int V) {
  return (V + kStatVariants - 1) / kStatVariants;
}

int repro_congruence(const float* p, int A, const float* m, int V, float* out,
                     int overlap, float eps, int clamp, void* stream) {
  const int ngroups = (A + kAppGroup - 1) / kAppGroup;
  const long long nblocks = (long long)ngroups * ((V + kTile - 1) / kTile);
  if (nblocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const auto k = overlap ? (clamp ? &congruence_k<true, true> : &congruence_k<true, false>)
                         : (clamp ? &congruence_k<false, true> : &congruence_k<false, false>);
  k<<<(unsigned)nblocks, kThreads, 0, (cudaStream_t)stream>>>(p, A, m, V, out,
                                                             eps, ngroups);
  return (int)cudaGetLastError();
}

int repro_step_time(const float* p, int A, const float* m, int V, float* out,
                    int overlap, void* stream) {
  // a 1-D grid: ngroups app groups (fastest) x the variant tiles
  const int ngroups = (A + kStepApps - 1) / kStepApps;
  const long long nblocks = (long long)ngroups * ((V + kThreads - 1) / kThreads);
  if (nblocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const auto kernel = overlap ? &step_time_k<true> : &step_time_k<false>;
  kernel<<<(unsigned)nblocks, kThreads, 0, (cudaStream_t)stream>>>(p, A, m, V,
                                                                   out, ngroups);
  return (int)cudaGetLastError();
}

int repro_default_beta(const float* p, int A, const float* m, float* out,
                       void* stream) {
  const int threads = A < 1024 ? ((A + 31) / 32) * 32 : 1024;
  default_beta_k<<<1, threads, 0, (cudaStream_t)stream>>>(p, A, m, out);
  return (int)cudaGetLastError();
}

int repro_launch_floor(float* out, void* stream) {
  launch_floor_k<<<1, 32, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

// part_val and part_idx: (A, repro_stats_blocks(V)) scratch each.
int repro_sweep_stats(const float* p, int A, const float* m, int V,
                      int overlap, float eps, int clamp, float* mean_out,
                      float* part_val, int* part_idx, float* app_min,
                      long long* app_idx, void* stream) {
  const int nblocks = repro_stats_blocks(V);
  const auto k = overlap ? (clamp ? &sweep_stats_k<true, true> : &sweep_stats_k<true, false>)
                         : (clamp ? &sweep_stats_k<false, true> : &sweep_stats_k<false, false>);
  k<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(p, A, m, V, eps, mean_out,
                                                   part_val, part_idx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge_k<<<A, kThreads, 0, (cudaStream_t)stream>>>(
      part_val, part_idx, nblocks, app_min, app_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
