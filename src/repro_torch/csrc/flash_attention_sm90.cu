// Hopper (sm_90a) flash-attention forward on the tensor cores: the bf16
// kernel K5 of the port, beside the float32-FMA kernel of
// flash_attention.cu.
//
// Replaces src/repro/kernels/flash_attention.py:_attn_kernel (and the
// pallas_call in flash_attention() that grids it) for bfloat16 q, k, v with
// a head dim of 64, 128 or 256.  It computes what that kernel computes: GQA
// (query head h reads KV head h / (H / K)), causal and sliding-window masks
// (q - k < window), the scale (1/sqrt(D) unless the caller gives one), an
// online softmax whose running (m, l, acc) stay in float32, rows with no
// live key written as 0, and the output in bf16.  q, k, v and o are read and
// written through their (batch, head, position) strides with a unit stride
// along D, so the model's (B, S, H, D) projections go in as transposed views.
// The one departure from the TPU kernel's arithmetic: P is rounded to bf16
// before P V, as the tensor cores take it, and the row sum l adds the
// rounded P, so the weights that multiply V sum to l and O is a convex
// combination of V's rows (the products of Q K^T are exact in the f32
// accumulator; only their order of summation differs).
//
// Design.  One CTA owns one (b, h, 128-row query tile); the heaviest query
// tiles of all heads are issued first (the tile is the slowest index of a
// flat grid), and only the key tiles that the causal and window limits
// leave live are visited (loop bounds, as the TPU kernel's whole-tile skip;
// a consumer also skips a tile that is dead for all of its own 64 rows).
//  * Loads: one thread issues TMA loads, the Q tile once, then each key
//    tile of K and V into a two-stage ring in shared memory, guarded by
//    full / empty mbarriers.  Tiles are bf16 in 128-byte-swizzled panels of
//    64 columns (a D = 256 row is four panels).  TMA zero-fills rows past S
//    and T.  At D 64 / 128 that thread is in a producer warpgroup that gives
//    up registers (setmaxnreg.dec; the consumers take 240 with
//    setmaxnreg.inc).  At D 256 the CTA is the two consumer warpgroups
//    alone (256 threads), and thread 128 fills each stage again once both
//    have released it.
//  * Warpgroups 0 and 1, the consumers, own 64 query rows each.  S = Q K^T
//    is wgmma m64nBNk16 with Q and K K-major from shared memory; the 64 x
//    BN f32 scores stay in registers.  The softmax runs in registers: the 4
//    threads that share a row reduce its max and sum with two shuffles, 2^x
//    takes scale * log2(e) folded into one multiply-add, and the mask is
//    applied only on tiles that cut the diagonal, the window edge or T.  P
//    is rounded to bf16 in place and packed into wgmma's A-fragment layout
//    (the accumulator layout of S is that layout), and O += P V is wgmma
//    with A from registers and V read MN-major from shared memory (the
//    transpose bit), n64 at D 64 and n128 per 128 columns of D above.  O
//    stays in f32 registers and is divided by l once.  At D 256 the
//    consumers take turns to issue their Q K^T (named barriers 1 and 2,
//    warpgroup 0 first), and the loading thread is in warpgroup 1, which is
//    then behind, so its wait for both releases seldom stalls.
//  * Registers.  ptxas gives a thread at most a scheduler's 16 384
//    registers over the threads of the warps it holds (the CTA's warps
//    spread over the SM's four): 168 with 12 or 9 warps, 255 with 8, and it
//    compiled the consumers within that although setmaxnreg gives them 240
//    at run time (a D-256 build with the producer warpgroup spilled 552 B
//    at 168).  At D 256 a consumer thread holds 128 f32 of O, so the CTA
//    drops the producer warpgroup, and the key tile BN is 80 (at D 64 / 128
//    it is 128): 40 registers of scores and 20 of P, 202 in all and
//    no spill.  Shared memory at D 256 is Q 64 KB plus two stages of 40 KB
//    K and 40 KB V: 230 440 B with barriers and alignment slack, of the
//    232 448 a block can have.  80 keys beat 64 (about 9 % less time at
//    recurrentgemma-9b's shape, PERF.md): each wgmma of Q K^T reads Q's 2 KB
//    from shared memory for more products.
//
// Bound.  At chatglm3-6b's shape (B 4, H 32, K 2, S = T 2048, D 128, causal)
// the work is 1.4e11 bf16 tensor-core operations against 143 MB of traffic,
// and at recurrentgemma-9b's (B 4, H 16, K 1, S = T 2048, D 256, window
// 2048) 1.37e11 against 143 MB: the card's 989 TFLOP/s bound both (0.139
// ms).  Tried at D 256 and slower here (PERF.md): the softmax of one tile
// overlapped with P V of the one before, and K and V released apart.  Left
// for later: persistent CTAs, TMA multicast in clusters, fp8.
//
// Tensor maps are encoded on the host per call with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.
// Built without --use_fast_math.  The entry point launches on the caller's
// stream, allocates nothing and returns a cudaError_t as int; the Python
// wrapper raises when it is not 0.  It takes only what the wrapper routes to
// it: bf16, D in {64, 128, 256}, 16-byte-aligned bases and strides, a
// positive scale.

#include <cuda.h>   // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // query rows per CTA, 64 per consumer
constexpr int kStages = 2;          // K / V ring depth
constexpr int kPanel = 64;          // bf16 columns per 128-byte swizzled panel
constexpr float kLog2e = 1.4426950408889634f;
// A wait on an mbarrier that lasts this many clocks (seconds on the card)
// means a lost arrival: trap rather than hang the card.
constexpr long long kWaitLimit = 20000000000LL;

struct Strides {
  long long b, h, s;
};

template <int D>
struct Layout {
  static constexpr int kBN = D <= 128 ? 128 : 80;  // keys per tile (see the header)
  // two consumer warpgroups and a producer warpgroup, or at D 256 the two
  // consumers alone, one of whose threads also issues the loads (see the header)
  static constexpr bool kProducerWG = D <= 128;
  static constexpr int kThreads = kProducerWG ? 384 : 256;
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;     // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;  // q_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;     // slack to align the base to 1024
  static_assert(kAlloc <= 232448, "over the 227 KB of shared memory a block can use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) start = now;
    else if (now - start > kWaitLimit) __trap();
  }
}

// 4-D tiled TMA load (coordinates innermost first) completing on an mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Registers that an in-flight wgmma writes or reads: keep the compiler from
// moving their uses across the wait, or reusing them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit.  Subnormal results flush to 0: p is
// rounded to bf16 next, and l gains nothing from them.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The sum of the two bf16 halves of a packed pair.
__device__ __forceinline__ float bf16_sum(uint32_t v) {
  return __uint_as_float(v << 16) + __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D(64 x 128, f32) (+)= A(64 x 16, smem) * B(128 x 16, smem)^T, both K-major;
// Acc false overwrites D, whose old values are then not read (so they need
// not live across the key loop).
template <bool Acc>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (Acc)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(da), "l"(db));
}

// D(64 x 80, f32) (+)= A(64 x 16, smem) * B(80 x 16, smem)^T, both K-major.
template <bool Acc>
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da, uint64_t db) {
  if constexpr (Acc)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39])
        : "l"(da), "l"(db));
}

// D(64 x 128, f32) += A(64 x 16, bf16 registers) * B(16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64, f32) += A(64 x 16, bf16 registers) * B(16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T over one key tile (80 or 128 keys), and O += P V over 64 or 128
// columns of D: the instruction's N follows the accumulator's size.
template <bool Acc>
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t da, uint64_t db) {
  wgmma_ss_n128<Acc>(s, da, db);
}
template <bool Acc>
__device__ __forceinline__ void wgmma_qk(float (&s)[40], uint64_t da, uint64_t db) {
  wgmma_ss_n80<Acc>(s, da, db);
}
__device__ __forceinline__ void wgmma_pv(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

// TMA coordinates of a (batch, head, position, panel column) tile corner, in
// the order of the tensor map (see make_map): bit `which` of `orders` set
// means (d, head, position, batch), clear means (d, position, head, batch).
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int orders, int which, int rows, int d, int pos,
                                          int head, int batch) {
  const bool head_first = (orders >> which) & 1;
#pragma unroll
  for (int p = 0; p * kPanel < d; ++p) {
    const uint32_t at = dst + p * rows * 128;
    if (head_first)
      tma_load_4d(at, map, bar, p * kPanel, head, pos, batch);
    else
      tma_load_4d(at, map, bar, p * kPanel, pos, head, batch);
  }
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_attention_sm90_k(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, Strides os, int orders, int heads,
                       int batch, int group, int S, int Tk, int causal, int has_window,
                       int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  // one flat grid, the query tile slowest and counted down: the heaviest
  // causal tiles of every head are issued first, the light ones fill the tail
  const int bh = blockIdx.x % (heads * batch);
  const int tiles = gridDim.x / (heads * batch);
  const int q0 = (tiles - 1 - (int)(blockIdx.x / (heads * batch))) * kBM;
  const int h = bh % heads, b = bh / heads;
  const int kh = h / group;

  // live keys of this tile's rows: [kv_lo, kv_hi)
  int kv_hi = Tk;
  if (causal) kv_hi = min(kv_hi, min(q0 + kBM, S));
  int kv_lo = 0;
  if (has_window)
    kv_lo = (int)min((long long)Tk, max(0LL, (long long)q0 - window + 1));
  const int t_begin = kv_lo / kBN;
  const int t_end = (kv_hi + kBN - 1) / kBN;   // <= t_begin: no live key

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the Q tile, and the i-th live key tile into stage i % kStages once the
  // consumers have released the stage's previous tile
  auto load_q = [&]() {
    mbar_expect_tx(q_full, L::kQBytes);
    load_tile(base + L::kQ, &tm_q, q_full, orders, 0, kBM, D, q0, h, b);
  };
  auto load_kv = [&](int i) {
    const int s = i % kStages, t = t_begin + i;
    mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * L::kKVBytes);
    load_tile(base + L::kK + s * L::kKVBytes, &tm_k, full, orders, 1, kBN, D, t * kBN, kh,
              b);
    load_tile(base + L::kV + s * L::kKVBytes, &tm_v, full, orders, 2, kBN, D, t * kBN, kh,
              b);
  };
  const int n_tiles = t_end - t_begin;

  const int wg = threadIdx.x / 128;
  if (L::kProducerWG && wg == 2) {
    // ---- producer: one thread keeps the TMA ring full ----
    if constexpr (L::kProducerWG)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      load_q();
      for (int i = 0; i < n_tiles; ++i) load_kv(i);
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (L::kProducerWG) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    } else if (threadIdx.x == 128) {   // the first tiles; the loop issues the rest
      load_q();
      for (int i = 0; i < min(n_tiles, kStages); ++i) load_kv(i);
    }
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int qlo = q0 + wg * 64, qhi = qlo + 63;
    const int row0 = qlo + warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
    const int col = 2 * (lane % 4);                // and columns col, col + 1 of each 8
    const uint32_t q_addr = base + L::kQ + wg * 64 * 128;

    // O in chunks of ON columns, one P V wgmma each: n64 at D 64, else n128
    constexpr int ON = D < 128 ? D : 128;
    constexpr int NC = D / ON;
    constexpr int NS = kBN / 2;   // f32 scores a thread
    float acc[NC][ON / 2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) acc[c][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // m in log2 units

    mbar_wait(q_full, 0);
    if constexpr (!L::kProducerWG) if (wg == 1) named_arrive(1, 256);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % kStages;
      const int k0 = t * kBN;
      const uint32_t k_addr = base + L::kK + s * L::kKVBytes;
      const uint32_t v_addr = base + L::kV + s * L::kKVBytes;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      // a tile past this warpgroup's diagonal or before its window holds no
      // live key of its rows (it is live for the other warpgroup's)
      const bool dead = (causal && k0 > qhi) || (has_window && qlo - (k0 + kBN - 1) >= window);
      if constexpr (!L::kProducerWG) named_sync(1 + wg, 256);
      if (!dead) {
        // S = Q K^T: 64 x kBN f32 in registers, written whole by the first
        // wgmma.  The Q descriptors are rebuilt each tile from an address
        // the compiler cannot see through, so it does not hold all of them
        // (2 registers each, 32 at D 256) across the loop.
        float sc[NS];
        uint32_t qa = q_addr;
        asm volatile("" : "+r"(qa));
        const uint64_t qd = smem_desc(qa, 16, 1024), kd = smem_desc(k_addr, 16, 1024);
        wgmma_fence();
        wgmma_qk<false>(sc, qd, kd);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
          for (int kk = 0; kk < kPanel / 16; ++kk)
            if (p | kk)   // descriptor addresses are in 16-byte units
              wgmma_qk<true>(sc, qd + ((p * kBM * 128 + kk * 32) >> 4),
                             kd + ((p * kBN * 128 + kk * 32) >> 4));
        wgmma_commit();
        if constexpr (!L::kProducerWG) named_arrive(2 - wg, 256);
        wgmma_wait_all();
        fence_regs(sc);

        // mask only tiles that cut T, the diagonal or the window edge
        const bool edge = (k0 + kBN > Tk) || (causal && k0 + kBN - 1 > qlo) ||
                          (has_window && qhi - k0 >= window);
        if (edge) {
#pragma unroll
          for (int e = 0; e < NS; ++e) {
            const int qi = row0 + ((e & 2) ? 8 : 0);
            const int kj = k0 + 8 * (e / 4) + col + (e & 1);
            const bool live = kj < Tk && (!causal || kj <= qi) &&
                              (!has_window || qi - kj < window);
            if (!live) sc[e] = -INFINITY;
          }
        }

        // online softmax of rows row0 (elements 4j, 4j+1) and row0 + 8 (4j+2, 4j+3)
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // scale_log2 > 0, so the scaled max is the max scaled
        const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
        // a row with no live key so far subtracts 0: its p and alpha are 0
        const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
        const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
        const float al0 = ex2(m0 - mu0), al1 = ex2(m1 - mu1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -mu0));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -mu0));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -mu1));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -mu1));
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < ON / 8; ++j) {
            acc[c][4 * j] *= al0;
            acc[c][4 * j + 1] *= al0;
            acc[c][4 * j + 2] *= al1;
            acc[c][4 * j + 3] *= al1;
          }

        // P in bf16, in wgmma's A-fragment layout: keys 16kk .. 16kk + 15;
        // registers 0 and 2 hold row row0, 1 and 3 row row0 + 8, and this
        // thread's share of each row sum adds the rounded P
        uint32_t pa[kBN / 16][4];
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
          rs0 += bf16_sum(pa[kk][0]) + bf16_sum(pa[kk][2]);
          rs1 += bf16_sum(pa[kk][1]) + bf16_sum(pa[kk][3]);
        }
        l0 = l0 * al0 + rs0;
        l1 = l1 * al1 + rs1;
        // O += P V, V MN-major: 16 keys a step (2048 bytes), panels LBO apart;
        // chunk c of O starts ON / 64 panels into the tile
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_pv(acc[c], pa[kk],
                     smem_desc(v_addr + c * (ON / kPanel) * kBN * 128 + kk * 16 * 128,
                               kBN * 128, 1024));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
        fence_regs(pa);
      } else {
        if constexpr (!L::kProducerWG) named_arrive(2 - wg, 256);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if constexpr (!L::kProducerWG) {
        // waits for both consumers to release stage s, then refills it
        if (threadIdx.x == 128 && i + kStages < n_tiles) load_kv(i + kStages);
        __syncwarp();
      }
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const int d = c * ON + 8 * j + col;
        if (row0 < S)
          *reinterpret_cast<uint32_t*>(ob + row0 * os.s + d) =
              pack_bf16(acc[c][4 * j] * inv0, acc[c][4 * j + 1] * inv0);
        if (row0 + 8 < S)
          *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * os.s + d) =
              pack_bf16(acc[c][4 * j + 2] * inv1, acc[c][4 * j + 3] * inv1);
      }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || p == nullptr)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (batch, head, position, D) bf16 tensor, boxes of
// (rows x 64) with 128-byte swizzle.  Its dims run D first, then head and
// position in the order of their strides (the smaller first, so the byte
// strides rise), then batch; *head_first says which order was taken.  A dim
// of extent 1 gets the packed stride, whatever the tensor's stride there.
bool make_map(CUtensorMap* map, const void* ptr, int D, int rows_total, int heads,
              int batch, Strides st, int box_rows, bool* head_first) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  *head_first = heads > 1 && rows_total > 1 ? st.h < st.s : heads > 1;
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, (cuuint64_t)batch};
  long long el[3];   // element strides of dims 1..3
  if (*head_first) {
    dims[1] = heads, dims[2] = rows_total;
    el[0] = st.h, el[1] = st.s;
  } else {
    dims[1] = rows_total, dims[2] = heads;
    el[0] = st.s, el[1] = st.h;
  }
  el[2] = st.b;
  cuuint64_t strides[3];
  long long packed = D;
  for (int i = 0; i < 3; ++i) {
    const long long e = dims[i + 1] == 1 ? packed : el[i];
    if (e <= 0 || (e * 2) % 16 != 0) return false;
    strides[i] = (cuuint64_t)(e * 2);
    packed = e * (long long)dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, *head_first ? 1u : (cuuint32_t)box_rows,
                             *head_first ? (cuuint32_t)box_rows : 1u, 1u};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
           int S, int Tk, Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int has_window, int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  bool fq, fk, fv;
  if (!make_map(&mq, q, D, S, H, B, qs, kBM, &fq) ||
      !make_map(&mk, k, D, Tk, KH, B, ks, Layout<D>::kBN, &fk) ||
      !make_map(&mv, v, D, Tk, KH, B, vs, Layout<D>::kBN, &fv))
    return (int)cudaErrorInvalidValue;
  const int orders = (fq ? 1 : 0) | (fk ? 2 : 0) | (fv ? 4 : 0);
  constexpr int bytes = Layout<D>::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_k<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)H * B * ((S + kBM - 1) / kBM);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_sm90_k<D><<<(unsigned)ctas, Layout<D>::kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), os, orders, H, B, H / KH, S, Tk,
      causal, has_window, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// bf16 only; D 64, 128 or 256; 16-byte-aligned bases; strides (in elements) of
// dims longer than 1 multiples of 8; scale > 0.  window is read only when
// has_window.
int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                               int B, int H, int KH, int S, int Tk, int D,
                               long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss,
                               int causal, int has_window, int window, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || Tk <= 0 ||
      (D != 64 && D != 128 && D != 256) || !(scale > 0.f) ||
      !aligned(q) || !aligned(k) ||
      !aligned(v) || !aligned(o) || o_ss % 2 != 0 || o_sh % 2 != 0 || o_sb % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, B, H, KH, S, Tk, qs, ks, vs, os, causal, has_window,
                      window, scale, st);
  if (D == 128)
    return launch<128>(q, k, v, o, B, H, KH, S, Tk, qs, ks, vs, os, causal, has_window,
                       window, scale, st);
  return launch<256>(q, k, v, o, B, H, KH, S, Tk, qs, ks, vs, os, causal, has_window,
                     window, scale, st);
}

// Head dim -> the tensor-core kernel's dynamic shared memory in bytes (0
// for a head dim it is not built for).
int repro_flash_attention_sm90_smem_bytes(int D) {
  if (D == 64) return Layout<64>::kAlloc;
  if (D == 128) return Layout<128>::kAlloc;
  if (D == 256) return Layout<256>::kAlloc;
  return 0;
}

}  // extern "C"
