// The warpgroup tile mainloop of the port's Hopper kernels, written once and
// shared by csrc/matmul.cu (wgmma_gemm: the GEMM under K1, K1b and the
// all-gather rings' products), csrc/ring_rs.cu (rs_step_wgmma: the
// reduce-scatter rings' persistent pickup) and csrc/ring_fused.cu
// (ring_fused_wgmma: K6's tiles).
//
// One block computes a BM x BN tile of C = A . B, A row-major (K-major), B
// row-major K x N (MN-major), bf16 or f16 operands, fp32 sums in registers:
// - TMA (cp.async.bulk.tensor) loads the A tile and BN/64 boxes of B into a
//   ring of STAGES shared-memory stages. A's rows are BK elements: 64 bytes
//   (BK 32, SWIZZLE_64B) or 128 bytes (BK 64, SWIZZLE_128B). B's boxes are
//   64 columns (128 bytes, SWIZZLE_128B) by BK rows. TMA zero-fills what lies
//   past the tensor's edge, so ragged M, N and K need no padding.
// - Each stage has a "full" mbarrier (one arrival plus the stage's bytes,
//   completed by TMA) and an "empty" one (one arrival from each consumer
//   warp, and from the copier thread where a kernel has one).
// - One producer thread keeps up to STAGES loads in flight. It sits in a
//   producer warpgroup that gives its registers away (setmaxnreg.dec 40).
// - Two consumer warpgroups take them (setmaxnreg.inc 232) and run
//   wgmma.mma_async (m64nWNk16, A and B from shared memory, B transposed,
//   since its N dimension is the contiguous one) with the sums in registers.
//   Each keeps one wgmma group in flight: it frees stage s only when the
//   group that read it is done.
// - The kernels put the two roles in one if/else that never reconverges, so
//   that ptxas honours setmaxnreg; csrc/*.cu and ops/_build.py fail the build
//   phase if ptxas reports otherwise or serialises the wgmma.
//
// The consumers split the tile among themselves along M when BM >= 128 (each
// WM = BM/2 rows, all BN columns), else along N (all 64 rows, BN/2 columns
// each). A warpgroup's columns WN are one wgmma's width (64, 128 or 256) and
// its rows WM/64 wgmmas.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the driver API, reached via the runtime)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace tmb {

constexpr int kConsumerWGs = 2;
constexpr int kConsumerWarps = kConsumerWGs * 4;
constexpr int kThreads = (kConsumerWGs + 1) * 128;  // the consumers, then the producer warpgroup
constexpr int kProducerThread = kConsumerWGs * 128;  // issues every TMA load
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSmemBudget = 200 * 1024;  // for the stages, of the 227 KB a block may use

template <int BM_, int BN_, int BK_> struct WgTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WG_M = BM >= 128 ? 2 : 1, WG_N = kConsumerWGs / WG_M;
  static constexpr int WM = BM / WG_M, WN = BN / WG_N;  // one consumer warpgroup's part
  static constexpr int MI = WM / 64;                    // its m64 wgmmas
  static constexpr int A_ROW = BK * 2;                  // bytes in a row of the A tile
  static constexpr int A_BYTES = BM * A_ROW;
  static constexpr int B_BOX = BK * 128;  // one 64-column box of B
  static constexpr int B_BYTES = (BN / 64) * B_BOX;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = kSmemBudget / STAGE_BYTES < 5 ? kSmemBudget / STAGE_BYTES : 5;
  // the stages, 1 KB to align them (SWIZZLE_128B wants 1024-byte boxes), barriers
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static_assert(BK == 32 || BK == 64, "A's row must be one 64- or 128-byte swizzle span");
  static_assert(WM % 64 == 0 && WN % 64 == 0 && WN <= 256, "a warpgroup takes m64 x n64..256");
  static_assert(STAGES >= 3, "the ring needs three stages at least");
};

// ------------------------------------------------------------------ barriers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A shared-memory box out to the tensor (the part inside its edges).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Every committed bulk store has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Every committed bulk store has written the tensor.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order the generic proxy's view of global memory with the async proxy's
// (TMA): after a barrier, before TMA reads what another block's TMA wrote.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// The same for shared memory: a thread's stores before it, then a barrier,
// come before a TMA store of what they wrote.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------- wgmma
// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128B, 2: 64B).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | swizzle << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a wgmma
// fence or wait.
template <int R> __device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R> __device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D[64 x N] += A[64 x 16] . B[16 x N]: A K-major, B MN-major (transposed),
// both from shared memory; fp32 sums. TY is the operand type's PTX name.
#define TMB_WGMMA_N64(TY)                                                       \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                  \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
#define TMB_WGMMA_N128(TY)                                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                       \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, "      \
  "%63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
#define TMB_WGMMA_N256(TY)                                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                              \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "     \
  "%125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
#define TMB_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TMB_D32(i) TMB_D8(i), TMB_D8(i + 8), TMB_D8(i + 16), TMB_D8(i + 24)

// `add` 0 makes D = A . B, dropping what D held: the first K step of a tile
// starts the sums so, and nothing but wgmma ever writes the accumulators
// (a zeroing move among them makes ptxas serialise the wgmma).
template <typename T>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int add) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm volatile(TMB_WGMMA_N64("bf16") : TMB_D32(0) : "l"(a), "l"(b), "r"(add));
  else
    asm volatile(TMB_WGMMA_N64("f16") : TMB_D32(0) : "l"(a), "l"(b), "r"(add));
}
template <typename T>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int add) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm volatile(TMB_WGMMA_N128("bf16") : TMB_D32(0), TMB_D32(32) : "l"(a), "l"(b), "r"(add));
  else
    asm volatile(TMB_WGMMA_N128("f16") : TMB_D32(0), TMB_D32(32) : "l"(a), "l"(b), "r"(add));
}
template <typename T>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b, int add) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm volatile(TMB_WGMMA_N256("bf16")
                 : TMB_D32(0), TMB_D32(32), TMB_D32(64), TMB_D32(96)
                 : "l"(a), "l"(b), "r"(add));
  else
    asm volatile(TMB_WGMMA_N256("f16")
                 : TMB_D32(0), TMB_D32(32), TMB_D32(64), TMB_D32(96)
                 : "l"(a), "l"(b), "r"(add));
}
#undef TMB_D32
#undef TMB_D8
#undef TMB_WGMMA_N256
#undef TMB_WGMMA_N128
#undef TMB_WGMMA_N64

// ------------------------------------------------------------------ the ring
// A stage index and the parity of its barriers' current phase, advanced in
// the same order by the producer, the consumers and a copier.
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  template <int STAGES> __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The stages in dynamic shared memory, aligned to 1 KB, then the barriers.
template <typename G> struct Stages {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ unsigned char* a(int s) const { return base + s * G::STAGE_BYTES; }
  __device__ __forceinline__ unsigned char* b(int s) const { return a(s) + G::A_BYTES; }
};

// Carve the stages out of `raw` and initialise the barriers: `empty_arrivals`
// arrivals free a stage. Every thread of the block calls it.
template <typename G>
__device__ __forceinline__ Stages<G> make_stages(unsigned char* raw, int empty_arrivals) {
  const uintptr_t at = (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023);
  Stages<G> st;
  st.base = reinterpret_cast<unsigned char*>(at);
  st.full = reinterpret_cast<uint64_t*>(st.base + G::STAGES * G::STAGE_BYTES);
  st.empty = st.full + G::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(st.full + s, 1);
      mbar_init(st.empty + s, empty_arrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return st;
}

// Producer: load one K step of a tile into the next free stage. `load_a`
// issues the A box (its tensor map and coordinates are the caller's); B's
// BN/64 boxes come from `b_map` at columns n0.., rows k0...
template <typename G, typename LoadA>
__device__ __forceinline__ void produce(const Stages<G>& st, Pipe& p, const CUtensorMap* b_map,
                                        int n0, int k0, LoadA&& load_a) {
  mbar_wait(st.empty + p.stage, p.phase ^ 1);
  mbar_expect_tx(st.full + p.stage, G::STAGE_BYTES);
  load_a(st.a(p.stage), st.full + p.stage);
#pragma unroll
  for (int j = 0; j < G::BN / 64; ++j)
    tma_load_2d(st.b(p.stage) + j * G::B_BOX, b_map, st.full + p.stage, n0 + 64 * j, k0);
  p.advance<G::STAGES>();
}

// Consumer warpgroup `wg`: acc = the sum over `ktiles` (at least 1) stages
// of its part of A . B. acc[i] holds rows 64*i.. of the part, in the wgmma
// fragment layout that pair_row and pair_col name.
template <typename T, typename G>
__device__ __forceinline__ void consume(const Stages<G>& st, Pipe& p, int ktiles, int wg,
                                        float (&acc)[G::MI][G::WN / 2]) {
  constexpr uint64_t a_swizzle = G::A_ROW == 128 ? 1 : 2;
  const int wm0 = (wg / G::WG_N) * G::WM, wn0 = (wg % G::WG_N) * G::WN;
  int held = -1;  // the stage whose wgmma group may still run
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(st.full + p.stage, p.phase);
#pragma unroll
    for (int i = 0; i < G::MI; ++i) fence_operands(acc[i]);
    wgmma_fence();
    const unsigned char* a = st.a(p.stage) + wm0 * G::A_ROW;
    const unsigned char* b = st.b(p.stage) + (wn0 / 64) * G::B_BOX;
#pragma unroll
    for (int kk = 0; kk < G::BK / 16; ++kk) {
      // A: K-major rows, 8-row atoms A_ROW*8 bytes apart, k16 = 32 bytes on;
      // B: MN-major, 8-row atoms 1 KB apart, 64-column boxes B_BOX apart,
      // k16 = 16 rows of 128 bytes on
      const uint64_t db = smem_desc(b + kk * 16 * 128, G::B_BOX, 1024, 1);
#pragma unroll
      for (int i = 0; i < G::MI; ++i)
        wgmma<T>(acc[i], smem_desc(a + i * 64 * G::A_ROW + kk * 32, 16, 8 * G::A_ROW, a_swizzle),
                 db, kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < G::MI; ++i) fence_operands(acc[i]);
    if (held >= 0 && threadIdx.x % 32 == 0) mbar_arrive(st.empty + held);
    held = p.stage;
    p.advance<G::STAGES>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < G::MI; ++i) fence_operands(acc[i]);
  if (held >= 0 && threadIdx.x % 32 == 0) mbar_arrive(st.empty + held);
}

// The fp32 results of an m64nN wgmma come as N/4 pairs of neighbouring
// columns per thread: pair q is d[2q], d[2q+1], at row pair_row(q) and
// columns pair_col(q), pair_col(q) + 1 of the 64 x N part. The kernels walk
// q in unrolled loops, so that every index into the accumulators is a
// constant and they stay in registers.
__device__ __forceinline__ int pair_row(int q) {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * (q % 2);
}
__device__ __forceinline__ int pair_col(int q) { return 8 * (q / 2) + 2 * (threadIdx.x % 4); }

// The output tile (m, n) of block `block` of a tm x tn grid of tiles: the
// raster walks groups of kGroup tiles of the slow axis (M for `m_slow`, else
// N), and inside a group the fast axis's tiles in turn, so that the blocks in
// flight share kGroup bands of one operand and a few of the other, and both
// stay in L2.
constexpr int kGroup = 8;
__device__ __forceinline__ void raster(int block, int tm, int tn, bool m_slow, int* m, int* n) {
  const int slow = m_slow ? tm : tn, fast = m_slow ? tn : tm;
  const int first = block / (kGroup * fast) * kGroup;
  const int rows = slow - first < kGroup ? slow - first : kGroup;
  const int in = block - first * fast;
  const int s = first + in % rows, f = in / rows;
  *m = m_slow ? s : f;
  *n = m_slow ? f : s;
}

// ------------------------------------------------------------ stores, host
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__half* p, float x) { *p = __float2half_rn(x); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// p[0] = v0 and, when `two`, p[1] = v1; one store of both when `pair` says
// that p is aligned for it.
__device__ __forceinline__ void put2(float* p, float v0, float v1, bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    *p = v0;
    if (two) p[1] = v1;
  }
}
__device__ __forceinline__ void put2(__half* p, float v0, float v1, bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
  } else {
    put(p, v0);
    if (two) put(p + 1, v1);
  }
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float v0, float v1, bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    put(p, v0);
    if (two) put(p + 1, v1);
  }
}

// cuTensorMapEncodeTiled, taken from the CUDA driver API through the runtime
// once, so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major tensor of `dims` (innermost first; 2 or 3 of them) with the
// byte strides of its outer dimensions, read or written in boxes of `box`.
// Returns cudaErrorInvalidValue when the CUDA driver API refuses it.
inline cudaError_t encode(CUtensorMap* map, bool bf16, const void* base, int rank,
                          const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                          CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The A operand of a tile: a rows x cols (K) row-major matrix, rows `ld`
// elements apart, in boxes of BK x BM. And B: K x N, in 64 x BK boxes.
template <typename G>
inline cudaError_t encode_a(CUtensorMap* map, bool bf16, const void* base, int rows, int cols,
                            int ld) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld) * 2};
  const uint32_t box[2] = {G::BK, G::BM};
  return encode(map, bf16, base, 2, dims, strides, box,
                G::A_ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}
template <typename G>
inline cudaError_t encode_b(CUtensorMap* map, bool bf16, const void* base, int rows, int cols,
                            int ld) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld) * 2};
  const uint32_t box[2] = {64, G::BK};
  return encode(map, bf16, base, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Whether TMA can describe a 16-bit operand at `p` with rows `ld` elements
// apart: a 16-byte aligned base and a row stride that is a whole number of
// 16-byte units (ops/cuda_matmul.py gemm_route is the same rule).
inline bool tma_describable(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * 2) % 16 == 0;
}

// The SM count and cooperative-launch support of each device, queried once
// per library and device (the grids of K6 and of the persistent pickup).
constexpr int kMaxDevices = 64;
struct Card {
  bool ready = false;
  int sms = 0, coop = 0;
};

inline cudaError_t card(int dev, const Card** out) {
  static Card cards[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Card& c = cards[dev];
  if (!c.ready) {
    cudaError_t e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&c.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    c.ready = true;
  }
  *out = &c;
  return cudaSuccess;
}

}  // namespace tmb
