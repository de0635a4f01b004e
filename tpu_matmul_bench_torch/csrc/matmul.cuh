// The kernels of K1 (csrc/matmul.cu): every template of the GEMM's two
// tensor-core routes, shared by the units that instantiate them.
//
// csrc/matmul.cu's library is compiled from several units, one nvcc each,
// started together and linked into one library (ops/_build.py): csrc/matmul.cu
// itself (the C entry points, the route dispatch, the fp32 SIMT GEMM and the
// split-K reduction) and one unit of csrc/matmul/ for each tensor-core route
// and operand dtype, and on the wmma route for each epilogue. A unit
// explicitly instantiates its kernels, for every tile of TMB_TILES, in the
// same file as the host functions that launch them (declared below), so a
// kernel is launched only from the unit that holds it and nothing needs
// relocatable device code. The kernels stay in an anonymous namespace: each
// is instantiated in one unit only, under the name ptxas reports for it.
//
// What the kernels compute, their routes and their design are described at
// the top of csrc/matmul.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "hopper_tile.cuh"

// The instantiated tensor-core tiles (BM, BN, BK), smallest first;
// ops/cuda_matmul.py TILES lists the same (tests/test_torch_tune.py holds
// the two together).
#define TMB_TILES(X)                                                                          \
  X(64, 128, 32) X(128, 64, 32) X(128, 128, 32) X(128, 128, 64) X(128, 256, 32) X(256, 128, 32) \
      X(128, 256, 64)

namespace tmb_gemm {

// grid orders shared with ops/cuda_matmul.py
enum Order : int { kMNK = 0, kNMK = 1 };

// The pickup operand of one launch: accin (nullptr for a plain product), its
// row stride, and C's row stride.
struct Pickup {
  const void* accin;
  int ldacc, ldc;
};

// One product as csrc/matmul.cu's dispatch hands it to a unit: C = A . B in
// `splits` slabs of width k (partials m*n apart in C), or with p.accin one
// pass that adds accin at the store; (bm, bn, bk) an instantiated tile; C in
// fp32 when f32_out (bf16 and f16 operands), else in the operands' dtype
// (int32 for int8); launched on stream s.
struct GemmArgs {
  const void* a;
  const void* b;
  void* c;
  int m, n, k, lda, ldb, splits, bm, bn, bk, order;
  bool f32_out;
  Pickup p;
  cudaStream_t s;
};

// Each unit's launch (the product, or cudaErrorInvalidValue for a tile it
// does not hold), the raise of its kernels' shared-memory limit (`_init`,
// once per device, outside any CUDA-graph capture), and the resident blocks
// per SM of its vector-load kernel at a tile (`_occupancy`; the plain units):
// csrc/matmul/wmma_{bf16,f16,i8}.cu, their pickup epilogues
// csrc/matmul/wmma_{bf16,f16,i8}_acc.cu, and csrc/matmul/wgmma_{bf16,f16}.cu.
cudaError_t wmma_bf16(const GemmArgs& g);
cudaError_t wmma_bf16_init();
cudaError_t wmma_bf16_occupancy(int bm, int bn, int bk, int* blocks);
cudaError_t wmma_bf16_acc(const GemmArgs& g);
cudaError_t wmma_bf16_acc_init();
cudaError_t wmma_f16(const GemmArgs& g);
cudaError_t wmma_f16_init();
cudaError_t wmma_f16_occupancy(int bm, int bn, int bk, int* blocks);
cudaError_t wmma_f16_acc(const GemmArgs& g);
cudaError_t wmma_f16_acc_init();
cudaError_t wmma_i8(const GemmArgs& g);
cudaError_t wmma_i8_init();
cudaError_t wmma_i8_occupancy(int bm, int bn, int bk, int* blocks);
cudaError_t wmma_i8_acc(const GemmArgs& g);
cudaError_t wmma_i8_acc_init();
cudaError_t wgmma_bf16(const GemmArgs& g);
cudaError_t wgmma_bf16_init();
cudaError_t wgmma_bf16_occupancy(int bm, int bn, int bk, int* blocks);
cudaError_t wgmma_f16(const GemmArgs& g);
cudaError_t wgmma_f16_init();
cudaError_t wgmma_f16_occupancy(int bm, int bn, int bk, int* blocks);

}  // namespace tmb_gemm

namespace {

using namespace nvcuda;
using namespace tmb_gemm;

// ---------------------------------------------------------------- tensor cores
constexpr int THREADS = 256;  // 8 warps, for every tile
constexpr int STAGES = 2;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

// Elements per row of a 16-wide slice in shared memory: 16 plus a pad that
// keeps the row a multiple of 16 bytes (cp.async) and every 16-row fragment
// a multiple of 32 bytes (wmma), with ldm a multiple of 16 bytes.
template <typename T> constexpr int kPitch = 16 + 16 / int(sizeof(T));

// Geometry of one tile: warp layout, fragments per warp, shared memory.
template <typename T, int BM_, int BN_, int BK_> struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = BM >= BN ? 4 : 2;
  static constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // per warp
  static constexpr int FM = WM / 16, FN = WN / 16;            // fragments
  static constexpr int P = kPitch<T>;
  static constexpr int A_ELEMS = (BK / 16) * BM * P;
  static constexpr int STAGE = A_ELEMS + (BN / 16) * BK * P;
  static constexpr int PIPE_BYTES = STAGES * STAGE * int(sizeof(T));
  static constexpr int EPI_BYTES = (THREADS / 32) * 256 * int(sizeof(typename AccOf<T>::type));
  static constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0,
                "a tile must split into 16x16x16 fragments over 8 warps");
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ __half zero() { return __float2half(0.f); }
template <> __device__ __forceinline__ signed char zero() { return 0; }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__half* p, float x) { *p = __float2half_rn(x); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(int* p, int x) { *p = x; }

// accin's element, widened to the accumulator dtype
__device__ __forceinline__ float get(const float* p) { return *p; }
__device__ __forceinline__ float get(const __half* p) { return __half2float(*p); }
__device__ __forceinline__ float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ int get(const int* p) { return *p; }

// The pickup's store: C[at] = v + accin[ai], both in C's dtype O, summed in
// the accumulator dtype and rounded once
template <typename O, typename Acc>
__device__ __forceinline__ void put_acc(void* C, const void* accin, size_t at, size_t ai, Acc v) {
  put(static_cast<O*>(C) + at, v + get(static_cast<const O*>(accin) + ai));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// One K step's tiles into shared memory. A's tile is kept as BK/16 slices of
// [BM][pitch], B's as BN/16 slices of [BK][pitch].
template <typename T, typename G, bool VEC>
__device__ __forceinline__ void load_tiles(T* As, T* Bs, const T* __restrict__ A,
                                           const T* __restrict__ B, int M, int N, int K,
                                           int lda, int ldb, int m0, int n0, int k0, int tid) {
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK, P = G::P;
  if constexpr (VEC) {
    constexpr int V = 16 / int(sizeof(T));  // elements per 16-byte vector
    for (int v = tid; v < BM * BK / V; v += THREADS) {
      const int r = v / (BK / V), kk = (v % (BK / V)) * V;
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async16(As + (kk / 16) * BM * P + r * P + kk % 16,
                 ok ? A + static_cast<size_t>(gm) * lda + gk : A, ok);
    }
    for (int v = tid; v < BK * BN / V; v += THREADS) {
      const int r = v / (BN / V), nn = (v % (BN / V)) * V;
      const int gk = k0 + r, gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + (nn / 16) * BK * P + r * P + nn % 16,
                 ok ? B + static_cast<size_t>(gk) * ldb + gn : B, ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[(kk / 16) * BM * P + r * P + kk % 16] =
          (gm < M && gk < K) ? A[static_cast<size_t>(gm) * lda + gk] : zero<T>();
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, nn = e % BN;
      const int gk = k0 + r, gn = n0 + nn;
      Bs[(nn / 16) * BK * P + r * P + nn % 16] =
          (gk < K && gn < N) ? B[static_cast<size_t>(gk) * ldb + gn] : zero<T>();
    }
  }
}

// C (+ blockIdx.z * c_split) = A[:, z*K : (z+1)*K] . B[z*K : (z+1)*K, :].
// C is int32 for int8 operands; otherwise fp32 when f32_out, else T.
// With ACC (one split only), C[i, j] = A.B[i, j] + accin[i, j]: accin has
// C's dtype, its rows `ldacc` apart, and C's rows are `ldc` apart.
template <typename T, bool VEC, int BM, int BN, int BK, bool ACC = false>
__global__ void __launch_bounds__(THREADS)
    wmma_gemm(const T* __restrict__ A, const T* __restrict__ B, void* __restrict__ C, int M,
              int N, int K, int lda, int ldb, size_t c_split, int order, bool f32_out,
              const void* __restrict__ accin, int ldacc, int ldc) {
  using G = Tile<T, BM, BN, BK>;
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int m0 = (order == kMNK ? blockIdx.y : blockIdx.x) * BM;
  const int n0 = (order == kMNK ? blockIdx.x : blockIdx.y) * BN;
  A += static_cast<size_t>(blockIdx.z) * K;
  B += static_cast<size_t>(blockIdx.z) * K * ldb;
  const size_t c0 = blockIdx.z * c_split;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[G::FM][G::FN];
#pragma unroll
  for (int i = 0; i < G::FM; ++i)
#pragma unroll
    for (int j = 0; j < G::FN; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const int steps = (K + BK - 1) / BK;
  if (steps > 0)
    load_tiles<T, G, VEC>(tiles, tiles + G::A_ELEMS, A, B, M, N, K, lda, ldb, m0, n0, 0, tid);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      T* next = tiles + ((s + 1) % STAGES) * G::STAGE;
      load_tiles<T, G, VEC>(next, next + G::A_ELEMS, A, B, M, N, K, lda, ldb, m0, n0,
                            (s + 1) * BK, tid);
    }
    cp_async_commit();
    cp_async_wait_prev();  // step s has landed; step s+1 may still be in flight
    __syncthreads();
    const T* As = tiles + (s % STAGES) * G::STAGE;
    const T* Bs = As + G::A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[G::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[G::FN];
#pragma unroll
      for (int i = 0; i < G::FM; ++i)
        wmma::load_matrix_sync(a[i], As + ks * BM * G::P + (wm * G::WM + i * 16) * G::P, G::P);
#pragma unroll
      for (int j = 0; j < G::FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * G::FN + j) * BK * G::P + ks * 16 * G::P, G::P);
#pragma unroll
      for (int i = 0; i < G::FM; ++i)
#pragma unroll
        for (int j = 0; j < G::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the buffer of step s is refilled at step s+1
  }

  // Epilogue: a fragment's element layout is opaque, so each warp stages one
  // 16x16 fragment at a time in shared memory, then stores it converted and
  // masked to the ragged edge.
  Acc* stage = reinterpret_cast<Acc*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < G::FM; ++i)
#pragma unroll
    for (int j = 0; j < G::FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * G::WM + i * 16 + e / 16;
        const int gn = n0 + wn * G::WN + j * 16 + e % 16;
        if (gm < M && gn < N) {
          if constexpr (ACC) {
            const size_t at = static_cast<size_t>(gm) * ldc + gn;
            const size_t ai = static_cast<size_t>(gm) * ldacc + gn;
            if constexpr (std::is_same_v<T, signed char>)
              put_acc<int>(C, accin, at, ai, stage[e]);
            else if (f32_out)
              put_acc<float>(C, accin, at, ai, stage[e]);
            else
              put_acc<T>(C, accin, at, ai, stage[e]);
          } else {
            const size_t at = c0 + static_cast<size_t>(gm) * N + gn;
            if constexpr (std::is_same_v<T, signed char>)
              put(static_cast<int*>(C) + at, stage[e]);
            else if (f32_out)
              put(static_cast<float*>(C) + at, stage[e]);
            else
              put(static_cast<T*>(C) + at, stage[e]);
          }
        }
      }
      __syncwarp();
    }
}

template <typename T, int BM, int BN, int BK, bool ACC>
void launch_kernel(bool vec, dim3 grid, const T* A, const T* B, void* C, int m, int n, int k,
                   int lda, int ldb, size_t c_split, int order, bool f32_out, Pickup p,
                   cudaStream_t s) {
  constexpr int smem = Tile<T, BM, BN, BK>::SMEM_BYTES;
  if (vec)
    wmma_gemm<T, true, BM, BN, BK, ACC><<<grid, THREADS, smem, s>>>(
        A, B, C, m, n, k, lda, ldb, c_split, order, f32_out, p.accin, p.ldacc, p.ldc);
  else
    wmma_gemm<T, false, BM, BN, BK, ACC><<<grid, THREADS, smem, s>>>(
        A, B, C, m, n, k, lda, ldb, c_split, order, f32_out, p.accin, p.ldacc, p.ldc);
}

template <typename T, int BM, int BN, int BK, bool ACC>
cudaError_t launch_tile(const T* A, const T* B, void* C, int m, int n, int k, int lda, int ldb,
                        int splits, int order, bool f32_out, Pickup p, cudaStream_t s) {
  constexpr int V = 16 / int(sizeof(T));
  const bool vec = k % V == 0 && n % V == 0 && lda % V == 0 && ldb % V == 0 &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const unsigned tm = (m + BM - 1) / BM, tn = (n + BN - 1) / BN;
  const dim3 grid(order == kMNK ? tn : tm, order == kMNK ? tm : tn, splits);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  const size_t c_split = static_cast<size_t>(m) * n;
  launch_kernel<T, BM, BN, BK, ACC>(vec, grid, A, B, C, m, n, k, lda, ldb, c_split, order,
                                    f32_out, p, s);
  return cudaGetLastError();
}

// The wmma route's product at the tile (g.bm, g.bn, g.bk), with the pickup's
// epilogue when ACC (g.p.accin set), else the plain one.
template <typename T, bool ACC> cudaError_t launch_wmma(const GemmArgs& g) {
  const T* A = static_cast<const T*>(g.a);
  const T* B = static_cast<const T*>(g.b);
#define TMB_LAUNCH(BM_, BN_, BK_)                                                              \
  if (g.bm == BM_ && g.bn == BN_ && g.bk == BK_)                                               \
    return launch_tile<T, BM_, BN_, BK_, ACC>(A, B, g.c, g.m, g.n, g.k, g.lda, g.ldb, g.splits, \
                                              g.order, g.f32_out, g.p, g.s);
  TMB_TILES(TMB_LAUNCH)
#undef TMB_LAUNCH
  return cudaErrorInvalidValue;  // not an instantiated tile
}

// Kernels above 48 KB of dynamic shared memory launch only after their limit
// is raised; set it for every instantiation, at the size each one uses.
template <typename T, int BM, int BN, int BK, bool ACC> cudaError_t init_kernels() {
  constexpr int bytes = Tile<T, BM, BN, BK>::SMEM_BYTES;
  const cudaError_t e = cudaFuncSetAttribute(wmma_gemm<T, true, BM, BN, BK, ACC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(wmma_gemm<T, false, BM, BN, BK, ACC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ... for every tile of TMB_TILES, with one epilogue
template <typename T, bool ACC> cudaError_t init_wmma() {
  cudaError_t e = cudaSuccess;
#define TMB_INIT(BM_, BN_, BK_) \
  if (e == cudaSuccess) e = init_kernels<T, BM_, BN_, BK_, ACC>();
  TMB_TILES(TMB_INIT)
#undef TMB_INIT
  return e;
}

// Resident blocks per SM of the vector-load kernel of one tile, as the
// runtime computes it from registers, shared memory and threads.
template <typename T, int BM, int BN, int BK> cudaError_t occupancy_tile(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wmma_gemm<T, true, BM, BN, BK>, THREADS, Tile<T, BM, BN, BK>::SMEM_BYTES);
}

template <typename T> cudaError_t occupancy_wmma(int bm, int bn, int bk, int* blocks) {
#define TMB_OCCUPANCY(BM_, BN_, BK_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return occupancy_tile<T, BM_, BN_, BK_>(blocks);
  TMB_TILES(TMB_OCCUPANCY)
#undef TMB_OCCUPANCY
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------- wgmma + TMA
// The epilogue's store of two neighbouring results v0, v1 at (gm, gn) (v1
// only when gn + 1 < N): into C's slice `slice` (rows N apart), or with
// accin, C = v + accin (rows ldc and ldacc apart); fp32 when f32_out, else T.
template <typename T>
__device__ __forceinline__ void store_pair(void* C, const void* accin, size_t slice, int M, int N,
                                           int ldacc, int ldc, bool f32_out, bool pairs, int gm,
                                           int gn, float v0, float v1) {
  if (gm >= M || gn >= N) return;
  const bool two = gn + 1 < N;
  if (accin != nullptr) {
    const size_t at = static_cast<size_t>(gm) * ldc + gn;
    const size_t ai = static_cast<size_t>(gm) * ldacc + gn;
    if (f32_out) {
      const float* in = static_cast<const float*>(accin) + ai;
      tmb::put2(static_cast<float*>(C) + at, v0 + in[0], two ? v1 + in[1] : 0.f, two, pairs);
    } else {
      const T* in = static_cast<const T*>(accin) + ai;
      tmb::put2(static_cast<T*>(C) + at, v0 + get(in), two ? v1 + get(in + 1) : 0.f, two, pairs);
    }
  } else {
    const size_t at = slice + static_cast<size_t>(gm) * N + gn;
    if (f32_out)
      tmb::put2(static_cast<float*>(C) + at, v0, v1, two, pairs);
    else
      tmb::put2(static_cast<T*>(C) + at, v0, v1, two, pairs);
  }
}

// C (+ blockIdx.z * c_split) = A[:, z*K : (z+1)*K] . B[z*K : (z+1)*K, :] on
// the warpgroup mainloop of hopper_tile.cuh; a_map and b_map describe the
// whole of A and B. C is fp32 when f32_out, else T. With accin, C[i, j] =
// A.B[i, j] + accin[i, j]: accin has C's dtype, its rows `ldacc` apart, and
// C's rows are `ldc` apart (one split only). `pairs`: C (and accin) take
// two neighbouring columns in one store. The grid is (tiles, 1, splits);
// tmb::raster places each block's tile, M the slow axis for kMNK.
template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(tmb::kThreads, 1)
    wgmma_gemm(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
               void* __restrict__ C, int M, int N, int K, size_t c_split, int order,
               bool f32_out, const void* __restrict__ accin, int ldacc, int ldc, bool pairs) {
  using G = tmb::WgTile<BM, BN, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const tmb::Stages<G> st = tmb::make_stages<G>(smem, tmb::kConsumerWarps);
  int mt = 0, nt = 0;
  tmb::raster(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, order == kMNK, &mt, &nt);
  const int m0 = mt * BM, n0 = nt * BN;
  const int kz = blockIdx.z * K;  // the split's first K coordinate
  const int ktiles = (K + BK - 1) / BK;
  tmb::Pipe pipe;
  if (threadIdx.x >= tmb::kProducerThread) {
    // the producer warpgroup: one thread issues every load
    tmb::producer_regs<tmb::kProducerRegs>();
    if (threadIdx.x == tmb::kProducerThread) {
      const CUtensorMap* am = &a_map;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int k0 = kz + kt * BK;
        tmb::produce(st, pipe, &b_map, n0, k0, [am, k0, m0](void* dst, uint64_t* bar) {
          tmb::tma_load_2d(dst, am, bar, k0, m0);
        });
      }
    }
  } else {
    tmb::consumer_regs<tmb::kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    float acc[G::MI][G::WN / 2];
    tmb::consume<T>(st, pipe, ktiles, wg, acc);
    const int r0 = m0 + (wg / G::WG_N) * G::WM, c0 = n0 + (wg % G::WG_N) * G::WN;
    const size_t slice = blockIdx.z * c_split;
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int q = 0; q < G::WN / 4; ++q)
        store_pair<T>(C, accin, slice, M, N, ldacc, ldc, f32_out, pairs,
                      r0 + 64 * i + tmb::pair_row(q), c0 + tmb::pair_col(q), acc[i][2 * q],
                      acc[i][2 * q + 1]);
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch_wgmma_tile(const T* A, const T* B, void* C, int m, int n, int k, int lda,
                              int ldb, int splits, int order, bool f32_out, Pickup p,
                              cudaStream_t s) {
  using G = tmb::WgTile<BM, BN, BK>;
  constexpr bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  CUtensorMap a_map, b_map;
  const int ktotal = k * splits;
  cudaError_t e = tmb::encode_a<G>(&a_map, bf16, A, m, ktotal, lda);
  if (e == cudaSuccess) e = tmb::encode_b<G>(&b_map, bf16, B, ktotal, n, ldb);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles), 1, splits);
  const size_t c_split = static_cast<size_t>(m) * n;
  const size_t item = f32_out ? 4 : 2;
  const auto even = [item](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % (2 * item) == 0;
  };
  const bool pairs = p.accin != nullptr
                         ? even(C) && even(p.accin) && p.ldc % 2 == 0 && p.ldacc % 2 == 0
                         : even(C) && n % 2 == 0;
  wgmma_gemm<T, BM, BN, BK><<<grid, tmb::kThreads, G::SMEM_BYTES, s>>>(
      a_map, b_map, C, m, n, k, c_split, order, f32_out, p.accin, p.ldacc, p.ldc, pairs);
  return cudaGetLastError();
}

// The wgmma route's product at the tile (g.bm, g.bn, g.bk).
template <typename T> cudaError_t launch_wgmma(const GemmArgs& g) {
  // what TMA cannot describe is refused, never sent to another route
  if (!tmb::tma_describable(g.a, g.lda) || !tmb::tma_describable(g.b, g.ldb))
    return reinterpret_cast<uintptr_t>(g.a) % 16 || reinterpret_cast<uintptr_t>(g.b) % 16
               ? cudaErrorMisalignedAddress
               : cudaErrorInvalidPitchValue;
  if (g.k < 1 || (g.splits > 1 && g.k % 64 != 0)) return cudaErrorInvalidValue;
  const T* A = static_cast<const T*>(g.a);
  const T* B = static_cast<const T*>(g.b);
#define TMB_LAUNCH(BM_, BN_, BK_)                                                           \
  if (g.bm == BM_ && g.bn == BN_ && g.bk == BK_)                                            \
    return launch_wgmma_tile<T, BM_, BN_, BK_>(A, B, g.c, g.m, g.n, g.k, g.lda, g.ldb,       \
                                               g.splits, g.order, g.f32_out, g.p, g.s);
  TMB_TILES(TMB_LAUNCH)
#undef TMB_LAUNCH
  return cudaErrorInvalidValue;  // not an instantiated tile
}

template <typename T, int BM, int BN, int BK> cudaError_t init_wgmma_tile() {
  return cudaFuncSetAttribute(wgmma_gemm<T, BM, BN, BK>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              tmb::WgTile<BM, BN, BK>::SMEM_BYTES);
}

template <typename T> cudaError_t init_wgmma() {
  cudaError_t e = cudaSuccess;
#define TMB_INIT(BM_, BN_, BK_) \
  if (e == cudaSuccess) e = init_wgmma_tile<T, BM_, BN_, BK_>();
  TMB_TILES(TMB_INIT)
#undef TMB_INIT
  return e;
}

template <typename T> cudaError_t occupancy_wgmma(int bm, int bn, int bk, int* blocks) {
#define TMB_OCCUPANCY(BM_, BN_, BK_)                                                     \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                               \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wgmma_gemm<T, BM_, BN_, BK_>, \
                                                         tmb::kThreads,                  \
                                                         tmb::WgTile<BM_, BN_, BK_>::SMEM_BYTES);
  TMB_TILES(TMB_OCCUPANCY)
#undef TMB_OCCUPANCY
  return cudaErrorInvalidValue;
}

}  // namespace
