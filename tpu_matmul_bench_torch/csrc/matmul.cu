// Hand-written GEMMs for Hopper (sm_90a): the port's `cuda` matmul kernel,
// its split-K form, and the reduction that finishes the split-K.
//
// Replaces:
// - tpu_matmul_bench/ops/pallas_matmul.py::_matmul_kernel (:37-50), the
//   blocked Pallas kernel that pallas_matmul (:240-345) runs on the TPU MXU,
//   with its block sizes and grid_order;
// - pallas_matmul_ksplit (:352-401), which runs that kernel once per K slab
//   with accumulator-dtype stores and sums the partials before one downcast;
// - tpu_matmul_bench/ops/pallas_ring_rs_hbm.py::_rs_acc_kernel (:52-66), the
//   reduce-scatter ring's pickup: C = round_out(A.B + accin), the partial
//   that arrived over the ring added to the product in fp32 (int32 for int8)
//   and rounded once at the store (tmb_matmul_acc).
//
// What it computes: C[m,n] = A[m,k] . B[k,n] for row-major operands whose
// rows may be strided (lda, ldb), so a K slab A[:, k0:k0+kc] . B[k0:k0+kc, :]
// is a view, never a copy. bf16/f16/f32 products accumulate in fp32
// registers, int8 products in int32, and each C element is stored once,
// converted to the output dtype the caller names: the operand dtype by
// default (int32 for int8), or fp32 for bf16/f16 operands.
//
// Bound on this card: the headline product, 16384^3 in bf16, does
// 2*16384^3 = 8.8e12 operations on 1.5 GiB of A, B and C, about 5,500 FLOP
// per byte of device memory traffic, far above the H100's ridge of ~295
// FLOP/byte. It is bound by the tensor cores: 8.9 ms at the SXM part's 989
// dense bf16 TFLOP/s (NVIDIA H100 datasheet). A split-K in two adds two fp32
// partials written and read back (4 bytes x m x n each way): at 16384^3
// that is 1.76 ms of traffic against 8.9 ms of operations, still bound by
// operations.
//
// Design, against the TPU kernel:
// - The Pallas grid walks K as its innermost, sequential axis and carries the
//   sum in a VMEM scratch between grid steps. Blocks on a GPU run in no
//   order, so here each block owns one BMxBN output tile and loops over K
//   itself, with the sum in registers; nothing crosses blocks.
// - The tile (BM, BN, BK) is a template parameter with a small fixed set of
//   instantiations (TMB_TILES). Every tile runs 8 warps; the warp layout is
//   derived from the tile (4x2 warps when BM >= BN, else 2x4), and each warp
//   computes its sub-tile as 16x16x16 wmma fragments (bf16/f16 into fp32, s8
//   into s32).
// - A and B tiles are staged through dynamic shared memory in two buffers:
//   cp.async brings in step k+1 while the tensor cores work on k. Tiles are
//   kept as 16-wide column slices, so that every fragment starts on the
//   32-byte boundary wmma requires, for 8-bit operands too. Tiles above the
//   default 48 KB of shared memory (128x128x64, the 256-wide ones) need the
//   per-kernel limit raised: tmb_init does that for every instantiation.
// - grid_order is the raster of output tiles: "mnk" puts N tiles on
//   blockIdx.x, so M is the slowest axis and the blocks in flight share a
//   band of A; "nmk" swaps the two axes and they share a band of B.
// - pallas_matmul zero-pads awkward dimensions to multiples of 128 and slices
//   the result. Here the ragged edge is zero-filled on the way into shared
//   memory and masked on the store, so no padded copy is ever made. When a
//   row of A or B is not a whole number of 16-byte vectors the tiles are
//   loaded element by element instead of by cp.async.
// - Split-K: one launch with gridDim.z = S. Block z multiplies the slab
//   [z*kc, (z+1)*kc) and stores its fp32 (int32 for int8) partial into slice
//   z of a workspace [S, m, n]; reduce_partials then adds the slices in the
//   order s = 0..S-1 and stores C once, as pallas_matmul_ksplit's
//   `acc + part` loop followed by one astype.
// - fp32 operands take a plain SIMT kernel (64x64x16 tiles, 4x4 outputs per
//   thread, fp32 FMA): the tensor cores have no full-precision fp32 mode.
// - The pickup is an epilogue option (template flag ACC) of both kernels:
//   the Pallas kernel adds accin on its last K step, here the epilogue reads
//   accin (output dtype, rows `ldacc` apart) beside each stored element and
//   C's rows are `ldc` apart. With ACC off the kernel is K1 as it was. The
//   extra traffic is one read of accin per output element, m*n*2 bytes in
//   bf16: for one ring step of bf16 16384^2 over 4 ranks (4096x4096 .
//   4096x16384) 128 MiB, 0.04 ms at 3.35 TB/s against 0.56 ms of
//   operations at 989 TFLOP/s, so the pickup stays bound by operations.
//
// Left for later work: wgmma and TMA with a multistage mbarrier pipeline,
// warp specialisation, persistent blocks, and a tensor-core path for fp32
// under TF32.
//
// The C entry points launch on the caller's stream, allocate nothing and do
// not synchronise, so they can be captured in a CUDA graph. They return
// cudaGetLastError() after the launch. tmb_init must run once per device,
// outside any capture, before the first launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;

// The instantiated tensor-core tiles (BM, BN, BK), smallest first;
// ops/cuda_matmul.py TILES lists the same (tests/test_torch_tune.py holds
// the two together).
#define TMB_TILES(X) \
  X(64, 128, 32) X(128, 64, 32) X(128, 128, 32) X(128, 128, 64) X(128, 256, 32) X(256, 128, 32)

namespace {

// dtype codes shared with ops/cuda_matmul.py
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3, kI32 = 4 };
// grid orders shared with ops/cuda_matmul.py
enum Order : int { kMNK = 0, kNMK = 1 };

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

// The pickup operand of one launch: accin (nullptr for a plain product), its
// row stride, and C's row stride.
struct Pickup {
  const void* accin;
  int ldacc, ldc;
};

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

template <typename T, int BM, int BN, int BK>
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
  if (p.accin != nullptr)
    launch_kernel<T, BM, BN, BK, true>(vec, grid, A, B, C, m, n, k, lda, ldb, c_split, order,
                                       f32_out, p, s);
  else
    launch_kernel<T, BM, BN, BK, false>(vec, grid, A, B, C, m, n, k, lda, ldb, c_split, order,
                                        f32_out, p, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wmma(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                        int ldb, int splits, int bm, int bn, int bk, int order, bool f32_out,
                        Pickup p, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
#define TMB_LAUNCH(BM_, BN_, BK_)                                                            \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                                   \
    return launch_tile<T, BM_, BN_, BK_>(A, B, c, m, n, k, lda, ldb, splits, order, f32_out, p, \
                                         s);
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

template <typename T, int BM, int BN, int BK> cudaError_t init_tile() {
  const cudaError_t e = init_kernels<T, BM, BN, BK, false>();
  if (e != cudaSuccess) return e;
  return init_kernels<T, BM, BN, BK, true>();
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

// ------------------------------------------------------------------ fp32 SIMT
constexpr int SBM = 64, SBN = 64, SBK = 16, STHREADS = 256;

template <bool ACC = false>
__global__ void __launch_bounds__(STHREADS)
    simt_gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, int lda, int ldb, size_t c_split,
                  int order, const float* __restrict__ accin, int ldacc, int ldc) {
  __shared__ float As[SBK][SBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = (order == kMNK ? blockIdx.y : blockIdx.x) * SBM;
  const int n0 = (order == kMNK ? blockIdx.x : blockIdx.y) * SBN;
  A += static_cast<size_t>(blockIdx.z) * K;
  B += static_cast<size_t>(blockIdx.z) * K * ldb;
  C += blockIdx.z * c_split;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int e = tid; e < SBM * SBK; e += STHREADS) {
      const int r = e / SBK, kk = e % SBK, gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * lda + gk] : 0.f;
    }
    for (int e = tid; e < SBK * SBN; e += STHREADS) {
      const int kk = e / SBN, cc = e % SBN, gk = k0 + kk, gn = n0 + cc;
      Bs[kk][cc] = (gk < K && gn < N) ? B[static_cast<size_t>(gk) * ldb + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if constexpr (ACC) {
        if (gm < M && gn < N)
          C[static_cast<size_t>(gm) * ldc + gn] =
              acc[i][j] + accin[static_cast<size_t>(gm) * ldacc + gn];
      } else {
        if (gm < M && gn < N) C[static_cast<size_t>(gm) * N + gn] = acc[i][j];
      }
    }
}

cudaError_t launch_simt(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                        int ldb, int splits, int bm, int bn, int bk, int order, Pickup p,
                        cudaStream_t s) {
  if (bm != SBM || bn != SBN || bk != SBK) return cudaErrorInvalidValue;
  const unsigned tm = (m + SBM - 1) / SBM, tn = (n + SBN - 1) / SBN;
  const dim3 grid(order == kMNK ? tn : tm, order == kMNK ? tm : tn, splits);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  const float* acc = static_cast<const float*>(p.accin);
  const size_t c_split = static_cast<size_t>(m) * n;
  if (acc != nullptr)
    simt_gemm_f32<true><<<grid, STHREADS, 0, s>>>(A, B, C, m, n, k, lda, ldb, c_split, order,
                                                  acc, p.ldacc, p.ldc);
  else
    simt_gemm_f32<false><<<grid, STHREADS, 0, s>>>(A, B, C, m, n, k, lda, ldb, c_split, order,
                                                   acc, p.ldacc, p.ldc);
  return cudaGetLastError();
}

// ------------------------------------------------- split-K: sum of partials
// C[i] = sum over s = 0..S-1, in that order, of ws[s][i], added in the
// accumulator dtype and converted once. Bound by memory: S reads and one
// write per element, in a grid-stride loop over 16-byte vectors of partials.
constexpr int RTHREADS = 256, RMAX_BLOCKS = 4096;

template <typename Acc> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <typename Acc, typename TO, bool VEC>
__global__ void __launch_bounds__(RTHREADS)
    reduce_partials(const Acc* __restrict__ ws, TO* __restrict__ C, int splits, size_t count) {
  const size_t stride = static_cast<size_t>(gridDim.x) * RTHREADS;
  const size_t first = static_cast<size_t>(blockIdx.x) * RTHREADS + threadIdx.x;
  if constexpr (VEC) {
    using V4 = typename Vec4<Acc>::type;
    const V4* w = reinterpret_cast<const V4*>(ws);
    const size_t count4 = count / 4;
    for (size_t i = first; i < count4; i += stride) {
      V4 acc = w[i];
      for (int s = 1; s < splits; ++s) {
        const V4 p = w[s * count4 + i];
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
      put(C + 4 * i, acc.x);
      put(C + 4 * i + 1, acc.y);
      put(C + 4 * i + 2, acc.z);
      put(C + 4 * i + 3, acc.w);
    }
  } else {
    for (size_t i = first; i < count; i += stride) {
      Acc acc = ws[i];
      for (int s = 1; s < splits; ++s) acc += ws[s * count + i];
      put(C + i, acc);
    }
  }
}

template <typename Acc, typename TO>
cudaError_t launch_reduce(const void* ws, void* c, int splits, size_t count, cudaStream_t s) {
  const bool vec = count % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  const size_t work = vec ? count / 4 : count;
  const size_t want = (work + RTHREADS - 1) / RTHREADS;
  const unsigned blocks = static_cast<unsigned>(want < RMAX_BLOCKS ? want : RMAX_BLOCKS);
  const Acc* W = static_cast<const Acc*>(ws);
  TO* C = static_cast<TO*>(c);
  if (vec)
    reduce_partials<Acc, TO, true><<<blocks, RTHREADS, 0, s>>>(W, C, splits, count);
  else
    reduce_partials<Acc, TO, false><<<blocks, RTHREADS, 0, s>>>(W, C, splits, count);
  return cudaGetLastError();
}

// The GEMM for every dtype pair. `splits` slabs of width k each, partials
// `m*n` apart in C; or, with p.accin, one pass that adds accin at the store.
cudaError_t gemm(const void* a, const void* b, void* c, int m, int n, int k, int lda, int ldb,
                 int splits, int in_dtype, int out_dtype, int bm, int bn, int bk, int order,
                 Pickup p, cudaStream_t s) {
  if (m < 0 || n < 0 || k < 0 || splits < 1 || splits > 65535 || ldb < n ||
      static_cast<long long>(lda) < static_cast<long long>(k) * splits ||
      (order != kMNK && order != kNMK) ||
      (p.accin != nullptr && (splits != 1 || p.ldacc < n || p.ldc < n)))
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  if (in_dtype == kBF16 && (out_dtype == kBF16 || out_dtype == kF32))
    return launch_wmma<__nv_bfloat16>(a, b, c, m, n, k, lda, ldb, splits, bm, bn, bk, order,
                                      out_dtype == kF32, p, s);
  if (in_dtype == kF16 && (out_dtype == kF16 || out_dtype == kF32))
    return launch_wmma<__half>(a, b, c, m, n, k, lda, ldb, splits, bm, bn, bk, order,
                               out_dtype == kF32, p, s);
  if (in_dtype == kI8 && out_dtype == kI32)
    return launch_wmma<signed char>(a, b, c, m, n, k, lda, ldb, splits, bm, bn, bk, order,
                                    false, p, s);
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch_simt(a, b, c, m, n, k, lda, ldb, splits, bm, bn, bk, order, p, s);
  return cudaErrorInvalidValue;
}

constexpr Pickup kNoPickup = {nullptr, 0, 0};

}  // namespace

extern "C" {

// Raise the dynamic shared-memory limit of every tensor-core instantiation on
// the current device. Call once per device, outside any CUDA-graph capture.
int tmb_init() {
  cudaError_t e = cudaSuccess;
#define TMB_INIT(BM_, BN_, BK_)                                                  \
  if (e == cudaSuccess) e = init_tile<__nv_bfloat16, BM_, BN_, BK_>();           \
  if (e == cudaSuccess) e = init_tile<__half, BM_, BN_, BK_>();                  \
  if (e == cudaSuccess) e = init_tile<signed char, BM_, BN_, BK_>();
  TMB_TILES(TMB_INIT)
#undef TMB_INIT
  return static_cast<int>(e);
}

// Resident blocks per SM of the tensor-core kernel for operands of
// `in_dtype` (bf16, f16 or int8) at tile (bm, bn, bk), into *blocks. Call
// after tmb_init.
int tmb_occupancy(int in_dtype, int bm, int bn, int bk, int* blocks) {
  cudaError_t e = cudaErrorInvalidValue;
  if (in_dtype == kBF16) e = occupancy_wmma<__nv_bfloat16>(bm, bn, bk, blocks);
  if (in_dtype == kF16) e = occupancy_wmma<__half>(bm, bn, bk, blocks);
  if (in_dtype == kI8) e = occupancy_wmma<signed char>(bm, bn, bk, blocks);
  return static_cast<int>(e);
}

// C = A . B on `stream`. A's rows are `lda` elements apart and B's `ldb`;
// C is dense m x n. in_dtype/out_dtype are DType codes; the pairs taken are
// bf16->{bf16,f32}, f16->{f16,f32}, f32->f32 and int8->int32. (bm, bn, bk)
// is an instantiated tile (64x64x16 for fp32); grid_order is an Order code.
// Returns 0 or a cudaError_t code.
int tmb_matmul(const void* a, const void* b, void* c, int m, int n, int k, int lda, int ldb,
               int in_dtype, int out_dtype, int bm, int bn, int bk, int grid_order,
               void* stream) {
  return static_cast<int>(gemm(a, b, c, m, n, k, lda, ldb, 1, in_dtype, out_dtype, bm, bn, bk,
                               grid_order, kNoPickup, static_cast<cudaStream_t>(stream)));
}

// The reduce-scatter ring's pickup: C = A . B + accin, summed in fp32 (int32
// for int8) and rounded once to out_dtype. accin and C are m x n in
// out_dtype, their rows `ldacc` and `ldc` elements apart, in two buffers
// that do not overlap. The other arguments are tmb_matmul's.
int tmb_matmul_acc(const void* a, const void* b, const void* accin, void* c, int m, int n, int k,
                   int lda, int ldb, int ldacc, int ldc, int in_dtype, int out_dtype, int bm,
                   int bn, int bk, int grid_order, void* stream) {
  if (accin == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gemm(a, b, c, m, n, k, lda, ldb, 1, in_dtype, out_dtype, bm, bn, bk,
                               grid_order, Pickup{accin, ldacc, ldc},
                               static_cast<cudaStream_t>(stream)));
}

// The K-split partials: for s = 0..splits-1, ws[s] = A[:, s*kc:(s+1)*kc] .
// B[s*kc:(s+1)*kc, :], stored in the accumulator dtype (fp32; int32 for
// int8) into the dense [splits, m, n] workspace, in one launch.
int tmb_matmul_ksplit(const void* a, const void* b, void* ws, int m, int n, int kc, int splits,
                      int lda, int ldb, int in_dtype, int bm, int bn, int bk, int grid_order,
                      void* stream) {
  const int acc = in_dtype == kI8 ? kI32 : kF32;
  return static_cast<int>(gemm(a, b, ws, m, n, kc, lda, ldb, splits, in_dtype, acc, bm, bn, bk,
                               grid_order, kNoPickup, static_cast<cudaStream_t>(stream)));
}

// C[i] = sum_{s<splits} ws[s][i] for i < count, summed in order in the
// partials' dtype (int32 when out_dtype is int32, else fp32) and stored once
// as out_dtype (f32, f16, bf16 or int32).
int tmb_reduce_partials(const void* ws, void* c, int splits, long long count, int out_dtype,
                        void* stream) {
  if (splits < 1 || count < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const size_t n = static_cast<size_t>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (out_dtype) {
    case kF32: e = launch_reduce<float, float>(ws, c, splits, n, s); break;
    case kF16: e = launch_reduce<float, __half>(ws, c, splits, n, s); break;
    case kBF16: e = launch_reduce<float, __nv_bfloat16>(ws, c, splits, n, s); break;
    case kI32: e = launch_reduce<int, int>(ws, c, splits, n, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* tmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
