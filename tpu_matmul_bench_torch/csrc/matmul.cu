// Hand-written GEMM for Hopper (sm_90a): the port's `cuda` matmul kernel.
//
// Replaces: tpu_matmul_bench/ops/pallas_matmul.py::_matmul_kernel (:37-50),
// the blocked Pallas kernel that pallas_matmul (:240-345) runs on the TPU MXU.
//
// What it computes: C[m,n] = A[m,k] . B[k,n] for row-major contiguous
// operands. bf16/f16/f32 products accumulate in fp32 registers, int8 products
// in int32, and each C element is stored once, converted to the output dtype
// the caller names: the operand dtype by default (int32 for int8), or fp32
// for bf16/f16 operands, which the K-split variant needs for its partials.
//
// Bound on this card: the headline product, 16384^3 in bf16, does
// 2*16384^3 = 8.8e12 operations on 1.5 GiB of A, B and C, about 5,500 FLOP
// per byte of device memory traffic, far above the H100's ridge of ~295
// FLOP/byte. It is bound by the tensor cores: 8.9 ms at the SXM part's 989
// dense bf16 TFLOP/s (NVIDIA H100 datasheet).
//
// Design, against the TPU kernel:
// - The Pallas grid walks K as its innermost, sequential axis and carries the
//   sum in a VMEM scratch between grid steps. Blocks on a GPU run in no
//   order, so here each block owns one 128x128 output tile and loops over K
//   itself, with the sum in registers; nothing crosses blocks.
// - A and B tiles (128x32, 32x128) are staged through shared memory in two
//   buffers: cp.async brings in step k+1 while the tensor cores work on k.
//   Eight warps each compute a 32x64 sub-tile as 2x4 wmma fragments of
//   16x16x16 (bf16/f16 into fp32, s8 into s32).
// - Tiles are kept in shared memory as 16-wide column slices, so that every
//   fragment starts on the 32-byte boundary wmma requires, for 8-bit
//   operands too.
// - pallas_matmul zero-pads awkward dimensions to multiples of 128 and slices
//   the result. Here the ragged edge is zero-filled on the way into shared
//   memory and masked on the store, so no padded copy is ever made. When a
//   row of A or B is not a whole number of 16-byte vectors the tiles are
//   loaded element by element instead of by cp.async.
// - fp32 operands take a plain SIMT kernel (64x64 tiles, 4x4 outputs per
//   thread, fp32 FMA): the tensor cores have no full-precision fp32 mode.
//
// Left for later work: wgmma and TMA with a multistage mbarrier pipeline,
// warp specialisation, persistent blocks with tile rasterisation for L2
// reuse (the TPU kernel's grid_order), and a tensor-core path for fp32
// under TF32.
//
// The C entry point launches on the caller's stream, allocates nothing and
// does not synchronise, so it can be captured in a CUDA graph. It returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

// dtype codes shared with ops/cuda_matmul.py
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3, kI32 = 4 };

// ---------------------------------------------------------------- tensor cores
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 32 rows per warp
constexpr int WN = BN / WARPS_N;  // 64 columns per warp
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int STAGES = 2;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

// Elements per row of a 16-wide slice in shared memory: 16 plus a pad that
// keeps the row a multiple of 16 bytes (cp.async) and every 16-row fragment
// a multiple of 32 bytes (wmma), with ldm a multiple of 16 bytes.
template <typename T> constexpr int kPitch = 16 + 16 / int(sizeof(T));

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ __half zero() { return __float2half(0.f); }
template <> __device__ __forceinline__ signed char zero() { return 0; }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__half* p, float x) { *p = __float2half_rn(x); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(int* p, int x) { *p = x; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// One K step's tiles into shared memory. A's tile is kept as BK/16 slices of
// [BM][pitch], B's as BN/16 slices of [BK][pitch].
template <typename T, bool VEC>
__device__ __forceinline__ void load_tiles(T* As, T* Bs, const T* __restrict__ A,
                                           const T* __restrict__ B, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  constexpr int P = kPitch<T>;
  if constexpr (VEC) {
    constexpr int V = 16 / int(sizeof(T));  // elements per 16-byte vector
    for (int v = tid; v < BM * BK / V; v += THREADS) {
      const int r = v / (BK / V), kk = (v % (BK / V)) * V;
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      cp_async16(As + (kk / 16) * BM * P + r * P + kk % 16,
                 ok ? A + static_cast<size_t>(gm) * K + gk : A, ok);
    }
    for (int v = tid; v < BK * BN / V; v += THREADS) {
      const int r = v / (BN / V), nn = (v % (BN / V)) * V;
      const int gk = k0 + r, gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + (nn / 16) * BK * P + r * P + nn % 16,
                 ok ? B + static_cast<size_t>(gk) * N + gn : B, ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[(kk / 16) * BM * P + r * P + kk % 16] =
          (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : zero<T>();
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, nn = e % BN;
      const int gk = k0 + r, gn = n0 + nn;
      Bs[(nn / 16) * BK * P + r * P + nn % 16] =
          (gk < K && gn < N) ? B[static_cast<size_t>(gk) * N + gn] : zero<T>();
    }
  }
}

template <typename T, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS)
    wmma_gemm(const T* __restrict__ A, const T* __restrict__ B, TO* __restrict__ C, int M,
              int N, int K) {
  using Acc = typename AccOf<T>::type;
  constexpr int P = kPitch<T>;
  constexpr int A_ELEMS = (BK / 16) * BM * P;
  constexpr int STAGE = A_ELEMS + (BN / 16) * BK * P;
  constexpr int PIPE_BYTES = STAGES * STAGE * int(sizeof(T));
  constexpr int EPI_BYTES = (THREADS / 32) * 256 * int(sizeof(Acc));
  __shared__ __align__(128) unsigned char smem[PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES];
  T* tiles = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const int steps = (K + BK - 1) / BK;
  if (steps > 0) load_tiles<T, VEC>(tiles, tiles + A_ELEMS, A, B, M, N, K, m0, n0, 0, tid);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      T* next = tiles + ((s + 1) % STAGES) * STAGE;
      load_tiles<T, VEC>(next, next + A_ELEMS, A, B, M, N, K, m0, n0, (s + 1) * BK, tid);
    }
    cp_async_commit();
    cp_async_wait_prev();  // step s has landed; step s+1 may still be in flight
    __syncthreads();
    const T* As = tiles + (s % STAGES) * STAGE;
    const T* Bs = As + A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + ks * BM * P + (wm * WM + i * 16) * P, P);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * FN + j) * BK * P + ks * 16 * P, P);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the buffer of step s is refilled at step s+1
  }

  // Epilogue: a fragment's element layout is opaque, so each warp stages one
  // 16x16 fragment at a time in shared memory, then stores it converted and
  // masked to the ragged edge.
  Acc* stage = reinterpret_cast<Acc*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * WM + i * 16 + e / 16;
        const int gn = n0 + wn * WN + j * 16 + e % 16;
        if (gm < M && gn < N) put(C + static_cast<size_t>(gm) * N + gn, stage[e]);
      }
      __syncwarp();
    }
}

template <typename T, typename TO>
void launch_wmma(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t s) {
  constexpr int V = 16 / int(sizeof(T));
  const bool vec = k % V == 0 && n % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  TO* C = static_cast<TO*>(c);
  if (vec)
    wmma_gemm<T, TO, true><<<grid, THREADS, 0, s>>>(A, B, C, m, n, k);
  else
    wmma_gemm<T, TO, false><<<grid, THREADS, 0, s>>>(A, B, C, m, n, k);
}

// ------------------------------------------------------------------ fp32 SIMT
constexpr int SBM = 64, SBN = 64, SBK = 16, STHREADS = 256;

__global__ void __launch_bounds__(STHREADS)
    simt_gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[SBK][SBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int e = tid; e < SBM * SBK; e += STHREADS) {
      const int r = e / SBK, kk = e % SBK, gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    for (int e = tid; e < SBK * SBN; e += STHREADS) {
      const int kk = e / SBN, cc = e % SBN, gk = k0 + kk, gn = n0 + cc;
      Bs[kk][cc] = (gk < K && gn < N) ? B[static_cast<size_t>(gk) * N + gn] : 0.f;
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
      if (gm < M && gn < N) C[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
}

}  // namespace

extern "C" {

// C = A . B on `stream`. in_dtype/out_dtype are DType codes; the pairs taken
// are bf16->{bf16,f32}, f16->{f16,f32}, f32->f32 and int8->int32. Returns 0
// or a cudaError_t code.
int tmb_matmul(const void* a, const void* b, void* c, int m, int n, int k, int in_dtype,
               int out_dtype, void* stream) {
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    launch_wmma<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, s);
  else if (in_dtype == kBF16 && out_dtype == kF32)
    launch_wmma<__nv_bfloat16, float>(a, b, c, m, n, k, s);
  else if (in_dtype == kF16 && out_dtype == kF16)
    launch_wmma<__half, __half>(a, b, c, m, n, k, s);
  else if (in_dtype == kF16 && out_dtype == kF32)
    launch_wmma<__half, float>(a, b, c, m, n, k, s);
  else if (in_dtype == kI8 && out_dtype == kI32)
    launch_wmma<signed char, int>(a, b, c, m, n, k, s);
  else if (in_dtype == kF32 && out_dtype == kF32)
    simt_gemm_f32<<<dim3((n + SBN - 1) / SBN, (m + SBM - 1) / SBM), STHREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), m,
        n, k);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* tmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
