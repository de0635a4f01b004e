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
//   and rounded once at the store (tmb_matmul_acc); the rings take it where
//   csrc/ring_rs.cu's persistent pickup does not take the operands
//   (ops/cuda_matmul.py step_route).
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
// operations. Only wgmma reaches the tensor cores' full rate on Hopper, and
// only when loads stay in flight while it runs.
//
// Three routes, chosen by ops/cuda_matmul.py gemm_route before the launch and
// passed in as `route`; the C side refuses a route that does not fit the
// operands, and nothing here tries another route after a failure:
// - wgmma (bf16 and f16 whose base pointers are 16-byte aligned and whose row
//   strides are whole 16-byte units, so that TMA can describe them; a K
//   split's slab width a multiple of 64): wgmma_gemm, on the warpgroup tile
//   mainloop of hopper_tile.cuh. TMA loads A and B tiles into a ring of 3-5
//   shared-memory stages under mbarriers, one producer thread keeps them in
//   flight, two consumer warpgroups run wgmma with the sums in registers
//   (setmaxnreg moves registers from the producer warpgroup to them), and
//   the epilogue stores two neighbouring columns at once straight from the
//   registers. The TMA descriptors are built on the host for each launch
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda) and
//   passed by value as __grid_constant__ parameters, so a CUDA graph replays
//   what it captured.
// - wmma (int8, and bf16/f16 operands TMA cannot describe): wmma_gemm, the
//   first slice's kernel. int8 stays here because wgmma takes 8-bit B only
//   K-major, and B is row-major K x N.
// - simt (fp32): simt_gemm_f32, a plain SIMT kernel (64x64x16 tiles, 4x4
//   outputs per thread, fp32 FMA): the tensor cores have no full-precision
//   fp32 mode.
//
// Design, against the TPU kernel:
// - The Pallas grid walks K as its innermost, sequential axis and carries the
//   sum in a VMEM scratch between grid steps. Blocks on a GPU run in no
//   order, so here each block owns one BMxBN output tile and loops over K
//   itself, with the sum in registers; nothing crosses blocks.
// - The tile (BM, BN, BK) is a template parameter with a small fixed set of
//   instantiations (TMB_TILES, csrc/matmul.cuh), the same on both tensor-core
//   routes. wgmma blocks run 384 threads (two consumer warpgroups and the
//   producer's); wmma blocks run 8 warps (4x2 when BM >= BN, else 2x4), each
//   warp on 16x16x16 fragments fed by a two-buffer cp.async pipeline from
//   padded 16-wide column slices. tmb_init raises every instantiation's
//   shared memory limit.
// - grid_order is the raster of output tiles: "mnk" makes M the slowest
//   axis, so the blocks in flight share a band of A; "nmk" makes it N, and
//   they share a band of B. The wmma route walks the plain raster (N tiles on
//   blockIdx.x for "mnk"). The wgmma route, four times faster, would read
//   all of B from device memory for every wave of 132 blocks that way, so it
//   walks the slow axis in groups of 8 tiles (tmb::raster): a wave then
//   reads 8 bands of one operand and about 17 of the other.
// - pallas_matmul zero-pads awkward dimensions to multiples of 128 and slices
//   the result. Here TMA zero-fills past the tensors' edges (wgmma route), or
//   the loads zero-fill the ragged edge (wmma route), and the stores are
//   masked, so no padded copy is ever made.
// - Split-K: one launch with gridDim.z = S. Block z multiplies the slab
//   [z*kc, (z+1)*kc) (on the wgmma route, K coordinates of one descriptor over
//   the whole A and B) and stores its fp32 (int32 for int8) partial into slice
//   z of a workspace [S, m, n]; reduce_partials then adds the slices in the
//   order s = 0..S-1 and stores C once, as pallas_matmul_ksplit's
//   `acc + part` loop followed by one astype.
// - The pickup is an epilogue option of every kernel: the Pallas kernel adds
//   accin on its last K step, here the epilogue reads accin (output dtype,
//   rows `ldacc` apart) beside each stored element and C's rows are `ldc`
//   apart. The extra traffic is one read of accin per output element, m*n*2
//   bytes in bf16: for one ring step of bf16 16384^2 over 4 ranks (4096x4096
//   . 4096x16384) 128 MiB, 0.04 ms at 3.35 TB/s against 0.56 ms of
//   operations at 989 TFLOP/s, so the pickup stays bound by operations.
//
// Left for later work: persistent blocks over many tiles (one tile's
// epilogue under the next one's loads) and a TMA-store epilogue here too
// (csrc/ring_rs.cu has both for the reduce-scatter rings), thread-block
// clusters with TMA multicast, and a tensor-core path for fp32 under TF32.
//
// The C entry points launch on the caller's stream, allocate nothing and do
// not synchronise, so they can be captured in a CUDA graph. They return
// cudaGetLastError() after the launch. tmb_init must run once per device,
// outside any capture, before the first launch.
//
// The build: the tensor-core kernels live in csrc/matmul.cuh and are
// instantiated by the units of csrc/matmul/, one per route, operand dtype
// and (wmma) epilogue; this file holds the dtype and route codes, the fp32
// SIMT GEMM, the split-K reduction, the dispatch and the C entry points.
// ops/_build.py compiles every unit at once and links them into one library.

#include <initializer_list>

#include "matmul.cuh"

namespace {

// dtype codes shared with ops/cuda_matmul.py
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3, kI32 = 4 };
// routes shared with ops/cuda_matmul.py ROUTES
enum Route : int { kSimt = 0, kWmma = 1, kWgmma = 2 };

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

// The GEMM for every dtype pair, on `route`. `splits` slabs of width k each,
// partials `m*n` apart in C; or, with p.accin, one pass that adds accin at
// the store. A route that does not take the dtypes is refused.
cudaError_t gemm(const void* a, const void* b, void* c, int m, int n, int k, int lda, int ldb,
                 int splits, int in_dtype, int out_dtype, int bm, int bn, int bk, int order,
                 int route, Pickup p, cudaStream_t s) {
  if (m < 0 || n < 0 || k < 0 || splits < 1 || splits > 65535 || ldb < n ||
      static_cast<long long>(lda) < static_cast<long long>(k) * splits ||
      (order != kMNK && order != kNMK) ||
      (p.accin != nullptr && (splits != 1 || p.ldacc < n || p.ldc < n)))
    return cudaErrorInvalidValue;
  const bool half = in_dtype == kBF16 || in_dtype == kF16;
  const bool wide = out_dtype == kF32;
  if (!(half && (out_dtype == in_dtype || wide)) && !(in_dtype == kI8 && out_dtype == kI32) &&
      !(in_dtype == kF32 && out_dtype == kF32))
    return cudaErrorInvalidValue;
  const bool fits = route == kWgmma ? half : route == kWmma ? half || in_dtype == kI8
                                           : route == kSimt && in_dtype == kF32;
  if (!fits) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  if (route == kSimt)
    return launch_simt(a, b, c, m, n, k, lda, ldb, splits, bm, bn, bk, order, p, s);
  const GemmArgs g = {a, b, c, m, n, k, lda, ldb, splits, bm, bn, bk, order, wide, p, s};
  const bool acc = p.accin != nullptr;
  if (route == kWgmma) return in_dtype == kBF16 ? wgmma_bf16(g) : wgmma_f16(g);
  if (in_dtype == kBF16) return acc ? wmma_bf16_acc(g) : wmma_bf16(g);
  if (in_dtype == kF16) return acc ? wmma_f16_acc(g) : wmma_f16(g);
  return acc ? wmma_i8_acc(g) : wmma_i8(g);
}

constexpr Pickup kNoPickup = {nullptr, 0, 0};

}  // namespace

extern "C" {

// Raise the dynamic shared-memory limit of every tensor-core instantiation on
// the current device. Call once per device, outside any CUDA-graph capture.
int tmb_init() {
  cudaError_t e = cudaSuccess;
  for (cudaError_t (*init)() : {wmma_bf16_init, wmma_bf16_acc_init, wmma_f16_init,
                                wmma_f16_acc_init, wmma_i8_init, wmma_i8_acc_init,
                                wgmma_bf16_init, wgmma_f16_init})
    if (e == cudaSuccess) e = init();
  return static_cast<int>(e);
}

// Resident blocks per SM of the tensor-core kernel of `route` (wmma: bf16,
// f16 or int8; wgmma: bf16 or f16) for operands of `in_dtype` at tile (bm,
// bn, bk), into *blocks. Call after tmb_init.
int tmb_occupancy(int in_dtype, int route, int bm, int bn, int bk, int* blocks) {
  cudaError_t e = cudaErrorInvalidValue;
  if (route == kWgmma) {
    if (in_dtype == kBF16) e = wgmma_bf16_occupancy(bm, bn, bk, blocks);
    if (in_dtype == kF16) e = wgmma_f16_occupancy(bm, bn, bk, blocks);
  } else if (route == kWmma) {
    if (in_dtype == kBF16) e = wmma_bf16_occupancy(bm, bn, bk, blocks);
    if (in_dtype == kF16) e = wmma_f16_occupancy(bm, bn, bk, blocks);
    if (in_dtype == kI8) e = wmma_i8_occupancy(bm, bn, bk, blocks);
  }
  return static_cast<int>(e);
}

// C = A . B on `stream`. A's rows are `lda` elements apart and B's `ldb`;
// C is dense m x n. in_dtype/out_dtype are DType codes; the pairs taken are
// bf16->{bf16,f32}, f16->{f16,f32}, f32->f32 and int8->int32. (bm, bn, bk)
// is an instantiated tile (64x64x16 for fp32); grid_order is an Order code;
// route a Route code (simt for fp32; wmma for int8; wmma or wgmma for
// bf16/f16, wgmma only where TMA describes A and B: else
// cudaErrorMisalignedAddress or cudaErrorInvalidPitchValue). Returns 0 or a
// cudaError_t code.
int tmb_matmul(const void* a, const void* b, void* c, int m, int n, int k, int lda, int ldb,
               int in_dtype, int out_dtype, int bm, int bn, int bk, int grid_order, int route,
               void* stream) {
  return static_cast<int>(gemm(a, b, c, m, n, k, lda, ldb, 1, in_dtype, out_dtype, bm, bn, bk,
                               grid_order, route, kNoPickup, static_cast<cudaStream_t>(stream)));
}

// The reduce-scatter ring's pickup: C = A . B + accin, summed in fp32 (int32
// for int8) and rounded once to out_dtype. accin and C are m x n in
// out_dtype, their rows `ldacc` and `ldc` elements apart, in two buffers
// that do not overlap. The other arguments are tmb_matmul's.
int tmb_matmul_acc(const void* a, const void* b, const void* accin, void* c, int m, int n, int k,
                   int lda, int ldb, int ldacc, int ldc, int in_dtype, int out_dtype, int bm,
                   int bn, int bk, int grid_order, int route, void* stream) {
  if (accin == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gemm(a, b, c, m, n, k, lda, ldb, 1, in_dtype, out_dtype, bm, bn, bk,
                               grid_order, route, Pickup{accin, ldacc, ldc},
                               static_cast<cudaStream_t>(stream)));
}

// The K-split partials: for s = 0..splits-1, ws[s] = A[:, s*kc:(s+1)*kc] .
// B[s*kc:(s+1)*kc, :], stored in the accumulator dtype (fp32; int32 for
// int8) into the dense [splits, m, n] workspace, in one launch. On the
// wgmma route kc must be a multiple of 64.
int tmb_matmul_ksplit(const void* a, const void* b, void* ws, int m, int n, int kc, int splits,
                      int lda, int ldb, int in_dtype, int bm, int bn, int bk, int grid_order,
                      int route, void* stream) {
  const int acc = in_dtype == kI8 ? kI32 : kF32;
  return static_cast<int>(gemm(a, b, ws, m, n, kc, lda, ldb, splits, in_dtype, acc, bm, bn, bk,
                               grid_order, route, kNoPickup, static_cast<cudaStream_t>(stream)));
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
