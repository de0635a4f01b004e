// The fused all-gather ring matmul (K6): every step of the ring, for every
// rank of a world that shares one card, in one cooperative kernel launch.
//
// Replaces tpu_matmul_bench/ops/pallas_ring.py::_ring_kernel (:42-118), which
// ring_allgather_matmul (:121-174) runs on each TPU core with every operand
// resident in VMEM: at step t the core multiplies the chunk it holds by its W
// shard with one jnp.dot, writes the product into Y rows src*mshard, and
// sends the chunk into the right neighbour's comm slot (t+1) mod 2 with
// make_async_remote_copy, under send/recv/free semaphores.
//
// What it computes: Y_r = all_gather(X) . W_r for every rank r, with X
// row-sharded (X_r is mshard x k), W column-sharded (W_r is k x nshard) and
// Y_r the m x nshard column block (m = D * mshard). At step t rank r holds
// the chunk that started at rank src = (r - t) mod D (its own X_r at t = 0,
// slot t mod 2 after), writes chunk . W_r into Y_r rows [src*mshard,
// (src+1)*mshard), and copies the chunk into slot (t+1) mod 2 of rank r+1.
// Each product sums in fp32 (int32 for int8) and rounds once at the store,
// as _ring_kernel's jnp.dot with preferred_element_type followed by astype.
//
// Bound on this card: the function is 2*m*n*k operations with X and W read
// once and Y written once (the hops are the ring's own traffic). At its cap,
// bf16 2048^2 over 4 ranks on one card, that is 0.0174 ms of operations at
// 989 TFLOP/s against 0.0075 ms of bytes at 3.35 TB/s, so it is bound by
// operations; the launch and the 3 grid barriers (a few microseconds each)
// are of the same order, and every block reads its A and B tiles from L2 at
// each step (about 100 MB a step at the cap), so L2 bandwidth is close too.
//
// Design, against the TPU kernel:
// - "One kernel, operands resident" becomes one cooperative launch
//   (cudaLaunchCooperativeKernel) that covers every rank on the card. The
//   grid is split among the ranks: blocks [r*per_rank, (r+1)*per_rank) serve
//   rank r. At each step every block computes its share of its rank's
//   output tiles, the chunk is copied into the right neighbour's slot, and
//   one grid-wide barrier (cooperative_groups::this_grid().sync()) ends the
//   step.
// - Why one barrier is enough (the argument of pallas_ring.py:46-53): the
//   barrier stands for recv_sem, send_sem and free_sem together. At step t
//   rank r reads its slot t mod 2 and writes slot (t+1) mod 2 of rank r+1;
//   rank r+1 reads its slot t mod 2 in the same step, so no slot is read and
//   written in one step. The slot written at step t is complete when the
//   barrier at the end of step t returns, before its reader starts step t+1
//   (recv_sem and send_sem). The slot read at step t is written again at
//   step t+1 only, after that same barrier, when every read of it is done
//   (free_sem). Step 0 reads X_r itself and no slot, so D ranks take D - 1
//   barriers and no seed copy.
// - Resident: the TPU kernel keeps X, the slots, W and Y in VMEM. A block's
//   227 KB of shared memory holds no useful chunk, so here the operands stay
//   in the card's 50 MB L2 between steps: ops/cuda_ring_fused.py caps the
//   problem so that every rank's X, two slots, W and Y fit it together, as
//   pallas_ring_max_size caps it to the VMEM budget. Nothing pins the lines:
//   whether they stay there between steps is assumed, not measured.
// - bf16 and f16 shapes that TMA can describe (16-byte aligned pointers, k
//   and nshard whole 16-byte rows; ops/cuda_ring_fused.py fused_route) take
//   ring_fused_wgmma, on the warpgroup tile mainloop of hopper_tile.cuh:
//   - the tile is 128x64x64, so that one step's tiles fill the card in one
//     wave at the cap (mshard = nshard = 512: 32 tiles a rank, 128 a step,
//     against 132 SMs at one 384-thread block each);
//   - TMA loads the held chunk (X_r as a 2-D map, the two slots as one 3-D
//     map) and W_r into 5 stages under mbarriers, one producer thread keeps
//     them in flight, and two consumer warpgroups run wgmma;
//   - the chunk copy rides on those loads: a copier thread in the producer
//     warpgroup stores every A box of the blocks whose tiles start at column
//     0 (they cover the whole chunk once) from shared memory into the right
//     neighbour's slot with a TMA store, so the copy overlaps the products
//     and reads the chunk from L2 no second time. The copier frees a stage
//     only when its store has read it (cp.async.bulk.wait_group.read), and
//     waits for its stores to land (cp.async.bulk.wait_group) before the
//     step's barrier; after the barrier, fence.proxy.async.global orders the
//     slot's new contents before the next TMA load of it;
//   - the three maps per rank (X_r, slots, W_r) are 128-byte CUtensorMaps
//     passed by value as one __grid_constant__ parameter: 3 KB at
//     TMB_FUSED_MAX_RANKS = 8, with TmbRingArgs beside it under the 4 KB a
//     kernel's parameters may take.
// - Other shapes, and int8 and fp32 (not on the main path), take ring_fused,
//   the first form: one 64x64 tile a block and pass, K in steps of 32
//   through shared memory, 16x16x16 wmma fragments on 8 warps (tile_wmma),
//   or a SIMT tile for fp32 (tile_simt), and the chunk copied with plain SM
//   stores before the tiles. Its chunk is read with ld.global.cg (L2 only,
//   never L1): another block wrote the slot during this launch, and the
//   barrier orders that write before the read in L2, not in a block's L1.
// - The device's SM count, cooperative-launch support and each kernel's
//   resident blocks per SM are queried once per device and cached; the grid
//   is as many blocks as the card holds at once, an equal share a rank, so
//   the runtime can refuse the launch but it cannot hang.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "hopper_tile.cuh"

namespace cg = cooperative_groups;
using namespace nvcuda;

// The most ranks one launch takes (ops/cuda_ring_fused.py FUSED_MAX_RANKS).
#define TMB_FUSED_MAX_RANKS 8

// Every rank's pointers and the shapes, passed by value as the kernel's
// parameter; ops/cuda_ring_fused.py _RingArgs has the same layout.
struct TmbRingArgs {
  const void* x[TMB_FUSED_MAX_RANKS];  // X_r, mshard x k, dense
  const void* w[TMB_FUSED_MAX_RANKS];  // W_r, k x nshard, dense
  void* y[TMB_FUSED_MAX_RANKS];        // Y_r, (ranks*mshard) x nshard, dense
  void* slots[TMB_FUSED_MAX_RANKS];    // rank r's 2 slots, 2 x mshard x k
  int ranks, mshard, k, nshard;
};

namespace {

// dtype codes shared with ops/cuda_matmul.py
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3 };
// routes shared with ops/cuda_matmul.py ROUTES: simt and wmma both name the
// first form, ring_fused (SIMT tiles for fp32, wmma tiles for the others)
enum Route : int { kSimt = 0, kWmma = 1, kWgmma = 2 };
using tmb::kMaxDevices;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 64, BN = 64, BK = 32;  // the tensor-core tile
constexpr int SBK = 16;                   // the SIMT tile's K step

template <typename T> struct Types { using Out = T; using Acc = float; };
template <> struct Types<signed char> { using Out = int; using Acc = int; };

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ __half zero() { return __float2half(0.f); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__half* p, float x) { *p = __float2half_rn(x); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(int* p, int x) { *p = x; }

// Loads of the chunk (X_r or a slot): through L2 only, see the header.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ signed char ld_cg(const signed char* p) { return __ldcg(p); }
__device__ __forceinline__ __half ld_cg(const __half* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ __nv_bfloat16 ld_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Elements per row of a 16-wide slice in shared memory: 16 plus a pad that
// keeps every 16-row fragment on a 32-byte boundary and ldm a multiple of 16
// bytes, as wmma requires, for 8-bit operands too.
template <typename T> constexpr int kPitch = 16 + 16 / int(sizeof(T));

// One 64x64 tile of C (rows ldc apart) = A (rows lda apart, read through L2)
// . B (rows ldb apart), on the tensor cores. 8 warps as 4 (M) x 2 (N), each
// 16 x 32. `vec`: k, ldb and the pointers allow 16-byte loads.
template <typename T>
__device__ void tile_wmma(const T* A, const T* B, typename Types<T>::Out* C, int M, int N, int K,
                          int lda, int ldb, int ldc, int m0, int n0, bool vec) {
  using Acc = typename Types<T>::Acc;
  constexpr int P = kPitch<T>, V = 16 / int(sizeof(T));
  __shared__ __align__(128) T As[(BK / 16) * BM * P];  // BK/16 slices of [BM][P]
  __shared__ __align__(128) T Bs[(BN / 16) * BK * P];  // BN/16 slices of [BK][P]
  __shared__ __align__(128) Acc stage[(THREADS / 32) * 256];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2];
  wmma::fill_fragment(acc[0], Acc(0));
  wmma::fill_fragment(acc[1], Acc(0));
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec) {
      for (int v = tid; v < BM * BK / V; v += THREADS) {
        const int r = v / (BK / V), kk = (v % (BK / V)) * V, gm = m0 + r, gk = k0 + kk;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gm < M && gk < K)
          val = __ldcg(reinterpret_cast<const uint4*>(A + static_cast<size_t>(gm) * lda + gk));
        *reinterpret_cast<uint4*>(As + (kk / 16) * BM * P + r * P + kk % 16) = val;
      }
      for (int v = tid; v < BK * BN / V; v += THREADS) {
        const int r = v / (BN / V), nn = (v % (BN / V)) * V, gk = k0 + r, gn = n0 + nn;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gk < K && gn < N)
          val = *reinterpret_cast<const uint4*>(B + static_cast<size_t>(gk) * ldb + gn);
        *reinterpret_cast<uint4*>(Bs + (nn / 16) * BK * P + r * P + nn % 16) = val;
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK, gm = m0 + r, gk = k0 + kk;
        As[(kk / 16) * BM * P + r * P + kk % 16] =
            (gm < M && gk < K) ? ld_cg(A + static_cast<size_t>(gm) * lda + gk) : zero<T>();
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, nn = e % BN, gk = k0 + r, gn = n0 + nn;
        Bs[(nn / 16) * BK * P + r * P + nn % 16] =
            (gk < K && gn < N) ? B[static_cast<size_t>(gk) * ldb + gn] : zero<T>();
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + ks * BM * P + wm * 16 * P, P);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + (wn * 2 + j) * BK * P + ks * 16 * P, P);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // the tiles are refilled at the next K step
  }

  // a fragment's element layout is opaque: stage it, then store it converted
  // and masked to the ragged edge
  Acc* st = stage + warp * 256;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int gm = m0 + wm * 16 + e / 16, gn = n0 + wn * 32 + j * 16 + e % 16;
      if (gm < M && gn < N) put(C + static_cast<size_t>(gm) * ldc + gn, st[e]);
    }
    __syncwarp();
  }
}

// The same tile for fp32 operands on the SIMT cores: 4x4 outputs a thread.
__device__ void tile_simt(const float* A, const float* B, float* C, int M, int N, int K, int lda,
                          int ldb, int ldc, int m0, int n0) {
  __shared__ float As[SBK][BM + 4];  // transposed: As[k][m]
  __shared__ float Bs[SBK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int e = tid; e < BM * SBK; e += THREADS) {
      const int r = e / SBK, kk = e % SBK, gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? ld_cg(A + static_cast<size_t>(gm) * lda + gk) : 0.f;
    }
    for (int e = tid; e < SBK * BN; e += THREADS) {
      const int kk = e / BN, c = e % BN, gk = k0 + kk, gn = n0 + c;
      Bs[kk][c] = (gk < K && gn < N) ? B[static_cast<size_t>(gk) * ldb + gn] : 0.f;
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
      if (gm < M && gn < N) C[static_cast<size_t>(gm) * ldc + gn] = acc[i][j];
    }
}

// dst[i] = src[i] for i < count, by the threads [first, first + stride * ...)
// of the rank's blocks; 16 bytes at a time when `vec`.
template <typename T>
__device__ void copy_chunk(T* dst, const T* src, size_t count, size_t first, size_t stride,
                           bool vec) {
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const size_t count16 = count * sizeof(T) / 16;
    for (size_t i = first; i < count16; i += stride) d[i] = __ldcg(s + i);
  } else {
    for (size_t i = first; i < count; i += stride) dst[i] = ld_cg(src + i);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ring_fused(TmbRingArgs a, int per_rank, bool vec) {
  using Out = typename Types<T>::Out;
  cg::grid_group grid = cg::this_grid();
  const int d = a.ranks, r = blockIdx.x / per_rank, lb = blockIdx.x % per_rank;
  const int right = (r + 1) % d;
  const size_t chunk = static_cast<size_t>(a.mshard) * a.k;
  const int tn = (a.nshard + BN - 1) / BN;
  const int tiles = ((a.mshard + BM - 1) / BM) * tn;
  const T* W = static_cast<const T*>(a.w[r]);
  for (int t = 0; t < d; ++t) {
    const T* held = t == 0 ? static_cast<const T*>(a.x[r])
                           : static_cast<const T*>(a.slots[r]) + (t % 2) * chunk;
    if (t + 1 < d)
      copy_chunk(static_cast<T*>(a.slots[right]) + ((t + 1) % 2) * chunk, held, chunk,
                 static_cast<size_t>(lb) * THREADS + threadIdx.x,
                 static_cast<size_t>(per_rank) * THREADS, vec);
    const int src = (r - t + d) % d;
    Out* Y = static_cast<Out*>(a.y[r]) + static_cast<size_t>(src) * a.mshard * a.nshard;
    for (int tile = lb; tile < tiles; tile += per_rank) {
      const int m0 = (tile / tn) * BM, n0 = (tile % tn) * BN;
      if constexpr (std::is_same_v<T, float>)
        tile_simt(held, W, Y, a.mshard, a.nshard, a.k, a.k, a.nshard, a.nshard, m0, n0);
      else
        tile_wmma<T>(held, W, Y, a.mshard, a.nshard, a.k, a.k, a.nshard, a.nshard, m0, n0, vec);
    }
    if (t + 1 < d) grid.sync();  // the step's barrier, see the header
  }
}

// ------------------------------------------------------------- wgmma form
// Every rank's tensor maps: X_r (2-D, mshard x k), its two slots (3-D, 2 x
// mshard x k) and W_r (2-D, k x nshard); 3 KB at 8 ranks.
struct RingMaps {
  CUtensorMap x[TMB_FUSED_MAX_RANKS], slots[TMB_FUSED_MAX_RANKS], w[TMB_FUSED_MAX_RANKS];
};
static_assert(sizeof(RingMaps) + sizeof(TmbRingArgs) + sizeof(int) + 64 <= 4096,
              "a kernel's parameters take at most 4 KB");

using FusedTile = tmb::WgTile<128, 64, 64>;
constexpr int kCopierThread = tmb::kProducerThread + 32;  // lane 0 of the producer's second warp

template <typename T>
__global__ void __launch_bounds__(tmb::kThreads, 1)
    ring_fused_wgmma(const __grid_constant__ RingMaps maps, TmbRingArgs a, int per_rank) {
  using G = FusedTile;
  extern __shared__ __align__(128) unsigned char smem[];
  // a stage is free once the 8 consumer warps and the copier are done with it
  const tmb::Stages<G> st = tmb::make_stages<G>(smem, tmb::kConsumerWarps + 1);
  cg::grid_group grid = cg::this_grid();
  const int d = a.ranks, r = blockIdx.x / per_rank, lb = blockIdx.x % per_rank;
  const int tn = (a.nshard + G::BN - 1) / G::BN;
  const int tiles = ((a.mshard + G::BM - 1) / G::BM) * tn;
  const int ktiles = (a.k + G::BK - 1) / G::BK;
  tmb::Pipe pipe;
  if (threadIdx.x >= tmb::kProducerThread) {
    tmb::producer_regs<tmb::kProducerRegs>();
    for (int t = 0; t < d; ++t) {
      if (threadIdx.x == tmb::kProducerThread) {
        // the chunk held at step t: X_r, then slot t mod 2, which TMA stores
        // wrote before the last barrier
        const CUtensorMap* held = t == 0 ? &maps.x[r] : &maps.slots[r];
        const int slot = t % 2;
        if (t > 0) tmb::fence_proxy_async_global();
        for (int tile = lb; tile < tiles; tile += per_rank) {
          const int m0 = (tile / tn) * G::BM, n0 = (tile % tn) * G::BN;
          for (int kt = 0; kt < ktiles; ++kt) {
            const int k0 = kt * G::BK;
            tmb::produce(st, pipe, &maps.w[r], n0, k0,
                         [held, t, slot, k0, m0](void* dst, uint64_t* bar) {
                           if (t == 0)
                             tmb::tma_load_2d(dst, held, bar, k0, m0);
                           else
                             tmb::tma_load_3d(dst, held, bar, k0, m0, slot);
                         });
          }
        }
      } else if (threadIdx.x == kCopierThread) {
        // the copy into slot (t+1) mod 2 of rank r+1: every A box of the
        // tiles at column 0 (they hold the chunk once), out of shared memory
        const bool copy = t + 1 < d;
        const CUtensorMap* to = &maps.slots[(r + 1) % d];
        for (int tile = lb; tile < tiles; tile += per_rank) {
          const int m0 = (tile / tn) * G::BM;
          const bool mine = copy && tile % tn == 0;
          for (int kt = 0; kt < ktiles; ++kt) {
            tmb::mbar_wait(st.full + pipe.stage, pipe.phase);
            if (mine) {
              tmb::tma_store_3d(to, st.a(pipe.stage), kt * G::BK, m0, (t + 1) % 2);
              tmb::bulk_commit();
              tmb::bulk_wait_read();  // the stage may be refilled now
            }
            tmb::mbar_arrive(st.empty + pipe.stage);
            pipe.advance<G::STAGES>();
          }
        }
        if (copy) {
          tmb::bulk_wait();  // the slot is written before the barrier
          tmb::fence_proxy_async_global();
        }
      }
      __syncwarp();
      if (t + 1 < d) grid.sync();  // the step's barrier, see the header
    }
  } else {
    tmb::consumer_regs<tmb::kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const bool pairs = a.nshard % 2 == 0;
    for (int t = 0; t < d; ++t) {
      const int src = (r - t + d) % d;
      T* Y = static_cast<T*>(a.y[r]) + static_cast<size_t>(src) * a.mshard * a.nshard;
      for (int tile = lb; tile < tiles; tile += per_rank) {
        const int r0 = (tile / tn) * G::BM + (wg / G::WG_N) * G::WM;
        const int c0 = (tile % tn) * G::BN + (wg % G::WG_N) * G::WN;
        float acc[G::MI][G::WN / 2];
        tmb::consume<T>(st, pipe, ktiles, wg, acc);
#pragma unroll
        for (int i = 0; i < G::MI; ++i)
#pragma unroll
          for (int q = 0; q < G::WN / 4; ++q) {
            const int gm = r0 + 64 * i + tmb::pair_row(q), gn = c0 + tmb::pair_col(q);
            if (gm < a.mshard && gn < a.nshard)
              tmb::put2(Y + static_cast<size_t>(gm) * a.nshard + gn, acc[i][2 * q],
                        acc[i][2 * q + 1], gn + 1 < a.nshard, pairs);
          }
      }
      if (t + 1 < d) grid.sync();
    }
  }
}

// ----------------------------------------------------------------- launches
// Resident blocks per SM of one form of the kernel on device `dev`, queried
// once (for the wgmma form after raising its shared-memory limit).
template <typename T, bool WGMMA> cudaError_t resident(int dev, int* per_sm) {
  static int cached[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    cudaError_t e;
    if constexpr (WGMMA) {
      e = cudaFuncSetAttribute(ring_fused_wgmma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FusedTile::SMEM_BYTES);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev], ring_fused_wgmma<T>,
                                                          tmb::kThreads, FusedTile::SMEM_BYTES);
    } else {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev], ring_fused<T>, THREADS, 0);
    }
    if (e != cudaSuccess) return e;
  }
  *per_sm = cached[dev];
  return cudaSuccess;
}

// As many blocks as the card holds at once, an equal share for each rank,
// and no more than a rank has tiles (ops/cuda_ring_fused.py fused_plan).
cudaError_t grid_share(const tmb::Card& c, int per_sm, int ranks, int tiles, int* per_rank) {
  if (!c.coop) return cudaErrorNotSupported;
  *per_rank = per_sm * c.sms / ranks;
  if (*per_rank < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (*per_rank > tiles) *per_rank = tiles;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const TmbRingArgs& a, cudaStream_t s, int* grid_blocks) {
  int dev = 0, per_sm = 0, per_rank = 0;
  const tmb::Card* c = nullptr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = tmb::card(dev, &c);
  if (e == cudaSuccess) e = resident<T, false>(dev, &per_sm);
  const int tiles = ((a.mshard + BM - 1) / BM) * ((a.nshard + BN - 1) / BN);
  if (e == cudaSuccess) e = grid_share(*c, per_sm, a.ranks, tiles, &per_rank);
  if (e != cudaSuccess) return e;
  constexpr int V = 16 / int(sizeof(T));
  bool vec = a.k % V == 0 && a.nshard % V == 0;
  for (int r = 0; r < a.ranks; ++r)
    vec = vec && aligned16(a.x[r]) && aligned16(a.w[r]) && aligned16(a.slots[r]);
  TmbRingArgs args = a;
  void* params[] = {&args, &per_rank, &vec};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ring_fused<T>),
                                  dim3(per_rank * a.ranks), dim3(THREADS), params, 0, s);
  if (e != cudaSuccess) return e;
  *grid_blocks = per_rank * a.ranks;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(const TmbRingArgs& a, cudaStream_t s, int* grid_blocks) {
  using G = FusedTile;
  constexpr bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  // what TMA cannot describe is refused, never sent to the other form
  for (int r = 0; r < a.ranks; ++r)
    if (!tmb::tma_describable(a.x[r], a.k) || !tmb::tma_describable(a.w[r], a.nshard) ||
        (a.ranks > 1 && !tmb::tma_describable(a.slots[r], a.k)))
      return aligned16(a.x[r]) && aligned16(a.w[r]) ? cudaErrorInvalidPitchValue
                                                    : cudaErrorMisalignedAddress;
  if (a.k < 1) return cudaErrorInvalidValue;
  RingMaps maps;
  cudaError_t e = cudaSuccess;
  for (int r = 0; r < a.ranks && e == cudaSuccess; ++r) {
    e = tmb::encode_a<G>(&maps.x[r], bf16, a.x[r], a.mshard, a.k, a.k);
    if (e == cudaSuccess) e = tmb::encode_b<G>(&maps.w[r], bf16, a.w[r], a.k, a.nshard, a.nshard);
    if (e == cudaSuccess && a.ranks > 1) {
      const uint64_t dims[3] = {static_cast<uint64_t>(a.k), static_cast<uint64_t>(a.mshard), 2};
      const uint64_t strides[2] = {static_cast<uint64_t>(a.k) * 2,
                                   static_cast<uint64_t>(a.mshard) * a.k * 2};
      const uint32_t box[3] = {G::BK, G::BM, 1};
      e = tmb::encode(&maps.slots[r], bf16, a.slots[r], 3, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    }
  }
  int dev = 0, per_sm = 0, per_rank = 0;
  const tmb::Card* c = nullptr;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = tmb::card(dev, &c);
  if (e == cudaSuccess) e = resident<T, true>(dev, &per_sm);
  const int tiles = ((a.mshard + G::BM - 1) / G::BM) * ((a.nshard + G::BN - 1) / G::BN);
  if (e == cudaSuccess) e = grid_share(*c, per_sm, a.ranks, tiles, &per_rank);
  if (e != cudaSuccess) return e;
  TmbRingArgs args = a;
  void* params[] = {&maps, &args, &per_rank};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ring_fused_wgmma<T>),
                                  dim3(per_rank * a.ranks), dim3(tmb::kThreads), params,
                                  G::SMEM_BYTES, s);
  if (e != cudaSuccess) return e;
  *grid_blocks = per_rank * a.ranks;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tmb_ring_fused_max_ranks() { return TMB_FUSED_MAX_RANKS; }

// Y_r = all_gather(X) . W_r for every rank of `args` (all on the current
// device), in one cooperative launch on `stream`. in_dtype is a DType code;
// Y is int32 for int8 operands, else the operand dtype. route is a Route
// code: wgmma (ring_fused_wgmma) for bf16/f16 that TMA can describe, else
// cudaErrorMisalignedAddress or cudaErrorInvalidPitchValue; simt for fp32 and
// wmma for the others (ring_fused). The slots of a one-rank world are never
// touched. *grid_blocks receives the grid's size. Returns 0 or a cudaError_t
// code.
int tmb_ring_fused(const TmbRingArgs* args, int in_dtype, int route, void* stream,
                   int* grid_blocks) {
  if (args == nullptr || grid_blocks == nullptr || args->ranks < 1 ||
      args->ranks > TMB_FUSED_MAX_RANKS || args->mshard < 0 || args->k < 0 || args->nshard < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool half = in_dtype == kF16 || in_dtype == kBF16;
  const bool fits = route == kWgmma ? half : route == kWmma ? half || in_dtype == kI8
                                           : route == kSimt && in_dtype == kF32;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  *grid_blocks = 0;
  if (args->mshard == 0 || args->nshard == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kWgmma)
    e = in_dtype == kBF16 ? launch_wgmma<__nv_bfloat16>(*args, s, grid_blocks)
                          : launch_wgmma<__half>(*args, s, grid_blocks);
  else
    switch (in_dtype) {
      case kF32: e = launch<float>(*args, s, grid_blocks); break;
      case kF16: e = launch<__half>(*args, s, grid_blocks); break;
      case kBF16: e = launch<__nv_bfloat16>(*args, s, grid_blocks); break;
      default: e = launch<signed char>(*args, s, grid_blocks); break;
    }
  return static_cast<int>(e);
}

// Resident blocks per SM of the kernel of `route` for operands of in_dtype
// on the current device, into *blocks.
int tmb_ring_fused_occupancy(int in_dtype, int route, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (route == kWgmma && in_dtype == kBF16) return resident<__nv_bfloat16, true>(dev, blocks);
  if (route == kWgmma && in_dtype == kF16) return resident<__half, true>(dev, blocks);
  if (route == kSimt && in_dtype == kF32) return resident<float, false>(dev, blocks);
  if (route == kWmma && in_dtype == kBF16) return resident<__nv_bfloat16, false>(dev, blocks);
  if (route == kWmma && in_dtype == kF16) return resident<__half, false>(dev, blocks);
  if (route == kWmma && in_dtype == kI8) return resident<signed char, false>(dev, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tmb_ring_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
