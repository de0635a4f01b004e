// The ring matmuls' step product on Hopper (sm_90a): a persistent GEMM that
// stores each tile of dest = round(A . B + accin) by TMA, straight into the
// buffer its reader takes it from, and in its forwarding mode also stores
// the A it loads into the reader's receive slot.
//
// Replaces, for the reduce-scatter rings K3 and K5 (ops/cuda_ring.py):
// - tpu_matmul_bench/ops/pallas_ring_rs_hbm.py::_rs_acc_kernel (:52-66), the
//   step's pickup, which the Pallas ring (_hbm_ring_rs_kernel, :160) runs
//   with its remote DMA of the previous step's sum under the MXU work;
// - and with it tpu_matmul_bench/ops/pallas_ring_bidir_rs_hbm.py's pickups
//   (_bidir_rs_kernel, :61-162), the same product on half the rows.
// And, in the forwarding mode, for the all-gather rings K2 and K4:
// - tpu_matmul_bench/ops/pallas_ring_hbm.py::_hbm_ring_kernel (:161), whose
//   step multiplies the chunk it holds while make_async_remote_copy (:214)
//   sends it into the right neighbour's slot, once free_sem says the slot is
//   free (:213, signalled at :236);
// - tpu_matmul_bench/ops/pallas_ring_bidir_hbm.py::_bidir_ring_kernel (:52),
//   the same on each direction's half of the chunk (:101-109, :133-135).
//
// What it computes: dest[m,n] = round(A[m,k] . B[k,n] + accin[m,n]) for
// bf16 or f16 operands, summed in fp32 and rounded once to the operand dtype
// at the store; without accin (a ring's first step, and every all-gather
// step) dest = round(A . B). With a forwarding slot `fwd` (m x k, rows
// ldfwd apart) it also copies A into fwd unchanged. A, B, accin, dest and
// fwd are row-major with rows lda, ldb, ldacc, ldc and ldfwd elements apart;
// TMA describes all five, so each base is 16-byte aligned and each row
// stride a whole number of 16-byte units (ops/cuda_matmul.py step_route
// checks the same before the launch, and tmb_rs_step and tmb_ag_step refuse
// the rest).
//
// Bound on this card: one K3 step at bf16 16384^2 over 4 ranks is 4096 x
// 16384 at depth 4096: 0.56 ms of operations at 989 TFLOP/s against 0.13 ms
// of bytes at 3.35 TB/s (A, B and accin read once, dest written once:
// 436 MB), so it is bound by operations; a K2 step (4096 x 4096 at depth
// 16384) is the same 0.56 ms of operations, and its forwarding writes 128
// MiB more, 0.04 ms at the memory rate. What kept the rings from that bound
// was around the product, not in it:
// - each step's sum was stored into a staging slot and then copied into the
//   reader's slot by a separate hop (csrc/ring.cu), on the critical path and
//   twice the partial's traffic: 3 GiB a call at 16384^2 over 4 ranks;
// - each all-gather step's chunk, which the product had just read, was read
//   again and copied by a hop on a second stream (1.5 GiB a call more, and a
//   launch and two events a hop);
// - each product's tiles are shallow (64 k-steps at 128x256x64), and every
//   block paid the pipeline's fill and an epilogue that nothing overlapped,
//   with accin loaded two elements at a time at fragment addresses.
//
// Design:
// - Persistent blocks: the grid is min(tiles, SMs x resident blocks), and
//   each block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... in
//   tmb::raster's grouped order (ops/cuda_matmul.py persistent_tiles is the
//   same walk). One producer thread keeps the stage ring (tmb::Pipe) running
//   across tile boundaries, so the next tile's first loads are in flight
//   while the consumers finish this one's epilogue. Two consumer warpgroups
//   share a tile (the cooperative form), as wgmma_gemm does.
// - The tile buffer: BN/64 boxes of BM rows x 64 columns (128-byte rows
//   under the 128-byte swizzle), one buffer for accin and the result. When
//   the producer has issued the first stages of tile i, it waits until the
//   consumers have written tile i-1 into the buffer and stores it with TMA;
//   half of tile i's k-steps later it waits until the store has read the
//   buffer (cp.async.bulk.wait_group.read) and loads tile i's accin into it
//   by TMA, on its own mbarrier. Both run under tile i's mainloop.
// - The epilogue: each consumer thread adds accin from the buffer to its
//   fp32 sums, rounds, writes the pair back in place (the swizzle keeps a
//   warp's pairs on distinct banks), fences the shared memory for the async
//   proxy and arrives on the tile's barrier; the producer's TMA store then
//   writes the tile into dest. TMA zero-fills what lies past the tensors'
//   edges and clips the store to them, so ragged M, N and K need no masks.
// - Into the reader's slot: the ring passes the reader's receive slot as
//   dest, so the partial sum moves once, in the product's own store; the
//   hop and its staging slot are gone for ranks that share a card.
// - Forwarding (the FWD instantiations): the chunk's trip to the reader
//   rides on the product's own TMA loads. A copier thread (lane 0 of the
//   producer warpgroup's second warp, as in csrc/ring_fused.cu) waits on
//   every stage's full barrier and TMA-stores the A box of the stages it
//   owns (BM rows x BK columns, read out of the stage under its 128-byte
//   swizzle) into fwd; it frees the stage (whose empty barrier then counts
//   one more arrival) once the store has read it, and waits for its stores
//   to land before the block ends, so the slot is complete when the kernel
//   is. Box (mt, kt) is stored by the tile (mt, kt mod tn): every box of
//   the chunk once, spread over a row of tiles (at a K2 step, 16 of each
//   tile's 256 boxes), where K6 puts them all on column 0. TMA clips the
//   store to fwd's extent, so ragged M and K need no masks here either.
// - Shared memory: at 128x256x64, 3 stages of 48 KB and the 64 KB buffer,
//   209 KB of the 227 KB a block may use (RsTile; ops/cuda_matmul.py
//   wgmma_plan(..., persistent=True) mirrors it); the copier needs none of
//   its own.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launch. tmb_rs_init
// must run once per device, outside any CUDA-graph capture, before the first
// launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper_tile.cuh"

// The instantiated tiles (BM, BN, BK); ops/cuda_matmul.py PERSISTENT_TILES
// lists the same. Every other tile of a ring's request goes to the pickup
// kernel or K1 of csrc/matmul.cu, decided before the launch (step_route).
#define TMB_RS_TILES(X) X(128, 256, 64)

namespace {

// dtype codes shared with ops/cuda_matmul.py
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3, kI32 = 4 };
// grid orders shared with ops/cuda_matmul.py
enum Order : int { kMNK = 0, kNMK = 1 };

// Shared memory for the stages and the tile buffer, of the 227 KB a block
// may use (the 1 KB of alignment and the barriers come on top).
constexpr int kRsBudget = 212 * 1024;
// the forwarding copier: lane 0 of the producer warpgroup's second warp
constexpr int kCopierThread = tmb::kProducerThread + 32;

template <int BM_, int BN_, int BK_> struct RsTile : tmb::WgTile<BM_, BN_, BK_> {
  using W = tmb::WgTile<BM_, BN_, BK_>;
  static constexpr int OUT_BOX = BM_ * 128;  // 64 columns of the tile, rows of 128 bytes
  static constexpr int OUT_BYTES = (BN_ / 64) * OUT_BOX;
  static constexpr int FIT = (kRsBudget - OUT_BYTES) / W::STAGE_BYTES;
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  // the stages, the buffer, 1 KB to align them, the stage barriers and two more
  static constexpr int SMEM_BYTES = STAGES * W::STAGE_BYTES + OUT_BYTES + 1024 + (2 * STAGES + 2) * 8;
  static_assert(BN_ % 64 == 0, "the buffer holds whole 64-column boxes");
  static_assert(STAGES >= 3, "the ring needs three stages at least");
  static_assert(SMEM_BYTES <= 232448, "a block may use 227 KB of shared memory");
};
static_assert(RsTile<128, 256, 64>::STAGES == 3 && RsTile<128, 256, 64>::SMEM_BYTES == 214080,
              "ops/cuda_matmul.py wgmma_plan(persistent=True) mirrors this plan");

template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 widen(type v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ type round(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ float2 widen(type v) { return __half22float2(v); }
  static __device__ __forceinline__ type round(float a, float b) { return __floats2half2_rn(a, b); }
};

// Byte offset of the tile's (row, col) in the buffer: box col/64, then
// 128-byte rows whose 16-byte chunks are XORed with row mod 8, as TMA's
// 128-byte swizzle lays out a box that starts on a 1 KB boundary.
template <int BM>
__device__ __forceinline__ int out_offset(int row, int col) {
  return (col / 64) * (BM * 128) + row * 128 + ((((col % 64) / 8) ^ (row % 8)) << 4) +
         (col % 8) * 2;
}

// The producer's store of tile `i` (rows m0.., columns n0..) once the
// consumers have written it into the buffer.
template <typename G>
__device__ __forceinline__ void store_tile(const CUtensorMap* c_map, const unsigned char* out,
                                           uint64_t* out_full, int i, int m0, int n0) {
  tmb::mbar_wait(out_full, i & 1);
#pragma unroll
  for (int j = 0; j < G::BN / 64; ++j) tmb::tma_store_2d(c_map, out + j * G::OUT_BOX, n0 + 64 * j, m0);
  tmb::bulk_commit();
}

// dest = round(A . B (+ accin)) over M x N, K deep, one persistent block a
// share of the tiles; a_map, b_map, acc_map and c_map describe A, B, accin
// and dest (acc_map is unused without accin). FWD: A is also stored into the
// forwarding slot fwd_map describes (unused otherwise). m_slow: the
// raster's slow axis is M (grid order "mnk").
template <typename T, int BM, int BN, int BK, bool FWD>
__global__ void __launch_bounds__(tmb::kThreads, 1)
    rs_step_wgmma(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap acc_map,
                  const __grid_constant__ CUtensorMap c_map,
                  const __grid_constant__ CUtensorMap fwd_map, int M, int N, int K, bool accin,
                  bool m_slow) {
  using G = RsTile<BM, BN, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  tmb::Stages<G> st;
  st.base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem) + 1023) &
                                             ~uintptr_t(1023));
  unsigned char* out = st.base + G::STAGES * G::STAGE_BYTES;  // 1 KB aligned
  st.full = reinterpret_cast<uint64_t*>(out + G::OUT_BYTES);
  st.empty = st.full + G::STAGES;
  uint64_t* acc_full = st.empty + G::STAGES;  // the buffer holds the tile's accin, or is free
  uint64_t* out_full = acc_full + 1;          // the consumers wrote the tile into it
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      tmb::mbar_init(st.full + s, 1);
      // a stage is free once the consumer warps (and the copier) are done
      tmb::mbar_init(st.empty + s, tmb::kConsumerWarps + (FWD ? 1 : 0));
    }
    tmb::mbar_init(acc_full, 1);
    tmb::mbar_init(out_full, tmb::kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN, tiles = tm * tn;
  const int ktiles = (K + BK - 1) / BK;
  tmb::Pipe pipe;
  if (threadIdx.x >= tmb::kProducerThread) {
    // the producer warpgroup: one thread issues every load and store
    tmb::producer_regs<tmb::kProducerRegs>();
    if (threadIdx.x == tmb::kProducerThread) {
      const CUtensorMap* am = &a_map;
      // after `lead` k-steps of a tile the last tile is stored, and after
      // `refill` the buffer is filled for this one (with a deep K, half a
      // tile later, when the store has long read it)
      const int lead = ktiles < G::STAGES ? ktiles : G::STAGES;
      const int refill = ktiles / 2 > lead ? ktiles / 2 : lead;
      int i = 0, pm0 = 0, pn0 = 0;  // the tile count, and the last tile's corner
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
        int mt = 0, nt = 0;
        tmb::raster(tile, tm, tn, m_slow, &mt, &nt);
        const int m0 = mt * BM, n0 = nt * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          const int k0 = kt * BK;
          tmb::produce(st, pipe, &b_map, n0, k0, [am, k0, m0](void* dst, uint64_t* bar) {
            tmb::tma_load_2d(dst, am, bar, k0, m0);
          });
          // this tile's first stages are in flight: store the last tile
          if (kt + 1 == lead && i > 0) store_tile<G>(&c_map, out, out_full, i - 1, pm0, pn0);
          if (kt + 1 == refill) {
            tmb::bulk_wait_read();  // the store has read the buffer
            if (accin) {
              tmb::mbar_expect_tx(acc_full, G::OUT_BYTES);
#pragma unroll
              for (int j = 0; j < G::BN / 64; ++j)
                tmb::tma_load_2d(out + j * G::OUT_BOX, &acc_map, acc_full, n0 + 64 * j, m0);
            } else {
              tmb::mbar_arrive(acc_full);
            }
          }
        }
        pm0 = m0;
        pn0 = n0;
      }
      if (i > 0) store_tile<G>(&c_map, out, out_full, i - 1, pm0, pn0);
      tmb::bulk_wait();  // the last tile is written before the block ends
    } else if (FWD && threadIdx.x == kCopierThread) {
      // the forwarding copier walks the producer's tiles and k-steps; box
      // (mt, kt) of A goes into the slot from the tile (mt, kt mod tn)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mt = 0, nt = 0;
        tmb::raster(tile, tm, tn, m_slow, &mt, &nt);
        for (int kt = 0; kt < ktiles; ++kt) {
          tmb::mbar_wait(st.full + pipe.stage, pipe.phase);
          if (kt % tn == nt) {
            tmb::tma_store_2d(&fwd_map, st.a(pipe.stage), kt * BK, mt * BM);
            tmb::bulk_commit();
            tmb::bulk_wait_read();  // the stage may be refilled now
          }
          tmb::mbar_arrive(st.empty + pipe.stage);
          pipe.advance<G::STAGES>();
        }
      }
      tmb::bulk_wait();  // the slot is written before the block ends
    }
  } else {
    tmb::consumer_regs<tmb::kConsumerRegs>();
    using P = Pair<T>;
    const int wg = threadIdx.x / 128;
    const int wm0 = (wg / G::WG_N) * G::WM, wn0 = (wg % G::WG_N) * G::WN;
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      float acc[G::MI][G::WN / 2];
      tmb::consume<T>(st, pipe, ktiles, wg, acc);
      tmb::mbar_wait(acc_full, i & 1);
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int q = 0; q < G::WN / 4; ++q) {
          const int row = wm0 + 64 * mi + tmb::pair_row(q), col = wn0 + tmb::pair_col(q);
          auto* p = reinterpret_cast<typename P::type*>(out + out_offset<BM>(row, col));
          float v0 = acc[mi][2 * q], v1 = acc[mi][2 * q + 1];
          if (accin) {
            const float2 in = P::widen(*p);
            v0 += in.x;
            v1 += in.y;
          }
          *p = P::round(v0, v1);
        }
      tmb::fence_proxy_async_shared();
      __syncwarp();
      if (threadIdx.x % 32 == 0) tmb::mbar_arrive(out_full);
    }
  }
}

// A row-major rows x cols matrix, rows `ld` elements apart, in the tile
// buffer's boxes: 64 columns by BM rows under the 128-byte swizzle.
template <typename G>
cudaError_t encode_out(CUtensorMap* map, bool bf16, const void* base, int rows, int cols, int ld) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld) * 2};
  const uint32_t box[2] = {64, G::BM};
  return tmb::encode(map, bf16, base, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Resident blocks per SM of one instantiation on device `dev`, queried once,
// after raising its shared-memory limit.
template <typename T, int BM, int BN, int BK, bool FWD>
cudaError_t resident(int dev, int* per_sm) {
  static int cached[tmb::kMaxDevices] = {};
  if (dev < 0 || dev >= tmb::kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    using G = RsTile<BM, BN, BK>;
    const auto kernel = rs_step_wgmma<T, BM, BN, BK, FWD>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev], kernel, tmb::kThreads,
                                                        G::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (cached[dev] == 0) return cudaErrorInvalidConfiguration;  // not one block fits an SM
  }
  *per_sm = cached[dev];
  return cudaSuccess;
}

// One step's operands, as the entry points take them: accin is null at a
// reduce-scatter ring's first step and at every all-gather step, fwd (the
// forwarding slot) null but at an all-gather step that forwards.
struct Step {
  const void *a, *b, *accin;
  void* c;
  int m, n, k, lda, ldb, ldacc, ldc;
  void* fwd = nullptr;
  int ldfwd = 0;
};

bool instantiated(int bm, int bn, int bk) {
#define TMB_IS(BM_, BN_, BK_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return true;
  TMB_RS_TILES(TMB_IS)
#undef TMB_IS
  return false;
}

// What the kernel refuses, before anything is encoded or launched: other
// dtypes, empty shapes, rows closer than their width, a tile not
// instantiated (cudaErrorInvalidValue), a base TMA cannot take
// (cudaErrorMisalignedAddress) or a row stride it cannot
// (cudaErrorInvalidPitchValue). ops/cuda_matmul.py step_route sends exactly
// the rest to this kernel.
cudaError_t check(const Step& s, int in_dtype, int bm, int bn, int bk) {
  const bool acc = s.accin != nullptr, fwd = s.fwd != nullptr;
  if ((in_dtype != kBF16 && in_dtype != kF16) || s.m < 1 || s.n < 1 || s.k < 1 || s.lda < s.k ||
      s.ldb < s.n || s.ldc < s.n || (acc && s.ldacc < s.n) || (fwd && s.ldfwd < s.k) ||
      (acc && fwd) || !instantiated(bm, bn, bk))
    return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (!aligned(s.a) || !aligned(s.b) || !aligned(s.c) || (acc && !aligned(s.accin)) ||
      (fwd && !aligned(s.fwd)))
    return cudaErrorMisalignedAddress;
  if (!tmb::tma_describable(s.a, s.lda) || !tmb::tma_describable(s.b, s.ldb) ||
      !tmb::tma_describable(s.c, s.ldc) || (acc && !tmb::tma_describable(s.accin, s.ldacc)) ||
      (fwd && !tmb::tma_describable(s.fwd, s.ldfwd)))
    return cudaErrorInvalidPitchValue;
  return cudaSuccess;
}

template <typename T, int BM, int BN, int BK, bool FWD>
cudaError_t launch_tile(const Step& s, int order, cudaStream_t stream, int* grid_blocks) {
  using G = RsTile<BM, BN, BK>;
  constexpr bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  int dev = 0, per_sm = 0;
  const tmb::Card* card = nullptr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = tmb::card(dev, &card);
  if (e == cudaSuccess) e = resident<T, BM, BN, BK, FWD>(dev, &per_sm);
  CUtensorMap a_map, b_map, acc_map, c_map, fwd_map{};
  if (e == cudaSuccess) e = tmb::encode_a<G>(&a_map, bf16, s.a, s.m, s.k, s.lda);
  if (e == cudaSuccess) e = tmb::encode_b<G>(&b_map, bf16, s.b, s.k, s.n, s.ldb);
  if (e == cudaSuccess) e = encode_out<G>(&c_map, bf16, s.c, s.m, s.n, s.ldc);
  if (e == cudaSuccess)
    e = s.accin != nullptr ? encode_out<G>(&acc_map, bf16, s.accin, s.m, s.n, s.ldacc)
                           : encode_out<G>(&acc_map, bf16, s.c, s.m, s.n, s.ldc);
  // the slot in A's boxes: the copier stores them as the loads left them
  if (e == cudaSuccess && FWD) e = tmb::encode_a<G>(&fwd_map, bf16, s.fwd, s.m, s.k, s.ldfwd);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>((s.m + BM - 1) / BM) * ((s.n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long room = static_cast<long long>(card->sms) * per_sm;
  const int grid = static_cast<int>(tiles < room ? tiles : room);
  rs_step_wgmma<T, BM, BN, BK, FWD><<<grid, tmb::kThreads, G::SMEM_BYTES, stream>>>(
      a_map, b_map, acc_map, c_map, fwd_map, s.m, s.n, s.k, s.accin != nullptr, order == kMNK);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid_blocks = grid;
  return e;
}

template <typename T>
cudaError_t launch(const Step& s, int bm, int bn, int bk, int order, cudaStream_t stream,
                   int* grid_blocks) {
#define TMB_LAUNCH(BM_, BN_, BK_)                                                     \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                            \
    return s.fwd != nullptr                                                           \
               ? launch_tile<T, BM_, BN_, BK_, true>(s, order, stream, grid_blocks)   \
               : launch_tile<T, BM_, BN_, BK_, false>(s, order, stream, grid_blocks);
  TMB_RS_TILES(TMB_LAUNCH)
#undef TMB_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T, bool FWD> cudaError_t occupancy(int dev, int bm, int bn, int bk, int* blocks) {
#define TMB_OCCUPANCY(BM_, BN_, BK_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return resident<T, BM_, BN_, BK_, FWD>(dev, blocks);
  TMB_RS_TILES(TMB_OCCUPANCY)
#undef TMB_OCCUPANCY
  return cudaErrorInvalidValue;
}

// One step on `stream`, after `check`: bf16 or f16 operands.
cudaError_t step(const Step& s, int in_dtype, int bm, int bn, int bk, int grid_order,
                 void* stream, int* grid_blocks) {
  cudaError_t e = check(s, in_dtype, bm, bn, bk);
  if (e == cudaSuccess && grid_order != kMNK && grid_order != kNMK) e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_dtype == kBF16 ? launch<__nv_bfloat16>(s, bm, bn, bk, grid_order, st, grid_blocks)
                           : launch<__half>(s, bm, bn, bk, grid_order, st, grid_blocks);
}

// Resident blocks per SM of the instantiation (bm, bn, bk), with or without
// forwarding, for operands of in_dtype on the current device.
int occupancy_of(int in_dtype, int bm, int bn, int bk, bool fwd, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (in_dtype == kBF16)
    return static_cast<int>(fwd ? occupancy<__nv_bfloat16, true>(dev, bm, bn, bk, blocks)
                                : occupancy<__nv_bfloat16, false>(dev, bm, bn, bk, blocks));
  if (in_dtype == kF16)
    return static_cast<int>(fwd ? occupancy<__half, true>(dev, bm, bn, bk, blocks)
                                : occupancy<__half, false>(dev, bm, bn, bk, blocks));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Raise the shared-memory limit of every instantiation on the current device
// and cache its resident blocks per SM and the SM count. Call once per
// device, outside any CUDA-graph capture.
int tmb_rs_init() {
  int dev = 0, blocks = 0;
  const tmb::Card* card = nullptr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = tmb::card(dev, &card);
#define TMB_INIT(BM_, BN_, BK_)                                                         \
  if (e == cudaSuccess) e = resident<__nv_bfloat16, BM_, BN_, BK_, false>(dev, &blocks); \
  if (e == cudaSuccess) e = resident<__half, BM_, BN_, BK_, false>(dev, &blocks);        \
  if (e == cudaSuccess) e = resident<__nv_bfloat16, BM_, BN_, BK_, true>(dev, &blocks);  \
  if (e == cudaSuccess) e = resident<__half, BM_, BN_, BK_, true>(dev, &blocks);
  TMB_RS_TILES(TMB_INIT)
#undef TMB_INIT
  return static_cast<int>(e);
}

// Whether tmb_rs_step takes these operands: 0, or the cudaError_t code it
// would return without launching (see `check`). No device work.
int tmb_rs_check(const void* a, const void* b, const void* accin, void* c, int m, int n, int k,
                 int lda, int ldb, int ldacc, int ldc, int in_dtype, int bm, int bn, int bk) {
  return static_cast<int>(check(Step{a, b, accin, c, m, n, k, lda, ldb, ldacc, ldc}, in_dtype,
                                bm, bn, bk));
}

// One reduce-scatter step's product on `stream`: C = round(A . B + accin),
// or C = round(A . B) when accin is null, for bf16 or f16 operands (in_dtype
// a DType code), C and accin in the operand dtype. (bm, bn, bk) is an
// instantiated tile, grid_order an Order code. *grid_blocks receives the
// persistent grid's size. Returns 0 or a cudaError_t code.
int tmb_rs_step(const void* a, const void* b, const void* accin, void* c, int m, int n, int k,
                int lda, int ldb, int ldacc, int ldc, int in_dtype, int bm, int bn, int bk,
                int grid_order, void* stream, int* grid_blocks) {
  return static_cast<int>(step(Step{a, b, accin, c, m, n, k, lda, ldb, ldacc, ldc}, in_dtype, bm,
                               bn, bk, grid_order, stream, grid_blocks));
}

// Whether tmb_ag_step takes these operands: 0, or the cudaError_t code it
// would return without launching (see `check`). No device work.
int tmb_ag_check(const void* a, const void* b, void* c, void* fwd, int m, int n, int k, int lda,
                 int ldb, int ldc, int ldfwd, int in_dtype, int bm, int bn, int bk) {
  return static_cast<int>(
      check(Step{a, b, nullptr, c, m, n, k, lda, ldb, 0, ldc, fwd, ldfwd}, in_dtype, bm, bn, bk));
}

// One all-gather step's product on `stream`: C = round(A . B) for bf16 or
// f16 operands, and, when fwd is not null, A copied into fwd (m x k, rows
// ldfwd apart: the reader's receive slot) by the same launch. The other
// arguments are tmb_rs_step's. Returns 0 or a cudaError_t code.
int tmb_ag_step(const void* a, const void* b, void* c, void* fwd, int m, int n, int k, int lda,
                int ldb, int ldc, int ldfwd, int in_dtype, int bm, int bn, int bk,
                int grid_order, void* stream, int* grid_blocks) {
  return static_cast<int>(step(Step{a, b, nullptr, c, m, n, k, lda, ldb, 0, ldc, fwd, ldfwd},
                               in_dtype, bm, bn, bk, grid_order, stream, grid_blocks));
}

// Resident blocks per SM of the instantiation (bm, bn, bk) for operands of
// in_dtype (bf16 or f16) on the current device, into *blocks: tmb_rs_step's
// (and tmb_ag_step's without fwd), and tmb_ag_step's forwarding one.
int tmb_rs_occupancy(int in_dtype, int bm, int bn, int bk, int* blocks) {
  return occupancy_of(in_dtype, bm, bn, bk, false, blocks);
}
int tmb_ag_occupancy(int in_dtype, int bm, int bn, int bk, int* blocks) {
  return occupancy_of(in_dtype, bm, bn, bk, true, blocks);
}

const char* tmb_rs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
