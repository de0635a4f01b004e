// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wgmma route's bf16 kernels, at every tile of TMB_TILES.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wgmma_bf16(const GemmArgs& g) { return launch_wgmma<__nv_bfloat16>(g); }

cudaError_t wgmma_bf16_init() { return init_wgmma<__nv_bfloat16>(); }

cudaError_t wgmma_bf16_occupancy(int bm, int bn, int bk, int* blocks) {
  return occupancy_wgmma<__nv_bfloat16>(bm, bn, bk, blocks);
}

}  // namespace tmb_gemm
