// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wgmma route's f16 kernels, at every tile of TMB_TILES.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wgmma_f16(const GemmArgs& g) { return launch_wgmma<__half>(g); }

cudaError_t wgmma_f16_init() { return init_wgmma<__half>(); }

cudaError_t wgmma_f16_occupancy(int bm, int bn, int bk, int* blocks) {
  return occupancy_wgmma<__half>(bm, bn, bk, blocks);
}

}  // namespace tmb_gemm
