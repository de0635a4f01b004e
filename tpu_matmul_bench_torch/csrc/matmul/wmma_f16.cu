// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wmma route's f16 kernels with the plain epilogue, at every
// tile of TMB_TILES, with vector and scalar loads.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wmma_f16(const GemmArgs& g) { return launch_wmma<__half, false>(g); }

cudaError_t wmma_f16_init() { return init_wmma<__half, false>(); }

cudaError_t wmma_f16_occupancy(int bm, int bn, int bk, int* blocks) {
  return occupancy_wmma<__half>(bm, bn, bk, blocks);
}

}  // namespace tmb_gemm
