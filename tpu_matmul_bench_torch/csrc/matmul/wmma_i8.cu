// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wmma route's int8 kernels with the plain epilogue, at every
// tile of TMB_TILES, with vector and scalar loads.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wmma_i8(const GemmArgs& g) { return launch_wmma<signed char, false>(g); }

cudaError_t wmma_i8_init() { return init_wmma<signed char, false>(); }

cudaError_t wmma_i8_occupancy(int bm, int bn, int bk, int* blocks) {
  return occupancy_wmma<signed char>(bm, bn, bk, blocks);
}

}  // namespace tmb_gemm
