// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wmma route's bf16 kernels with the plain epilogue, at every
// tile of TMB_TILES, with vector and scalar loads.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wmma_bf16(const GemmArgs& g) { return launch_wmma<__nv_bfloat16, false>(g); }

cudaError_t wmma_bf16_init() { return init_wmma<__nv_bfloat16, false>(); }

cudaError_t wmma_bf16_occupancy(int bm, int bn, int bk, int* blocks) {
  return occupancy_wmma<__nv_bfloat16>(bm, bn, bk, blocks);
}

}  // namespace tmb_gemm
