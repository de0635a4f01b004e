// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wmma route's f16 kernels with the pickup's epilogue (C = A.B
// + accin), at every tile of TMB_TILES, with vector and scalar loads.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wmma_f16_acc(const GemmArgs& g) { return launch_wmma<__half, true>(g); }

cudaError_t wmma_f16_acc_init() { return init_wmma<__half, true>(); }

}  // namespace tmb_gemm
