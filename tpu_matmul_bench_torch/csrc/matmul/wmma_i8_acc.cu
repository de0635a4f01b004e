// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wmma route's int8 kernels with the pickup's epilogue (C = A.B
// + accin), at every tile of TMB_TILES, with vector and scalar loads.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wmma_i8_acc(const GemmArgs& g) { return launch_wmma<signed char, true>(g); }

cudaError_t wmma_i8_acc_init() { return init_wmma<signed char, true>(); }

}  // namespace tmb_gemm
