// One unit of csrc/matmul.cu's library (csrc/matmul.cuh says how the units
// split it): the wmma route's bf16 kernels with the pickup's epilogue (C = A.B
// + accin), at every tile of TMB_TILES, with vector and scalar loads.

#include "../matmul.cuh"

namespace tmb_gemm {

cudaError_t wmma_bf16_acc(const GemmArgs& g) { return launch_wmma<__nv_bfloat16, true>(g); }

cudaError_t wmma_bf16_acc_init() { return init_wmma<__nv_bfloat16, true>(); }

}  // namespace tmb_gemm
