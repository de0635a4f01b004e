// One hop of the port's ring matmuls: a copy of a whole chunk from one rank's
// buffer into the next rank's receive slot.
//
// Replaces the remote DMAs of the Pallas ring kernels,
// tpu_matmul_bench/ops/pallas_ring_hbm.py::_hbm_ring_kernel (:214-222) and
// tpu_matmul_bench/ops/pallas_ring_rs_hbm.py::_hbm_ring_rs_kernel (:245-253):
// `pltpu.make_async_remote_copy` of a chunk to the right neighbour over ICI.
// On Hopper the copy leaves the kernel (the products are hand-written GEMMs
// in matmul.cu) and becomes a copy on the sending rank's copy stream: a DMA
// that the copy engines run beside the SMs' work, between two cards
// (cudaMemcpyPeerAsync) or, for ranks that share one card, within its memory
// (cudaMemcpyAsync, which a CUDA graph can capture; the peer form cannot be
// captured, so a ring across cards runs only outside a graph). The semaphores
// around the Pallas DMA become CUDA events, recorded and waited on in
// ops/cuda_ring.py.
//
// Bound: a hop moves its bytes once each way, so it is bound by bytes: over
// NVLink at 450 GB/s each way between two H100s, within one card at the
// 3.35 TB/s of its memory (read once, written once).
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the call.

#include <cuda_runtime.h>

extern "C" {

// Copy `bytes` from `src` on device `src_device` to `dst` on device
// `dst_device`, on `stream`. Returns 0 or a cudaError_t code.
int tmb_ring_hop(void* dst, const void* src, long long bytes, int dst_device, int src_device,
                 void* stream) {
  if (bytes < 0 || dst == nullptr || src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(bytes);
  const cudaError_t e = dst_device == src_device
                            ? cudaMemcpyAsync(dst, src, n, cudaMemcpyDeviceToDevice, s)
                            : cudaMemcpyPeerAsync(dst, dst_device, src, src_device, n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* tmb_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
