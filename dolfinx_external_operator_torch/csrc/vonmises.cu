// Von Mises return map with consistent tangent: the CUDA kernel (sm_90a).
//
// Replaces dolfinx_external_operator_tpu/ops/vonmises_pallas.py::
// vonmises_return_map_pallas (the pl.pallas_call at :97, body _kernel
// :30-83), the one Pallas kernel of the JAX package.
//
// One thread per Gauss point, no communication between threads: the
// per-point body (vonmises.cuh) reads 9 floats and writes 21, so 120 bytes
// a point.  The bound is memory bandwidth: 120 B x 4,096 points (the main
// path's 3,750 points padded to the 512 tile) is 0.49 MB, 0.15 us at
// 3.35 TB/s, far below one launch, so at main-path shapes the kernel is
// launch-bound.  The design keeps every load and store coalesced (SoA with
// the point axis contiguous) and everything else in registers; the ragged
// edge is masked here, so n need not be a multiple of the block.
#include <cuda_runtime.h>

#include "vonmises.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vonmises_kernel(const float* __restrict__ deps, const float* __restrict__ sig_n,
                const float* __restrict__ p, float* __restrict__ C,
                float* __restrict__ sig, float* __restrict__ dp, long long n,
                float lmbda, float mu, float H, float sig0) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  vonmises_point(deps, sig_n, p, C, sig, dp, i, n, lmbda, mu, H, sig0);
}

}  // namespace

// Launches on the caller's stream and does not synchronise.  Returns
// cudaGetLastError() so that a refused launch is seen by the caller.
extern "C" int vonmises_return_map_launch(const float* deps, const float* sig_n, const float* p,
                                          float* C, float* sig, float* dp, long long n,
                                          float lmbda, float mu, float H, float sig0,
                                          void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    vonmises_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(deps, sig_n, p, C, sig, dp, n, lmbda,
                                                           mu, H, sig0);
  }
  return static_cast<int>(cudaGetLastError());
}
