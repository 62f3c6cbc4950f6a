// Mohr-Coulomb return map with consistent tangent: the CUDA kernel (sm_90a).
//
// Replaces the per-Gauss-point return map that the JAX package compiles
// with XLA (not a Pallas kernel): dolfinx_external_operator_tpu/models/
// mohr_coulomb.py::MohrCoulombMaterial._build, return_mapping :224-342 and
// tangent_stress_point :344-361, with ops/abbo_sloan.py:118-166, vmapped
// at :374-376 and in the sorted chunks :384-486.
//
// One thread per Gauss point, each running its own f32 Newton, f64 polish
// and tangent solve to its own exit (body in mohr_coulomb.cuh), so a lane
// costs its own iteration count, as a lane of vmap(while_loop) does.  Per
// point it reads 64 bytes and writes 188 (252 B), so the byte bound is far
// below the arithmetic: the kernel is bound by operations, and at the main
// path's 3,750 points (30 blocks of 128 threads on 132 SMs) by the serial
// chain of the slowest lane.  Nothing is sorted: lanes of one warp may take
// different iteration counts, and the warp runs to its slowest lane.
// Spills to local memory are accepted here (see PERF.md for the count).
#include <cuda_runtime.h>

#include "mohr_coulomb.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mohr_coulomb_kernel(const double* __restrict__ deps, const double* __restrict__ sig_n,
                    double* __restrict__ C, double* __restrict__ sig, int* __restrict__ niter,
                    double* __restrict__ yielding, double* __restrict__ norm_res,
                    double* __restrict__ dlambda, long long n, const mc::Params P) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  mc::mc_point(deps, sig_n, C, sig, niter, yielding, norm_res, dlambda, i, n, P);
}

}  // namespace

// Launches on the caller's stream and does not synchronise.  ``params`` is
// the host array of mc::kParams packed constants, read before the launch.
// Returns cudaGetLastError() so that a refused launch is seen by the caller.
extern "C" int mohr_coulomb_launch(const double* deps, const double* sig_n, double* C,
                                   double* sig, int* niter, double* yielding, double* norm_res,
                                   double* dlambda, long long n, const double* params,
                                   void* stream) {
  if (n > 0) {
    const mc::Params P = mc::make_params(params);
    const long long blocks = (n + kThreads - 1) / kThreads;
    mohr_coulomb_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(deps, sig_n, C, sig, niter,
                                                               yielding, norm_res, dlambda, n, P);
  }
  return static_cast<int>(cudaGetLastError());
}
