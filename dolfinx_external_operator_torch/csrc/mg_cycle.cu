// AMG-CG's f32 iteration on the card (sm_90a): a Chebyshev step's vector
// updates and the PCG's vector and scalar work, each one launch.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses these chains
// inside the while_loop of ir_pcg and the smoother
// (dolfinx_external_operator_tpu/parallel/mg.py, _chebyshev and the PCG
// body); the port's torch chains (parallel/mg.py, *_reference) launched
// 14-16 elementwise kernels a Chebyshev call and about 30 a PCG
// iteration, each 1.5-2.5 us for at most 11,222 floats.  Three kernels,
// the arithmetic in mg_cycle.cuh, in the chains' order and rounding:
//
//   mg_cheb   one Chebyshev launch between two matvecs (modes 0, 1, 2)
//   mg_pcg_xr PCG (a), after Ap = A p and pAp = p . Ap: alpha, x, r
//   mg_pcg_p  PCG (b), after z = M r, rz2 = r . z and nn = |r|: beta, p,
//             the best iterate into its slot of the batch, and (one
//             thread) the new best norm and the loop test's row
//
// The scalars (theta and the Chebyshev weights that mg_setup keeps in its
// workspace, the dots and norms) are read through device pointers, never
// on the host, so a CUDA graph replayed after mg_setup(..., out=) reads
// the new hierarchy's.  No thread writes what another thread of the
// launch reads: the vectors are read and written at a thread's own dofs
// alone, and the scalars a launch writes lie in buffers it does not read.
//
// What bounds them: at 11,222 dofs a launch moves at most 8 x 45 KB, some
// 0.1 us at 3.35 TB/s, under the ~1 us floor of a launch: the time is the
// launch and one round trip to memory, so one thread takes one dof (four
// dofs a thread through 16-byte loads timed the same in a graph).  Each
// launcher runs on the caller's stream, does not synchronise and
// allocates nothing (graph-capturable), and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mg_cycle.cuh"

namespace {

constexpr int kThreads = 256;

unsigned int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

__device__ __forceinline__ long long dof() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    cheb_kernel(MgChebArgs a, long long n, const float* c0p, const float* c1p) {
  const long long i = dof();
  if (i >= n) return;
  mg_cheb_at<kMode>(a, *c0p, kMode == 2 ? *c1p : 0.0f, i);
}

__global__ void __launch_bounds__(kThreads)
    pcg_xr_kernel(MgXrArgs a, long long n, const float* pAp, const float* rz) {
  const long long i = dof();
  if (i >= n) return;
  mg_xr_at(a, mg_pcg_alpha(*pAp, *rz), i);
}

__global__ void __launch_bounds__(kThreads)
    pcg_p_kernel(MgPArgs a, long long n, const float* pAp, const float* rz, const float* rz2,
                 const float* nn, const float* nb, float* nb_out, float* test) {
  const long long i = dof();
  const MgPcgTest t = mg_pcg_test(*pAp, *rz, *nn, *nb);
  if (i == 0) {
    *nb_out = t.nb;
    test[0] = t.good;
    test[1] = t.nn;
    test[2] = t.better;
  }
  if (i >= n) return;
  mg_p_at(a, mg_pcg_beta(*rz, *rz2), t.better != 0.0f, i);
}

}  // namespace

extern "C" int mg_cheb_launch(int mode, long long n, const float* dinv, const float* r_in,
                              const float* av, const float* x_in, float* r_out, float* d,
                              float* x_out, const float* c0, const float* c1, void* stream) {
  if (n < 0 || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const MgChebArgs a{dinv, r_in, av, x_in, r_out, d, x_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (mode == 0) cheb_kernel<0><<<grid_for(n), kThreads, 0, st>>>(a, n, c0, c1);
    if (mode == 1) cheb_kernel<1><<<grid_for(n), kThreads, 0, st>>>(a, n, c0, c1);
    if (mode == 2) cheb_kernel<2><<<grid_for(n), kThreads, 0, st>>>(a, n, c0, c1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_pcg_xr_launch(long long n, const float* pAp, const float* rz, const float* x_in,
                                const float* r_in, const float* p, const float* ap, float* x_out,
                                float* r_out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const MgXrArgs a{x_in, r_in, p, ap, x_out, r_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) pcg_xr_kernel<<<grid_for(n), kThreads, 0, st>>>(a, n, pAp, rz);
  return static_cast<int>(cudaGetLastError());
}

// launched also at n = 0: its one thread writes the scalars
extern "C" int mg_pcg_p_launch(long long n, const float* pAp, const float* rz, const float* rz2,
                               const float* nn, const float* nb, const float* z,
                               const float* p_in, const float* x, const float* xb_in,
                               float* p_out, float* xb_out, float* nb_out, float* test,
                               void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const MgPArgs a{z, p_in, x, xb_in, p_out, xb_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pcg_p_kernel<<<grid_for(n), kThreads, 0, st>>>(a, n, pAp, rz, rz2, nn, nb, nb_out, test);
  return static_cast<int>(cudaGetLastError());
}
