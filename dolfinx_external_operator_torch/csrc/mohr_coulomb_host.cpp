// CPU build of the Mohr-Coulomb per-point body (mohr_coulomb.cuh), compiled
// with g++ so that the tests can hold the kernel's own arithmetic against
// the plain PyTorch version on a machine without a GPU.
#include "mohr_coulomb.cuh"

extern "C" void mohr_coulomb_host(const double* deps, const double* sig_n, double* C,
                                  double* sig, int* niter, double* yielding, double* norm_res,
                                  double* dlambda, long long n, const double* params) {
  const mc::Params P = mc::make_params(params);
  for (long long i = 0; i < n; ++i) {
    mc::mc_point(deps, sig_n, C, sig, niter, yielding, norm_res, dlambda, i, n, P);
  }
}
