// CPU build of the von Mises per-point body (vonmises.cuh), compiled with
// g++ so that the tests can hold the kernel's own arithmetic against the
// plain PyTorch version on a machine without a GPU.
#include "vonmises.cuh"

extern "C" void vonmises_return_map_host(const float* deps, const float* sig_n, const float* p,
                                         float* C, float* sig, float* dp, long long n,
                                         float lmbda, float mu, float H, float sig0) {
  for (long long i = 0; i < n; ++i) {
    vonmises_point(deps, sig_n, p, C, sig, dp, i, n, lmbda, mu, H, sig0);
  }
}
