// CPU build of the von Mises per-point body (vonmises.cuh), compiled with
// g++ so that the tests can hold the kernels' own arithmetic against the
// plain PyTorch version on a machine without a GPU: both entry points, one
// point after another.
#include "vonmises.cuh"

extern "C" void vonmises_return_map_host(const float* deps, const float* sig_n, const float* p,
                                         float* C, float* sig, float* dp, long long n,
                                         float lmbda, float mu, float H, float sig0) {
  const VmParams k{lmbda, mu, H, sig0};
  for (long long i = 0; i < n; ++i) vonmises_point(deps, sig_n, p, C, sig, dp, i, n, k);
}

extern "C" void vonmises_f64_host(const double* deps, long long rs_d, long long ps_d,
                                  const double* sig_n, long long rs_s, long long ps_s,
                                  const double* p, double* C, double* sig, double* dp,
                                  long long n, float lmbda, float mu, float H, float sig0) {
  const VmParams k{lmbda, mu, H, sig0};
  for (long long i = 0; i < n; ++i) {
    vonmises_point_f64(deps, rs_d, ps_d, sig_n, rs_s, ps_s, p, C, sig, dp, i, n, k);
  }
}
