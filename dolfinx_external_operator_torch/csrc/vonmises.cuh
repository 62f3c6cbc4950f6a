// Von Mises return map with consistent tangent for one Gauss point.
//
// The per-point body shared by the CUDA kernel (vonmises.cu) and the CPU
// build (vonmises_host.cpp) that the tests hold against the plain PyTorch
// version (ops/vonmises.py::vonmises_return_map_reference).  It is the f32
// formula of ops/vonmises_pallas.py::_kernel in the JAX package, operation
// for operation and in the same order, so the three agree to f32 rounding.
//
// Layout is structure-of-arrays with the point axis contiguous:
//   deps, sig_n (4, n); p (n,)  ->  C (16, n), sig (4, n), dp (n,)
// so neighbouring points (threads) touch neighbouring addresses.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define VM_HD __host__ __device__ __forceinline__
#else
#define VM_HD inline
#endif

VM_HD void vonmises_point(const float* __restrict__ deps, const float* __restrict__ sig_n,
                          const float* __restrict__ p, float* __restrict__ C,
                          float* __restrict__ sig, float* __restrict__ dp_out,
                          long long i, long long n, float lmbda, float mu, float H,
                          float sig0) {
  const float e0 = deps[i], e1 = deps[n + i], e2 = deps[2 * n + i], e3 = deps[3 * n + i];

  // elastic predictor: sig_el = sig_n + C_elas @ deps (Mandel notation)
  const float tr_e = e0 + e1 + e2;
  const float two_mu = 2.0f * mu;
  const float s0 = sig_n[i] + lmbda * tr_e + two_mu * e0;
  const float s1 = sig_n[n + i] + lmbda * tr_e + two_mu * e1;
  const float s2 = sig_n[2 * n + i] + lmbda * tr_e + two_mu * e2;
  const float s3 = sig_n[3 * n + i] + two_mu * e3;

  const float m = (s0 + s1 + s2) / 3.0f;
  const float d0 = s0 - m, d1 = s1 - m, d2 = s2 - m, d3 = s3;
  const float sig_eq = sqrtf(1.5f * (d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3));

  const float f_el = sig_eq - sig0 - H * p[i];
  const bool plastic = f_el > 0.0f;
  const float f_plus = plastic ? f_el : 0.0f;
  const float dp = f_plus / (3.0f * mu + H);

  const float seq_safe = sig_eq > 0.0f ? sig_eq : 1.0f;
  const float beta = plastic ? 3.0f * mu * dp / seq_safe : 0.0f;
  const float scale_n = plastic ? 1.0f / seq_safe : 0.0f;
  const float nv[4] = {d0 * scale_n, d1 * scale_n, d2 * scale_n, d3 * scale_n};

  sig[i] = s0 - beta * d0;
  sig[n + i] = s1 - beta * d1;
  sig[2 * n + i] = s2 - beta * d2;
  sig[3 * n + i] = s3 - beta * d3;
  dp_out[i] = dp;

  // C_tang = C_elas - 3mu (3mu/(3mu+H) - beta) n (x) n - 2mu beta DEV
  const float coef_n = 3.0f * mu * (3.0f * mu / (3.0f * mu + H) - beta);
  const float two_mu_beta = two_mu * beta;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // DEV entries are the f32 roundings of 1, 2/3, -1/3 and 0
      float c_el, dev_ab;
      if (a == 3 && b == 3) {
        c_el = two_mu;
        dev_ab = 1.0f;
      } else if (a < 3 && b < 3) {
        c_el = a == b ? lmbda + two_mu : lmbda;
        dev_ab = a == b ? 2.0f / 3.0f : -1.0f / 3.0f;
      } else {
        c_el = 0.0f;
        dev_ab = 0.0f;
      }
      C[(4 * a + b) * n + i] = c_el - coef_n * nv[a] * nv[b] - two_mu_beta * dev_ab;
    }
  }
}
