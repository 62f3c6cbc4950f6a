// Von Mises return map with consistent tangent for one Gauss point.
//
// The per-point body shared by the CUDA kernels (vonmises.cu) and the CPU
// build (vonmises_host.cpp) that the tests hold against the plain PyTorch
// version (ops/vonmises.py::vonmises_return_map_reference).  It is the f32
// formula of ops/vonmises_pallas.py::_kernel in the JAX package, operation
// for operation and in the same order, so the three agree to f32 rounding.
//
// vonmises_eval works on one point's values in registers; each entry point
// loads them in its own layout and precision and stores the results:
//   - the f32 entry, SoA with the point axis contiguous:
//     deps, sig_n (4, n); p (n,) -> C (16, n), sig (4, n), dp (n,), f32;
//   - the f64 entry (the fused step's contract): deps, sig_n (4, n) f64 at
//     any strides, p (n,) f64 or none (p = 0), each value rounded to f32
//     to nearest as torch's .to(float32) rounds it; the same f32 body; the
//     results widened to f64 (exact) into C (16, n), sig (4, n) and, when
//     asked for, dp (n,).
// Both run the one body on the same f32 values, so the f64 entry gives the
// f32 entry's results, widened, bit for bit.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define VM_HD __host__ __device__ __forceinline__
#else
#define VM_HD inline
#endif

struct VmParams {
  float lmbda, mu, H, sig0;
};

VM_HD void vonmises_eval(const float e[4], const float sn[4], float p, const VmParams& k,
                         float C[16], float sig[4], float& dp) {
  const float lmbda = k.lmbda, mu = k.mu, H = k.H, sig0 = k.sig0;

  // elastic predictor: sig_el = sig_n + C_elas @ deps (Mandel notation)
  const float tr_e = e[0] + e[1] + e[2];
  const float two_mu = 2.0f * mu;
  const float s0 = sn[0] + lmbda * tr_e + two_mu * e[0];
  const float s1 = sn[1] + lmbda * tr_e + two_mu * e[1];
  const float s2 = sn[2] + lmbda * tr_e + two_mu * e[2];
  const float s3 = sn[3] + two_mu * e[3];

  const float m = (s0 + s1 + s2) / 3.0f;
  const float d0 = s0 - m, d1 = s1 - m, d2 = s2 - m, d3 = s3;
  const float sig_eq = sqrtf(1.5f * (d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3));

  const float f_el = sig_eq - sig0 - H * p;
  const bool plastic = f_el > 0.0f;
  const float f_plus = plastic ? f_el : 0.0f;
  dp = f_plus / (3.0f * mu + H);

  const float seq_safe = sig_eq > 0.0f ? sig_eq : 1.0f;
  const float beta = plastic ? 3.0f * mu * dp / seq_safe : 0.0f;
  const float scale_n = plastic ? 1.0f / seq_safe : 0.0f;
  const float nv[4] = {d0 * scale_n, d1 * scale_n, d2 * scale_n, d3 * scale_n};

  sig[0] = s0 - beta * d0;
  sig[1] = s1 - beta * d1;
  sig[2] = s2 - beta * d2;
  sig[3] = s3 - beta * d3;

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
      C[4 * a + b] = c_el - coef_n * nv[a] * nv[b] - two_mu_beta * dev_ab;
    }
  }
}

// f64 -> f32 to nearest, ties to even: what torch's .to(float32) does
VM_HD float vm_narrow(double x) {
#ifdef __CUDA_ARCH__
  return __double2float_rn(x);
#else
  return static_cast<float>(x);
#endif
}

// Point i of the f32 entry: the CPU build's loop body (the card's kernels
// do the same with read-only loads and streaming stores).
VM_HD void vonmises_point(const float* __restrict__ deps, const float* __restrict__ sig_n,
                          const float* __restrict__ p, float* __restrict__ C,
                          float* __restrict__ sig, float* __restrict__ dp, long long i,
                          long long n, const VmParams& k) {
  float e[4], sn[4], c[16], s[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    e[r] = deps[r * n + i];
    sn[r] = sig_n[r * n + i];
  }
  vonmises_eval(e, sn, p[i], k, c, s, dp[i]);
#pragma unroll
  for (int r = 0; r < 16; ++r) C[r * n + i] = c[r];
#pragma unroll
  for (int r = 0; r < 4; ++r) sig[r * n + i] = s[r];
}

// Point i of the f64 entry, likewise: deps and sig_n at (row, point)
// strides, p null for p = 0, dp null when not asked for.
VM_HD void vonmises_point_f64(const double* __restrict__ deps, long long rs_d, long long ps_d,
                              const double* __restrict__ sig_n, long long rs_s, long long ps_s,
                              const double* __restrict__ p, double* __restrict__ C,
                              double* __restrict__ sig, double* __restrict__ dp, long long i,
                              long long n, const VmParams& k) {
  float e[4], sn[4], c[16], s[4], d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    e[r] = vm_narrow(deps[r * rs_d + i * ps_d]);
    sn[r] = vm_narrow(sig_n[r * rs_s + i * ps_s]);
  }
  vonmises_eval(e, sn, p ? vm_narrow(p[i]) : 0.0f, k, c, s, d);
#pragma unroll
  for (int r = 0; r < 16; ++r) C[r * n + i] = c[r];
#pragma unroll
  for (int r = 0; r < 4; ++r) sig[r * n + i] = s[r];
  if (dp) dp[i] = d;
}
