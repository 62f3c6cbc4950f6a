// AMG-CG's f32 iteration: the elementwise chains of a Chebyshev step and
// of a PCG iteration, one dof a call.
//
// The arithmetic shared by the CUDA kernels (mg_cycle.cu) and the CPU
// build (mg_cycle_host.cpp) that the tests hold against the torch chains
// they replace (parallel/mg.py: _chebyshev_reference,
// _pcg_iterations_reference).  The JAX package runs these chains inside
// its while_loop, where XLA fuses them (dolfinx_external_operator_tpu/
// parallel/mg.py, _chebyshev and the PCG body of ir_pcg); torch launches
// one kernel an operation.
//
// Rounding: every operation is one of torch's, in torch's order, each
// rounded on its own: products mg_mul(), sums mg_add() and mg_sub(),
// quotients mg_div().  On the card they are __fmul_rn, __fadd_rn,
// __fsub_rn and __fdiv_rn, which nvcc never contracts into a fused
// multiply-add (NVCC_FLAGS leave -fmad on); the g++ build on x86-64 has
// no FMA to contract into.  So the kernels' bits are the torch chains'.
//
// The chains (every operand f32; the scalars are 0-dim tensors, read
// through device pointers on the card):
//   Chebyshev, mode 0 (zero start)  d = (dinv r) / theta,  x = d
//              mode 1 (a start x0)  r = b - A x0,  d = (dinv r) / theta,
//                                   x = x0 + d
//              mode 2 (a step)      r = r - A d,
//                                   d = c_old d + c_new (dinv r),  x = x + d
//   PCG (a)  good  = finite(pAp) & pAp > 0 & finite(rz) & rz > 0
//            alpha = good ? rz / (pAp > 0 ? pAp : 1) : 0
//            x = x + alpha p,  r = r - alpha Ap
//   PCG (b)  beta = rz > 0 ? rz2 / (rz > 0 ? rz : 1) : 0,  p = z + beta p
//            better = nn < nb,  xb = better ? x : xb,  nb = better ? nn : nb
//            good = good & finite(nn) & nn < 100 nb  (the new nb)
#pragma once

#include <cfloat>

#ifdef __CUDACC__
#define MG_HD __host__ __device__ __forceinline__
#else
#define MG_HD inline
#endif

MG_HD float mg_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
MG_HD float mg_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
MG_HD float mg_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
MG_HD float mg_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
// torch.isfinite: NaN compares false, and the infinities are the only
// values past FLT_MAX
MG_HD bool mg_finite(float a) { return a >= -FLT_MAX && a <= FLT_MAX; }

// A Chebyshev launch's vectors (n floats each).  r_in may be r_out and
// x_in x_out (a step updates its own buffers in place); d is read (mode 2)
// and written.  A dof's operands are all read before any is written.
struct MgChebArgs {
  const float* dinv;
  const float* r_in;
  const float* av;
  const float* x_in;
  float* r_out;
  float* d;
  float* x_out;
};

// One dof of a Chebyshev launch: mode 0 reads dinv and r_in and writes d
// and x_out; mode 1 reads r_in = b, av = A x0 and x_in = x0, and writes
// r_out too; mode 2 reads r_in, av = A d, d and x_in.  c0 is theta in
// modes 0 and 1, c_old in mode 2; c1 is c_new.
template <int kMode>
MG_HD void mg_cheb_at(const MgChebArgs& a, float c0, float c1, long long i) {
  const float dinv = a.dinv[i];
  if (kMode == 0) {
    const float d0 = mg_div(mg_mul(dinv, a.r_in[i]), c0);
    a.d[i] = d0;
    a.x_out[i] = d0;
    return;
  }
  const float rn = mg_sub(a.r_in[i], a.av[i]);
  const float dn = kMode == 1 ? mg_div(mg_mul(dinv, rn), c0)
                              : mg_add(mg_mul(c0, a.d[i]), mg_mul(c1, mg_mul(dinv, rn)));
  const float xn = mg_add(a.x_in[i], dn);
  a.r_out[i] = rn;
  a.d[i] = dn;
  a.x_out[i] = xn;
}

// PCG (a)'s step length from pAp = p . Ap and rz = r . z
MG_HD bool mg_pcg_good(float pAp, float rz) {
  return mg_finite(pAp) && pAp > 0.0f && mg_finite(rz) && rz > 0.0f;
}
MG_HD float mg_pcg_alpha(float pAp, float rz) {
  return mg_pcg_good(pAp, rz) ? mg_div(rz, pAp > 0.0f ? pAp : 1.0f) : 0.0f;
}

// PCG (a)'s vectors: x_out = x_in + alpha p, r_out = r_in - alpha ap (in
// place or not)
struct MgXrArgs {
  const float* x_in;
  const float* r_in;
  const float* p;
  const float* ap;
  float* x_out;
  float* r_out;
};

MG_HD void mg_xr_at(const MgXrArgs& a, float alpha, long long i) {
  const float x = mg_add(a.x_in[i], mg_mul(alpha, a.p[i]));
  const float r = mg_sub(a.r_in[i], mg_mul(alpha, a.ap[i]));
  a.x_out[i] = x;
  a.r_out[i] = r;
}

// PCG (b)'s weight of the old direction, from the old rz and the new rz2
MG_HD float mg_pcg_beta(float rz, float rz2) {
  return rz > 0.0f ? mg_div(rz2, rz > 0.0f ? rz : 1.0f) : 0.0f;
}

// PCG (b)'s loop test: the new best norm, and the row the host reads
// (good, nn, better as 1 or 0)
struct MgPcgTest {
  float nb, good, nn, better;
};

MG_HD MgPcgTest mg_pcg_test(float pAp, float rz, float nn, float nb) {
  const bool better = nn < nb;
  const float nb2 = better ? nn : nb;
  const bool good = mg_pcg_good(pAp, rz) && mg_finite(nn) && nn < mg_mul(100.0f, nb2);
  return {nb2, good ? 1.0f : 0.0f, nn, better ? 1.0f : 0.0f};
}

// PCG (b)'s vectors: p_out = z + beta p_in (in place or not), xb_out =
// x where better, else xb_in
struct MgPArgs {
  const float* z;
  const float* p_in;
  const float* x;
  const float* xb_in;
  float* p_out;
  float* xb_out;
};

MG_HD void mg_p_at(const MgPArgs& a, float beta, bool better, long long i) {
  const float p = mg_add(a.z[i], mg_mul(beta, a.p_in[i]));
  const float xb = better ? a.x[i] : a.xb_in[i];
  a.p_out[i] = p;
  a.xb_out[i] = xb;
}
