// CPU build of AMG-CG's fused f32 chains (mg_cycle.cuh), compiled with g++
// so that the tests can hold the kernels' own arithmetic against the torch
// chains on a machine without a GPU: the launchers' contracts, one dof
// after another.  Every operation is spelt out in the header, each
// rounded on its own, so these are the card's bits.
#include "mg_cycle.cuh"

namespace {

template <int kMode>
void cheb(const MgChebArgs& a, long long n, float c0, float c1) {
  for (long long i = 0; i < n; ++i) mg_cheb_at<kMode>(a, c0, c1, i);
}

}  // namespace

extern "C" void mg_cheb_host(int mode, long long n, const float* dinv, const float* r_in,
                             const float* av, const float* x_in, float* r_out, float* d,
                             float* x_out, const float* c0, const float* c1) {
  const MgChebArgs a{dinv, r_in, av, x_in, r_out, d, x_out};
  if (mode == 0) cheb<0>(a, n, *c0, 0.0f);
  if (mode == 1) cheb<1>(a, n, *c0, 0.0f);
  if (mode == 2) cheb<2>(a, n, *c0, *c1);
}

extern "C" void mg_pcg_xr_host(long long n, const float* pAp, const float* rz, const float* x_in,
                               const float* r_in, const float* p, const float* ap, float* x_out,
                               float* r_out) {
  const MgXrArgs a{x_in, r_in, p, ap, x_out, r_out};
  const float alpha = mg_pcg_alpha(*pAp, *rz);
  for (long long i = 0; i < n; ++i) mg_xr_at(a, alpha, i);
}

extern "C" void mg_pcg_p_host(long long n, const float* pAp, const float* rz, const float* rz2,
                              const float* nn, const float* nb, const float* z, const float* p_in,
                              const float* x, const float* xb_in, float* p_out, float* xb_out,
                              float* nb_out, float* test) {
  const MgPArgs a{z, p_in, x, xb_in, p_out, xb_out};
  const MgPcgTest t = mg_pcg_test(*pAp, *rz, *nn, *nb);
  const float beta = mg_pcg_beta(*rz, *rz2);
  for (long long i = 0; i < n; ++i) mg_p_at(a, beta, t.better != 0.0f, i);
  *nb_out = t.nb;
  test[0] = t.good;
  test[1] = t.nn;
  test[2] = t.better;
}
