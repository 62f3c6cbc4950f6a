// CPU build of the Mohr-Coulomb body (mohr_coulomb.cuh), compiled with g++
// so that the tests can hold the kernels' own arithmetic against the plain
// PyTorch version on a machine without a GPU.  Point by point, as the
// card's two passes share it: an elastic point that takes no Newton step
// as pass A finishes it; any other point as pass B does, with its roles
// run one after another (SerialGroup), in order or, with ``reverse`` != 0,
// in reverse order.  The two orders must give the same bits: a role that
// read what another role writes later would be a race between the threads
// of a tile on the card.
#include "mohr_coulomb.cuh"

template <bool Reverse>
static void run(const double* deps, const double* sig_n, const mc::Outputs& o, long long n,
                const mc::Params& P) {
  mc::SerialGroup<Reverse> g;
  for (long long i = 0; i < n; ++i) {
    mc::Trial t = mc::load_trial(deps, sig_n, i, n, P.c64);
    mc::set_yield(t, mc::trial_yield(t, P.c64));
    o.yielding[i] = t.f_tr;
    if (t.f_tr > 0.0) {
      mc::plastic_point(g, t, P, o, i, n);
    } else if (!mc::elastic_at_rest(t, P, o, i, n)) {
      mc::elastic_point(g, t, P, o, i, n);
    }
  }
}

extern "C" void mohr_coulomb_host(const double* deps, const double* sig_n, double* C,
                                  double* sig, int* niter, double* yielding, double* norm_res,
                                  double* dlambda, long long n, const double* params,
                                  int reverse) {
  const mc::Params P = mc::make_params(params);
  const mc::Outputs o{C, sig, niter, yielding, norm_res, dlambda};
  if (reverse) {
    run<true>(deps, sig_n, o, n, P);
  } else {
    run<false>(deps, sig_n, o, n, P);
  }
}
