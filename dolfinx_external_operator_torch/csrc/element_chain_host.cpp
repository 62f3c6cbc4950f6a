// CPU build of the element chain's per-output bodies (element_chain.cuh),
// compiled with g++ so that the tests can hold the kernels' own arithmetic
// against the plain PyTorch version on a machine without a GPU: the same
// launchers' contracts, one output after another.  Every operation is
// spelt out in the header (fma, products rounded on their own), so these
// are the card's bits.
#include "element_chain.cuh"

extern "C" void ec_strain_host(const double* B, const long long* dof, const double* u,
                               long long n, double* out, long long nc, int nq, int ni, int nk) {
  const EcShape s{nc, nq, ni, nk};
  for (long long c = 0; c < nc; ++c)
    for (int q = 0; q < nq; ++q)
      for (int i = 0; i < ni; ++i) out[(c * nq + q) * ni + i] = ec_strain(B, dof, u, n, s, c, q, i);
}

extern "C" void ec_residual_host(const double* B, const double* sig, long long s0, long long s1,
                                 long long s2, const double* w, double* out, long long nc, int nq,
                                 int ni, int nk) {
  const EcShape s{nc, nq, ni, nk};
  for (long long c = 0; c < nc; ++c)
    for (int k = 0; k < nk; ++k) out[c * nk + k] = ec_residual(B, sig, s0, s1, s2, w, s, c, k);
}

extern "C" void ec_tangent_host(int mode, const double* B, const double* C, long long c0,
                                long long c1, long long c2, long long c3, const double* w,
                                const long long* dof, const double* x, long long n,
                                const double* keep, void* out, long long nc, int nq, int ni,
                                int nk) {
  const EcShape s{nc, nq, ni, nk};
  const EcTangent tg{C, {c0, c1, c2, c3}};
  for (long long c = 0; c < nc; ++c) {
    for (int k = 0; k < nk; ++k) {
      if (mode == 0) {
        static_cast<double*>(out)[c * nk + k] = ec_tangent_matvec(B, tg, w, dof, x, n, s, c, k);
      } else if (mode == 1) {
        static_cast<double*>(out)[c * nk + k] =
            ec_tangent_block<double>(B, tg, w, nullptr, s, c, k, k);
      } else {
        for (int l = 0; l < nk; ++l) {
          const long long o = (c * nk + k) * nk + l;
          if (mode == 2) {
            static_cast<double*>(out)[o] = ec_tangent_block<double>(B, tg, w, keep, s, c, k, l);
          } else {
            static_cast<float*>(out)[o] = ec_tangent_block<float>(B, tg, w, keep, s, c, k, l);
          }
        }
      }
    }
  }
}

extern "C" void ec_ebe_host(int f32, const void* K, long long k0, long long k1, long long k2,
                            const long long* idx, const void* x, long long n, void* out,
                            long long nc, int na, int nb, int bs) {
  const long long ks[3] = {k0, k1, k2};
  for (long long c = 0; c < nc; ++c) {
    for (int a = 0; a < na; ++a) {
      if (f32) {
        static_cast<float*>(out)[c * na + a] = ec_ebe<float>(
            static_cast<const float*>(K), ks, idx, static_cast<const float*>(x), n, c, a, nb, bs);
      } else {
        static_cast<double*>(out)[c * na + a] = ec_ebe<double>(
            static_cast<const double*>(K), ks, idx, static_cast<const double*>(x), n, c, a, nb, bs);
      }
    }
  }
}

extern "C" void ec_product_host(int f32, const void* A, const void* B, void* out, long long n0,
                                long long n1, long long n2, long long n3, long long a0,
                                long long a1, long long a2, long long a3, long long b0,
                                long long b1, long long b2, long long b3, long long ak,
                                long long bk, int nk) {
  const EcProduct p{{n0, n1, n2, n3}, {a0, a1, a2, a3}, {b0, b1, b2, b3}, ak, bk, nk};
  const long long total = n0 * n1 * n2 * n3;
  for (long long t = 0; t < total; ++t) {
    if (f32) {
      static_cast<float*>(out)[t] =
          ec_product<float>(static_cast<const float*>(A), static_cast<const float*>(B), p, t);
    } else {
      static_cast<double*>(out)[t] =
          ec_product<double>(static_cast<const double*>(A), static_cast<const double*>(B), p, t);
    }
  }
}
