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

// The staged kernels' composition (element_chain.cu) on the CPU: the same
// loads and stages of the header, stage by stage over each group of cells
// through buffers, as a block of the kernel runs them.  Each returns 1,
// and writes nothing, where the shape is not the staged one
// (ec_quad_staged, the launchers' test).  The tests hold them to the
// bodies above, bit for bit.
extern "C" int ec_residual_staged_host(const double* B, const double* sig, long long s0,
                                       long long s1, long long s2, const double* w, double* out,
                                       long long nc, int nq, int ni, int nk) {
  if (!ec_quad_staged(nq, ni, nk)) return 1;
  for (long long t = 0; t < nc * kEcNK; ++t) {
    EcResidualOps o;
    ec_residual_load(o, B, sig, s0, s1, s2, w, t / kEcNK, static_cast<int>(t % kEcNK));
    out[t] = ec_residual_staged(o);
  }
  return 0;
}

namespace {

void staged_matvec(const double* B, const EcTangent& tg, const double* w, const long long* dof,
                   const double* x, long long n, double* out, long long nc) {
  constexpr int G = kEcVecCells, R = kEcNK;
  EcMatvecOps o[G * R];
  double xs[G * R], de[G * R], ds[G * R];
  for (long long c0 = 0; c0 < nc; c0 += G) {
    const int threads = static_cast<int>(nc - c0 < G ? nc - c0 : G) * R;
    for (int t = 0; t < threads; ++t) {
      ec_matvec_load(o[t], B, tg, w, dof, c0 + t / R, t % R);
      xs[t] = ec_read<double>(x, n, o[t].dof);
    }
    for (int t = 0; t < threads; ++t) de[t] = ec_matvec_de(o[t], xs + t / R * R);
    for (int t = 0; t < threads; ++t) ds[t] = ec_matvec_ds(o[t], de + t / R * R, t % R);
    for (int t = 0; t < threads; ++t) out[c0 * R + t] = ec_matvec_out(o[t], ds + t / R * R);
  }
}

template <typename T>
void staged_blocks(const double* B, const EcTangent& tg, const double* w, const double* keep,
                   T* out, long long nc) {
  constexpr int G = kEcBlockCells, R = kEcNK * kEcNK;
  EcBlockOps<T> o[G * R];
  T bs[G * R], tab[G * R];
  for (long long c0 = 0; c0 < nc; c0 += G) {
    const int threads = static_cast<int>(nc - c0 < G ? nc - c0 : G) * R;
    for (int t = 0; t < threads; ++t) {
      bs[t] = ec_block_load(o[t], B, tg, w, keep, c0 + t / R, t % R);
    }
    for (int t = 0; t < threads; ++t) tab[t] = ec_block_table(o[t], bs + t / R * R, t % R);
    for (int t = 0; t < threads; ++t) {
      out[c0 * R + t] = ec_block_out(o[t], bs + t / R * R, tab + t / R * R, t % R,
                                     keep != nullptr);
    }
  }
}

}  // namespace

extern "C" int ec_tangent_staged_host(int mode, const double* B, const double* C, long long c0,
                                      long long c1, long long c2, long long c3, const double* w,
                                      const long long* dof, const double* x, long long n,
                                      const double* keep, void* out, long long nc, int nq,
                                      int ni, int nk) {
  if (!ec_quad_staged(nq, ni, nk)) return 1;
  const EcTangent tg{C, {c0, c1, c2, c3}};
  if (mode == 0) {
    staged_matvec(B, tg, w, dof, x, n, static_cast<double*>(out), nc);
  } else if (mode == 1) {
    for (long long t = 0; t < nc * kEcNK; ++t) {
      EcDiagOps o;
      ec_diag_load(o, B, tg, w, t / kEcNK, static_cast<int>(t % kEcNK));
      static_cast<double*>(out)[t] = ec_diag_staged(o);
    }
  } else if (mode == 2) {
    staged_blocks(B, tg, w, keep, static_cast<double*>(out), nc);
  } else {
    staged_blocks(B, tg, w, keep, static_cast<float*>(out), nc);
  }
  return 0;
}

// E5 staged: ec_product_launch's staged kernel at the staged shapes
// (ec_product_staged_form), the table copied once as a block stages it,
// then every output's loads and sum (ec_product_load, ec_product_sum).
namespace {

template <typename T, int NK>
void staged_product(const T* A, const T* B, T* out, const EcProduct32& q) {
  T tab[kEcTableMax];
  for (int i = 0; i < q.tab_n; ++i) tab[i] = A[i];
  for (int t = 0; t < q.total; ++t) {
    EcProductOps<T, NK> o;
    ec_product_load(o, A, B, q, t);
    out[t] = ec_product_sum(o, tab, q);
  }
}

template <typename T>
void staged_product_nk(const T* A, const T* B, T* out, const EcProduct32& q, int nk) {
  if (nk == 2) {
    staged_product<T, 2>(A, B, out, q);
  } else if (nk == 3) {
    staged_product<T, 3>(A, B, out, q);
  } else {
    staged_product<T, 6>(A, B, out, q);
  }
}

template <typename T, int NB>
void staged_pair(const T* phi, const T* gp, const T* d2, T* val, T* grad, const EcPair& q) {
  T tab[kEcTableMax], ds[NB * (kEcPairThreads / (1 + kEcPairNG))];
  for (int i = 0; i < q.tab_n; ++i) tab[i] = phi[i];
  EcPairOut<T, NB> o[kEcPairThreads];
  bool mine[kEcPairThreads];
  const int nd = q.nbbs.d;
  for (long long c0 = 0; c0 < q.nc; c0 += q.G) {
    const int cells = static_cast<int>(q.nc - c0 < q.G ? q.nc - c0 : q.G);
    for (int t = 0; t < kEcPairThreads; ++t) {
      mine[t] = ec_pair_load(o[t], gp, val, grad, q, c0, cells, t);
    }
    for (int i = 0; i < cells * nd; ++i) ds[i] = ec_pair_d2(d2, q, c0, i);
    for (int t = 0; t < kEcPairThreads; ++t) {
      if (mine[t]) *o[t].dst = ec_pair_out(o[t], tab, ds + o[t].cell * nd, q);
    }
  }
}

template <typename T>
void staged_pair_nb(const T* phi, const T* gp, const T* d2, T* val, T* grad, const EcPair& q,
                    int nb) {
  if (nb == 2) {
    staged_pair<T, 2>(phi, gp, d2, val, grad, q);
  } else if (nb == 3) {
    staged_pair<T, 3>(phi, gp, d2, val, grad, q);
  } else {
    staged_pair<T, 6>(phi, gp, d2, val, grad, q);
  }
}

}  // namespace

extern "C" int ec_product_staged_host(int f32, const void* A, const void* B, void* out,
                                      long long n0, long long n1, long long n2, long long n3,
                                      long long a0, long long a1, long long a2, long long a3,
                                      long long b0, long long b1, long long b2, long long b3,
                                      long long ak, long long bk, int nk) {
  const EcProduct p{{n0, n1, n2, n3}, {a0, a1, a2, a3}, {b0, b1, b2, b3}, ak, bk, nk};
  EcProduct32 q;
  if (!ec_product_staged_form(p, q)) return 1;
  if (f32) {
    staged_product_nk(static_cast<const float*>(A), static_cast<const float*>(B),
                      static_cast<float*>(out), q, nk);
  } else {
    staged_product_nk(static_cast<const double*>(A), static_cast<const double*>(B),
                      static_cast<double*>(out), q, nk);
  }
  return 0;
}

extern "C" int ec_values_grads_staged_host(int f32, const void* phi, long long p0, long long p1,
                                           const void* gp, long long g0, long long g1,
                                           long long g2, long long g3, const void* d2,
                                           long long d0, long long d1, long long d2s, void* val,
                                           void* grad, long long nc, long long nq, long long nb,
                                           long long bs, long long ng) {
  const long long ps[2] = {p0, p1}, gs[4] = {g0, g1, g2, g3}, ds[3] = {d0, d1, d2s};
  EcPair q;
  if (!ec_pair_staged_form(nc, nq, nb, bs, ng, ps, gs, ds, q)) return 1;
  if (f32) {
    staged_pair_nb(static_cast<const float*>(phi), static_cast<const float*>(gp),
                   static_cast<const float*>(d2), static_cast<float*>(val),
                   static_cast<float*>(grad), q, static_cast<int>(nb));
  } else {
    staged_pair_nb(static_cast<const double*>(phi), static_cast<const double*>(gp),
                   static_cast<const double*>(d2), static_cast<double*>(val),
                   static_cast<double*>(grad), q, static_cast<int>(nb));
  }
  return 0;
}

// the level-1 triple staged: over groups of kEcTripleCells cells, the
// group's W and K copied as the block loads them, then T and out stage by
// stage
extern "C" int ec_triple_staged_host(const float* W, long long w0, long long w1, long long w2,
                                     const float* K, long long k0, long long k1, long long k2,
                                     float* out, long long nc, long long nk, long long na) {
  const long long ws_[3] = {w0, w1, w2}, ks_[3] = {k0, k1, k2};
  if (!ec_triple_staged(nc, nk, na, ws_, ks_)) return 1;
  constexpr int G = kEcTripleCells, NW = kEcTripleNK * kEcTripleNA,
                NKK = kEcTripleNK * kEcTripleNK, NO = kEcTripleNA * kEcTripleNA;
  float ws[G * NW], ks[G * NKK], ts[G * NW];
  for (long long c0 = 0; c0 < nc; c0 += G) {
    const int cells = static_cast<int>(nc - c0 < G ? nc - c0 : G);
    for (int i = 0; i < cells * NW; ++i) ws[i] = W[c0 * NW + i];
    for (int i = 0; i < cells * NKK; ++i) ks[i] = K[c0 * NKK + i];
    for (int t = 0; t < cells * NW; ++t) {
      ts[t] = ec_triple_t(ws + t / NW * NW, ks + t / NW * NKK, t % NW);
    }
    for (int t = 0; t < cells * NO; ++t) {
      out[c0 * NO + t] = ec_triple_out(ts + t / NO * NW, ws + t / NO * NW, t % NO);
    }
  }
  return 0;
}
