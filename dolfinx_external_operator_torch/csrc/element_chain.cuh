// The element chain of the fused plasticity step: one output a call.
//
// The arithmetic shared by the CUDA kernels (element_chain.cu) and the CPU
// build (element_chain_host.cpp) that the tests hold against the plain
// PyTorch version (ops/element_chain.py).  The JAX package computes these
// contractions as XLA einsums (parallel/spmd.py:493, :508, :514-516, :521,
// the element blocks at :612, :651, :745, :794, :947, the
// element-blocked matvec at :617-620, the AMG setup's level-1 triple at
// parallel/mg.py:890 and the operand evaluation at assembly.py:114-139);
// the port's plain versions are torch einsums, matmuls and torch.bmm,
// which cuBLAS runs with a kernel it picks by the batch count, so that a
// rank's slice of the cells could give other bits than the same cells of
// the whole batch.
//
// The rule of this file: every output is one sum in a written, fixed
// order that depends on nothing but the output's own indices.  No body
// reads the cell count, the grid, the block or the position of its cell
// in the batch; none splits a sum or picks an order by the shapes.  So a
// cell gives the same bits in any batch, at any offset, on any rank.  A
// kernel may stage its operands (shared memory, a block's group of cells
// loaded together): staging changes where an operand is read from, never
// the order of a sum or its operations.
//
// The orders (ascending in every index):
//   E1 strain    deps[c,q,i] = sum_k B[c,q,i,k] u[dof[c,k]]
//   E2 residual  r[c,k]      = sum_q w[c,q] (sum_i B[c,q,i,k] sig[c,q,i])
//   E3 tangent   matvec  y[c,k]   = sum_q w (sum_i B[c,q,i,k] dsig_i),
//                          dsig_i = sum_j C[c,q,i,j] de_j,
//                          de_j   = sum_l B[c,q,j,l] x[dof[c,l]]
//                blocks  K[c,k,l] = sum_q w (sum_i B[c,q,i,k] t_i),
//                          t_i    = sum_j C[c,q,i,j] B[c,q,j,l]
//                diag    d[c,k]   = K[c,k,k] of the blocks, the same bits
//                masked  (K[c,k,l] * keep[c,k]) * keep[c,l]
//   E4 ebe       y[c,a] = sum_b K[c,a,b] x[idx[c,b/bs] bs + b%bs]  (K may be
//                non-square: a < na, b < nb)
//   E5 product   out[b0,b1,m,n] = sum_k A[b0,b1,m,k] B[b0,b1,k,n], each
//                operand at its strides (0 broadcasts it over an axis);
//                the triple W^T K W is (W^T K) W: T[c,a,j] = sum_i
//                W[c,i,a] K[c,i,j], then out[c,a,b] = sum_j T[c,a,j] W[c,j,b]
// A gathered index outside [0, n) is padding and reads 0, as the plain
// version's appended zero does.
//
// Rounding: every step of a sum is one fused multiply-add, ec_fma(), and
// the masking products are ec_mul(), a product rounded on its own.  Both
// are spelt out, so nvcc fuses no f64 or f32 product of its own accord
// and every operation rounds the same way on the card and in the g++
// build (which does not contract, and whose fma() is correctly rounded):
// the kernel's bits are the g++ build's.
#pragma once

#include <cmath>

#ifdef __CUDACC__
#define EC_HD __host__ __device__ __forceinline__
#else
#define EC_HD inline
#endif

// strain components a Gauss point may have (Mandel: 4 in 2D, 6 in 3D)
constexpr int kEcMaxComp = 6;

EC_HD double ec_fma(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return fma(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}
EC_HD float ec_fma(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return fmaf(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

EC_HD double ec_mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
EC_HD float ec_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// x[j] in T, or 0 where j is padding
template <typename T, typename X>
EC_HD T ec_read(const X* x, long long n, long long j) {
  return (j >= 0 && j < n) ? static_cast<T>(x[j]) : T(0);
}

// The sum of a row against a vector, ascending in k: E1's, E4's and E5's
// sum, each step one FMA (row[k] at row + k * rs, v(k) the vector's k-th
// entry)
template <typename T, typename V>
EC_HD T ec_dot(const T* row, long long rs, const V& v, int nk) {
  T acc = T(0);
  for (int k = 0; k < nk; ++k) acc = ec_fma(row[k * rs], v(k), acc);
  return acc;
}

// The shapes of one batch: cells, Gauss points, strain components, dofs
// of a cell.  B is (nc, nq, ni, nk), w (nc, nq) and dof (nc, nk), all
// contiguous; sigma and C are read at the strides given.
struct EcShape {
  long long nc;
  int nq, ni, nk;
};

// E1: deps[c, q, i]
EC_HD double ec_strain(const double* B, const long long* dof, const double* u, long long n,
                       const EcShape& s, long long c, int q, int i) {
  const long long* d = dof + c * s.nk;
  return ec_dot(B + ((c * s.nq + q) * s.ni + i) * s.nk, 1,
                [&](int k) { return ec_read<double>(u, n, d[k]); }, s.nk);
}

// E2: r[c, k]; sigma[c, q, i] at sig + c*s0 + q*s1 + i*s2
EC_HD double ec_residual(const double* B, const double* sig, long long s0, long long s1,
                         long long s2, const double* w, const EcShape& s, long long c, int k) {
  double acc = 0.0;
  for (int q = 0; q < s.nq; ++q) {
    const double* b = B + (c * s.nq + q) * s.ni * s.nk + k;
    const double* sg = sig + c * s0 + q * s1;
    double t = 0.0;
    for (int i = 0; i < s.ni; ++i) t = ec_fma(b[i * s.nk], sg[i * s2], t);
    acc = ec_fma(w[c * s.nq + q], t, acc);
  }
  return acc;
}

// The tangent C[c, q, i, j] at C + c*cs[0] + q*cs[1] + i*cs[2] + j*cs[3]
struct EcTangent {
  const double* C;
  long long cs[4];
};

// E3, matvec: y[c, k]
EC_HD double ec_tangent_matvec(const double* B, const EcTangent& t, const double* w,
                               const long long* dof, const double* x, long long n,
                               const EcShape& s, long long c, int k) {
  const long long* d = dof + c * s.nk;
  double acc = 0.0;
  for (int q = 0; q < s.nq; ++q) {
    const double* bq = B + (c * s.nq + q) * s.ni * s.nk;
    const double* Cq = t.C + c * t.cs[0] + q * t.cs[1];
    double de[kEcMaxComp];
    for (int j = 0; j < s.ni; ++j) {
      double e = 0.0;
      for (int l = 0; l < s.nk; ++l) e = ec_fma(bq[j * s.nk + l], ec_read<double>(x, n, d[l]), e);
      de[j] = e;
    }
    double y = 0.0;
    for (int i = 0; i < s.ni; ++i) {
      double ds = 0.0;
      for (int j = 0; j < s.ni; ++j) ds = ec_fma(Cq[i * t.cs[2] + j * t.cs[3]], de[j], ds);
      y = ec_fma(bq[i * s.nk + k], ds, y);
    }
    acc = ec_fma(w[c * s.nq + q], y, acc);
  }
  return acc;
}

// E3, blocks: K[c, k, l] in T (the inputs rounded to T first, as the plain
// f32 version casts them), masked by keep[c, .] where keep is given
template <typename T>
EC_HD T ec_tangent_block(const double* B, const EcTangent& t, const double* w,
                         const double* keep, const EcShape& s, long long c, int k, int l) {
  T acc = T(0);
  for (int q = 0; q < s.nq; ++q) {
    const double* bq = B + (c * s.nq + q) * s.ni * s.nk;
    const double* Cq = t.C + c * t.cs[0] + q * t.cs[1];
    T y = T(0);
    for (int i = 0; i < s.ni; ++i) {
      T ti = T(0);
      for (int j = 0; j < s.ni; ++j) {
        ti = ec_fma(static_cast<T>(Cq[i * t.cs[2] + j * t.cs[3]]),
                    static_cast<T>(bq[j * s.nk + l]), ti);
      }
      y = ec_fma(static_cast<T>(bq[i * s.nk + k]), ti, y);
    }
    acc = ec_fma(static_cast<T>(w[c * s.nq + q]), y, acc);
  }
  if (keep != nullptr) {
    acc = ec_mul(ec_mul(acc, static_cast<T>(keep[c * s.nk + k])),
                 static_cast<T>(keep[c * s.nk + l]));
  }
  return acc;
}

// ----------------------------------------------------------------------
// E2 and E3 staged (element_chain.cu's staged kernels, and the staged CPU
// entries of element_chain_host.cpp): the repo's shape, nq = 3 Gauss
// points of ni = 4 strain components and nk = 12 dofs a cell, every trip
// count fixed at compile time.  A cell takes 12 threads (E2, the matvec,
// the diagonal) or 144 (the blocks).  Each thread first loads all of its
// operands (ec_*_load: independent loads, all in flight at once); then
// the stages each compute a value once a cell that the bodies above
// recompute in every output (de_j, dsig_i, t_i), from the cell's values
// of the stage before, in the bodies' order.  So the staged outputs are
// the bodies' bits.  In the 12-thread kernels thread r of a cell is dof
// r, pair (q, i) = (r / ni, r % ni) and output k = r at once.
constexpr int kEcNQ = 3;
constexpr int kEcNI = 4;
constexpr int kEcNK = 12;
constexpr int kEcNP = kEcNQ * kEcNI;  // a cell's (point, component) pairs
static_assert(kEcNP == kEcNK && kEcNI <= kEcMaxComp, "the staged shape");
// cells a block of the staged kernels takes: the matvec's groups (12
// threads a cell) and the blocks' (144 threads a cell)
constexpr int kEcVecCells = 10;
constexpr int kEcBlockCells = 1;

EC_HD bool ec_quad_staged(int nq, int ni, int nk) {
  return nq == kEcNQ && ni == kEcNI && nk == kEcNK;
}

#ifdef __CUDA_ARCH__
#define EC_UNROLL _Pragma("unroll")
#else
#define EC_UNROLL
#endif

// sum_q w[q] (sum_i b(q ni + i) v(q ni + i)): the outer sums of E2 and E3
// (b(p) = B[c, q, i, k] of the thread's output k)
template <typename T, typename Bp, typename V>
EC_HD T ec_weighted(const T* w, const Bp& b, const V& v) {
  T acc = T(0);
  EC_UNROLL
  for (int q = 0; q < kEcNQ; ++q) {
    T y = T(0);
    EC_UNROLL
    for (int i = 0; i < kEcNI; ++i) y = ec_fma(b(q * kEcNI + i), v(q * kEcNI + i), y);
    acc = ec_fma(w[q], y, acc);
  }
  return acc;
}

// b[p] = B[c, p, k] (p = q ni + i) and wq[q] = w[c, q]
EC_HD void ec_load_column(double* b, double* wq, const double* B, const double* w, long long c,
                          int k) {
  EC_UNROLL
  for (int p = 0; p < kEcNP; ++p) b[p] = B[(c * kEcNP + p) * kEcNK + k];
  EC_UNROLL
  for (int q = 0; q < kEcNQ; ++q) wq[q] = w[c * kEcNQ + q];
}

// E2: the operands of r[c, k]; sigma[c, q, i] at sig + c*s0 + q*s1 + i*s2
struct EcResidualOps {
  double b[kEcNP], sig[kEcNP], w[kEcNQ];
};

EC_HD void ec_residual_load(EcResidualOps& o, const double* B, const double* sig, long long s0,
                            long long s1, long long s2, const double* w, long long c, int k) {
  ec_load_column(o.b, o.w, B, w, c, k);
  EC_UNROLL
  for (int p = 0; p < kEcNP; ++p) o.sig[p] = sig[c * s0 + (p / kEcNI) * s1 + (p % kEcNI) * s2];
}

EC_HD double ec_residual_staged(const EcResidualOps& o) {
  return ec_weighted(o.w, [&](int p) { return o.b[p]; }, [&](int p) { return o.sig[p]; });
}

// E3 matvec: thread r's operands: the dof of x it gathers, the B row of
// de[q, j] (r = q ni + j), the C row of dsig[q, i] (r = q ni + i), and the
// B column and weights of y[c, k = r]
struct EcMatvecOps {
  long long dof;
  double brow[kEcNK], crow[kEcNI], b[kEcNP], w[kEcNQ];
};

EC_HD void ec_matvec_load(EcMatvecOps& o, const double* B, const EcTangent& t, const double* w,
                          const long long* dof, long long c, int r) {
  o.dof = dof[c * kEcNK + r];
  EC_UNROLL
  for (int l = 0; l < kEcNK; ++l) o.brow[l] = B[(c * kEcNP + r) * kEcNK + l];
  const double* Cr = t.C + c * t.cs[0] + (r / kEcNI) * t.cs[1] + (r % kEcNI) * t.cs[2];
  EC_UNROLL
  for (int j = 0; j < kEcNI; ++j) o.crow[j] = Cr[j * t.cs[3]];
  ec_load_column(o.b, o.w, B, w, c, r);
}

// stage 1: de[q, j] of the cell's gathered x (xs[l] = x[dof[c, l]])
EC_HD double ec_matvec_de(const EcMatvecOps& o, const double* xs) {
  return ec_dot(o.brow, 1, [&](int l) { return xs[l]; }, kEcNK);
}

// stage 2: dsig[q, i] of the cell's de (de[q ni + j]), r = q ni + i
EC_HD double ec_matvec_ds(const EcMatvecOps& o, const double* de, int r) {
  const double* dq = de + (r / kEcNI) * kEcNI;
  return ec_dot(o.crow, 1, [&](int j) { return dq[j]; }, kEcNI);
}

// stage 3: y[c, k] of the cell's dsig (ds[q ni + i])
EC_HD double ec_matvec_out(const EcMatvecOps& o, const double* ds) {
  return ec_weighted(o.w, [&](int p) { return o.b[p]; }, [&](int p) { return ds[p]; });
}

// E3 diagonal, one thread an output: the B column of k (which is also
// B[c, q, j, l = k] of t_i), the cell's C and weights
struct EcDiagOps {
  double b[kEcNP], C[kEcNP * kEcNI], w[kEcNQ];
};

EC_HD void ec_diag_load(EcDiagOps& o, const double* B, const EcTangent& t, const double* w,
                        long long c, int k) {
  ec_load_column(o.b, o.w, B, w, c, k);
  EC_UNROLL
  for (int p = 0; p < kEcNP; ++p) {
    const double* Cp = t.C + c * t.cs[0] + (p / kEcNI) * t.cs[1] + (p % kEcNI) * t.cs[2];
    EC_UNROLL
    for (int j = 0; j < kEcNI; ++j) o.C[p * kEcNI + j] = Cp[j * t.cs[3]];
  }
}

// K[c, k, k] = sum_q w (sum_i B[q, i, k] t_i), t_i = sum_j C[q, i, j] B[q, j, k]
EC_HD double ec_diag_staged(const EcDiagOps& o) {
  return ec_weighted(o.w, [&](int p) { return o.b[p]; }, [&](int p) {
    const double* bq = o.b + (p / kEcNI) * kEcNI;
    return ec_dot(o.C + p * kEcNI, 1, [&](int j) { return bq[j]; }, kEcNI);
  });
}

// E3 blocks in T: thread r = k nk + l of a cell holds the cell's B entry
// r (B[c] is 144 contiguous values; rounded to T on load, where
// ec_tangent_block casts) for the cell's copy in shared memory, computes
// the cell's table entry t[p, l] = sum_j C[q, i, j] B[q, j, l] (p = q ni
// + i = k) and then K[c, k, l] from B's column k and the table's column
// l; its own operands: the C row of p, the weights, the mask of k and l
template <typename T>
struct EcBlockOps {
  T crow[kEcNI], w[kEcNQ], keep_k, keep_l;
};

// loads thread r's operands; returns its entry of the cell's B
template <typename T>
EC_HD T ec_block_load(EcBlockOps<T>& o, const double* B, const EcTangent& t, const double* w,
                      const double* keep, long long c, int r) {
  const int k = r / kEcNK, l = r % kEcNK;
  const double* Cr = t.C + c * t.cs[0] + (k / kEcNI) * t.cs[1] + (k % kEcNI) * t.cs[2];
  EC_UNROLL
  for (int j = 0; j < kEcNI; ++j) o.crow[j] = static_cast<T>(Cr[j * t.cs[3]]);
  EC_UNROLL
  for (int q = 0; q < kEcNQ; ++q) o.w[q] = static_cast<T>(w[c * kEcNQ + q]);
  if (keep != nullptr) {
    o.keep_k = static_cast<T>(keep[c * kEcNK + k]);
    o.keep_l = static_cast<T>(keep[c * kEcNK + l]);
  }
  return static_cast<T>(B[c * kEcNP * kEcNK + r]);
}

// stage 1: the table entry t[p, l] of the cell's B (bs[p nk + l])
template <typename T>
EC_HD T ec_block_table(const EcBlockOps<T>& o, const T* bs, int r) {
  const T* bq = bs + (r / kEcNK / kEcNI) * kEcNI * kEcNK + r % kEcNK;
  return ec_dot(o.crow, 1, [&](int j) { return bq[j * kEcNK]; }, kEcNI);
}

// stage 2: K[c, k, l] of the cell's B and table (tab[p nk + l]), masked
// where `masked`
template <typename T>
EC_HD T ec_block_out(const EcBlockOps<T>& o, const T* bs, const T* tab, int r, bool masked) {
  const int k = r / kEcNK, l = r % kEcNK;
  const T acc = ec_weighted(o.w, [&](int p) { return bs[p * kEcNK + k]; },
                            [&](int p) { return tab[p * kEcNK + l]; });
  return masked ? ec_mul(ec_mul(acc, o.keep_k), o.keep_l) : acc;
}

// E4: y[c, a] of the (nc, na, nb) blocks K in T, K[c, a, b] at K + c*ks[0]
// + a*ks[1] + b*ks[2], against x (n,) in T, gathered by node: idx (nc,
// nb / bs)
template <typename T>
EC_HD T ec_ebe(const T* K, const long long* ks, const long long* idx, const T* x, long long n,
               long long c, int a, int nb, int bs) {
  const long long* d = idx + c * (nb / bs);
  return ec_dot(K + c * ks[0] + a * ks[1], ks[2], [&](int b) {
    const long long node = d[b / bs];
    return ec_read<T>(x, n, node < 0 ? -1 : node * bs + b % bs);
  }, nb);
}

// E5: the product's shape and strides.  The output (n[0], n[1], n[2],
// n[3]) is contiguous; its element (i0, i1, i2, i3) is the sum over k <
// nk of A[sum_d i_d as[d] + k ak] B[sum_d i_d bs[d] + k bk] (as[d] or
// bs[d] 0 where an operand does not vary along output axis d: the batch
// axes b0, b1 of the other operand, m of B, n of A).
struct EcProduct {
  long long n[4];
  long long as[4], bs[4];
  long long ak, bk;
  int nk;
};

// E5: the output at flat index t
template <typename T>
EC_HD T ec_product(const T* A, const T* B, const EcProduct& p, long long t) {
  long long oa = 0, ob = 0;
  for (int d = 3; d >= 0; --d) {
    const long long i = t % p.n[d];
    t /= p.n[d];
    oa += i * p.as[d];
    ob += i * p.bs[d];
  }
  const T* b = B + ob;
  return ec_dot(A + oa, p.ak, [&](int k) { return b[k * p.bk]; }, p.nk);
}

// ----------------------------------------------------------------------
// E5 staged (element_chain.cu's staged product, pair and triple kernels,
// and the staged CPU entries of element_chain_host.cpp).  The same sums
// as ec_product, in the same ascending order, one ec_fma a step; what
// changes is where the operands come from: every index 32-bit, the flat
// index split by divisors fixed on the host (EcDiv), the summed length a
// template parameter with all of a thread's loads issued before its first
// FMA, and a table broadcast over the cells read once a block into
// shared memory.

// summed lengths the staged product and pair take (the operand
// evaluation's at the repo's spaces: 2 and 3 reference axes or geometry
// vertices of a triangle, 6 basis functions of P2); others run ec_product
constexpr int kEcProductNK[] = {2, 3, 6};
// the largest table (an operand broadcast over the cells) that a block
// stages in shared memory
constexpr int kEcTableMax = 512;
// the pair's gradient width (2D)
constexpr int kEcPairNG = 2;
// the level-1 triple's staged shape: W (nc, 12, 6) and K (nc, 12, 12)
// contiguous f32, G cells a block of 72 G threads
constexpr int kEcTripleNK = 12;
constexpr int kEcTripleNA = 6;
constexpr int kEcTripleCells = 3;

inline bool ec_product_nk(long long nk) {
  for (int v : kEcProductNK) {
    if (v == nk) return true;
  }
  return false;
}

// Division of n in [0, 2^31) by d in [1, 2^31) as a multiply-high and a
// shift (Granlund and Montgomery's round-up method: m = ceil(2^p / d), p
// = 31 + ceil(log2 d)), the multiplier fixed on the host: in place of a
// 64-bit division, tens of instructions on the card.
struct EcDiv {
  unsigned int mul;
  int shift, d;
};

inline EcDiv ec_divisor(int d) {
  if (d <= 1) return EcDiv{0u, 0, 1};
  int l = 0;
  while ((1LL << l) < d) ++l;
  const int p = 31 + l;
  return EcDiv{static_cast<unsigned int>(((1ULL << p) + d - 1) / d), p - 32, d};
}

// n / v.d, and its remainder in r
EC_HD int ec_divmod(const EcDiv& v, int n, int& r) {
  int q = n;
  if (v.d != 1) {
    const unsigned int un = static_cast<unsigned int>(n);
#ifdef __CUDA_ARCH__
    q = static_cast<int>(__umulhi(un, v.mul) >> v.shift);
#else
    q = static_cast<int>((static_cast<unsigned long long>(un) * v.mul >> 32) >> v.shift);
#endif
  }
  r = n - q * v.d;
  return q;
}

constexpr long long kEcIntMax = 0x7fffffffLL;

// the largest element offset that shape n (each below 2^31) and strides s
// reach, or -1 where a stride is negative or the offset passes 2^31; over
// axes of size 0 the operand is not read
inline long long ec_reach(const long long* n, const long long* s, int nd) {
  long long off = 0;
  for (int d = 0; d < nd; ++d) {
    if (n[d] == 0) return 0;
  }
  for (int d = 0; d < nd; ++d) {
    if (n[d] < 0 || n[d] > kEcIntMax || s[d] < 0 || (n[d] > 1 && s[d] > kEcIntMax)) return -1;
    off += (n[d] - 1) * s[d];
    if (off > kEcIntMax) return -1;
  }
  return off;
}

// the product of the sizes n, or -1 past 2^31 - 1 (or for a negative size)
inline long long ec_count(const long long* n, int nd) {
  long long c = 1;
  for (int d = 0; d < nd; ++d) {
    if (n[d] < 0 || n[d] > kEcIntMax) return -1;
    c *= n[d];
    if (c > kEcIntMax) return -1;
  }
  return c;
}

// E5 staged: the output's axes 1-3 as divisors (axis 0 is what is left),
// the strides in 32 bits, and A's first tab_n elements staged as a table
// (0: A is read where it lies)
struct EcProduct32 {
  EcDiv n1, n2, n3;
  int as[4], bs[4], ak, bk;
  int total, tab_n;
};

// Whether ec_product's p runs staged, and then its staged form in q: the
// summed length one of kEcProductNK, the outputs and both operands'
// offsets below 2^31.  Where A's elements fit kEcTableMax (a table
// broadcast over the cells: the basis or geometry tabulation, which every
// caller passes first), A is staged as the table.
inline bool ec_product_staged_form(const EcProduct& p, EcProduct32& q) {
  const long long total = ec_count(p.n, 4);
  const long long na[5] = {p.n[0], p.n[1], p.n[2], p.n[3], p.nk};
  const long long sa[5] = {p.as[0], p.as[1], p.as[2], p.as[3], p.ak};
  const long long sb[5] = {p.bs[0], p.bs[1], p.bs[2], p.bs[3], p.bk};
  const long long ra = ec_reach(na, sa, 5), rb = ec_reach(na, sb, 5);
  if (!ec_product_nk(p.nk) || total < 0 || ra < 0 || rb < 0) return false;
  q.n1 = ec_divisor(static_cast<int>(p.n[1]));
  q.n2 = ec_divisor(static_cast<int>(p.n[2]));
  q.n3 = ec_divisor(static_cast<int>(p.n[3]));
  for (int d = 0; d < 4; ++d) {
    q.as[d] = static_cast<int>(p.as[d]);
    q.bs[d] = static_cast<int>(p.bs[d]);
  }
  q.ak = static_cast<int>(p.ak);
  q.bk = static_cast<int>(p.bk);
  q.total = static_cast<int>(total);
  q.tab_n = total > 0 && ra < kEcTableMax ? static_cast<int>(ra + 1) : 0;
  return true;
}

// E5 staged, one output a thread: its operands' offsets and values
template <typename T, int NK>
struct EcProductOps {
  int oa, ob;
  T x[NK], y[NK];
};

// stage 1: output t's offsets, and the loads of its operands that are not
// the table (all in flight at once)
template <typename T, int NK>
EC_HD void ec_product_load(EcProductOps<T, NK>& o, const T* A, const T* B, const EcProduct32& p,
                           int t) {
  int i1, i2, i3;
  t = ec_divmod(p.n3, t, i3);
  t = ec_divmod(p.n2, t, i2);
  const int i0 = ec_divmod(p.n1, t, i1);
  o.oa = i0 * p.as[0] + i1 * p.as[1] + i2 * p.as[2] + i3 * p.as[3];
  o.ob = i0 * p.bs[0] + i1 * p.bs[1] + i2 * p.bs[2] + i3 * p.bs[3];
  if (p.tab_n == 0) {
    EC_UNROLL
    for (int k = 0; k < NK; ++k) o.x[k] = A[o.oa + k * p.ak];
  }
  EC_UNROLL
  for (int k = 0; k < NK; ++k) o.y[k] = B[o.ob + k * p.bk];
}

// stage 2: A's values from the table's copy tab where it is staged, then
// ec_product's sum
template <typename T, int NK>
EC_HD T ec_product_sum(EcProductOps<T, NK>& o, const T* tab, const EcProduct32& p) {
  if (p.tab_n > 0) {
    EC_UNROLL
    for (int k = 0; k < NK; ++k) o.x[k] = tab[o.oa + k * p.ak];
  }
  return ec_dot(o.x, 1, [&](int k) { return o.y[k]; }, NK);
}

// The values-and-gradients pair of one coefficient: with phi (nq, nb), gp
// (nc, nq, nb, ng) and d2 (nc, nb, bs) at their strides, the two products
// val[c, q, k] = sum_b phi[q, b] d2[c, b, k] ("qb,cbk->cqk") and
// grad[c, q, k, g] = sum_b gp[c, q, b, g] d2[c, b, k] ("cqbg,cbk->cqkg"),
// each output its own sum in ec_product's order.  A block of
// kEcPairThreads takes a group of G cells: the group's d2 is read once
// into shared memory, then a thread an output, its flat index in the
// group's values (threads [0, G nq bs)) or gradients (from G nq bs on).
constexpr int kEcPairThreads = 128;

struct EcPair {
  EcDiv bs, v, vg, nbbs;  // bs, a cell's values nq bs and gradients nq bs ng, nb bs
  int ps[2], gs[4], ds[3];
  long long nc;
  int G, tab_n;
};

// whether the pair runs staged (nb one of kEcProductNK, ng == kEcPairNG,
// a cell's outputs within a block, every offset below 2^31, phi within
// kEcTableMax), and then its staged form in q
inline bool ec_pair_staged_form(long long nc, long long nq, long long nb, long long bs,
                                long long ng, const long long* ps, const long long* gs,
                                const long long* ds, EcPair& q) {
  const long long np[2] = {nq, nb}, ng4[4] = {nc, nq, nb, ng}, nd[3] = {nc, nb, bs};
  const long long out[4] = {nc, nq, bs, ng};
  const long long rp = ec_reach(np, ps, 2), rg = ec_reach(ng4, gs, 4), rd = ec_reach(nd, ds, 3);
  if (!ec_product_nk(nb) || ng != kEcPairNG || ec_count(out, 4) < 0 || nq < 1 || bs < 1 ||
      nq * bs * (1 + ng) > kEcPairThreads || rp < 0 || rp >= kEcTableMax || rg < 0 || rd < 0) {
    return false;
  }
  const int v = static_cast<int>(nq * bs);
  q.bs = ec_divisor(static_cast<int>(bs));
  q.v = ec_divisor(v);
  q.vg = ec_divisor(v * kEcPairNG);
  q.nbbs = ec_divisor(static_cast<int>(nb * bs));
  for (int d = 0; d < 2; ++d) q.ps[d] = static_cast<int>(ps[d]);
  for (int d = 0; d < 4; ++d) q.gs[d] = static_cast<int>(gs[d]);
  for (int d = 0; d < 3; ++d) q.ds[d] = static_cast<int>(ds[d]);
  q.nc = nc;
  q.G = kEcPairThreads / (v * (1 + kEcPairNG));
  q.tab_n = static_cast<int>(rp + 1);
  return true;
}

// stage 1: entry i of the group's d2 (g nb bs + b bs + k for its cell g)
template <typename T>
EC_HD T ec_pair_d2(const T* d2, const EcPair& p, long long c0, int i) {
  int r, k;
  const int g = ec_divmod(p.nbbs, i, r);
  const int b = ec_divmod(p.bs, r, k);
  return d2[(c0 + g) * p.ds[0] + (b * p.ds[1] + k * p.ds[2])];
}

// A thread's output in the group of cells from c0: where it lies (val
// or grad) and its point, component and gradient entry; the gradients'
// row of gp loaded up front
template <typename T, int NB>
struct EcPairOut {
  T* dst;
  int cell, q, k, j;  // j = -1: a value
  T g[NB];
};

// loads thread tid's operands (gp's row for a gradient); false where the
// thread has no output in the group of `cells` cells
template <typename T, int NB>
EC_HD bool ec_pair_load(EcPairOut<T, NB>& o, const T* gp, T* val, T* grad, const EcPair& p,
                        long long c0, int cells, int tid) {
  const int V = p.v.d, gv = p.G * V;
  int r;
  if (tid < gv) {
    if (tid >= cells * V) return false;
    o.cell = ec_divmod(p.v, tid, r);
    o.j = -1;
    o.dst = val + (c0 * V + tid);
  } else {
    const int u = tid - gv;
    if (u >= cells * V * kEcPairNG) return false;
    o.cell = ec_divmod(p.vg, u, r);
    o.j = r % kEcPairNG;
    r /= kEcPairNG;
    o.dst = grad + (c0 * V * kEcPairNG + u);
  }
  o.q = ec_divmod(p.bs, r, o.k);
  if (o.j >= 0) {
    const T* row = gp + ((c0 + o.cell) * p.gs[0] + (o.q * p.gs[1] + o.j * p.gs[3]));
    EC_UNROLL
    for (int b = 0; b < NB; ++b) o.g[b] = row[b * p.gs[2]];
  }
  return true;
}

// stage 2: the output from the group's d2 (dg: its cell's nb bs entries)
// and phi (the table's copy)
template <typename T, int NB>
EC_HD T ec_pair_out(const EcPairOut<T, NB>& o, const T* phi, const T* dg, const EcPair& p) {
  const int bs = p.bs.d;
  const T* dk = dg + o.k;
  if (o.j >= 0) return ec_dot(o.g, 1, [&](int b) { return dk[b * bs]; }, NB);
  return ec_dot(phi + o.q * p.ps[0], p.ps[1], [&](int b) { return dk[b * bs]; }, NB);
}

// the level-1 triple staged: whether W (nc, nk, na) and K (nc, nk, nk)
// at strides ws, ks are the staged shape (contiguous, nk = kEcTripleNK,
// na = kEcTripleNA, every offset below 2^31)
inline bool ec_triple_staged(long long nc, long long nk, long long na, const long long* ws,
                             const long long* ks) {
  constexpr long long NK = kEcTripleNK, NA = kEcTripleNA;
  return nk == NK && na == NA && nc >= 0 && nc < kEcIntMax / (NK * NK) &&
         (nc <= 1 || (ws[0] == NK * NA && ks[0] == NK * NK)) && ws[1] == NA && ws[2] == 1 &&
         ks[1] == NK && ks[2] == 1;
}

// stage 1: T[a, j] = sum_i W[i, a] K[i, j] of a cell's W (nk, na) and K
// (nk, nk) in shared memory, r = a nk + j: the first product's sum
template <typename T>
EC_HD T ec_triple_t(const T* w, const T* k, int r) {
  const int a = r / kEcTripleNK, j = r % kEcTripleNK;
  return ec_dot(w + a, kEcTripleNA, [&](int i) { return k[i * kEcTripleNK + j]; }, kEcTripleNK);
}

// stage 2: out[a, b] = sum_j T[a, j] W[j, b] of the cell's T (na, nk)
// rounded to T, as the first product stores it, r = a na + b
template <typename T>
EC_HD T ec_triple_out(const T* t, const T* w, int r) {
  const int a = r / kEcTripleNA, b = r % kEcTripleNA;
  return ec_dot(t + a * kEcTripleNK, 1, [&](int j) { return w[j * kEcTripleNA + b]; },
                kEcTripleNK);
}
