// Mohr-Coulomb return map with consistent tangent for one Gauss point.
//
// The arithmetic shared by the CUDA kernel (mohr_coulomb.cu) and the CPU
// build (mohr_coulomb_host.cpp) that the tests hold against the plain
// PyTorch version (models/mohr_coulomb.py::MohrCoulombMaterial.
// tangent_stress).  It is the algorithm of the JAX package's
// models/mohr_coulomb.py:224-361 with the surface of ops/abbo_sloan.py:
// 118-161, operation for operation and in the same order:
//
//   1. trial stress sig_tr = sig_n + C deps and the f64 test f(sig_tr) > 0;
//   2. f32 damped Newton on r(sig, dlambda) from the trial state: Jacobian
//      in closed form, 6 candidate steps, the first that lowers |r| (else
//      the shortest), stagnation exit, cap max_iter32;
//   3. f64 polish from the f32 iterate (elastic lanes: from the exact f64
//      trial state), 3 candidate steps, to |r| <= tol * scale, cap 60;
//   4. tangent dy*/deps = J(y*)^-1 [C; 0], one 5x5 solve per column.
//
// Each point runs its own loops to its own exit, as each lane of the JAX
// package's vmap(while_loop) does.
//
// The work of one Newton iteration is split into roles that a group of
// kRoles workers shares (the Group types below):
//   - the Jacobian: role k < 4 evaluates terms() of the potential on a value
//     with one tangent along sigma's axis k, giving grad g and column k of
//     I + dlambda C Hg; with non-associative flow, role 4 evaluates grad f;
//   - the 5x5 solve: every worker, redundantly (it needs no exchange);
//   - the line search: role a evaluates candidate a;
//   - the tangent: role b < 4 solves for column b of [C; 0].
// A role writes only its own slot and reads only values that every worker
// holds, so the roles may run in any order or at once.  On the card the
// group is a tile of 8 threads that exchange by shuffles and ballots
// (mohr_coulomb.cu); in the CPU build SerialGroup runs the roles one after
// another and exchanges through arrays.
//
// Where trouble lies, and what this file does about it:
// - Silent promotion to double in the f32 phase.  Every literal in a
//   template body is written T(...), and the material constants arrive in
//   Consts<float>, rounded once on the host: the JAX package's Python
//   floats are weak-typed and round to f32 the same way.  Constants the JAX
//   package folds in Python (sin_a / 3.0, -1.0 + eps_clip, 1.0 - 1e-3) are
//   folded in double on the host before that rounding.
// - The Hessian of the potential.  terms() is written once, generic over
//   its scalar type S, and evaluated on Dual1<T> (a value and one tangent)
//   to give g, grad g and one column of Hg = d(grad g)/d sig in one pass,
//   with the tangent rules of jax.jvp: no tangent through the f32 seed of
//   the f64 trig (stop_gradient), selects select tangents, max/min pass the
//   tangent of the larger/smaller operand and half of each at a tie
//   (jnp.clip, jnp.maximum).  The value part does not depend on the
//   tangent, so every role computes the same grad g.
// - The one-hot pick of the line search.  The JAX package picks the
//   candidate with a one-hot dot product, so a component that is not finite
//   in any other candidate (0 * inf) makes that component of the pick NaN.
//   newton() gathers a mask of such candidates per component and does the
//   same.
// - Elastic lanes.  Their Jacobian is I (the JAX package's and the plain
//   version's I + 0 * C Hg, for a finite Hg), so no Hessian is evaluated,
//   and the tangent J^-1 [C; 0] is C itself: solve_small of I against C
//   returns C bit for bit.
// - The f32 phase's rounding on the card.  Its iterate is the start of the
//   f64 polish, and a polish that stops on the other side of its tol
//   leaves the tangent up to ~2e-6 from the plain map's where every lane is
//   plastic.  Two things moved that iterate: nvcc fuses a multiply and the
//   add that takes its result into one FMA, rounded once, where the plain
//   versions round each operation; and torch on the card (like XLA) takes
//   I1 / 3 as I1 * (1/3).  So every product of the templates below is
//   mul(), which on the card is __fmul_rn for f32 (nvcc never fuses it into
//   an FMA) and a plain * for f64, whose polish keeps nvcc's FMAs; and the
//   f32 phase takes I1 * (1/3) on the card (terms()).  Built instead with
//   -fmad=false over the whole kernel, K1 gives the same gaps to the plain
//   map and is 2.4% slower at 3,750 points of the slope's step 50, 10% at
//   65,536 (in turns on an NVIDIA H100 80GB HBM3 at 700 W,
//   tools/k1_compare.py).
// - Trig.  The f32 phase uses the C library's (host) or CUDA's (device)
//   asinf, sinf, cosf; the plain versions use PyTorch's and XLA's.  These
//   differ in the last bits; the f64 polish absorbs it, but a lane that
//   ends near a tolerance or stagnation threshold may differ in its
//   iteration count.
//
// Layout is structure-of-arrays with the point axis contiguous:
//   deps, sig_n (4, n) f64 -> C (16, n) f64 (row-major 4x4), sig (4, n),
//   niter (n,) int32, yielding, norm_res, dlambda (n,) f64.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define MC_HD __host__ __device__ __forceinline__
#else
#define MC_HD inline
#endif

namespace mc {

// ---------------------------------------------------------------------------
// constants
// ---------------------------------------------------------------------------

// Packed f64 constants from models/mohr_coulomb.py::kernel_params.
constexpr int kSurfaceKeys = 9;  // sin_a, c_cos_a, asa2, Ap, Bp, Cp, Am, Bm, Cm
constexpr int kOffF = 16;
constexpr int kOffG = kOffF + kSurfaceKeys;
constexpr int kOffShared = kOffG + kSurfaceKeys;  // inv_sqrt3, c0, sinT, sin3T
constexpr int kOffTol = kOffShared + 4;  // tol, tol32, max_iter32, n_polish_max, assoc
constexpr int kParams = kOffTol + 5;

// Workers of a group: 6 candidates of the f32 line search, rounded up.
constexpr int kRoles = 8;

template <typename T>
struct Surface {
  T sin_a, sin_a_3, c_cos_a, asa2, Ap, Bp, Cp, Am, Bm, Cm;
};

// The constants of one precision phase, rounded to T on the host.
template <typename T>
struct Consts {
  T C[16];
  Surface<T> f, g;
  T inv_sqrt3, c0, sinT, sin3T;
  T lo, hi, q_floor;  // clip range of sin(3 theta) and the floor of Q
  T stall;            // a step that keeps |r| above stall * |r| has stalled
  T tol;
  int max_it;
  int assoc;  // f and g are the same surface: evaluate it once
};

struct Params {
  Consts<float> c32;
  Consts<double> c64;
};

template <typename T>
inline Surface<T> make_surface(const double* p) {
  Surface<T> s;
  s.sin_a = T(p[0]);
  s.sin_a_3 = T(p[0] / 3.0);
  s.c_cos_a = T(p[1]);
  s.asa2 = T(p[2]);
  s.Ap = T(p[3]);
  s.Bp = T(p[4]);
  s.Cp = T(p[5]);
  s.Am = T(p[6]);
  s.Bm = T(p[7]);
  s.Cm = T(p[8]);
  return s;
}

template <typename T>
inline Consts<T> make_consts(const double* p, double eps_clip, double q_floor, double tol,
                             int max_it) {
  Consts<T> k;
  for (int i = 0; i < 16; ++i) k.C[i] = T(p[i]);
  k.f = make_surface<T>(p + kOffF);
  k.g = make_surface<T>(p + kOffG);
  k.inv_sqrt3 = T(p[kOffShared]);
  k.c0 = T(p[kOffShared + 1]);
  k.sinT = T(p[kOffShared + 2]);
  k.sin3T = T(p[kOffShared + 3]);
  k.lo = T(-1.0 + eps_clip);
  k.hi = T(1.0 - eps_clip);
  k.q_floor = T(q_floor);
  k.stall = T(1.0 - 1e-3);
  k.tol = T(tol);
  k.max_it = max_it;
  k.assoc = p[kOffTol + 4] != 0.0;
  return k;
}

// Host side: the packed constants -> both phases' constants.
inline Params make_params(const double* p) {
  Params P;
  P.c32 = make_consts<float>(p, 1e-6, 1e-20, p[kOffTol + 1], static_cast<int>(p[kOffTol + 2]));
  P.c64 = make_consts<double>(p, 1e-12, 1e-30, p[kOffTol], static_cast<int>(p[kOffTol + 3]));
  return P;
}

// ---------------------------------------------------------------------------
// scalar helpers, overloaded for float and double
// ---------------------------------------------------------------------------

MC_HD float m_sqrt(float x) { return sqrtf(x); }
MC_HD double m_sqrt(double x) { return sqrt(x); }
MC_HD float m_abs(float x) { return fabsf(x); }
MC_HD double m_abs(double x) { return fabs(x); }
MC_HD float m_asin(float x) { return asinf(x); }
MC_HD double m_asin(double x) { return asin(x); }
MC_HD float m_sin(float x) { return sinf(x); }
MC_HD double m_sin(double x) { return sin(x); }
MC_HD float m_cos(float x) { return cosf(x); }
MC_HD double m_cos(double x) { return cos(x); }
MC_HD bool m_finite(float x) { return m_abs(x) <= 3.402823466e+38F; }
MC_HD bool m_finite(double x) { return m_abs(x) <= 1.7976931348623157e+308; }
template <typename T>
MC_HD T m_nan() {
  return static_cast<T>(NAN);
}

// a * b.  On the card an f32 product is __fmul_rn, rounded on its own: nvcc
// fuses a plain * with the add that takes its result into one FMA, and
// never this one.  f64 products (and every product of the g++ build, which
// does not contract) are a plain *.
MC_HD float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
MC_HD double mul(double a, double b) { return a * b; }

// index of the lowest set bit of m != 0
MC_HD int lowest_bit(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// v[a] for a runtime a, by selects (no indexed array on the card)
template <typename T, int N>
MC_HD T pick(const T (&v)[N], int a) {
  T r = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = a == j ? v[j] : r;
  return r;
}

// ---------------------------------------------------------------------------
// forward-mode dual numbers: a value and its tangent along one direction
// ---------------------------------------------------------------------------

template <typename T>
struct Dual1 {
  T v;
  T d;
};

template <typename T>
MC_HD Dual1<T> lift(T c) {  // a constant: zero tangent
  return {c, T(0)};
}

template <typename T>
MC_HD T val(T x) {
  return x;
}
template <typename T>
MC_HD T val(const Dual1<T>& x) {
  return x.v;
}

// JAX's jvp rules: d(a*b) = da*b + a*db; d(a/b) = da/b + (-db*a)/(b*b)
template <typename T>
MC_HD Dual1<T> operator+(const Dual1<T>& a, const Dual1<T>& b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
MC_HD Dual1<T> operator-(const Dual1<T>& a, const Dual1<T>& b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
MC_HD Dual1<T> operator-(const Dual1<T>& a) {
  return {-a.v, -a.d};
}
template <typename T>
MC_HD Dual1<T> operator*(const Dual1<T>& a, const Dual1<T>& b) {
  return {mul(a.v, b.v), mul(a.d, b.v) + mul(a.v, b.d)};
}
template <typename T>
MC_HD Dual1<T> operator/(const Dual1<T>& a, const Dual1<T>& b) {
  const T inv_b2 = T(1) / mul(b.v, b.v);
  return {a.v / b.v, a.d / b.v + mul(mul(-b.d, a.v), inv_b2)};
}
template <typename T>
MC_HD Dual1<T> operator+(const Dual1<T>& a, T c) {
  return {a.v + c, a.d};
}
template <typename T>
MC_HD Dual1<T> operator+(T c, const Dual1<T>& a) {
  return {c + a.v, a.d};
}
template <typename T>
MC_HD Dual1<T> operator-(const Dual1<T>& a, T c) {
  return {a.v - c, a.d};
}
template <typename T>
MC_HD Dual1<T> operator-(T c, const Dual1<T>& a) {
  return {c - a.v, -a.d};
}
template <typename T>
MC_HD Dual1<T> operator*(const Dual1<T>& a, T c) {
  return {mul(a.v, c), mul(a.d, c)};
}
template <typename T>
MC_HD Dual1<T> operator*(T c, const Dual1<T>& a) {
  return {mul(c, a.v), mul(c, a.d)};
}
template <typename T>
MC_HD Dual1<T> operator/(const Dual1<T>& a, T c) {
  return {a.v / c, a.d / c};
}
template <typename T>
MC_HD Dual1<T> operator/(T c, const Dual1<T>& b) {
  const T inv_b2 = T(1) / mul(b.v, b.v);
  return {c / b.v, mul(mul(-b.d, c), inv_b2)};
}

// mul() on duals: the operators above, which take mul() of the values
template <typename T>
MC_HD Dual1<T> mul(const Dual1<T>& a, const Dual1<T>& b) {
  return a * b;
}
template <typename T>
MC_HD Dual1<T> mul(const Dual1<T>& a, T c) {
  return a * c;
}
template <typename T>
MC_HD Dual1<T> mul(T c, const Dual1<T>& a) {
  return c * a;
}

template <typename T>
MC_HD Dual1<T> m_sqrt(const Dual1<T>& a) {  // d sqrt = da * (0.5 / sqrt(a))
  const T r = m_sqrt(a.v);
  return {r, mul(a.d, T(0.5) / r)};
}
template <typename T>
MC_HD Dual1<T> m_asin(const Dual1<T>& a) {  // d asin = da / sqrt(1 - a^2)
  return {m_asin(a.v), mul(a.d, T(1) / m_sqrt(T(1) - mul(a.v, a.v)))};
}
template <typename T>
MC_HD Dual1<T> m_sin(const Dual1<T>& a) {
  return {m_sin(a.v), mul(a.d, m_cos(a.v))};
}
template <typename T>
MC_HD Dual1<T> m_cos(const Dual1<T>& a) {
  return {m_cos(a.v), -mul(a.d, m_sin(a.v))};
}

// select, and max/min against a constant as lax.max/lax.min: NaN in, NaN
// out; the tangent passes where x wins, half of it at a tie
template <typename T>
MC_HD T select(bool c, T a, T b) {
  return c ? a : b;
}
template <typename T>
MC_HD Dual1<T> select(bool c, const Dual1<T>& a, const Dual1<T>& b) {
  return c ? a : b;
}
template <typename T>
MC_HD T max_c(T x, T c) {
  return x < c ? c : x;
}
template <typename T>
MC_HD T min_c(T x, T c) {
  return x > c ? c : x;
}
template <typename T>
MC_HD Dual1<T> max_c(const Dual1<T>& x, T c) {
  const T w = x.v > c ? T(1) : (x.v == c ? T(0.5) : T(0));
  return {x.v < c ? c : x.v, mul(x.d, w)};
}
template <typename T>
MC_HD Dual1<T> min_c(const Dual1<T>& x, T c) {
  const T w = x.v < c ? T(1) : (x.v == c ? T(0.5) : T(0));
  return {x.v > c ? c : x.v, mul(x.d, w)};
}

template <typename S>
MC_HD S zero_like(S) {
  return S(0);
}
template <typename T>
MC_HD Dual1<T> zero_like(const Dual1<T>&) {
  return lift(T(0));
}

// ---------------------------------------------------------------------------
// the smoothed surface: value and gradient, shared trig (abbo_sloan.py)
// ---------------------------------------------------------------------------

// sin(theta) and cos(theta) with theta = asin(x) / 3
template <typename T, typename S>
MC_HD void sincos_third(const S& x, const Consts<T>& k, S& st, S& ct) {
  if constexpr (sizeof(T) == sizeof(double)) {
    // f32 seed with no tangent, clamped to the inner-branch range, then two
    // f64 triple-angle Newton steps: s <- s - (3s - 4s^3 - x) / (3 - 12 s^2)
    const float x32 = static_cast<float>(val(x));
    const float s32 = sinf(mul(asinf(x32), 1.0f / 3.0f));
    const T s0 = min_c(max_c(static_cast<T>(s32), -k.sinT), k.sinT);
    S s = zero_like(x) + s0;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      s = s - (mul(T(3), s) - mul(mul(mul(T(4), s), s), s) - x) / (T(3) - mul(mul(T(12), s), s));
    }
    st = s;
    ct = m_sqrt(T(1) - mul(st, st));
  } else {
    const S theta = mul(m_asin(x), T(1.0 / 3.0));
    st = m_sin(theta);
    ct = m_cos(theta);
  }
}

// DEV @ v with DEV's entries rounded to T (the products by 0 left out)
template <typename T, typename S>
MC_HD void dev4(const S v[4], S out[4]) {
  const T d23 = T(2.0 / 3.0), d13 = T(-1.0 / 3.0);
  out[0] = mul(d23, v[0]) + mul(d13, v[1]) + mul(d13, v[2]);
  out[1] = mul(d13, v[0]) + mul(d23, v[1]) + mul(d13, v[2]);
  out[2] = mul(d13, v[0]) + mul(d13, v[1]) + mul(d23, v[2]);
  out[3] = v[3];
}

// f(sig) and grad f(sig) (abbo_sloan.py:118-161)
template <typename T, typename S>
MC_HD void terms(const S sig[4], const Surface<T>& p, const Consts<T>& k, S& f, S df[4]) {
  S s[4];
  dev4<T>(sig, s);
  const S I1 = sig[0] + sig[1] + sig[2];
  const S J2 = mul(T(0.5), mul(s[0], s[0]) + mul(s[1], s[1]) + mul(s[2], s[2]) + mul(s[3], s[3]));
  const bool safe = val(J2) > T(0);
  const S J2s = select(safe, J2, zero_like(J2) + T(1));
  const S J3 = mul(s[2], mul(s[0], s[1]) - mul(s[3], s[3]) / T(2));
  const S sqJ2 = m_sqrt(J2s);
  const S invJ2_32 = T(1) / mul(J2s, sqJ2);
  const S arg_raw = select(safe, mul(mul(-k.c0, J3), invJ2_32), zero_like(J2));
  const S x = min_c(max_c(arg_raw, k.lo), k.hi);  // == sin(3 theta)

  S st, ct;
  sincos_third<T>(x, k, st, ct);
  const S c3t = m_sqrt(T(1) - mul(x, x));  // cos(3 theta)

  const bool pos = val(x) >= T(0);
  const T Ac = pos ? p.Ap : p.Am;
  const T Bc = pos ? p.Bp : p.Bm;
  const T Cc = pos ? p.Cp : p.Cm;

  const S K_in = ct - mul(mul(p.sin_a, st), k.inv_sqrt3);
  const S K_out = Ac + mul(Bc + mul(Cc, x), x);
  const S dKin_dx = (-st - mul(mul(p.sin_a, ct), k.inv_sqrt3)) / mul(T(3), c3t);
  const S dKout_dx = Bc + mul(mul(T(2), Cc), x);
  const bool outer = m_abs(val(x)) > k.sin3T;
  const S K = select(outer, K_out, K_in);
  const S dK_dx = select(outer, dKout_dx, dKin_dx);

  const S Q = m_sqrt(mul(mul(J2, K), K) + p.asa2);
  // I1 / 3 in the f32 phase as the plain version computes it on each side:
  // on the card torch folds a division by a constant into a product by its
  // reciprocal, as XLA does (the JAX package's own arithmetic); torch on
  // the CPU divides.  It moves f by an f32 ulp, and so where the f32
  // Newton stops on some lanes; the f64 polish absorbs its own rounding
#ifdef __CUDA_ARCH__
  constexpr bool kReciprocal = sizeof(T) == sizeof(float);
#else
  constexpr bool kReciprocal = false;
#endif
  const S I1_3 = kReciprocal ? mul(I1, T(1.0 / 3.0)) : I1 / T(3);
  f = mul(I1_3, p.sin_a) + Q - p.c_cos_a;

  S dJ3_ds[4], dJ3[4];
  dJ3_ds[0] = mul(s[1], s[2]);
  dJ3_ds[1] = mul(s[0], s[2]);
  dJ3_ds[2] = mul(s[0], s[1]) - mul(s[3], s[3]) / T(2);
  dJ3_ds[3] = mul(-s[2], s[3]);
  dev4<T>(dJ3_ds, dJ3);
  const bool unclipped = safe && m_abs(val(arg_raw)) < k.hi;
  const S ratio = mul(T(1.5), J3 / J2s);
  const S Qs = max_c(Q, k.q_floor);
  const S coef = mul(mul(mul(T(2), J2), K), dK_dx);
  const S KK = mul(K, K);
  const S den = mul(T(2), Qs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const S darg = mul(mul(-k.c0, dJ3[i] - mul(ratio, s[i])), invJ2_32);
    const S dx = select(unclipped, darg, zero_like(darg));
    const S frac = (mul(KK, s[i]) + mul(coef, dx)) / den;
    df[i] = i < 3 ? p.sin_a_3 + frac : frac;
  }
}

// ---------------------------------------------------------------------------
// residual, small solve
// ---------------------------------------------------------------------------

// C @ v over 4 entries, summed in column order
template <typename T>
MC_HD T row_dot(const T* Crow, const T v[4]) {
  return mul(Crow[0], v[0]) + mul(Crow[1], v[1]) + mul(Crow[2], v[2]) + mul(Crow[3], v[3]);
}

// r(y), y = (sig, dlambda) (mohr_coulomb.py:184-191)
template <typename T>
MC_HD void residual(const T y[5], const T d[4], const T sn[4], bool plastic, const Consts<T>& k,
                    T r[5]) {
  T g, dg[4], ff = T(0);
  terms<T, T>(y, k.g, k, g, dg);
  if (k.assoc) {
    ff = g;
  } else {
    T df[4];
    terms<T, T>(y, k.f, k, ff, df);
  }
  const T dlp = plastic ? y[4] : T(0);
  T v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = d[j] - mul(dlp, dg[j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = y[i] - sn[i] - row_dot(k.C + 4 * i, v);
  r[4] = plastic ? ff : y[4];
}

// A x = B for one 5x5 system and M right-hand sides: unrolled elimination
// with pairwise max-bubbling pivoting (mohr_coulomb.py:59-102).  Columns of
// B are independent: M = 1 on column j gives column j of M = 4 bit for bit.
template <typename T, int M>
MC_HD void solve_small(const T A[5][5], const T B[5][M], T X[5][M]) {
  constexpr int N = 5;
  T R[N][N + M];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) R[i][j] = A[i][j];
#pragma unroll
    for (int j = 0; j < M; ++j) R[i][N + j] = B[i][j];
  }
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
#pragma unroll
    for (int i = kk + 1; i < N; ++i) {
      const bool swap = m_abs(R[i][kk]) > m_abs(R[kk][kk]);
#pragma unroll
      for (int j = kk; j < N + M; ++j) {
        const T rk = R[kk][j], ri = R[i][j];
        R[kk][j] = swap ? ri : rk;
        R[i][j] = swap ? rk : ri;
      }
    }
    const T inv_piv = T(1) / R[kk][kk];
#pragma unroll
    for (int i = kk + 1; i < N; ++i) {
      const T f = mul(R[i][kk], inv_piv);
#pragma unroll
      for (int j = kk + 1; j < N + M; ++j) R[i][j] = R[i][j] - mul(f, R[kk][j]);
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const T inv_d = T(1) / R[i][i];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = R[i][N + j];
#pragma unroll
      for (int kk = i + 1; kk < N; ++kk) acc = acc - mul(R[i][kk], X[kk][j]);
      X[i][j] = mul(acc, inv_d);
    }
  }
}

template <typename T>
MC_HD T norm5(const T r[5]) {
  return m_sqrt(mul(r[0], r[0]) + mul(r[1], r[1]) + mul(r[2], r[2]) + mul(r[3], r[3]) +
                mul(r[4], r[4]));
}

// ---------------------------------------------------------------------------
// the roles
// ---------------------------------------------------------------------------

template <typename T>
MC_HD Surface<T> pick_surface(bool first, const Surface<T>& a, const Surface<T>& b) {
  Surface<T> s;
  s.sin_a = first ? a.sin_a : b.sin_a;
  s.sin_a_3 = first ? a.sin_a_3 : b.sin_a_3;
  s.c_cos_a = first ? a.c_cos_a : b.c_cos_a;
  s.asa2 = first ? a.asa2 : b.asa2;
  s.Ap = first ? a.Ap : b.Ap;
  s.Bp = first ? a.Bp : b.Bp;
  s.Cp = first ? a.Cp : b.Cp;
  s.Am = first ? a.Am : b.Am;
  s.Bm = first ? a.Bm : b.Bm;
  s.Cm = first ? a.Cm : b.Cm;
  return s;
}

// Jacobian role r of a plastic point (mohr_coulomb.py:193-214): for r < 4,
// column r of I + dlambda C Hg and the potential's gradient; role 4 gives
// the yield surface's gradient in grad (its column is unused).
template <typename T>
MC_HD void hg_column(const T y[5], int r, const Consts<T>& k, T col[4], T grad[4]) {
  const Surface<T> s = pick_surface(r == 4, k.f, k.g);
  Dual1<T> sd[4], val_d, dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sd[i] = {y[i], i == r ? T(1) : T(0)};
  terms<T, Dual1<T>>(sd, s, k, val_d, dd);
  T h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    grad[i] = dd[i].v;
    h[i] = dd[i].d;  // Hg[i][r]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) col[i] = (i == r ? T(1) : T(0)) + mul(y[4], row_dot(k.C + 4 * i, h));
}

// Line-search role a: the candidate y + alpha_a dy, its residual and |r|
// (out: y (5), r (5), |r|).
template <typename T, int NA>
MC_HD void candidate(const T y[5], const T dy[5][1], const T (&alphas)[NA], int a, const T d[4],
                     const T sn[4], bool plastic, const Consts<T>& k, T out[11]) {
  const T al = pick(alphas, a);
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i] = y[i] + mul(al, dy[i][0]);
  residual(out, d, sn, plastic, k, out + 5);
  out[10] = norm5(out + 5);
}

// Tangent role b: column b of J^-1 [C; 0] (mohr_coulomb.py:344-361).
template <typename T>
MC_HD void tangent_column(const T J[5][5], int b, const Consts<T>& k, T x[5]) {
  T B[5][1], X[5][1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const T row[4] = {k.C[4 * a], k.C[4 * a + 1], k.C[4 * a + 2], k.C[4 * a + 3]};
    B[a][0] = pick(row, b);
  }
  B[4][0] = T(0);
  solve_small<T, 1>(J, B, X);
#pragma unroll
  for (int a = 0; a < 5; ++a) x[a] = X[a][0];
}

// ---------------------------------------------------------------------------
// the group: workers that share a point's roles
// ---------------------------------------------------------------------------
//
// A group G provides
//   Slots<T, W>           W values per role; at(r) -> role r's values;
//   compute(count, f)     f(r) for every role r < count; f writes only
//                         slot r (on the card, a worker past count repeats
//                         the last role, so that the tile never diverges);
//   store(count, f)       f(r) for r < count only (f writes memory);
//   ballot(count, pred)   bit r set where pred(r), for r < count;
//   from(s, src, i)       value i of role src's slot, on every worker.

// The roles one after another, in order or in reverse order, exchanging
// through arrays.
template <bool Reverse>
struct SerialGroup {
  template <typename T, int W>
  struct Slots {
    T v[kRoles][W];
    MC_HD T* at(int r) { return v[r]; }
  };
  template <typename F>
  MC_HD void compute(int count, F&& f) {
    for (int j = 0; j < count; ++j) f(Reverse ? count - 1 - j : j);
  }
  template <typename F>
  MC_HD void store(int count, F&& f) {
    compute(count, f);
  }
  template <typename F>
  MC_HD unsigned ballot(int count, F&& pred) {
    unsigned m = 0u;
    for (int j = 0; j < count; ++j) {
      const int r = Reverse ? count - 1 - j : j;
      m |= pred(r) ? 1u << r : 0u;
    }
    return m;
  }
  template <typename T, int W>
  MC_HD T from(Slots<T, W>& s, int src, int i) {
    return s.v[src][i];
  }
};

// J(y) of a plastic point: [[I + dl C Hg, C grad g], [grad f^T, 0]]
template <typename T, typename G>
MC_HD void jacobian(G& g, const T y[5], const Consts<T>& k, T J[5][5]) {
  typename G::template Slots<T, 8> s;  // column (4), gradient (4)
  g.compute(k.assoc ? 4 : 5, [&](int r) { hg_column(y, r, k, s.at(r), s.at(r) + 4); });
  T dg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dg[i] = g.from(s, 0, 4 + i);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) J[i][j] = g.from(s, j, i);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    J[i][4] = row_dot(k.C + 4 * i, dg);
    J[4][i] = k.assoc ? dg[i] : g.from(s, 4, 4 + i);
  }
  J[4][4] = T(0);
}

// Damped Newton to |r| <= tol * scale, k.max_it steps or a stalled step
// (mohr_coulomb.py:255-295 and :305-338).  y, res and norm are updated in
// place; returns the number of steps.  Every branch depends only on values
// that every worker of the group holds.
template <bool Plastic, typename T, int NA, typename G>
MC_HD int newton(G& g, T y[5], T res[5], T& norm, const T (&alphas)[NA], T scale, const T d[4],
                 const T sn[4], const Consts<T>& k) {
  int it = 0;
  bool stalled = false;
  while (!stalled && norm / scale > k.tol && it < k.max_it) {
    T J[5][5], B[5][1], dy[5][1];
    if constexpr (Plastic) {
      jacobian(g, y, k, J);
    } else {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 5; ++j) J[i][j] = i == j ? T(1) : T(0);
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) B[i][0] = -res[i];
    solve_small<T, 1>(J, B, dy);
    // candidates side by side; keep the first that lowers |r|, else the last
    typename G::template Slots<T, 11> c;
    g.compute(NA, [&](int a) { candidate(y, dy, alphas, a, d, sn, Plastic, k, c.at(a)); });
    const T old = norm;
    const unsigned improving = g.ballot(NA, [&](int a) { return c.at(a)[10] < old; });
    const int sel = improving != 0u ? lowest_bit(improving) : NA - 1;
    T v[11];
#pragma unroll
    for (int i = 0; i < 11; ++i) v[i] = g.from(c, sel, i);
    // the one-hot pick: 0 * (inf or NaN) of another candidate is NaN; one
    // ballot finds whether any candidate holds such a value
    const unsigned others = ~(1u << sel);
    const unsigned any_bad = g.ballot(NA, [&](int a) {
      bool bad = false;
#pragma unroll
      for (int i = 0; i < 11; ++i) bad = bad | !m_finite(c.at(a)[i]);
      return bad;
    });
    if ((any_bad & others) != 0u) {
#pragma unroll
      for (int i = 0; i < 11; ++i) {
        const unsigned bad = g.ballot(NA, [&](int a) { return !m_finite(c.at(a)[i]); });
        if ((bad & others) != 0u) v[i] = m_nan<T>();
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      y[i] = v[i];
      res[i] = v[5 + i];
    }
    norm = v[10];
    stalled = norm >= mul(old, k.stall);
    ++it;
  }
  return it;
}

// ---------------------------------------------------------------------------
// one Gauss point
// ---------------------------------------------------------------------------

struct Trial {
  double d[4], sn[4], Cd[4], sig_tr[4];
  double f_tr;    // f(sig_tr); the point is plastic where f_tr > 0
  double scale0;  // convergence scale: |C deps| and the trial yield value
};

MC_HD Trial load_trial(const double* __restrict__ deps, const double* __restrict__ sig_n,
                       long long i, long long n, const Consts<double>& k) {
  Trial t;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t.d[j] = deps[j * n + i];
    t.sn[j] = sig_n[j * n + i];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t.Cd[j] = row_dot(k.C + 4 * j, t.d);
    t.sig_tr[j] = t.sn[j] + t.Cd[j];
  }
  return t;
}

MC_HD double trial_yield(const Trial& t, const Consts<double>& k) {
  double f, df[4];
  terms<double, double>(t.sig_tr, k.f, k, f, df);
  return f;
}

MC_HD void set_yield(Trial& t, double f_tr) {
  t.f_tr = f_tr;
  const double f_pl = f_tr > 0.0 ? f_tr : 0.0;
  const double* c = t.Cd;
  t.scale0 = max_c(m_sqrt(mul(c[0], c[0]) + mul(c[1], c[1]) + mul(c[2], c[2]) + mul(c[3], c[3]) +
                          mul(f_pl, f_pl)),
                   1e-30);
}

// The f32 phase's start: the inputs rounded to f32, y = (sig_tr, 0) and its
// residual; returns |r|.
MC_HD float start32(const Trial& t, bool plastic, const Consts<float>& k, float d32[4],
                    float s32[4], float y32[5], float r32[5]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d32[j] = static_cast<float>(t.d[j]);
    s32[j] = static_cast<float>(t.sn[j]);
    y32[j] = static_cast<float>(t.sig_tr[j]);
  }
  y32[4] = 0.0f;
  residual(y32, d32, s32, plastic, k, r32);
  return norm5(r32);
}

// The f32 phase and the f64 polish: y, |r| and the iterations of both.
template <bool Plastic, typename G>
MC_HD int solve_point(G& g, const Trial& t, const Params& P, double y[5], double& nrm) {
  const Consts<float>& k32 = P.c32;
  const Consts<double>& k64 = P.c64;
  float d32[4], s32[4], y32[5], r32[5];
  float n32 = start32(t, Plastic, k32, d32, s32, y32, r32);
  const float alphas32[6] = {1.0f, 0.5f, 0.25f, 0.0625f, 0.015625f, 0.0009765625f};
  const int it32 =
      newton<Plastic>(g, y32, r32, n32, alphas32, static_cast<float>(t.scale0), d32, s32, k32);

  // f64 polish; elastic lanes restart from the exact trial state
  double r[5];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = Plastic ? static_cast<double>(y32[j]) : t.sig_tr[j];
  y[4] = Plastic ? static_cast<double>(y32[4]) : 0.0;
  residual(y, t.d, t.sn, Plastic, k64, r);
  nrm = norm5(r);
  const double alphas64[3] = {1.0, 0.25, 0.0009765625};
  return it32 + newton<Plastic>(g, y, r, nrm, alphas64, t.scale0, t.d, t.sn, k64);
}

struct Outputs {
  double* __restrict__ C;
  double* __restrict__ sig;
  int* __restrict__ niter;
  double* __restrict__ yielding;
  double* __restrict__ norm_res;
  double* __restrict__ dlambda;
};

MC_HD void store_state(const Outputs& o, const double y[5], int it, double nrm, long long i,
                       long long n) {
#pragma unroll
  for (int a = 0; a < 4; ++a) o.sig[a * n + i] = y[a];
  o.niter[i] = it;
  o.norm_res[i] = nrm;
  o.dlambda[i] = y[4];
}

// An elastic point (f_tr <= 0): J = I in both phases and the tangent is C.
// Writes everything but yielding.
template <typename G>
MC_HD void elastic_point(G& g, const Trial& t, const Params& P, const Outputs& o, long long i,
                         long long n) {
  double y[5], nrm;
  const int it = solve_point<false>(g, t, P, y, nrm);
  g.store(1, [&](int) {
#pragma unroll
    for (int e = 0; e < 16; ++e) o.C[e * n + i] = P.c64.C[e];
    store_state(o, y, it, nrm, i, n);
  });
}

// An elastic point whose start residuals already meet both phases'
// tolerances takes no Newton step: elastic_point's result without its
// loops.  Writes it (all but yielding) and returns true; returns false,
// writing nothing, for a point that needs a step.
MC_HD bool elastic_at_rest(const Trial& t, const Params& P, const Outputs& o, long long i,
                           long long n) {
  const Consts<float>& k32 = P.c32;
  const Consts<double>& k64 = P.c64;
  float d32[4], s32[4], y32[5], r32[5];
  const float n32 = start32(t, false, k32, d32, s32, y32, r32);
  if (n32 / static_cast<float>(t.scale0) > k32.tol && k32.max_it > 0) return false;
  double y[5], r[5];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = t.sig_tr[j];
  y[4] = 0.0;
  residual(y, t.d, t.sn, false, k64, r);
  const double nrm = norm5(r);
  if (nrm / t.scale0 > k64.tol && k64.max_it > 0) return false;
#pragma unroll
  for (int e = 0; e < 16; ++e) o.C[e * n + i] = k64.C[e];
  store_state(o, y, 0, nrm, i, n);
  return true;
}

// A plastic point (f_tr > 0), its roles shared by the group.  Writes
// everything but yielding.
template <typename G>
MC_HD void plastic_point(G& g, const Trial& t, const Params& P, const Outputs& o, long long i,
                         long long n) {
  double y[5], nrm;
  const int it = solve_point<true>(g, t, P, y, nrm);
  double J[5][5];
  jacobian(g, y, P.c64, J);
  g.store(4, [&](int b) {
    double x[5];
    tangent_column(J, b, P.c64, x);
#pragma unroll
    for (int a = 0; a < 4; ++a) o.C[(4 * a + b) * n + i] = x[a];
  });
  g.store(1, [&](int) { store_state(o, y, it, nrm, i, n); });
}

}  // namespace mc
