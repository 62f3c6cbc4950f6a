// Mohr-Coulomb return map with consistent tangent for one Gauss point.
//
// The per-point body shared by the CUDA kernel (mohr_coulomb.cu) and the
// CPU build (mohr_coulomb_host.cpp) that the tests hold against the plain
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
//   4. tangent dy*/deps = J(y*)^-1 [C; 0] by one 5x4 solve.
//
// Each point runs its own loops to its own exit, as each lane of the JAX
// package's vmap(while_loop) does.
//
// Where trouble lies, and what this file does about it:
// - Silent promotion to double in the f32 phase.  Every literal in a
//   template body is written T(...), and the material constants arrive in
//   Consts<float>, rounded once on the host: the JAX package's Python
//   floats are weak-typed and round to f32 the same way.  Constants the JAX
//   package folds in Python (sin_a / 3.0, -1.0 + eps_clip, 1.0 - 1e-3) are
//   folded in double on the host before that rounding.
// - The Hessian of the potential.  terms() is written once, generic over
//   its scalar type S, and evaluated on Dual<T> (one value, four tangents)
//   to give g, grad g and Hg = d(grad g)/d sig in one pass, with the
//   tangent rules of jax.jvp: no tangent through the f32 seed of the f64
//   trig (stop_gradient), selects select tangents, max/min pass the tangent
//   of the larger/smaller operand and half of each at a tie (jnp.clip,
//   jnp.maximum).
// - The one-hot pick of the line search.  The JAX package picks the
//   candidate with a one-hot dot product, so a component that is not finite
//   in any other candidate (0 * inf) makes that component of the pick NaN.
//   newton() keeps a mask of such components and does the same.
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

// ---------------------------------------------------------------------------
// forward-mode dual numbers: a value and its tangents along sigma's 4 axes
// ---------------------------------------------------------------------------

template <typename T>
struct Dual {
  T v;
  T d[4];
};

template <typename T>
MC_HD Dual<T> lift(T c) {  // a constant: zero tangents
  Dual<T> r;
  r.v = c;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = T(0);
  return r;
}

template <typename T>
MC_HD T val(T x) {
  return x;
}
template <typename T>
MC_HD T val(const Dual<T>& x) {
  return x.v;
}

// JAX's jvp rules: d(a*b) = da*b + a*db; d(a/b) = da/b + (-db*a)/(b*b)
template <typename T>
MC_HD Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <typename T>
MC_HD Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <typename T>
MC_HD Dual<T> operator-(const Dual<T>& a) {
  Dual<T> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename T>
MC_HD Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <typename T>
MC_HD Dual<T> operator/(const Dual<T>& a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v / b.v;
  const T inv_b2 = T(1) / (b.v * b.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] / b.v + (-b.d[k] * a.v) * inv_b2;
  return r;
}
template <typename T>
MC_HD Dual<T> operator+(const Dual<T>& a, T c) {
  Dual<T> r = a;
  r.v = a.v + c;
  return r;
}
template <typename T>
MC_HD Dual<T> operator+(T c, const Dual<T>& a) {
  Dual<T> r = a;
  r.v = c + a.v;
  return r;
}
template <typename T>
MC_HD Dual<T> operator-(const Dual<T>& a, T c) {
  Dual<T> r = a;
  r.v = a.v - c;
  return r;
}
template <typename T>
MC_HD Dual<T> operator-(T c, const Dual<T>& a) {
  Dual<T> r;
  r.v = c - a.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = -a.d[k];
  return r;
}
template <typename T>
MC_HD Dual<T> operator*(const Dual<T>& a, T c) {
  Dual<T> r;
  r.v = a.v * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] * c;
  return r;
}
template <typename T>
MC_HD Dual<T> operator*(T c, const Dual<T>& a) {
  Dual<T> r;
  r.v = c * a.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = c * a.d[k];
  return r;
}
template <typename T>
MC_HD Dual<T> operator/(const Dual<T>& a, T c) {
  Dual<T> r;
  r.v = a.v / c;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] / c;
  return r;
}
template <typename T>
MC_HD Dual<T> operator/(T c, const Dual<T>& b) {
  Dual<T> r;
  r.v = c / b.v;
  const T inv_b2 = T(1) / (b.v * b.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = (-b.d[k] * c) * inv_b2;
  return r;
}

template <typename T>
MC_HD Dual<T> m_sqrt(const Dual<T>& a) {  // d sqrt = da * (0.5 / sqrt(a))
  Dual<T> r;
  r.v = m_sqrt(a.v);
  const T s = T(0.5) / r.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] * s;
  return r;
}
template <typename T>
MC_HD Dual<T> m_asin(const Dual<T>& a) {  // d asin = da / sqrt(1 - a^2)
  Dual<T> r;
  r.v = m_asin(a.v);
  const T s = T(1) / m_sqrt(T(1) - a.v * a.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] * s;
  return r;
}
template <typename T>
MC_HD Dual<T> m_sin(const Dual<T>& a) {
  Dual<T> r;
  r.v = m_sin(a.v);
  const T c = m_cos(a.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = a.d[k] * c;
  return r;
}
template <typename T>
MC_HD Dual<T> m_cos(const Dual<T>& a) {
  Dual<T> r;
  r.v = m_cos(a.v);
  const T s = m_sin(a.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = -(a.d[k] * s);
  return r;
}

// select, and max/min against a constant as lax.max/lax.min: NaN in, NaN
// out; the tangent passes where x wins, half of it at a tie
template <typename T>
MC_HD T select(bool c, T a, T b) {
  return c ? a : b;
}
template <typename T>
MC_HD Dual<T> select(bool c, const Dual<T>& a, const Dual<T>& b) {
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
MC_HD Dual<T> max_c(const Dual<T>& x, T c) {
  const T w = x.v > c ? T(1) : (x.v == c ? T(0.5) : T(0));
  Dual<T> r;
  r.v = x.v < c ? c : x.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = x.d[k] * w;
  return r;
}
template <typename T>
MC_HD Dual<T> min_c(const Dual<T>& x, T c) {
  const T w = x.v < c ? T(1) : (x.v == c ? T(0.5) : T(0));
  Dual<T> r;
  r.v = x.v > c ? c : x.v;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.d[k] = x.d[k] * w;
  return r;
}

template <typename S>
MC_HD S zero_like(S) {
  return S(0);
}
template <typename T>
MC_HD Dual<T> zero_like(const Dual<T>&) {
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
    const float s32 = sinf(asinf(x32) * (1.0f / 3.0f));
    const T s0 = min_c(max_c(static_cast<T>(s32), -k.sinT), k.sinT);
    S s = zero_like(x) + s0;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      s = s - (T(3) * s - T(4) * s * s * s - x) / (T(3) - T(12) * s * s);
    }
    st = s;
    ct = m_sqrt(T(1) - st * st);
  } else {
    const S theta = m_asin(x) * T(1.0 / 3.0);
    st = m_sin(theta);
    ct = m_cos(theta);
  }
}

// DEV @ v with DEV's entries rounded to T (the products by 0 left out)
template <typename T, typename S>
MC_HD void dev4(const S v[4], S out[4]) {
  const T d23 = T(2.0 / 3.0), d13 = T(-1.0 / 3.0);
  out[0] = d23 * v[0] + d13 * v[1] + d13 * v[2];
  out[1] = d13 * v[0] + d23 * v[1] + d13 * v[2];
  out[2] = d13 * v[0] + d13 * v[1] + d23 * v[2];
  out[3] = v[3];
}

// f(sig) and grad f(sig) (abbo_sloan.py:118-161)
template <typename T, typename S>
MC_HD void terms(const S sig[4], const Surface<T>& p, const Consts<T>& k, S& f, S df[4]) {
  S s[4];
  dev4<T>(sig, s);
  const S I1 = sig[0] + sig[1] + sig[2];
  const S J2 = T(0.5) * (s[0] * s[0] + s[1] * s[1] + s[2] * s[2] + s[3] * s[3]);
  const bool safe = val(J2) > T(0);
  const S J2s = select(safe, J2, zero_like(J2) + T(1));
  const S J3 = s[2] * (s[0] * s[1] - s[3] * s[3] / T(2));
  const S sqJ2 = m_sqrt(J2s);
  const S invJ2_32 = T(1) / (J2s * sqJ2);
  const S arg_raw = select(safe, -k.c0 * J3 * invJ2_32, zero_like(J2));
  const S x = min_c(max_c(arg_raw, k.lo), k.hi);  // == sin(3 theta)

  S st, ct;
  sincos_third<T>(x, k, st, ct);
  const S c3t = m_sqrt(T(1) - x * x);  // cos(3 theta)

  const bool pos = val(x) >= T(0);
  const T Ac = pos ? p.Ap : p.Am;
  const T Bc = pos ? p.Bp : p.Bm;
  const T Cc = pos ? p.Cp : p.Cm;

  const S K_in = ct - p.sin_a * st * k.inv_sqrt3;
  const S K_out = Ac + (Bc + Cc * x) * x;
  const S dKin_dx = (-st - p.sin_a * ct * k.inv_sqrt3) / (T(3) * c3t);
  const S dKout_dx = Bc + T(2) * Cc * x;
  const bool outer = m_abs(val(x)) > k.sin3T;
  const S K = select(outer, K_out, K_in);
  const S dK_dx = select(outer, dKout_dx, dKin_dx);

  const S Q = m_sqrt(J2 * K * K + p.asa2);
  f = I1 / T(3) * p.sin_a + Q - p.c_cos_a;

  S dJ3_ds[4], dJ3[4];
  dJ3_ds[0] = s[1] * s[2];
  dJ3_ds[1] = s[0] * s[2];
  dJ3_ds[2] = s[0] * s[1] - s[3] * s[3] / T(2);
  dJ3_ds[3] = -s[2] * s[3];
  dev4<T>(dJ3_ds, dJ3);
  const bool unclipped = safe && m_abs(val(arg_raw)) < k.hi;
  const S ratio = T(1.5) * (J3 / J2s);
  const S Qs = max_c(Q, k.q_floor);
  const S coef = T(2) * J2 * K * dK_dx;
  const S KK = K * K;
  const S den = T(2) * Qs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const S darg = -k.c0 * (dJ3[i] - ratio * s[i]) * invJ2_32;
    const S dx = select(unclipped, darg, zero_like(darg));
    const S frac = (KK * s[i] + coef * dx) / den;
    df[i] = i < 3 ? p.sin_a_3 + frac : frac;
  }
}

// ---------------------------------------------------------------------------
// residual, Jacobian, small solve
// ---------------------------------------------------------------------------

// C @ v over 4 entries, summed in column order
template <typename T>
MC_HD T row_dot(const T* Crow, const T v[4]) {
  return Crow[0] * v[0] + Crow[1] * v[1] + Crow[2] * v[2] + Crow[3] * v[3];
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
  for (int j = 0; j < 4; ++j) v[j] = d[j] - dlp * dg[j];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = y[i] - sn[i] - row_dot(k.C + 4 * i, v);
  r[4] = plastic ? ff : y[4];
}

// J(y) = [[I + dl C Hg, C grad g], [grad f^T, 0]] or I_5 (:193-214)
template <typename T>
MC_HD void jacobian(const T y[5], bool plastic, const Consts<T>& k, T J[5][5]) {
  Dual<T> sd[4], gd, dgd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sd[i] = lift(y[i]);
    sd[i].d[i] = T(1);
  }
  terms<T, Dual<T>>(sd, k.g, k, gd, dgd);
  T dg[4], Hg[4][4], df[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dg[i] = dgd[i].v;
#pragma unroll
    for (int j = 0; j < 4; ++j) Hg[i][j] = dgd[i].d[j];
  }
  if (k.assoc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) df[i] = dg[i];
  } else {
    T ff;
    terms<T, T>(y, k.f, k, ff, df);
  }
  const T dlp = plastic ? y[4] : T(0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T col[4] = {Hg[0][j], Hg[1][j], Hg[2][j], Hg[3][j]};
      J[i][j] = (i == j ? T(1) : T(0)) + dlp * row_dot(k.C + 4 * i, col);
    }
    J[i][4] = plastic ? row_dot(k.C + 4 * i, dg) : T(0);
    J[4][i] = plastic ? df[i] : T(0);
  }
  J[4][4] = plastic ? T(0) : T(1);
}

// A x = B for one 5x5 system and M right-hand sides: unrolled elimination
// with pairwise max-bubbling pivoting (mohr_coulomb.py:59-102)
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
      const T f = R[i][kk] * inv_piv;
#pragma unroll
      for (int j = kk + 1; j < N + M; ++j) R[i][j] = R[i][j] - f * R[kk][j];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const T inv_d = T(1) / R[i][i];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T acc = R[i][N + j];
#pragma unroll
      for (int kk = i + 1; kk < N; ++kk) acc = acc - R[i][kk] * X[kk][j];
      X[i][j] = acc * inv_d;
    }
  }
}

template <typename T>
MC_HD T norm5(const T r[5]) {
  return m_sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3] + r[4] * r[4]);
}

// Damped Newton to |r| <= tol * scale, k.max_it steps or a stalled step
// (mohr_coulomb.py:255-295 and :305-338).  y, res and norm are updated in
// place; returns the number of steps.
template <typename T, int NA>
MC_HD int newton(T y[5], T res[5], T& norm, const T (&alphas)[NA], T scale, const T d[4],
                 const T sn[4], bool plastic, const Consts<T>& k) {
  int it = 0;
  bool stalled = false;
  while (!stalled && norm / scale > k.tol && it < k.max_it) {
    T J[5][5], B[5][1], dy[5][1];
    jacobian(y, plastic, k, J);
#pragma unroll
    for (int i = 0; i < 5; ++i) B[i][0] = -res[i];
    solve_small<T, 1>(J, B, dy);
    // candidates in order; keep the first that lowers |r|, else the last
    T y_sel[5], r_sel[5], n_sel = T(0);
    T ya[5], ra[5], na = T(0);
    int sel = -1;
    // bit a set: candidate a holds a value that is not finite there
    unsigned bad_y[5] = {0u, 0u, 0u, 0u, 0u}, bad_r[5] = {0u, 0u, 0u, 0u, 0u}, bad_n = 0u;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int i = 0; i < 5; ++i) ya[i] = y[i] + alphas[a] * dy[i][0];
      residual(ya, d, sn, plastic, k, ra);
      na = norm5(ra);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        bad_y[i] |= m_finite(ya[i]) ? 0u : 1u << a;
        bad_r[i] |= m_finite(ra[i]) ? 0u : 1u << a;
      }
      bad_n |= m_finite(na) ? 0u : 1u << a;
      if (sel < 0 && na < norm) {
        sel = a;
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          y_sel[i] = ya[i];
          r_sel[i] = ra[i];
        }
        n_sel = na;
      }
    }
    if (sel < 0) {
      sel = NA - 1;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        y_sel[i] = ya[i];
        r_sel[i] = ra[i];
      }
      n_sel = na;
    }
    // the one-hot pick: 0 * (inf or NaN) of another candidate is NaN
    const unsigned others = ~(1u << sel);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (bad_y[i] & others) y_sel[i] = m_nan<T>();
      if (bad_r[i] & others) r_sel[i] = m_nan<T>();
    }
    if (bad_n & others) n_sel = m_nan<T>();
    stalled = n_sel >= norm * k.stall;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      y[i] = y_sel[i];
      res[i] = r_sel[i];
    }
    norm = n_sel;
    ++it;
  }
  return it;
}

// ---------------------------------------------------------------------------
// one Gauss point
// ---------------------------------------------------------------------------

MC_HD void mc_point(const double* __restrict__ deps, const double* __restrict__ sig_n,
                    double* __restrict__ C_out, double* __restrict__ sig_out,
                    int* __restrict__ niter_out, double* __restrict__ yielding_out,
                    double* __restrict__ norm_out, double* __restrict__ dlambda_out,
                    long long i, long long n, const Params& P) {
  const Consts<double>& k64 = P.c64;
  const Consts<float>& k32 = P.c32;
  double d[4], sn[4], Cd[4], sig_tr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d[j] = deps[j * n + i];
    sn[j] = sig_n[j * n + i];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    Cd[j] = row_dot(k64.C + 4 * j, d);
    sig_tr[j] = sn[j] + Cd[j];
  }
  double f_tr, df_tr[4];
  terms<double, double>(sig_tr, k64.f, k64, f_tr, df_tr);
  const bool plastic = f_tr > 0.0;
  const double f_pl = plastic ? f_tr : 0.0;
  // convergence scale: |C deps| and the trial yield value
  const double scale0 =
      max_c(m_sqrt(Cd[0] * Cd[0] + Cd[1] * Cd[1] + Cd[2] * Cd[2] + Cd[3] * Cd[3] + f_pl * f_pl),
            1e-30);

  // f32 phase from the trial state
  float d32[4], s32[4], y32[5], r32[5];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d32[j] = static_cast<float>(d[j]);
    s32[j] = static_cast<float>(sn[j]);
    y32[j] = static_cast<float>(sig_tr[j]);
  }
  y32[4] = 0.0f;
  residual(y32, d32, s32, plastic, k32, r32);
  float n32 = norm5(r32);
  const float alphas32[6] = {1.0f, 0.5f, 0.25f, 0.0625f, 0.015625f, 0.0009765625f};
  const int it32 = newton(y32, r32, n32, alphas32, static_cast<float>(scale0), d32, s32,
                          plastic, k32);

  // f64 polish; elastic lanes restart from the exact trial state
  double y[5], r[5];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = plastic ? static_cast<double>(y32[j]) : sig_tr[j];
  y[4] = plastic ? static_cast<double>(y32[4]) : 0.0;
  residual(y, d, sn, plastic, k64, r);
  double nrm = norm5(r);
  const double alphas64[3] = {1.0, 0.25, 0.0009765625};
  const int it64 = newton(y, r, nrm, alphas64, scale0, d, sn, plastic, k64);

  // tangent: J(y*) X = [C; 0]
  double J[5][5], B[5][4], X[5][4];
  jacobian(y, plastic, k64, J);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) B[a][b] = k64.C[4 * a + b];
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) B[4][b] = 0.0;
  solve_small<double, 4>(J, B, X);

#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) C_out[(4 * a + b) * n + i] = X[a][b];
    sig_out[a * n + i] = y[a];
  }
  niter_out[i] = it32 + it64;
  yielding_out[i] = f_tr;
  norm_out[i] = nrm;
  dlambda_out[i] = y[4];
}

}  // namespace mc
