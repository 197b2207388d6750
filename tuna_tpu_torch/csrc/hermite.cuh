// McMurchie-Davidson building blocks shared by the ERI sweep (eri.cu) and
// the one-electron integrals (one_electron.cu).
//
// The kernels evaluate the integrals UNSCALED, as the reference TUNA engine
// does: Hopper runs float64 natively with its full exponent range, so the
// (2p)^(t/2) scaling that tuna_tpu/ops/integrals.py applies for the TPU's
// float32-range emulated f64 is not needed.  The plain torch twins keep the
// scaled form; both agree to rounding.
#pragma once

#include "boys.cuh"

namespace tuna {

// (2m - 1)!!, the (T - 1)!! weight of an even Hermite order T = 2m on an
// axis with zero separation.  Called with unrolled, compile-time m.
__host__ __device__ constexpr double odd_double_factorial(int m) {
  double result = 1.0;
  for (int k = 2 * m - 1; k > 1; k -= 2) result *= k;
  return result;
}

// One step of the Hermite recursion (ops/integrals.py::build_E_table):
//   E_t^{i+1,j} = E_{t-1}^{ij} / (2p) + X E_t^{ij} + (t + 1) E_{t+1}^{ij}
// with X = X_PA (raising i) or X_PB (raising j).  Entries past the old
// row's end are zero, so the new row's tail is zero as well.
template <int LEN>
__device__ __forceinline__ void hermite_raise(double (&e)[LEN], double inv2p, double shift) {
  double prev = 0.0;
#pragma unroll
  for (int t = 0; t < LEN; ++t) {
    const double cur = e[t];
    const double next = (t + 1 < LEN) ? e[t + 1] : 0.0;
    e[t] = inv2p * prev + shift * cur + (t + 1) * next;
    prev = cur;
  }
}

// Start of the recursion: E_0^{00} = exp(-mu AB^2), the rest zero.
template <int LEN>
__device__ __forceinline__ void hermite_start(double (&e)[LEN], double a, double b, double AB) {
  const double mu = a * b / (a + b);
  e[0] = exp(-mu * AB * AB);
#pragma unroll
  for (int t = 1; t < LEN; ++t) e[t] = 0.0;
}

// Row E_t^{ij}, t = 0..LEN-1, of one Cartesian axis: i raises with X_PA,
// then j with X_PB, in the order of build_E_table.  Needs LEN > i + j.
template <int LEN>
__device__ __forceinline__ void hermite_row(int i, int j, double a, double b, double AB,
                                            double (&e)[LEN]) {
  const double p = a + b;
  const double inv2p = 0.5 / p;
  const double x_pa = -(b / p) * AB;
  const double x_pb = (a / p) * AB;
  hermite_start(e, a, b, AB);
  for (int s = 0; s < i; ++s) hermite_raise(e, inv2p, x_pa);
  for (int s = 0; s < j; ++s) hermite_raise(e, inv2p, x_pb);
}

// sum_v gz[v] sum_n axy[n] R^n_{00v}(alpha, PQz) over n <= NXY and
// v + STEP n <= NMAX.
// The z-axis Hermite Coulomb table (all centres on the z axis):
//   R^n_{000} = (-2 alpha)^n F_n(alpha PQz^2)
//   R^n_{00v} = PQz R^{n+1}_{00,v-1} + (v - 1) R^{n+1}_{00,v-2}
// built row by row over v, three rows live at a time.  The quartet kernels
// pass STEP = 2: there n = m_x + m_y counts pairs of x/y orders, so a term
// with v + 2n above the quartet's total angular momentum NMAX is an exact
// zero and is left out.
template <int NMAX, int VMAX, int NXY = NMAX, int STEP = 1>
__device__ __forceinline__ double hermite_coulomb(const double (&F)[NMAX + 1], double alpha,
                                                  double PQz, const double (&gz)[VMAX + 1],
                                                  const double (&axy)[NXY + 1]) {
  double r_older[NMAX + 1], r_old[NMAX + 1], r_new[NMAX + 1];
  double scale = 1.0;
#pragma unroll
  for (int n = 0; n <= NMAX; ++n) {
    r_old[n] = scale * F[n];
    r_older[n] = 0.0;
    scale *= -2.0 * alpha;
  }
  double dot0 = 0.0;
#pragma unroll
  for (int n = 0; n <= NXY && STEP * n <= NMAX; ++n) dot0 += axy[n] * r_old[n];
  double total = gz[0] * dot0;
#pragma unroll
  for (int v = 1; v <= VMAX; ++v) {
    double dot = 0.0;
#pragma unroll
    for (int n = 0; n + v <= NMAX; ++n) {
      r_new[n] = PQz * r_old[n + 1] + (v - 1) * r_older[n + 1];
      if (n <= NXY && v + STEP * n <= NMAX) dot += axy[n] * r_new[n];
    }
#pragma unroll
    for (int n = 0; n <= NMAX; ++n) {
      r_older[n] = r_old[n];
      r_old[n] = (n + v <= NMAX) ? r_new[n] : 0.0;
    }
    total += gz[v] * dot;
  }
  return total;
}

}  // namespace tuna
