// K8a: the R-tangent of the one-electron integrals S, T, V_NE, D (3) and
// Q (3) over AO pairs, when atom 1 moves along +z at unit rate, its nucleus
// with it, and the multipole origin at `origin_rate`.
//
// Replaces the forward-mode part of tuna_tpu/drivers/gradients.py:286
// (jax.grad of total_energy) that differentiates
// IntegralPlan.one_electron (gradients.py:247, tuna_tpu/ops/integrals.py:332)
// in the bond length R.
//
// What bounds it on an H100: latency, as K3 (one_electron.cu).  N2/cc-pVTZ
// has 2,485 AO pairs and ~6,900 primitive pairs; the whole job is ~10^7
// float64 operations and 0.35 MB of output, so a launch lasts as long as
// its longest chain of dependent arithmetic.  The first form took one
// thread an AO pair, which walked its primitive pairs serially (64 at
// cc-pVTZ, where the median is 1) and ran five full z recursions each.
//
// Arithmetic: only z positions move, so of the three axis factors of S, T,
// D, Q only the z factor changes; d/dA_z of a Cartesian Gaussian raises and
// lowers its z power, so the z factor's tangent is
//   dX^{ij} = cA (2a X^{i+1,j} - i X^{i-1,j}) + cB (2b X^{i,j+1} - j X^{i,j-1})
// (cA, cB = 1 for a function on atom 1), minus f S^{ij} for D and 2 f D^{ij}
// for Q (the moving origin).  V_NE of nucleus C takes the raised/lowered z
// Hermite rows with weights cA - [C = 1] and cB - [C = 1] (d/dC = -(d/dA +
// d/dB) by translation invariance), so its Hermite Coulomb table and Boys
// function go to order 2 lmax + 1.  The five z points come from one
// Hermite i-chain (hermite.cuh) up to i + 1, which keeps rows i - 1 and i,
// and three j-chains from those rows (to j + 2 from rows i +- 1, to j + 3
// from row i, which holds (i, j - 1), (i, j) and (i, j + 1)): the raises of
// five separate recursions, each done once.
//
// Design: K3's lane schedule (ops/integrals.py::IntegralPlan.lane_schedule,
// the same lanes): a group of w lanes of one warp an AO pair, lane r taking
// its primitive pairs r, r + w, ... and summing the nine tangent values in
// registers; the Boys table read through L1; then the fixed-order
// butterflies and lane 0's write of [i, j] and [j, i] of all nine matrices
// (lane_sums.cuh): deterministic, no atomics, every entry written once.
// Instantiated for lmax 0-5 (h shells: z rows of 14 orders, Boys order 11).
#include <cuda_runtime.h>

#include "boys.cuh"
#include "hermite.cuh"
#include "lane_sums.cuh"

namespace {

constexpr double kPiPow1_5 = 5.568327996831708;  // pi^(3/2)
constexpr double kTwoPi = 6.283185307179586;
constexpr int kThreads = 128;

// What the S, T, D and Q terms of one axis at powers (i, j) take from a
// chain of Hermite rows E^{i,s}, s = 0, 1, ...: the row's first three
// entries at s = j and its first entry at s = j - 2 and j + 2 (zero where
// the chain never reaches them, as at j < 0).
struct Point {
  int j;
  double minus2 = 0.0, e0 = 0.0, e1 = 0.0, e2 = 0.0, plus2 = 0.0;

  // Takes what it needs from row E^{i,s}, and adds w E^{ij}_t, t < NROW, to
  // `row`.
  template <int LEN, int NROW>
  __device__ __forceinline__ void see(int s, const double (&e)[LEN], double w,
                                      double (&row)[NROW]) {
    if (s == j - 2) minus2 = e[0];
    if (s == j) {
      e0 = e[0];
      e1 = e[1];
      e2 = e[2];
#pragma unroll
      for (int t = 0; t < NROW; ++t) row[t] += w * e[t];
    }
    if (s == j + 2) plus2 = e[0];
  }

  __device__ __forceinline__ double T(double b) const {
    return (2 * j + 1) * b * e0 - 2.0 * b * b * plus2 - 0.5 * (j * (j - 1)) * minus2;
  }
  // Pc: the centre's offset from the multipole origin on this axis
  __device__ __forceinline__ double D(double Pc) const { return e1 + Pc * e0; }
  __device__ __forceinline__ double Q(double Pc, double inv2p) const {
    return 2.0 * e2 + 2.0 * Pc * e1 + (Pc * Pc + inv2p) * e0;
  }
};

// The nine tangent values of primitive pair k, added to sums: S, T, V, D
// (3), Q (3).
template <int LMAX>
__device__ __forceinline__ void primitive_pair(
    int k, int n_atoms, const double* __restrict__ coords, const double* __restrict__ charges,
    const double* __restrict__ a, const double* __restrict__ b, const double* __restrict__ coef,
    const int* __restrict__ l1, const int* __restrict__ l2, const int* __restrict__ atom1,
    const int* __restrict__ atom2, const double* __restrict__ tab, double dipole_origin_z,
    double origin_rate, double (&sums)[9]) {
  constexpr int LXY = 2 * LMAX + 3;  // x, y: Hermite orders up to i + j + 2
  constexpr int LZ = 2 * LMAX + 4;   // z: up to (i + 1) + (j + 2) and i + (j + 3)
  constexpr int TL = 2 * LMAX + 1;   // orders of an x or y row
  constexpr int NZ = 2 * LMAX + 2;   // orders of a z tangent row
  constexpr int NMAX = NZ - 1;       // Boys and Coulomb-table order
  const double* A = coords + 3 * atom1[k];
  const double* B = coords + 3 * atom2[k];
  const double ak = a[k], bk = b[k];
  const double p = ak + bk;
  const double inv2p = 0.5 / p;
  const double prefactor = coef[k] * kPiPow1_5 / (p * sqrt(p));
  const double cA = atom1[k] == 1 ? 1.0 : 0.0, cB = atom2[k] == 1 ? 1.0 : 0.0;

  // x and y at (i, j), and their rows for V
  double S[2], T[2], D[2], Q[2], rows[2][TL];
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const int i = l1[3 * k + axis], j = l2[3 * k + axis];
    const double AB = A[axis] - B[axis];
    const double Pc = (ak * A[axis] + bk * B[axis]) / p;
    double e[LXY];
    tuna::hermite_start(e, ak, bk, AB);
    for (int s = 0; s < i; ++s) tuna::hermite_raise(e, inv2p, -(bk / p) * AB);
#pragma unroll
    for (int t = 0; t < TL; ++t) rows[axis][t] = 0.0;
    Point at{j};
    for (int s = 0; s <= j + 2; ++s) {
      at.see(s, e, 1.0, rows[axis]);
      if (s < j + 2) tuna::hermite_raise(e, inv2p, (ak / p) * AB);
    }
    S[axis] = at.e0;
    T[axis] = at.T(bk);
    D[axis] = at.D(Pc);
    Q[axis] = at.Q(Pc, inv2p);
  }

  // z: one i-chain up to iz + 1, keeping rows iz - 1 and iz (their orders
  // end at iz <= LMAX); then the j-chains of rows iz + 1, iz - 1 and iz.
  // The tangent rows: row_A = 2a E^{i+1,j} - i E^{i-1,j}, row_B = 2b
  // E^{i,j+1} - j E^{i,j-1}.
  const int iz = l1[3 * k + 2], jz = l2[3 * k + 2];
  const double ABz = A[2] - B[2];
  const double x_pa = -(bk / p) * ABz, x_pb = (ak / p) * ABz;
  const double Pz = (ak * A[2] + bk * B[2]) / p;
  const double Pcz = Pz - dipole_origin_z;
  double e[LZ], lower[LMAX + 1] = {}, middle[LMAX + 1] = {};
  tuna::hermite_start(e, ak, bk, ABz);
  for (int s = 0; s <= iz; ++s) {
#pragma unroll
    for (int t = 0; t <= LMAX; ++t) {
      if (s == iz - 1) lower[t] = e[t];
      if (s == iz) middle[t] = e[t];
    }
    tuna::hermite_raise(e, inv2p, x_pa);
  }
  double row_A[NZ] = {}, row_B[NZ] = {};
  Point up_i{jz}, down_i{jz}, up_j{jz + 1}, down_j{jz - 1};
  for (int s = 0; s <= jz + 2; ++s) {
    up_i.see(s, e, 2.0 * ak, row_A);
    if (s < jz + 2) tuna::hermite_raise(e, inv2p, x_pb);
  }
  if (iz > 0) {  // else its weight -iz is zero
#pragma unroll
    for (int t = 0; t < LZ; ++t) e[t] = t <= LMAX ? lower[t] : 0.0;
    for (int s = 0; s <= jz + 2; ++s) {
      down_i.see(s, e, -iz, row_A);
      if (s < jz + 2) tuna::hermite_raise(e, inv2p, x_pb);
    }
  }
  double centre_e0 = 0.0, centre_e1 = 0.0;
#pragma unroll
  for (int t = 0; t < LZ; ++t) e[t] = t <= LMAX ? middle[t] : 0.0;
  for (int s = 0; s <= jz + 3; ++s) {
    down_j.see(s, e, -jz, row_B);  // at jz = 0 it sees nothing of its own
    up_j.see(s, e, 2.0 * bk, row_B);
    if (s == jz) {
      centre_e0 = e[0];
      centre_e1 = e[1];
    }
    if (s < jz + 3) tuna::hermite_raise(e, inv2p, x_pb);
  }
  double dS = 0.0, dT = 0.0, dD = 0.0, dQ = 0.0;
  auto add = [&](const Point& at, double cw) {
    dS += cw * at.e0;
    dT += cw * at.T(bk);
    dD += cw * at.D(Pcz);
    dQ += cw * at.Q(Pcz, inv2p);
  };
  add(up_i, cA * (2.0 * ak));
  add(down_i, cA * -iz);
  add(up_j, cB * (2.0 * bk));
  add(down_j, cB * -jz);
  dD -= origin_rate * centre_e0;
  dQ -= 2.0 * origin_rate * (centre_e1 + Pcz * centre_e0);

  sums[0] += prefactor * S[0] * S[1] * dS;
  sums[1] += prefactor * (T[0] * S[1] * dS + S[0] * T[1] * dS + S[0] * S[1] * dT);
  sums[3] += prefactor * D[0] * S[1] * dS;
  sums[4] += prefactor * S[0] * D[1] * dS;
  sums[5] += prefactor * S[0] * S[1] * dD;
  sums[6] += prefactor * Q[0] * S[1] * dS;
  sums[7] += prefactor * S[0] * Q[1] * dS;
  sums[8] += prefactor * S[0] * S[1] * dQ;

  // Nuclear attraction: x and y pair into even Hermite orders 2m with
  // (2m - 1)!! weights, as in K3; z takes the tangent rows.
  double axy[NMAX + 1] = {};
#pragma unroll
  for (int mx = 0; mx <= LMAX; ++mx) {
#pragma unroll
    for (int my = 0; my <= LMAX; ++my) {
      axy[mx + my] += rows[0][2 * mx] * tuna::odd_double_factorial(mx) * rows[1][2 * my] *
                      tuna::odd_double_factorial(my);
    }
  }
  double v_pair = 0.0;
  for (int atom = 0; atom < n_atoms; ++atom) {
    const double moves = atom == 1 ? 1.0 : 0.0;
    const double wA = cA - moves, wB = cB - moves;
    if (wA == 0.0 && wB == 0.0) continue;
    double gz[NMAX + 1];
#pragma unroll
    for (int t = 0; t <= NMAX; ++t) gz[t] = wA * row_A[t] + wB * row_B[t];
    const double PCz = Pz - coords[3 * atom + 2];
    double F[NMAX + 1];
    tuna::boys_eval<NMAX>(p * PCz * PCz, tab, F);
    const double contrib = tuna::hermite_coulomb<NMAX, NMAX>(F, p, PCz, gz, axy);
    v_pair -= charges[atom] * contrib * kTwoPi / p;
  }
  sums[2] += coef[k] * v_pair;
}

// lanes (n_lanes, 2) from IntegralPlan.lane_schedule (lane_sums.cuh).
template <int LMAX>
__global__ void __launch_bounds__(kThreads)
one_electron_deriv_kernel(int n_atoms, int n_basis, int n_lanes,
                          const double* __restrict__ coords, const double* __restrict__ charges,
                          const double* __restrict__ a, const double* __restrict__ b,
                          const double* __restrict__ coef, const int* __restrict__ l1,
                          const int* __restrict__ l2, const int* __restrict__ atom1,
                          const int* __restrict__ atom2, const int* __restrict__ ao_i,
                          const int* __restrict__ ao_j, const int* __restrict__ pair_start,
                          const int2* __restrict__ lanes, const double* __restrict__ boys_table,
                          double dipole_origin_z, double origin_rate, double* __restrict__ out) {
  tuna::lane_sums<9>(n_lanes, lanes, pair_start, ao_i, ao_j, n_basis, out,
                     [&](int k, double (&sums)[9]) {
                       primitive_pair<LMAX>(k, n_atoms, coords, charges, a, b, coef, l1, l2,
                                            atom1, atom2, boys_table, dipole_origin_z,
                                            origin_rate, sums);
                     });
}

}  // namespace

// lanes (n_lanes, 2) int32 from IntegralPlan.lane_schedule, n_lanes a
// multiple of 32; boys_table: the Taylor table of Boys order 2 lmax + 1.
extern "C" int tuna_one_electron_deriv(int lmax, int n_atoms, int n_basis, int n_lanes,
                                       const double* coords, const double* charges,
                                       const double* a, const double* b, const double* coef,
                                       const int* l1, const int* l2, const int* atom1,
                                       const int* atom2, const int* ao_i, const int* ao_j,
                                       const int* pair_start, const int* lanes,
                                       const double* boys_table, double dipole_origin_z,
                                       double origin_rate, double* out, cudaStream_t stream) {
#define TUNA_ONE_ELECTRON_DERIV_CASE(L)                                                       \
  case L:                                                                                     \
    return tuna::launch_lanes<kThreads>(                                                      \
        one_electron_deriv_kernel<L>, n_lanes, stream, n_atoms, n_basis, n_lanes, coords,     \
        charges, a, b, coef, l1, l2, atom1, atom2, ao_i, ao_j, pair_start,                    \
        reinterpret_cast<const int2*>(lanes), boys_table, dipole_origin_z, origin_rate, out);
  switch (lmax) {
    TUNA_ONE_ELECTRON_DERIV_CASE(0)
    TUNA_ONE_ELECTRON_DERIV_CASE(1)
    TUNA_ONE_ELECTRON_DERIV_CASE(2)
    TUNA_ONE_ELECTRON_DERIV_CASE(3)
    TUNA_ONE_ELECTRON_DERIV_CASE(4)
    TUNA_ONE_ELECTRON_DERIV_CASE(5)
    default:
      return cudaErrorInvalidValue;
  }
#undef TUNA_ONE_ELECTRON_DERIV_CASE
}
