// K8a: the R-tangent of the one-electron integrals S, T, V_NE, D (3) and
// Q (3) over AO pairs, when atom 1 moves along +z at unit rate, its nucleus
// with it, and the multipole origin at `origin_rate`.
//
// Replaces the forward-mode part of tuna_tpu/drivers/gradients.py:286
// (jax.grad of total_energy) that differentiates
// IntegralPlan.one_electron (gradients.py:247, tuna_tpu/ops/integrals.py:332)
// in the bond length R.
//
// What bounds it on an H100: size, as K3 (one_electron.cu).  N2/cc-pVTZ has
// 2,485 AO pairs and ~6,900 primitive pairs; the whole job is ~10^7 float64
// operations and 0.35 MB of output, one launch of latency.
//
// Design: K3's, one thread per AO pair (i >= j) over its primitive pairs.
// Only z positions move, so of the three axis factors of S, T, D, Q only
// the z factor changes; d/dA_z of a Cartesian Gaussian raises and lowers its
// z power, so the z factor's tangent is
//   dX^{ij} = cA (2a X^{i+1,j} - i X^{i-1,j}) + cB (2b X^{i,j+1} - j X^{i,j-1})
// (cA, cB = 1 for a function on atom 1), minus f S^{ij} for D and 2 f D^{ij}
// for Q (the moving origin).  Each X^{i'j'} comes from its own Hermite
// recursion (hermite.cuh), run to j' + 2 for T and Q.  V_NE of nucleus C
// takes the raised/lowered z Hermite rows with weights cA - [C = 1] and
// cB - [C = 1] (d/dC = -(d/dA + d/dB) by translation invariance), so its
// Hermite Coulomb table and Boys function go to order 2 lmax + 1.  The
// thread writes all nine tangent matrices at [i, j] and [j, i]:
// deterministic, no atomics.
#include <cuda_runtime.h>

#include "boys.cuh"
#include "hermite.cuh"

namespace {

constexpr double kPiPow1_5 = 5.568327996831708;  // pi^(3/2)
constexpr double kTwoPi = 6.283185307179586;
constexpr int kThreads = 128;

// One axis's S, T, D, Q at powers (i, j) and, in `row`, the Hermite row
// E_t^{ij}.  Needs LEN > i + j + 2.
template <int LEN>
struct AxisTerms {
  double S, T, D, Q;
  double row[LEN];

  __device__ __forceinline__ void compute(int i, int j, double a, double b, double AB,
                                          double Pc) {
    const double p = a + b;
    const double inv2p = 0.5 / p;
    const double x_pa = -(b / p) * AB;
    const double x_pb = (a / p) * AB;
    double e[LEN];
    tuna::hermite_start(e, a, b, AB);
    for (int s = 0; s < i; ++s) tuna::hermite_raise(e, inv2p, x_pa);
    double s_minus2 = 0.0, e0 = 0.0, e1 = 0.0, e2 = 0.0;
    for (int s = 0; s <= j + 2; ++s) {
      if (s == j - 2) s_minus2 = e[0];
      if (s == j) {
        e0 = e[0];
        e1 = e[1];
        e2 = e[2];
#pragma unroll
        for (int t = 0; t < LEN; ++t) row[t] = e[t];
      }
      if (s < j + 2) tuna::hermite_raise(e, inv2p, x_pb);
    }
    S = e0;
    T = (2 * j + 1) * b * e0 - 2.0 * b * b * e[0] - 0.5 * (j * (j - 1)) * s_minus2;
    D = e1 + Pc * e0;
    Q = 2.0 * e2 + 2.0 * Pc * e1 + (Pc * Pc + inv2p) * e0;
  }
};

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
one_electron_deriv_kernel(int n_atoms, int n_basis, int n_pairs,
                          const double* __restrict__ coords, const double* __restrict__ charges,
                          const double* __restrict__ a, const double* __restrict__ b,
                          const double* __restrict__ coef, const int* __restrict__ l1,
                          const int* __restrict__ l2, const int* __restrict__ atom1,
                          const int* __restrict__ atom2, const int* __restrict__ ao_i,
                          const int* __restrict__ ao_j, const int* __restrict__ pair_start,
                          const double* __restrict__ boys_table, double dipole_origin_z,
                          double origin_rate, double* __restrict__ out) {
  constexpr int LEN = 2 * LMAX + 5;  // up to (i + 1) + (j + 1) + 2
  constexpr int NZ = 2 * LMAX + 2;   // Hermite orders of a z tangent row
  constexpr int NMAX = NZ - 1;       // Boys and Coulomb-table order
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  tuna::load_boys_table(tab, boys_table);

  const int P = blockIdx.x * blockDim.x + threadIdx.x;
  if (P >= n_pairs) return;
  const int k0 = pair_start[P], k1 = pair_start[P + 1];

  double s_sum = 0.0, t_sum = 0.0, v_sum = 0.0;
  double d_sum[3] = {0.0, 0.0, 0.0}, q_sum[3] = {0.0, 0.0, 0.0};
  for (int k = k0; k < k1; ++k) {
    const double* A = coords + 3 * atom1[k];
    const double* B = coords + 3 * atom2[k];
    const double ak = a[k], bk = b[k];
    const double p = ak + bk;
    const double prefactor = coef[k] * kPiPow1_5 / (p * sqrt(p));
    const double cA = atom1[k] == 1 ? 1.0 : 0.0, cB = atom2[k] == 1 ? 1.0 : 0.0;

    // x and y at (i, j); their Hermite rows for V
    double S[2], T[2], D[2], Q[2], rows_xy[2][LEN];
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
      AxisTerms<LEN> terms;
      const double Pc = (ak * A[axis] + bk * B[axis]) / p;
      terms.compute(l1[3 * k + axis], l2[3 * k + axis], ak, bk, A[axis] - B[axis], Pc);
      S[axis] = terms.S;
      T[axis] = terms.T;
      D[axis] = terms.D;
      Q[axis] = terms.Q;
#pragma unroll
      for (int t = 0; t < LEN; ++t) rows_xy[axis][t] = terms.row[t];
    }

    // z at (i, j) and its four neighbours; the tangent of each term
    const int iz = l1[3 * k + 2], jz = l2[3 * k + 2];
    const double ABz = A[2] - B[2];
    const double Pz = (ak * A[2] + bk * B[2]) / p;
    const double Pcz = Pz - dipole_origin_z;
    double dS = 0.0, dT = 0.0, dD = 0.0, dQ = 0.0, row_A[NZ], row_B[NZ];
#pragma unroll
    for (int t = 0; t < NZ; ++t) row_A[t] = row_B[t] = 0.0;
    const int di[4] = {1, -1, 0, 0}, dj[4] = {0, 0, 1, -1};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int i = iz + di[n], j = jz + dj[n];
      if (i < 0 || j < 0) continue;  // its weight -i or -j is zero
      const double w = n == 0 ? 2.0 * ak : n == 1 ? -iz : n == 2 ? 2.0 * bk : -jz;
      const double c = n < 2 ? cA : cB;
      AxisTerms<LEN> terms;
      terms.compute(i, j, ak, bk, ABz, Pcz);
      dS += c * w * terms.S;
      dT += c * w * terms.T;
      dD += c * w * terms.D;
      dQ += c * w * terms.Q;
      double* row = n < 2 ? row_A : row_B;
#pragma unroll
      for (int t = 0; t < NZ; ++t) row[t] += w * terms.row[t];
    }
    AxisTerms<LEN> z;
    z.compute(iz, jz, ak, bk, ABz, Pcz);
    dD -= origin_rate * z.S;
    dQ -= 2.0 * origin_rate * z.D;

    s_sum += prefactor * S[0] * S[1] * dS;
    t_sum += prefactor * (T[0] * S[1] * dS + S[0] * T[1] * dS + S[0] * S[1] * dT);
    d_sum[0] += prefactor * D[0] * S[1] * dS;
    d_sum[1] += prefactor * S[0] * D[1] * dS;
    d_sum[2] += prefactor * S[0] * S[1] * dD;
    q_sum[0] += prefactor * Q[0] * S[1] * dS;
    q_sum[1] += prefactor * S[0] * Q[1] * dS;
    q_sum[2] += prefactor * S[0] * S[1] * dQ;

    // Nuclear attraction: x and y pair into even Hermite orders 2m with
    // (2m - 1)!! weights, as in K3; z takes the tangent rows.
    double axy[NMAX + 1];
#pragma unroll
    for (int n = 0; n <= NMAX; ++n) axy[n] = 0.0;
#pragma unroll
    for (int mx = 0; mx <= LMAX; ++mx) {
#pragma unroll
      for (int my = 0; my <= LMAX; ++my) {
        axy[mx + my] += rows_xy[0][2 * mx] * tuna::odd_double_factorial(mx) *
                        rows_xy[1][2 * my] * tuna::odd_double_factorial(my);
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
    v_sum += coef[k] * v_pair;
  }

  const int i = ao_i[k0], j = ao_j[k0];
  const size_t nn = static_cast<size_t>(n_basis) * n_basis;
  const double values[9] = {s_sum,    t_sum,    v_sum,    d_sum[0], d_sum[1],
                            d_sum[2], q_sum[0], q_sum[1], q_sum[2]};
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    out[m * nn + static_cast<size_t>(i) * n_basis + j] = values[m];
    out[m * nn + static_cast<size_t>(j) * n_basis + i] = values[m];
  }
}

template <int LMAX>
cudaError_t launch_one_electron_deriv(int n_atoms, int n_basis, int n_pairs,
                                      const double* coords, const double* charges,
                                      const double* a, const double* b, const double* coef,
                                      const int* l1, const int* l2, const int* atom1,
                                      const int* atom2, const int* ao_i, const int* ao_j,
                                      const int* pair_start, const double* boys_table,
                                      double dipole_origin_z, double origin_rate, double* out,
                                      cudaStream_t stream) {
  if (n_pairs > 0) {
    const int blocks = (n_pairs + kThreads - 1) / kThreads;
    one_electron_deriv_kernel<LMAX><<<blocks, kThreads, 0, stream>>>(
        n_atoms, n_basis, n_pairs, coords, charges, a, b, coef, l1, l2, atom1, atom2, ao_i,
        ao_j, pair_start, boys_table, dipole_origin_z, origin_rate, out);
  }
  return cudaGetLastError();
}

}  // namespace

// boys_table: the Taylor table of Boys order 2 lmax + 1.
extern "C" int tuna_one_electron_deriv(int lmax, int n_atoms, int n_basis, int n_pairs,
                                       const double* coords, const double* charges,
                                       const double* a, const double* b, const double* coef,
                                       const int* l1, const int* l2, const int* atom1,
                                       const int* atom2, const int* ao_i, const int* ao_j,
                                       const int* pair_start, const double* boys_table,
                                       double dipole_origin_z, double origin_rate, double* out,
                                       cudaStream_t stream) {
#define TUNA_ONE_ELECTRON_DERIV_CASE(L)                                                        \
  case L:                                                                                      \
    return launch_one_electron_deriv<L>(n_atoms, n_basis, n_pairs, coords, charges, a, b,   \
                                        coef, l1, l2, atom1, atom2, ao_i, ao_j, pair_start, \
                                        boys_table, dipole_origin_z, origin_rate, out, stream);
  switch (lmax) {
    TUNA_ONE_ELECTRON_DERIV_CASE(0)
    TUNA_ONE_ELECTRON_DERIV_CASE(1)
    TUNA_ONE_ELECTRON_DERIV_CASE(2)
    TUNA_ONE_ELECTRON_DERIV_CASE(3)
    default:
      return cudaErrorInvalidValue;
  }
#undef TUNA_ONE_ELECTRON_DERIV_CASE
}
