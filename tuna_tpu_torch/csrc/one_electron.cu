// K3: one-electron integrals S, T, V_NE, D (3) and Q (3) over AO pairs.
//
// Replaces tuna_tpu/ops/integrals.py::IntegralPlan._one_electron_impl:
// per-primitive-pair overlap, kinetic, nuclear attraction (Boys and the
// z-axis Hermite Coulomb table per atom), dipole and diagonal quadrupole,
// scatter-added into N x N matrices.
//
// What bounds it on an H100: size.  N2/6-311G has 351 AO pairs and 1432
// primitive pairs, so the whole job is ~10^5 float64 operations and ~70 KB
// of output; one launch is latency, not bandwidth or arithmetic.
//
// Design: one thread per AO pair (i >= j) loops over its primitive pairs
// (contiguous per AO pair, CSR offsets) and, for V_NE, over the atoms.  The
// Hermite rows come from the same recursion as the ERI kernel (hermite.cuh),
// run up to j + 2 for the kinetic and quadrupole terms; Boys comes from
// boys.cuh with its Taylor table in shared memory.  The thread sums its
// primitive pairs in registers and writes all nine matrices at [i, j] and
// [j, i] itself: deterministic, no atomics, every entry written once.
#include <cuda_runtime.h>

#include "boys.cuh"
#include "hermite.cuh"

namespace {

constexpr double kPiPow1_5 = 5.568327996831708;  // pi^(3/2)
constexpr double kTwoPi = 6.283185307179586;
constexpr int kThreads = 128;

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
one_electron_kernel(int n_atoms, int n_basis, int n_pairs, const double* __restrict__ coords,
                    const double* __restrict__ charges, const double* __restrict__ a,
                    const double* __restrict__ b, const double* __restrict__ coef,
                    const int* __restrict__ l1, const int* __restrict__ l2,
                    const int* __restrict__ atom1, const int* __restrict__ atom2,
                    const int* __restrict__ ao_i, const int* __restrict__ ao_j,
                    const int* __restrict__ pair_start, const double* __restrict__ boys_table,
                    double dipole_origin_z, double* __restrict__ out) {
  constexpr int TL = 2 * LMAX + 1;   // Hermite orders of one pair and axis
  constexpr int LEN = 2 * LMAX + 3;  // up to j + 2 for kinetic/quadrupole
  constexpr int NMAX = 2 * LMAX;     // Boys order per pair
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
    const double inv2p = 0.5 / p;
    const double prefactor = coef[k] * kPiPow1_5 / (p * sqrt(p));

    double S[3], T[3], D[3], Q[3];
    double rows[3][TL];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      const int i = l1[3 * k + axis], j = l2[3 * k + axis];
      const double AB = A[axis] - B[axis];
      const double x_pa = -(bk / p) * AB;
      const double x_pb = (ak / p) * AB;
      double e[LEN];
      tuna::hermite_start(e, ak, bk, AB);
      for (int s = 0; s < i; ++s) tuna::hermite_raise(e, inv2p, x_pa);
      double s_minus2 = 0.0, e0 = 0.0, e1 = 0.0, e2 = 0.0;
      for (int s = 0; s <= j + 2; ++s) {
        if (s == j - 2) s_minus2 = e[0];
        if (s == j) {
          e0 = e[0];
          e1 = e[1];
          e2 = e[2];
#pragma unroll
          for (int t = 0; t < TL; ++t) rows[axis][t] = e[t];
        }
        if (s < j + 2) tuna::hermite_raise(e, inv2p, x_pb);
      }
      const double s_plus2 = e[0];
      const double Pc = (ak * A[axis] + bk * B[axis]) / p - (axis == 2 ? dipole_origin_z : 0.0);
      S[axis] = e0;
      T[axis] = (2 * j + 1) * bk * e0 - 2.0 * bk * bk * s_plus2 - 0.5 * (j * (j - 1)) * s_minus2;
      D[axis] = e1 + Pc * e0;
      Q[axis] = 2.0 * e2 + 2.0 * Pc * e1 + (Pc * Pc + inv2p) * e0;
    }
    s_sum += prefactor * S[0] * S[1] * S[2];
    t_sum += prefactor * (T[0] * S[1] * S[2] + S[0] * T[1] * S[2] + S[0] * S[1] * T[2]);
    d_sum[0] += prefactor * D[0] * S[1] * S[2];
    d_sum[1] += prefactor * S[0] * D[1] * S[2];
    d_sum[2] += prefactor * S[0] * S[1] * D[2];
    q_sum[0] += prefactor * Q[0] * S[1] * S[2];
    q_sum[1] += prefactor * S[0] * Q[1] * S[2];
    q_sum[2] += prefactor * S[0] * S[1] * Q[2];

    // Nuclear attraction: x and y contribute only even Hermite orders 2m
    // (zero separation), weighted by (2m - 1)!!; z runs over all orders.
    double axy[NMAX + 1], gz[NMAX + 1];
#pragma unroll
    for (int n = 0; n <= NMAX; ++n) {
      axy[n] = 0.0;
      gz[n] = rows[2][n];
    }
#pragma unroll
    for (int mx = 0; 2 * mx < TL; ++mx) {
#pragma unroll
      for (int my = 0; 2 * my < TL; ++my) {
        if (mx + my <= NMAX) {
          axy[mx + my] += rows[0][2 * mx] * tuna::odd_double_factorial(mx) * rows[1][2 * my] *
                          tuna::odd_double_factorial(my);
        }
      }
    }
    const double Pz = (ak * A[2] + bk * B[2]) / p;
    double v_pair = 0.0;
    for (int atom = 0; atom < n_atoms; ++atom) {
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
cudaError_t launch_one_electron(int n_atoms, int n_basis, int n_pairs, const double* coords,
                                const double* charges, const double* a, const double* b,
                                const double* coef, const int* l1, const int* l2,
                                const int* atom1, const int* atom2, const int* ao_i,
                                const int* ao_j, const int* pair_start,
                                const double* boys_table, double dipole_origin_z, double* out,
                                cudaStream_t stream) {
  if (n_pairs > 0) {
    const int blocks = (n_pairs + kThreads - 1) / kThreads;
    one_electron_kernel<LMAX><<<blocks, kThreads, 0, stream>>>(
        n_atoms, n_basis, n_pairs, coords, charges, a, b, coef, l1, l2, atom1, atom2, ao_i,
        ao_j, pair_start, boys_table, dipole_origin_z, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tuna_one_electron(int lmax, int n_atoms, int n_basis, int n_pairs,
                                 const double* coords, const double* charges, const double* a,
                                 const double* b, const double* coef, const int* l1,
                                 const int* l2, const int* atom1, const int* atom2,
                                 const int* ao_i, const int* ao_j, const int* pair_start,
                                 const double* boys_table, double dipole_origin_z, double* out,
                                 cudaStream_t stream) {
#define TUNA_ONE_ELECTRON_CASE(L)                                                            \
  case L:                                                                                    \
    return launch_one_electron<L>(n_atoms, n_basis, n_pairs, coords, charges, a, b, coef, \
                                  l1, l2, atom1, atom2, ao_i, ao_j, pair_start, boys_table, \
                                  dipole_origin_z, out, stream);
  switch (lmax) {
    TUNA_ONE_ELECTRON_CASE(0)
    TUNA_ONE_ELECTRON_CASE(1)
    TUNA_ONE_ELECTRON_CASE(2)
    TUNA_ONE_ELECTRON_CASE(3)
    default:
      return cudaErrorInvalidValue;
  }
#undef TUNA_ONE_ELECTRON_CASE
}
