// K3: one-electron integrals S, T, V_NE, D (3) and Q (3) over AO pairs.
//
// Replaces tuna_tpu/ops/integrals.py::IntegralPlan._one_electron_impl:
// per-primitive-pair overlap, kinetic, nuclear attraction (Boys and the
// z-axis Hermite Coulomb table per atom), dipole and diagonal quadrupole,
// scatter-added into N x N matrices.
//
// What bounds it on an H100: latency.  N2/6-311G has 351 AO pairs and 1432
// primitive pairs, N2/cc-pVTZ 2485 and 6235, so the whole job is 10^5-10^6
// float64 operations and 70 KB-2.8 MB of output, nothing against the card's
// rates: a launch lasts as long as its longest chain of dependent
// arithmetic.  The first form took one thread an AO pair, which
// walked its primitive pairs serially: a launch lasted as long as the
// longest AO pair (36 primitive pairs at 6-311G, 64 at cc-pVTZ, where the
// median is 1), about 3-4.5 us an iteration, on 3 blocks at 6-311G.
//
// Design: a lane schedule built on the host once per basis (ops/
// integrals.py::IntegralPlan.lane_schedule) gives each AO pair a group of
// w lanes of one warp, w the smallest power of two that covers its
// primitive pairs, at most 32; the AO pairs come longest first, so the
// lanes of a warp do about equal work, and a group starts at a lane that is
// a multiple of its width.  Lane r of a group takes the primitive pairs k0
// + r, k0 + r + w, ... (CSR offsets per AO pair) and, for V_NE, every atom
// (n_atoms <= 2), summing the nine values in registers.  The Hermite rows
// come from the same recursion as the ERI kernel (hermite.cuh), run up to j
// + 2 for the kinetic and quadrupole terms; Boys from boys.cuh with its
// Taylor table read through L1.  Then each value goes through five
// __shfl_xor_sync butterflies (lanes 1, 2, 4, 8, 16 apart; a step adds only
// inside a group of that width), in a fixed order, and lane 0 of the group
// writes all nine matrices at [i, j] and [j, i] (lane_sums.cuh, shared with
// K8a): deterministic, no atomics, every entry written once.  Measured
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.006-0.013 ms a
// launch from N2/STO-3G to N2/cc-pVTZ, where the longest chain is 2
// primitive pairs a lane; the Boys table staged in each block's shared
// memory (24 KB a block, read once) took 0.010-0.016, so it is read
// through L1; 118-158 registers, no stack frame (lmax 0-3).  Instantiated
// for lmax 0-5 (h shells: Hermite rows of 11 orders, Boys order 10).
#include <cuda_runtime.h>

#include "boys.cuh"
#include "hermite.cuh"
#include "lane_sums.cuh"

namespace {

constexpr double kPiPow1_5 = 5.568327996831708;  // pi^(3/2)
constexpr double kTwoPi = 6.283185307179586;
constexpr int kThreads = 128;

// The nine values of primitive pair k, added to sums: S, T, V, D (3), Q (3).
template <int LMAX>
__device__ __forceinline__ void primitive_pair(
    int k, int n_atoms, const double* __restrict__ coords, const double* __restrict__ charges,
    const double* __restrict__ a, const double* __restrict__ b, const double* __restrict__ coef,
    const int* __restrict__ l1, const int* __restrict__ l2, const int* __restrict__ atom1,
    const int* __restrict__ atom2, const double* __restrict__ tab, double dipole_origin_z,
    double (&sums)[9]) {
  constexpr int TL = 2 * LMAX + 1;   // Hermite orders of one pair and axis
  constexpr int LEN = 2 * LMAX + 3;  // up to j + 2 for kinetic/quadrupole
  constexpr int NMAX = 2 * LMAX;     // Boys order per pair
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
  sums[0] += prefactor * S[0] * S[1] * S[2];
  sums[1] += prefactor * (T[0] * S[1] * S[2] + S[0] * T[1] * S[2] + S[0] * S[1] * T[2]);
  sums[3] += prefactor * D[0] * S[1] * S[2];
  sums[4] += prefactor * S[0] * D[1] * S[2];
  sums[5] += prefactor * S[0] * S[1] * D[2];
  sums[6] += prefactor * Q[0] * S[1] * S[2];
  sums[7] += prefactor * S[0] * Q[1] * S[2];
  sums[8] += prefactor * S[0] * S[1] * Q[2];

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
  sums[2] += coef[k] * v_pair;
}

// lanes (n_lanes, 2) from IntegralPlan.lane_schedule (lane_sums.cuh).
template <int LMAX>
__global__ void __launch_bounds__(kThreads)
one_electron_kernel(int n_atoms, int n_basis, int n_lanes, const double* __restrict__ coords,
                    const double* __restrict__ charges, const double* __restrict__ a,
                    const double* __restrict__ b, const double* __restrict__ coef,
                    const int* __restrict__ l1, const int* __restrict__ l2,
                    const int* __restrict__ atom1, const int* __restrict__ atom2,
                    const int* __restrict__ ao_i, const int* __restrict__ ao_j,
                    const int* __restrict__ pair_start, const int2* __restrict__ lanes,
                    const double* __restrict__ boys_table, double dipole_origin_z,
                    double* __restrict__ out) {
  tuna::lane_sums<9>(n_lanes, lanes, pair_start, ao_i, ao_j, n_basis, out,
                     [&](int k, double (&sums)[9]) {
                       primitive_pair<LMAX>(k, n_atoms, coords, charges, a, b, coef, l1, l2,
                                            atom1, atom2, boys_table, dipole_origin_z, sums);
                     });
}

}  // namespace

// lanes (n_lanes, 2) int32 from IntegralPlan.lane_schedule, n_lanes a
// multiple of 32.
extern "C" int tuna_one_electron(int lmax, int n_atoms, int n_basis, int n_lanes,
                                 const double* coords, const double* charges, const double* a,
                                 const double* b, const double* coef, const int* l1,
                                 const int* l2, const int* atom1, const int* atom2,
                                 const int* ao_i, const int* ao_j, const int* pair_start,
                                 const int* lanes, const double* boys_table,
                                 double dipole_origin_z, double* out, cudaStream_t stream) {
#define TUNA_ONE_ELECTRON_CASE(L)                                                            \
  case L:                                                                                    \
    return tuna::launch_lanes<kThreads>(                                                     \
        one_electron_kernel<L>, n_lanes, stream, n_atoms, n_basis, n_lanes, coords, charges, \
        a, b, coef, l1, l2, atom1, atom2, ao_i, ao_j, pair_start,                            \
        reinterpret_cast<const int2*>(lanes), boys_table, dipole_origin_z, out);
  switch (lmax) {
    TUNA_ONE_ELECTRON_CASE(0)
    TUNA_ONE_ELECTRON_CASE(1)
    TUNA_ONE_ELECTRON_CASE(2)
    TUNA_ONE_ELECTRON_CASE(3)
    TUNA_ONE_ELECTRON_CASE(4)
    TUNA_ONE_ELECTRON_CASE(5)
    default:
      return cudaErrorInvalidValue;
  }
#undef TUNA_ONE_ELECTRON_CASE
}
