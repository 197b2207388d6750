// The contracted value of one unordered AO-pair quartet (PQ), shared by the
// packed ERI sweep (K1, eri.cu) and the direct Fock build (K4,
// fock_direct.cu), so the two kernels cannot drift.
//
// Both work from per-primitive-pair rows that pair_rows_kernel builds once
// (the three Hermite rows E_t of x, y and z, p, P_z and the contraction
// coefficient), and both visit the unordered AO-pair quartets P >= Q, one
// thread each, skipping the quartets whose x or y Hermite parities differ:
// those vanish for molecules on the z axis (the rule of
// tuna_tpu/ops/integrals.py:226-239).
//
// Everything here has internal linkage: each translation unit that includes
// the header gets its own copy of the kernel.
#pragma once

#include <cuda_runtime.h>

#include "boys.cuh"
#include "hermite.cuh"

namespace {

constexpr double kTwoPiPow2_5 = 34.986836655249725;  // 2 pi^(5/2)
constexpr int kQuartetThreads = 128;

template <int LMAX>
struct EriShape {
  static constexpr int TL = 2 * LMAX + 1;   // Hermite orders per pair and axis
  static constexpr int RS = 3 * TL + 3;     // row: Ex, Ey, Ez, p, Pz, coef
  static constexpr int NMAX = 4 * LMAX;     // Boys order per quartet
};

template <int LMAX>
__global__ void __launch_bounds__(kQuartetThreads)
pair_rows_kernel(int n_prim_pairs, const double* __restrict__ coords,
                 const double* __restrict__ a, const double* __restrict__ b,
                 const double* __restrict__ coef, const int* __restrict__ l1,
                 const int* __restrict__ l2, const int* __restrict__ atom1,
                 const int* __restrict__ atom2, double* __restrict__ rows) {
  using S = EriShape<LMAX>;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_prim_pairs) return;
  const double* A = coords + 3 * atom1[k];
  const double* B = coords + 3 * atom2[k];
  const double ak = a[k], bk = b[k];
  double* out = rows + static_cast<size_t>(k) * S::RS;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    double e[S::TL];
    tuna::hermite_row(l1[3 * k + axis], l2[3 * k + axis], ak, bk, A[axis] - B[axis], e);
#pragma unroll
    for (int t = 0; t < S::TL; ++t) out[axis * S::TL + t] = e[t];
  }
  const double p = ak + bk;
  out[3 * S::TL] = p;
  out[3 * S::TL + 1] = (ak * A[2] + bk * B[2]) / p;
  out[3 * S::TL + 2] = coef[k];
}

// Launches pair_rows_kernel over every primitive pair.
template <int LMAX>
cudaError_t launch_pair_rows(int n_prim_pairs, const double* coords, const double* a,
                             const double* b, const double* coef, const int* l1, const int* l2,
                             const int* atom1, const int* atom2, double* rows,
                             cudaStream_t stream) {
  if (n_prim_pairs <= 0) return cudaSuccess;
  const int blocks = (n_prim_pairs + kQuartetThreads - 1) / kQuartetThreads;
  pair_rows_kernel<LMAX><<<blocks, kQuartetThreads, 0, stream>>>(n_prim_pairs, coords, a, b,
                                                                 coef, l1, l2, atom1, atom2, rows);
  return cudaGetLastError();
}

// Index of the lower triangle (P >= Q) -> (P, Q), row by row.
__device__ __forceinline__ void unpack_triangle(long long idx, int& P, int& Q) {
  long long p = static_cast<long long>((sqrt(8.0 * static_cast<double>(idx) + 1.0) - 1.0) * 0.5);
  while (p * (p + 1) / 2 > idx) --p;
  while ((p + 1) * (p + 2) / 2 <= idx) ++p;
  P = static_cast<int>(p);
  Q = static_cast<int>(idx - p * (p + 1) / 2);
}

// Whether the AO pairs whose first primitive pairs are r0 and c0 have the
// same x and the same y Hermite parity (all primitive pairs of an AO pair
// share its angular momenta).
__device__ __forceinline__ bool same_xy_parity(const int* __restrict__ l1,
                                               const int* __restrict__ l2, int r0, int c0) {
  return ((l1[3 * r0] + l2[3 * r0]) & 1) == ((l1[3 * c0] + l2[3 * c0]) & 1) &&
         ((l1[3 * r0 + 1] + l2[3 * r0 + 1]) & 1) == ((l1[3 * c0 + 1] + l2[3 * c0 + 1]) & 1);
}

// (PQ) = sum over the primitive pairs r0..r1-1 of P and c0..c1-1 of Q of
// the primitive quartet values: Boys from the Taylor table `tab` (shared
// memory), the z Hermite Coulomb table in registers.  The caller has
// checked same_xy_parity.
template <int LMAX>
__device__ __forceinline__ double quartet_value(int r0, int r1, int c0, int c1,
                                                const double* __restrict__ rows,
                                                const double* __restrict__ tab) {
  using S = EriShape<LMAX>;
  constexpr int TL = S::TL, NMAX = S::NMAX, MX = 2 * LMAX;
  double sum = 0.0;
  for (int r = r0; r < r1; ++r) {
    const double* R = rows + static_cast<size_t>(r) * S::RS;
    double ex[TL], ey[TL], ez[TL];
#pragma unroll
    for (int t = 0; t < TL; ++t) {
      ex[t] = R[t];
      ey[t] = R[TL + t];
      ez[t] = R[2 * TL + t];
    }
    const double p = R[3 * TL], Pz = R[3 * TL + 1], coef_r = R[3 * TL + 2];
    for (int c = c0; c < c1; ++c) {
      const double* C = rows + static_cast<size_t>(c) * S::RS;
      // x and y: even total orders 2m only (matching parities), with the
      // ket's (-1)^u sign and the (2m - 1)!! weight of R_{TUV} on an axis
      // of zero separation.
      double gx[MX + 1], gy[MX + 1], gz[NMAX + 1], axy[NMAX + 1];
#pragma unroll
      for (int m = 0; m <= MX; ++m) gx[m] = gy[m] = 0.0;
#pragma unroll
      for (int n = 0; n <= NMAX; ++n) gz[n] = axy[n] = 0.0;
#pragma unroll
      for (int t = 0; t < TL; ++t) {
#pragma unroll
        for (int u = 0; u < TL; ++u) {
          const double sign = (u & 1) ? -1.0 : 1.0;
          gz[t + u] += ez[t] * sign * C[2 * TL + u];
          if (((t + u) & 1) == 0) {
            gx[(t + u) / 2] += ex[t] * sign * C[u];
            gy[(t + u) / 2] += ey[t] * sign * C[TL + u];
          }
        }
      }
#pragma unroll
      for (int mx = 0; mx <= MX; ++mx) {
#pragma unroll
        for (int my = 0; my <= MX; ++my) {
          axy[mx + my] += gx[mx] * tuna::odd_double_factorial(mx) * gy[my] *
                          tuna::odd_double_factorial(my);
        }
      }
      const double q = C[3 * TL], Qz = C[3 * TL + 1], coef_c = C[3 * TL + 2];
      const double psum = p + q;
      const double alpha = p * q / psum;
      const double PQz = Pz - Qz;
      double F[NMAX + 1];
      tuna::boys_eval<NMAX>(alpha * PQz * PQz, tab, F);
      const double value = tuna::hermite_coulomb<NMAX, NMAX>(F, alpha, PQz, gz, axy);
      sum += coef_r * coef_c * kTwoPiPow2_5 / (p * q * sqrt(psum)) * value;
    }
  }
  return sum;
}

}  // namespace
