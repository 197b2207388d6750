// K1: packed electron repulsion integrals (ij|kl) over AO pairs.
//
// Replaces tuna_tpu/ops/integrals.py::IntegralPlan._sweep_blocks (with its
// inner block_values), _pair_data, build_E_table, build_scaled_Rz_table and
// ops/boys.py::boys_table, accumulated by _eri_sweep/_eri_pair_impl into the
// packed (n_pairs, n_pairs) matrix.  The N^4 expansion and the spherical
// transform stay torch indexing and tensordot (ops/integrals.py).
//
// What bounds it on an H100: neither bytes nor FLOPs.  N2/6-311G has 351 AO
// pairs and 1432 primitive pairs, so the sweep is ~1e6 primitive quartets
// of a few hundred float64 operations each (~0.5 GFLOP, microseconds at the
// card's FP64 rate), reading a few KB of per-pair data that stays in L1/L2.
// It is bound by latency and load imbalance: 61,776 unordered AO-pair
// quartets are ~1,900 warps, and one quartet's primitive loop runs from 1
// to 1,296 iterations.
//
// Design, against the TPU version's dense (T, T) tiles of one parity class:
//   * pair_rows_kernel: one thread per primitive pair builds its three
//     Hermite rows E_t (x, y, z), p, P_z and the coefficient once, so the
//     quartet loop only reads them;
//   * eri_packed_kernel: one thread per unordered AO-pair quartet (P >= Q).
//     It returns 0 at once when the pairs' x or y Hermite parities differ
//     (those quartets vanish for molecules on the z axis, the rule of
//     integrals.py:226-239), else loops over the primitive pairs of P and
//     of Q (contiguous per AO pair, CSR offsets), evaluates Boys from the
//     Taylor table in shared memory, builds the z Hermite Coulomb table in
//     registers and contracts.  It writes packed[P,Q] and packed[Q,P]
//     itself: deterministic, no atomics, every entry written.
//   * Templated on LMAX so every Hermite loop unrolls into registers.
#include <cuda_runtime.h>

#include "boys.cuh"
#include "hermite.cuh"

namespace {

constexpr double kTwoPiPow2_5 = 34.986836655249725;  // 2 pi^(5/2)
constexpr int kThreads = 128;

template <int LMAX>
struct EriShape {
  static constexpr int TL = 2 * LMAX + 1;   // Hermite orders per pair and axis
  static constexpr int RS = 3 * TL + 3;     // row: Ex, Ey, Ez, p, Pz, coef
  static constexpr int NMAX = 4 * LMAX;     // Boys order per quartet
};

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
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

__device__ __forceinline__ void unpack_triangle(long long idx, int& P, int& Q) {
  long long p = static_cast<long long>((sqrt(8.0 * static_cast<double>(idx) + 1.0) - 1.0) * 0.5);
  while (p * (p + 1) / 2 > idx) --p;
  while ((p + 1) * (p + 2) / 2 <= idx) ++p;
  P = static_cast<int>(p);
  Q = static_cast<int>(idx - p * (p + 1) / 2);
}

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
eri_packed_kernel(int n_pairs, const int* __restrict__ l1, const int* __restrict__ l2,
                  const int* __restrict__ pair_start, const double* __restrict__ rows,
                  const double* __restrict__ boys_table, double* __restrict__ packed) {
  using S = EriShape<LMAX>;
  constexpr int TL = S::TL, NMAX = S::NMAX, MX = 2 * LMAX;
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  tuna::load_boys_table(tab, boys_table);

  const long long n_quartets = static_cast<long long>(n_pairs) * (n_pairs + 1) / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_quartets) return;
  int P, Q;
  unpack_triangle(idx, P, Q);

  const int r0 = pair_start[P], r1 = pair_start[P + 1];
  const int c0 = pair_start[Q], c1 = pair_start[Q + 1];
  const bool same_parity = ((l1[3 * r0] + l2[3 * r0]) & 1) == ((l1[3 * c0] + l2[3 * c0]) & 1) &&
                           ((l1[3 * r0 + 1] + l2[3 * r0 + 1]) & 1) ==
                               ((l1[3 * c0 + 1] + l2[3 * c0 + 1]) & 1);
  double sum = 0.0;
  if (same_parity) {
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
  }
  packed[static_cast<size_t>(P) * n_pairs + Q] = sum;
  packed[static_cast<size_t>(Q) * n_pairs + P] = sum;
}

template <int LMAX>
cudaError_t launch_eri(int n_pairs, int n_prim_pairs, const double* coords, const double* a,
                       const double* b, const double* coef, const int* l1, const int* l2,
                       const int* atom1, const int* atom2, const int* pair_start,
                       const double* boys_table, double* rows, double* packed,
                       cudaStream_t stream) {
  if (n_prim_pairs > 0) {
    const int blocks = (n_prim_pairs + kThreads - 1) / kThreads;
    pair_rows_kernel<LMAX><<<blocks, kThreads, 0, stream>>>(n_prim_pairs, coords, a, b, coef,
                                                            l1, l2, atom1, atom2, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n_quartets = static_cast<long long>(n_pairs) * (n_pairs + 1) / 2;
  if (n_quartets > 0) {
    const long long blocks = (n_quartets + kThreads - 1) / kThreads;
    eri_packed_kernel<LMAX><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        n_pairs, l1, l2, pair_start, rows, boys_table, packed);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tuna_eri_packed(int lmax, int n_atoms, int n_pairs, int n_prim_pairs,
                               const double* coords, const double* a, const double* b,
                               const double* coef, const int* l1, const int* l2,
                               const int* atom1, const int* atom2, const int* pair_start,
                               const double* boys_table, double* rows, double* packed,
                               cudaStream_t stream) {
  (void)n_atoms;
  switch (lmax) {
    case 0:
      return launch_eri<0>(n_pairs, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2,
                           pair_start, boys_table, rows, packed, stream);
    case 1:
      return launch_eri<1>(n_pairs, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2,
                           pair_start, boys_table, rows, packed, stream);
    case 2:
      return launch_eri<2>(n_pairs, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2,
                           pair_start, boys_table, rows, packed, stream);
    case 3:
      return launch_eri<3>(n_pairs, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2,
                           pair_start, boys_table, rows, packed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* tuna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
