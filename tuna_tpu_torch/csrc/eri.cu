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
//   * pair_rows_kernel (quartet.cuh): one thread per primitive pair builds
//     its three Hermite rows E_t (x, y, z), p, P_z and the coefficient once,
//     so the quartet loop only reads them;
//   * eri_packed_kernel: one thread per unordered AO-pair quartet (P >= Q).
//     It writes 0 at once when the pairs' x or y Hermite parities differ
//     (those quartets vanish for molecules on the z axis), else takes the
//     contracted value from quartet.cuh::quartet_value, which loops over the
//     primitive pairs of P and of Q (contiguous per AO pair, CSR offsets),
//     evaluates Boys from the Taylor table in shared memory, builds the z
//     Hermite Coulomb table in registers and contracts.  It writes
//     packed[P,Q] and packed[Q,P] itself: deterministic, no atomics, every
//     entry written.
//   * Templated on LMAX so every Hermite loop unrolls into registers.
#include <cuda_runtime.h>

#include "quartet.cuh"

namespace {

template <int LMAX>
__global__ void __launch_bounds__(kQuartetThreads)
eri_packed_kernel(int n_pairs, const int* __restrict__ l1, const int* __restrict__ l2,
                  const int* __restrict__ pair_start, const double* __restrict__ rows,
                  const double* __restrict__ boys_table, double* __restrict__ packed) {
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  tuna::load_boys_table(tab, boys_table);

  const long long n_quartets = static_cast<long long>(n_pairs) * (n_pairs + 1) / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_quartets) return;
  int P, Q;
  unpack_triangle(idx, P, Q);

  const int r0 = pair_start[P], c0 = pair_start[Q];
  const double sum = same_xy_parity(l1, l2, r0, c0)
                         ? quartet_value<LMAX>(r0, pair_start[P + 1], c0, pair_start[Q + 1],
                                               rows, tab)
                         : 0.0;
  packed[static_cast<size_t>(P) * n_pairs + Q] = sum;
  packed[static_cast<size_t>(Q) * n_pairs + P] = sum;
}

template <int LMAX>
cudaError_t launch_eri(int n_pairs, int n_prim_pairs, const double* coords, const double* a,
                       const double* b, const double* coef, const int* l1, const int* l2,
                       const int* atom1, const int* atom2, const int* pair_start,
                       const double* boys_table, double* rows, double* packed,
                       cudaStream_t stream) {
  cudaError_t err = launch_pair_rows<LMAX>(n_prim_pairs, coords, a, b, coef, l1, l2, atom1,
                                           atom2, rows, stream);
  if (err != cudaSuccess) return err;
  const long long n_quartets = static_cast<long long>(n_pairs) * (n_pairs + 1) / 2;
  if (n_quartets > 0) {
    const long long blocks = (n_quartets + kQuartetThreads - 1) / kQuartetThreads;
    eri_packed_kernel<LMAX><<<static_cast<unsigned>(blocks), kQuartetThreads, 0, stream>>>(
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
