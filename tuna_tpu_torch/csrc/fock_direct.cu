// K4: the direct Fock build.  J_ij = sum_kl (ij|kl) P_kl and
// K_ij = sum_kl (il|kj) P_kl for a symmetric Cartesian density P,
// contracted as the quartet values are generated; the N^4 tensor and the
// packed pair matrix are never stored.
//
// Replaces tuna_tpu/ops/integrals.py::IntegralPlan._fock_sweep (its
// accumulate and block_body), _fock_unpack and _fock_direct_impl, the
// integral-direct SCF's J/K build (DIRECT keyword), run once per SCF
// iteration.
//
// What bounds it on an H100: the same arithmetic as K1 (quartet.cuh), which
// is bound by latency and load imbalance rather than bytes or FLOPs: one
// AO-pair quartet runs from 1 to 1,296 primitive quartets.  The J/K terms
// add at most ten float64 atomics per AO-pair quartet; P (N^2 doubles, 39 KB
// at N2/cc-pVTZ) is read from global memory and stays in L1/L2.
//
// Design, on K1's layout:
//   * pair_rows_kernel (quartet.cuh) builds the per-primitive-pair rows;
//   * fock_direct_kernel: one thread per unordered AO-pair quartet
//     P = (ij) >= Q = (kl), i >= j, k >= l, with K1's x/y parity skip.  It
//     takes v = (ij|kl) from quartet.cuh::quartet_value, once, then adds
//     both orientations, (ij|kl) and, when P != Q, (kl|ij):
//       J_pair[P] += v P_kl (2 if k != l), and the mirror term;
//       K at the up to four dense positions of tuna_tpu's accumulate
//       (integrals.py:788-797), with its masks for i = j and k = l;
//     by double atomicAdd.  The sums therefore run in an order that changes
//     from call to call: two calls on the same input agree to rounding, not
//     bitwise.
//   * fock_unpack_kernel writes J symmetrically from J_pair, as _fock_unpack
//     does.
//   * Templated on LMAX 0-3 like K1.
#include <cuda_runtime.h>

#include "quartet.cuh"

namespace {

// Adds the orientation (ij|kl) of value v: rows "ij" = AO pair pid_ij, cols
// "kl".  K[m,n] += (ms|tn) P[t,s] over (m,s) in {(i,j),(j,i)} and (t,n) in
// {(k,l),(l,k)}, the degenerate options left out.
__device__ __forceinline__ void add_orientation(double v, int pid_ij, int i, int j, int k, int l,
                                                int n, const double* __restrict__ P,
                                                double* __restrict__ J_pair,
                                                double* __restrict__ K) {
  const bool m_ij = i != j, m_kl = k != l;
  atomicAdd(J_pair + pid_ij, v * P[k * n + l] * (m_kl ? 2.0 : 1.0));
  atomicAdd(K + i * n + l, v * P[k * n + j]);
  if (m_kl) atomicAdd(K + i * n + k, v * P[l * n + j]);
  if (m_ij) {
    atomicAdd(K + j * n + l, v * P[k * n + i]);
    if (m_kl) atomicAdd(K + j * n + k, v * P[l * n + i]);
  }
}

template <int LMAX>
__global__ void __launch_bounds__(kQuartetThreads)
fock_direct_kernel(int n_pairs, int n_basis, const int* __restrict__ l1,
                   const int* __restrict__ l2, const int* __restrict__ pair_start,
                   const int* __restrict__ pid_i, const int* __restrict__ pid_j,
                   const double* __restrict__ rows, const double* __restrict__ boys_table,
                   const double* __restrict__ P, double* __restrict__ J_pair,
                   double* __restrict__ K) {
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  tuna::load_boys_table(tab, boys_table);

  const long long n_quartets = static_cast<long long>(n_pairs) * (n_pairs + 1) / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_quartets) return;
  int A, B;
  unpack_triangle(idx, A, B);
  const int r0 = pair_start[A], c0 = pair_start[B];
  if (!same_xy_parity(l1, l2, r0, c0)) return;
  const double v =
      quartet_value<LMAX>(r0, pair_start[A + 1], c0, pair_start[B + 1], rows, tab);
  const int i = pid_i[A], j = pid_j[A], k = pid_i[B], l = pid_j[B];
  add_orientation(v, A, i, j, k, l, n_basis, P, J_pair, K);
  if (A != B) add_orientation(v, B, k, l, i, j, n_basis, P, J_pair, K);
}

__global__ void __launch_bounds__(kQuartetThreads)
fock_unpack_kernel(int n_pairs, int n_basis, const int* __restrict__ pid_i,
                   const int* __restrict__ pid_j, const double* __restrict__ J_pair,
                   double* __restrict__ J) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int i = pid_i[p], j = pid_j[p];
  J[i * n_basis + j] = J_pair[p];
  J[j * n_basis + i] = J_pair[p];
}

template <int LMAX>
cudaError_t launch_fock(int n_pairs, int n_prim_pairs, int n_basis, const double* coords,
                        const double* a, const double* b, const double* coef, const int* l1,
                        const int* l2, const int* atom1, const int* atom2,
                        const int* pair_start, const int* pid_i, const int* pid_j,
                        const double* boys_table, const double* P, double* rows,
                        double* J_pair, double* J, double* K, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(J_pair, 0, sizeof(double) * n_pairs, stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(K, 0, sizeof(double) * n_basis * n_basis, stream);
  }
  if (err == cudaSuccess) {
    err = launch_pair_rows<LMAX>(n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2, rows,
                                 stream);
  }
  if (err != cudaSuccess) return err;
  const long long n_quartets = static_cast<long long>(n_pairs) * (n_pairs + 1) / 2;
  if (n_quartets > 0) {
    const long long blocks = (n_quartets + kQuartetThreads - 1) / kQuartetThreads;
    fock_direct_kernel<LMAX><<<static_cast<unsigned>(blocks), kQuartetThreads, 0, stream>>>(
        n_pairs, n_basis, l1, l2, pair_start, pid_i, pid_j, rows, boys_table, P, J_pair, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fock_unpack_kernel<<<(n_pairs + kQuartetThreads - 1) / kQuartetThreads, kQuartetThreads, 0,
                         stream>>>(n_pairs, n_basis, pid_i, pid_j, J_pair, J);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tuna_fock_direct(int lmax, int n_pairs, int n_prim_pairs, int n_basis,
                                const double* coords, const double* a, const double* b,
                                const double* coef, const int* l1, const int* l2,
                                const int* atom1, const int* atom2, const int* pair_start,
                                const int* pid_i, const int* pid_j, const double* boys_table,
                                const double* P, double* rows, double* J_pair, double* J,
                                double* K, cudaStream_t stream) {
  switch (lmax) {
    case 0:
      return launch_fock<0>(n_pairs, n_prim_pairs, n_basis, coords, a, b, coef, l1, l2, atom1,
                            atom2, pair_start, pid_i, pid_j, boys_table, P, rows, J_pair, J, K,
                            stream);
    case 1:
      return launch_fock<1>(n_pairs, n_prim_pairs, n_basis, coords, a, b, coef, l1, l2, atom1,
                            atom2, pair_start, pid_i, pid_j, boys_table, P, rows, J_pair, J, K,
                            stream);
    case 2:
      return launch_fock<2>(n_pairs, n_prim_pairs, n_basis, coords, a, b, coef, l1, l2, atom1,
                            atom2, pair_start, pid_i, pid_j, boys_table, P, rows, J_pair, J, K,
                            stream);
    case 3:
      return launch_fock<3>(n_pairs, n_prim_pairs, n_basis, coords, a, b, coef, l1, l2, atom1,
                            atom2, pair_start, pid_i, pid_j, boys_table, P, rows, J_pair, J, K,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}
