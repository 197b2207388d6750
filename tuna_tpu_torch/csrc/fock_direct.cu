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
// What bounds it on an H100: the same quartet arithmetic as K1
// (quartet.cuh), bound by latency and load balance rather than bytes or
// FLOPs, plus at most ten float64 atomics per AO-pair quartet into J_pair
// and K; P (N^2 doubles, 39 KB at N2/cc-pVTZ) stays in L1/L2.
//
// Design, on K1's engine (csrc/quartet.cuh):
//   * pair_rows_kernel builds the per-primitive-pair rows;
//   * one kernel a class (L_bra, L_ket) and part, up to (10, 10) (lmax 5;
//     the classes of L_bra = 7..10 in quartet_l7.cu .. quartet_l10.cu),
//     over the work list of parity-matched unordered AO-pair quartets;
//     each quartet's value (quartet.cuh FockOut)
//     v = (ij|kl) is added in both orientations, (ij|kl) and, when the two
//     pairs differ, (kl|ij):
//       J_pair[P] += v P_kl (2 if k != l), and the mirror term;
//       K at the up to four dense positions of tuna_tpu's accumulate
//       (integrals.py:788-797), with its masks for i = j and k = l;
//     by double atomicAdd.  The sums therefore run in an order that changes
//     from call to call: two calls on the same input agree to rounding, not
//     bitwise.
//   * fock_unpack_kernel writes J symmetrically from J_pair, as _fock_unpack
//     does.
#include <cuda_runtime.h>

#include "quartet.cuh"

namespace {

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

}  // namespace

// quartets, classes and boys_tables as for tuna_eri_packed (eri.cu).
extern "C" int tuna_fock_direct(int lmax, int n_pairs, int n_prim_pairs, int n_basis,
                                const double* coords, const double* a, const double* b,
                                const double* coef, const int* l1, const int* l2,
                                const int* atom1, const int* atom2, const int* pair_start,
                                const int* pid_i, const int* pid_j, const int* quartets,
                                int n_classes, const int* classes, const double* boys_tables,
                                const double* P, double* rows, double* J_pair, double* J,
                                double* K, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(J_pair, 0, sizeof(double) * n_pairs, stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(K, 0, sizeof(double) * n_basis * n_basis, stream);
  }
  if (err == cudaSuccess) {
    err = launch_pair_rows(lmax, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2, rows,
                           stream);
  }
  if (err != cudaSuccess) return err;
  const QuartetPart part{reinterpret_cast<const int2*>(quartets), 0, pair_start, rows,
                         2 * lmax + 1, boys_tables};
  err = launch_work_list(n_classes, reinterpret_cast<const ClassPart*>(classes), part,
                         tuna_quartet::FockOut{n_basis, pid_i, pid_j, P, J_pair, K}, stream);
  if (err != cudaSuccess || n_pairs == 0) return err;
  fock_unpack_kernel<<<(n_pairs + kQuartetThreads - 1) / kQuartetThreads, kQuartetThreads, 0,
                       stream>>>(n_pairs, n_basis, pid_i, pid_j, J_pair, J);
  return cudaGetLastError();
}
