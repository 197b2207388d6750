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
//   * one kernel a class (L_bra, L_ket) and part, over the work list of
//     parity-matched unordered AO-pair quartets; each quartet's value
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

struct FockOut {
  int n_basis;
  const int* pid_i;
  const int* pid_j;
  const double* P;
  double* J_pair;
  double* K;

  __device__ __forceinline__ void operator()(double v, int A, int B) const {
    const int i = pid_i[A], j = pid_j[A], k = pid_i[B], l = pid_j[B];
    add_orientation(v, A, i, j, k, l, n_basis, P, J_pair, K);
    if (A != B) add_orientation(v, B, k, l, i, j, n_basis, P, J_pair, K);
  }
};

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
                         FockOut{n_basis, pid_i, pid_j, P, J_pair, K}, stream);
  if (err != cudaSuccess || n_pairs == 0) return err;
  fock_unpack_kernel<<<(n_pairs + kQuartetThreads - 1) / kQuartetThreads, kQuartetThreads, 0,
                       stream>>>(n_pairs, n_basis, pid_i, pid_j, J_pair, J);
  return cudaGetLastError();
}
