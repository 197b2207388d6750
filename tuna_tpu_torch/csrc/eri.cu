// K1: packed electron repulsion integrals (ij|kl) over AO pairs.
//
// Replaces tuna_tpu/ops/integrals.py::IntegralPlan._sweep_blocks (with its
// inner block_values), _pair_data, build_E_table, build_scaled_Rz_table and
// ops/boys.py::boys_table, accumulated by _eri_sweep/_eri_pair_impl into the
// packed (n_pairs, n_pairs) matrix.  The N^4 expansion and the spherical
// transform stay torch indexing and tensordot (ops/integrals.py).
//
// What bounds it on an H100: neither bytes nor FLOPs.  N2/cc-pVTZ has 2,485
// AO pairs and 808,279 parity-matched unordered AO-pair quartets, 5.8M
// primitive quartets of a few dozen to a few hundred float64 operations
// each at the quartet's own angular momentum (1.2e9 operations, 0.036 ms
// at the card's scalar FP64 rate), reading pair rows that stay in L1/L2;
// writing the 49 MB matrix takes 0.015 ms at 3.35 TB/s.  What is left is
// latency and load balance: one quartet runs 1 to 4,096 primitive
// quartets.
//
// Design (the engine is csrc/quartet.cuh, shared with K4):
//   * the matrix is zeroed once (cudaMemsetAsync): the work list holds only
//     the parity-matched quartets;
//   * pair_rows_kernel builds the per-primitive-pair rows;
//   * one kernel a class (L_bra, L_ket) and part, up to (10, 10) (lmax 5;
//     the classes of L_bra = 7..10 in quartet_l7.cu .. quartet_l10.cu):
//     light quartets one thread each, heavy ones one warp each with a
//     fixed-order reduction; each writes packed[P,Q] and packed[Q,P]
//     itself (quartet.cuh PackedOut), no atomics, so two calls give the
//     same bits.
#include <cuda_runtime.h>

#include "quartet.cuh"

// quartets: (n, 2) int32 on the device; classes: (n_classes, 7) int32 on the
// host (ClassPart rows); boys_tables: the Taylor tables of Boys orders
// 0..4 lmax (and above), one after another; lmax <= 5.
extern "C" int tuna_eri_packed(int lmax, int n_pairs, int n_prim_pairs, const double* coords,
                               const double* a, const double* b, const double* coef,
                               const int* l1, const int* l2, const int* atom1, const int* atom2,
                               const int* pair_start, const int* quartets, int n_classes,
                               const int* classes, const double* boys_tables, double* rows,
                               double* packed, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      packed, 0, sizeof(double) * static_cast<size_t>(n_pairs) * n_pairs, stream);
  if (err == cudaSuccess) {
    err = launch_pair_rows(lmax, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2, rows,
                           stream);
  }
  if (err != cudaSuccess) return err;
  const QuartetPart part{reinterpret_cast<const int2*>(quartets), 0, pair_start, rows,
                         2 * lmax + 1, boys_tables};
  return launch_work_list(n_classes, reinterpret_cast<const ClassPart*>(classes), part,
                          tuna_quartet::PackedOut{packed, n_pairs}, stream);
}

extern "C" const char* tuna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
