// Float64 tensor-core (DMMA) and asynchronous-copy helpers shared by K5
// (mo_transform.cu), K7bt (dft_grid.cu), K2u (ccsd_t_u.cu) and K9
// (ccsdt_q.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// D (16x8) += A (16x8, row) . B (8x8, col) in float64 on the tensor cores
// (Hopper's m16n8k8 shape).  With g = lane / 4, q = lane % 4: a = A[g][q],
// A[g + 8][q], A[g][q + 4], A[g + 8][q + 4]; b = B[q][g], B[q + 4][g]; c =
// C[g][2q], C[g][2q + 1], C[g + 8][2q], C[g + 8][2q + 1].
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4], double b0,
                                        double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// One double from device memory into shared memory, without a register.
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src));
}

// As cp_async8, but a zero lands where `valid` is false (src is not read
// then, but must be a device address).
__device__ __forceinline__ void cp_async8_zfill(double* dst, const double* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 8 : 0));
}

// Close the group of cp.async this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's committed groups are in
// flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::);
}

}  // namespace
