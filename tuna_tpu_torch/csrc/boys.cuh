// Boys function F_0..F_NMAX(T) on the device, shared by the quartet kernels
// and the one-electron integrals and their tangents.
//
// Same two-regime scheme as tuna_tpu/ops/boys.py::boys_table and its
// plain twin tuna_tpu_torch/ops/boys.py:
//   T < 30 : 10-term Taylor expansion of F_NMAX about the nearest point of
//            a 0.1-spaced grid (|dT| <= 0.05), then downward recursion
//            F_{m-1} = (2T F_m + e^-T) / (2m - 1);
//   T >= 30: F_0 = sqrt(pi / 4T), then upward recursion
//            F_{m+1} = ((2m + 1) F_m - e^-T) / (2T).
// The (301, 10) table tab[i][k] = F_{NMAX+k}(T_i) (-1)^k / k! is built on
// the host (ops/boys.py::_taylor_table) for this NMAX.  The quartet kernels
// (quartet.cuh, eri_deriv.cu) stage it in shared memory (24 KB) with
// load_boys_table; the one-electron kernels (one_electron.cu,
// one_electron_deriv.cu) read it from device memory through L1.
#pragma once

#define TUNA_BOYS_T_SWITCH 30.0
#define TUNA_BOYS_GRID_STEP 0.1
#define TUNA_BOYS_N_GRID 301
#define TUNA_BOYS_N_TAYLOR 10
#define TUNA_BOYS_TABLE_SIZE (TUNA_BOYS_N_GRID * TUNA_BOYS_N_TAYLOR)

namespace tuna {

// Cooperative copy of the Taylor table into shared memory; ends in a
// barrier, so every thread of the block must call it.
__device__ __forceinline__ void load_boys_table(double* __restrict__ dst,
                                                const double* __restrict__ src) {
  for (int k = threadIdx.x; k < TUNA_BOYS_TABLE_SIZE; k += blockDim.x) {
    dst[k] = src[k];
  }
  __syncthreads();
}

template <int NMAX>
__device__ __forceinline__ void boys_eval(double T, const double* __restrict__ tab,
                                          double (&F)[NMAX + 1]) {
  if (T < TUNA_BOYS_T_SWITCH) {
    int idx = static_cast<int>(rint(T / TUNA_BOYS_GRID_STEP));
    idx = max(0, min(idx, TUNA_BOYS_N_GRID - 1));
    const double dT = T - idx * TUNA_BOYS_GRID_STEP;
    const double* c = tab + idx * TUNA_BOYS_N_TAYLOR;
    double top = c[TUNA_BOYS_N_TAYLOR - 1];
#pragma unroll
    for (int k = TUNA_BOYS_N_TAYLOR - 2; k >= 0; --k) {
      top = top * dT + c[k];
    }
    const double e = exp(-T);
    F[NMAX] = top;
#pragma unroll
    for (int m = NMAX; m > 0; --m) {
      F[m - 1] = (2.0 * T * F[m] + e) / (2.0 * m - 1.0);
    }
  } else {
    const double e = exp(-T);
    F[0] = 0.88622692545275801365 / sqrt(T);  // sqrt(pi) / 2
#pragma unroll
    for (int m = 0; m < NMAX; ++m) {
      F[m + 1] = ((2.0 * m + 1.0) * F[m] - e) / (2.0 * T);
    }
  }
}

}  // namespace tuna
