// The shell of the lane-scheduled one-electron kernels, K3 (one_electron.cu)
// and K8a (one_electron_deriv.cu): a group of w lanes of one warp holds an
// AO pair's partial sums (ops/integrals.py::IntegralPlan.lane_schedule);
// they are summed in a fixed order and lane 0 of the group writes them.
// Each kernel brings only the values of one primitive pair.
#pragma once

#include <cuda_runtime.h>

namespace tuna {

// The group's sum of each of the M values, the same order in every group:
// lanes 1, 2, 4, 8, 16 apart, each step only inside groups at least that
// wide (every lane of the warp takes part in every shuffle).  Then lane 0
// of the group writes value m at [i, j] and [j, i] of the m-th N x N
// matrix of `out`: deterministic, no atomics, every entry written once.
// pair < 0 marks a lane without an AO pair.
template <int M>
__device__ __forceinline__ void write_group_sums(double (&sums)[M], int pair, int width,
                                                 int rank, const int* __restrict__ pair_start,
                                                 const int* __restrict__ ao_i,
                                                 const int* __restrict__ ao_j, int n_basis,
                                                 double* __restrict__ out) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const double other = __shfl_xor_sync(0xffffffffu, sums[m], offset);
      if (offset < width) sums[m] += other;
    }
  }
  if (pair < 0 || rank != 0) return;
  const int k0 = pair_start[pair];
  const int i = ao_i[k0], j = ao_j[k0];
  const size_t nn = static_cast<size_t>(n_basis) * n_basis;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    out[m * nn + static_cast<size_t>(i) * n_basis + j] = sums[m];
    out[m * nn + static_cast<size_t>(j) * n_basis + i] = sums[m];
  }
}

// A kernel's body.  lanes (n_lanes, 2): each lane's AO pair (-1 for none)
// and its group's width.  Lane r of a group adds primitive_pair(k, sums)
// over its AO pair's primitive pairs k0 + r, k0 + r + w, ... (CSR offsets
// pair_start), then the group's sums are written as above.
template <int M, class PrimitivePair>
__device__ __forceinline__ void lane_sums(int n_lanes, const int2* __restrict__ lanes,
                                          const int* __restrict__ pair_start,
                                          const int* __restrict__ ao_i,
                                          const int* __restrict__ ao_j, int n_basis,
                                          double* __restrict__ out,
                                          PrimitivePair primitive_pair) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const int2 lane = slot < n_lanes ? lanes[slot] : make_int2(-1, 1);
  const int pair = lane.x, width = lane.y, rank = threadIdx.x & (width - 1);

  double sums[M] = {};
  if (pair >= 0) {
    for (int k = pair_start[pair] + rank; k < pair_start[pair + 1]; k += width) {
      primitive_pair(k, sums);
    }
  }
  write_group_sums(sums, pair, width, rank, pair_start, ao_i, ao_j, n_basis, out);
}

// Launches `kernel` on n_lanes lanes, THREADS a block; n_lanes must be a
// multiple of 32 (whole warps), as lane_schedule pads it.
template <int THREADS, class... Params, class... Args>
cudaError_t launch_lanes(void (*kernel)(Params...), int n_lanes, cudaStream_t stream,
                         Args... args) {
  if (n_lanes % 32 != 0) return cudaErrorInvalidValue;
  if (n_lanes > 0) {
    kernel<<<(n_lanes + THREADS - 1) / THREADS, THREADS, 0, stream>>>(args...);
  }
  return cudaGetLastError();
}

}  // namespace tuna
