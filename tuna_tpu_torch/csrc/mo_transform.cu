// K5: one half-transform of a packed AO pair matrix to packed MO pairs.
//
// For each row r of a (n_rows, n_ao_pairs) matrix M, with D_r[k, l] =
// M[r, pair_index[k, l]] its dense symmetric (N, N) matrix:
//   out[r, (pq)] = sum_kl W[k, p] D_r[k, l] W[l, q],  p >= q,
// packed in np.tril_indices order, (pq) = p (p + 1) / 2 + q.
//
// Replaces tuna_tpu/ops/motransform.py::_half_transform (a gather and two
// einsums), as _chunked_half_transform, pair_packed_to_mo and
// pair_packed_to_mo_mixed call it.  Element (r, c) of M is read at
// M[r * row_stride + c * col_stride], so the second phase of the
// transform reads the first phase's result transposed, with no copy.
//
// What bounds it on an H100: operations.  At N2/cc-pVTZ (N = 70, n_mo = 60)
// a row is 2 N^2 n_mo + 2 N n_mo (n_mo + 1) / 2 = 0.84 MFLOP against 20 KB
// read and 15 KB written, and the two phases of pair_packed_to_mo do 3.6
// GFLOP on 149 MB: 0.107 ms at the float64 rate outside the tensor cores
// against 0.044 ms of memory traffic.
//
// Design: one block per row, a grid-stride loop over rows.  The columns l
// of D_r are taken in panels of `panel` columns, sized by the host so that
// the panel of D_r (N x panel) and of T = W^T D_r (n_mo x panel) fit in
// dynamic shared memory; at N = 70 one panel holds all of D_r (73 KB).
// For each panel:
//   1. gather D_r[:, panel] through pair_index into shared memory;
//   2. T[p, j] = sum_k W[k, p] D_r[k, j] into shared memory;
//   3. each thread adds sum_j T[p, j] W[l0 + j, q] to its own entries
//      out[r, (pq)], consecutive threads on consecutive (pq): coalesced
//      stores, and no two threads share an entry, so no atomics.
// W is read through L1/L2.  Plain float64 FMA on the CUDA cores;
// DMMA (wgmma on f64) and TMA are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Packed tril index -> (p, q), p >= q.
__device__ __forceinline__ void unpack_tril(int idx, int& p, int& q) {
  int r = static_cast<int>((sqrt(8.0 * idx + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > idx) --r;
  while ((r + 1) * (r + 2) / 2 <= idx) ++r;
  p = r;
  q = idx - r * (r + 1) / 2;
}

__global__ void __launch_bounds__(kThreads)
half_transform_kernel(int n_rows, int n_ao, int n_mo, int panel, long long row_stride,
                      long long col_stride, const double* __restrict__ M,
                      const int* __restrict__ pair_index, const double* __restrict__ W,
                      double* __restrict__ out) {
  extern __shared__ double smem[];
  double* Dp = smem;                 // (n_ao, panel)
  double* Tp = smem + n_ao * panel;  // (n_mo, panel)
  const int n_mo_pairs = n_mo * (n_mo + 1) / 2;
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const double* Mr = M + r * row_stride;
    double* out_r = out + static_cast<long long>(r) * n_mo_pairs;
    for (int l0 = 0; l0 < n_ao; l0 += panel) {
      const int lw = min(panel, n_ao - l0);
      for (int e = threadIdx.x; e < n_ao * lw; e += blockDim.x) {
        const int k = e / lw, j = e - k * lw;
        Dp[k * panel + j] = Mr[pair_index[k * n_ao + l0 + j] * col_stride];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n_mo * lw; e += blockDim.x) {
        const int p = e / lw, j = e - p * lw;
        double s = 0.0;
        for (int k = 0; k < n_ao; ++k) s = fma(W[k * n_mo + p], Dp[k * panel + j], s);
        Tp[p * panel + j] = s;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n_mo_pairs; e += blockDim.x) {
        int p, q;
        unpack_tril(e, p, q);
        const double* T_p = Tp + p * panel;
        const double* W_q = W + static_cast<long long>(l0) * n_mo + q;
        double s = 0.0;
        for (int j = 0; j < lw; ++j) s = fma(T_p[j], W_q[j * n_mo], s);
        out_r[e] = (l0 == 0) ? s : out_r[e] + s;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int tuna_mo_half_transform(int n_rows, int n_ao, int n_mo, int panel,
                                      long long row_stride, long long col_stride,
                                      const double* M, const int* pair_index, const double* W,
                                      double* out, cudaStream_t stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (panel < 1 || panel > n_ao) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(double) * (n_ao + n_mo) * panel);
  cudaError_t err = cudaFuncSetAttribute(half_transform_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = n_rows < 1056 ? n_rows : 1056;  // 8 resident blocks per SM at most
  half_transform_kernel<<<blocks, kThreads, smem, stream>>>(n_rows, n_ao, n_mo, panel,
                                                            row_stride, col_stride, M,
                                                            pair_index, W, out);
  return cudaGetLastError();
}
