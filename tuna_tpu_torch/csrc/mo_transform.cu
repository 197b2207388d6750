// K5: one half-transform of a packed AO pair matrix to packed MO pairs.
//
// For each row r of a (n_rows, n_ao_pairs) matrix M, with D_r[k, l] =
// M[r, (kl)] its dense symmetric (N, N) matrix:
//   out[r, (pq)] = sum_kl W[k, p] D_r[k, l] W[l, q],  p >= q,
// packed in np.tril_indices order, (pq) = p (p + 1) / 2 + q.
//
// Replaces tuna_tpu/ops/motransform.py:51 _half_transform (a gather and two
// einsums), as _chunked_half_transform (:63), pair_packed_to_mo (:79) and
// pair_packed_to_mo_mixed (:105) call it.  Element (r, c) of M is read at
// M[r * row_stride + c * col_stride]: the rows layout (row_stride =
// n_ao_pairs, col_stride = 1) or the second phase's, the first phase's
// result read transposed in place (row_stride = 1, col_stride = n_rows).
//
// What bounds it on an H100: operations.  At N2/cc-pVTZ (N = 70, n_mo = 60)
// a row needs 2 N^2 n_mo + 2 N n_mo (n_mo + 1) / 2 = 0.84 MFLOP against 20
// KB read and 15 KB written; the two phases of pair_packed_to_mo need 3.6
// GFLOP on 149 MB, 0.054 ms at the float64 tensor-core (DMMA) rate against
// 0.044 ms of memory traffic.  The first K5 (one block a row, FMAs on the
// CUDA cores, W through L1) took 1.69 ms for both phases there (NVIDIA H100
// 80GB HBM3, 700.00 W), 6.1x torch.matmul on the expanded rows.
//
// Design: both products on mma.sync.m16n8k8 f64 (DMMA), from shared memory.
// Per row, T^T = W^T D_r (M = q, N = k, K = l), then out = W^T T (M = p, N =
// q, K = k) for the 16 x 8 output tiles that touch p >= q only; the lower
// entries of each tile go straight from the accumulators to the packed row,
// at offsets from a table (the tiles of each product as warp jobs, and p (p
// + 1) / 2 for each p) that the host builds once per shape
// (ops/motransform.py::tile_table): no sqrt.  Both products take W^T as the
// row-major A operand; D_r (symmetric) and T^T are stored with the MMA's
// n index as rows, so every fragment load is one double a lane at a row
// stride of 4 mod 16 doubles, free of bank conflicts.  A warp job is one
// m-tile against up to kMaxTiles n-tiles, the A fragment reused across
// them.  Sums run in a fixed order with no atomics: two calls agree bitwise.
// At N2/cc-pVTZ this design takes 0.128 ms of device time a launch, 0.31
// ms for both phases with the wrappers, where torch.matmul on the rows
// handed to it expanded takes 0.26 ms (NVIDIA H100 80GB HBM3, 700.00 W);
// mma.sync.m16n8k8 ran 8% faster than m16n8k4 there, and 16 warps a block
// 6-16% faster than 8.
//
// Two layouts of shared memory, chosen by the host (ops/motransform.py::
// half_transform_layout):
//   staged (up to N = n_mo = 80, every shape of the smoke's paths):
//     persistent blocks of 16 warps, one an SM, stage W^T once, zero-padded
//     to the tiles (39 KB at cc-pVTZ), then walk runs of `run` consecutive
//     rows (4 up to N = 72).  A run's packed entries come in with cp.async,
//     all in flight at once: contiguous in the rows layout, and in the
//     transposed layout `run` consecutive doubles of each column of H, one
//     32-byte segment where one row would use 8 bytes of it.  Each row's
//     entries then go from the staging buffer into both triangles of D_r,
//     through the inverse of pair_index (pair_kl: k | l << 16 for each
//     packed column).  Of the two ways to read the second phase's input
//     coalesced, this one (consecutive rows a block) was chosen over a
//     transposed store in the first phase because it needs no change to
//     what the first phase writes, so the phases stay one kernel with one
//     output layout, and the mixed transform's .T stays a view.
//   panels (larger N, as at cc-pV6Z: N = 252, n_mo = 182, where D_r is 508 KB
//     and T 367 KB): one row at a time, D_r in panels of `panel` rows k
//     that divide the padded N (each a pass over the packed row, keeping
//     the entries that fall in it), T^T and the output accumulated over the
//     panels (the first panel writes the output row, the others add to it,
//     the same thread each time), W read through L1.  This layout is kept
//     right, not fast: no path of the smoke takes it.
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int kThreads = 512;   // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 6;    // n-tiles of one warp job

struct Shape {
  int n_rows, n_ao, n_mo, n_pairs;
  int np8;        // n_ao rounded up to 8: rows and columns of D_r, K of the first product
  int mq;         // n_mo rounded up to 16: rows of W^T and T^T
  int ld;         // row stride of W^T and D_r: np8 + 4 doubles
  int panel;      // rows of D_r a pass (np8 when staged)
  int ldt;        // row stride of T^T: panel + 4 doubles
  int run;        // rows staged at a time (staged layout)
  int n_jobs1, n_jobs2;
  long long row_stride, col_stride;
};

// W^T[q][l], zero past n_mo and n_ao: from shared memory when staged, else
// from W (n_ao, n_mo) through L1.
template <bool kStaged>
__device__ __forceinline__ double w_t(const Shape& s, const double* Ws, const double* W, int q,
                                      int l) {
  if constexpr (kStaged) {
    return Ws[q * s.ld + l];
  } else {
    return (q < s.n_mo && l < s.n_ao) ? __ldg(W + static_cast<size_t>(l) * s.n_mo + q) : 0.0;
  }
}

// Job codes: m-tile | first n-tile << 10 | n-tiles << 20.
__device__ __forceinline__ void decode(int code, int& i, int& j0, int& count) {
  i = code & 1023;
  j0 = (code >> 10) & 1023;
  count = code >> 20;
}

// T^T[q][k - k0] = sum_l W^T[q][l] D[k - k0][l] for the panel's k, into Tt.
template <bool kStaged>
__device__ void transform_left(const Shape& s, const int* __restrict__ jobs, const double* Ws,
                               const double* __restrict__ W, const double* D, double* Tt,
                               int warp, int lane) {
  const int g = lane >> 2, quad = lane & 3;
  for (int job = warp; job < s.n_jobs1; job += kWarps) {
    int i, j0, count;
    decode(__ldg(jobs + job), i, j0, count);
    const int q = 16 * i + g;
    double acc[kMaxTiles][4] = {};
    for (int kk = quad; kk < s.np8; kk += 8) {
      const double a[4] = {w_t<kStaged>(s, Ws, W, q, kk), w_t<kStaged>(s, Ws, W, q + 8, kk),
                           w_t<kStaged>(s, Ws, W, q, kk + 4),
                           w_t<kStaged>(s, Ws, W, q + 8, kk + 4)};
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        const double* b = D + (8 * (j0 + t) + g) * s.ld + kk;
        if (t < count) mma_f64(acc[t], a, b[0], b[4]);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < count) {
        const int col = 8 * (j0 + t) + 2 * quad;
        *reinterpret_cast<double2*>(Tt + q * s.ldt + col) = make_double2(acc[t][0], acc[t][1]);
        *reinterpret_cast<double2*>(Tt + (q + 8) * s.ldt + col) =
            make_double2(acc[t][2], acc[t][3]);
      }
    }
  }
}

// out[(pq)] (+)= sum_k W^T[p][k0 + k] T^T[q][k] over the panel, for the
// lower tiles; `first` writes, otherwise adds (the same thread wrote the
// entry for the previous panel).
template <bool kStaged>
__device__ void transform_right(const Shape& s, const int* __restrict__ jobs,
                                const int* __restrict__ tri_offset, const double* Ws,
                                const double* __restrict__ W, const double* Tt, int k0, bool first,
                                double* __restrict__ out_r, int warp, int lane) {
  const int g = lane >> 2, quad = lane & 3;
  for (int job = warp; job < s.n_jobs2; job += kWarps) {
    int i, j0, count;
    decode(__ldg(jobs + job), i, j0, count);
    const int p = 16 * i + g;
    double acc[kMaxTiles][4] = {};
    for (int kk = quad; kk < s.panel; kk += 8) {
      const int k = k0 + kk;
      const double a[4] = {w_t<kStaged>(s, Ws, W, p, k), w_t<kStaged>(s, Ws, W, p + 8, k),
                           w_t<kStaged>(s, Ws, W, p, k + 4), w_t<kStaged>(s, Ws, W, p + 8, k + 4)};
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        const double* b = Tt + (8 * (j0 + t) + g) * s.ldt + kk;
        if (t < count) mma_f64(acc[t], a, b[0], b[4]);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t >= count) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = p + 8 * h;
        if (row >= s.n_mo) continue;
        double* at = out_r + __ldg(tri_offset + row);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 8 * (j0 + t) + 2 * quad + r;
          if (col <= row) at[col] = first ? acc[t][2 * h + r] : at[col] + acc[t][2 * h + r];
        }
      }
    }
  }
}

// D[k - k0][l] = D[l - k0][k] = (kl) entry of the row, for the panel's rows.
__device__ __forceinline__ void scatter(double v, int kl, int k0, int panel, int ld, double* D) {
  const int k = kl & 0xffff, l = kl >> 16;
  if (k - k0 >= 0 && k - k0 < panel) D[(k - k0) * ld + l] = v;
  if (l - k0 >= 0 && l - k0 < panel) D[(l - k0) * ld + k] = v;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
half_transform_kernel(Shape s, const double* __restrict__ M, const int* __restrict__ pair_kl,
                      const double* __restrict__ W, const int* __restrict__ table,
                      double* __restrict__ out) {
  extern __shared__ __align__(16) double smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* jobs_left = table;
  const int* jobs_right = table + s.n_jobs1;
  const int* tri_offset = jobs_right + s.n_jobs2;
  const long long n_mo_pairs = static_cast<long long>(s.n_mo) * (s.n_mo + 1) / 2;
  if constexpr (kStaged) {
    double* Ws = smem;                    // W^T (mq, ld)
    double* D = Ws + s.mq * s.ld;         // D_r (np8, ld)
    double* Tt = D + s.np8 * s.ld;        // T^T (mq, ldt)
    double* staged = Tt + s.mq * s.ldt;   // the run's packed rows (run, n_pairs)
    for (int e = threadIdx.x; e < s.mq * s.ld; e += kThreads) {
      const int q = e / s.ld, l = e - q * s.ld;
      Ws[e] = (q < s.n_mo && l < s.n_ao) ? W[static_cast<size_t>(l) * s.n_mo + q] : 0.0;
    }
    // D_r's padding is never written by the scatter: zero it once
    for (int e = threadIdx.x; e < s.np8 * s.ld; e += kThreads) D[e] = 0.0;
    const int n_runs = (s.n_rows + s.run - 1) / s.run;
    for (int run = blockIdx.x; run < n_runs; run += gridDim.x) {
      const int r0 = run * s.run, rows = min(s.run, s.n_rows - r0);
      if (s.col_stride == 1) {   // rows layout: the run is one contiguous span
        const double* from = M + r0 * s.row_stride;
        for (int e = threadIdx.x; e < rows * s.n_pairs; e += kThreads)
          cp_async8(staged + e, from + e);
      } else {                   // transposed: `rows` consecutive doubles of each column
        const int rr = threadIdx.x % s.run;   // run divides kThreads
        if (rr < rows) {
          for (int c = threadIdx.x / s.run; c < s.n_pairs; c += kThreads / s.run)
            cp_async8(staged + rr * s.n_pairs + c,
                      M + c * s.col_stride + (r0 + rr) * s.row_stride);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      for (int rr = 0; rr < rows; ++rr) {
        const double* row = staged + rr * s.n_pairs;
#pragma unroll 4
        for (int c = threadIdx.x; c < s.n_pairs; c += kThreads)
          scatter(row[c], __ldg(pair_kl + c), 0, s.np8, s.ld, D);
        __syncthreads();
        transform_left<true>(s, jobs_left, Ws, W, D, Tt, warp, lane);
        __syncthreads();
        transform_right<true>(s, jobs_right, tri_offset, Ws, W, Tt, 0, true,
                              out + (r0 + rr) * n_mo_pairs, warp, lane);
      }
    }
  } else {
    double* D = smem;                     // a panel of D_r (panel, ld)
    double* Tt = D + s.panel * s.ld;      // T^T's columns of the panel (mq, ldt)
    for (int r = blockIdx.x; r < s.n_rows; r += gridDim.x) {
      const double* row = M + r * s.row_stride;
      for (int k0 = 0; k0 < s.np8; k0 += s.panel) {
        for (int e = threadIdx.x; e < s.panel * s.ld; e += kThreads) D[e] = 0.0;
        __syncthreads();
        for (int c = threadIdx.x; c < s.n_pairs; c += kThreads)
          scatter(row[c * s.col_stride], __ldg(pair_kl + c), k0, s.panel, s.ld, D);
        __syncthreads();
        transform_left<false>(s, jobs_left, nullptr, W, D, Tt, warp, lane);
        __syncthreads();
        transform_right<false>(s, jobs_right, tri_offset, nullptr, W, Tt, k0, k0 == 0,
                               out + r * n_mo_pairs, warp, lane);
      }
    }
  }
}

}  // namespace

// M as above; pair_kl (n_ao_pairs,) int32, k | l << 16 of each packed AO
// pair; W (n_ao, n_mo); table (n_jobs1 + n_jobs2 + n_mo,) int32: the warp
// jobs of the two products, then p (p + 1) / 2 for each p; out (n_rows,
// n_mo (n_mo + 1) / 2).  staged selects the layout, with run rows a stage;
// otherwise panel rows of D_r a pass.  The shared memory is computed here
// from the shape; a layout that does not fit is refused by the launch.
extern "C" int tuna_mo_half_transform(int n_rows, int n_ao, int n_mo, int staged, int run,
                                      int panel, int n_jobs1, int n_jobs2, long long row_stride,
                                      long long col_stride, const double* M, const int* pair_kl,
                                      const double* W, const int* table, double* out,
                                      cudaStream_t stream) {
  if (n_rows <= 0) return cudaSuccess;
  Shape s;
  s.n_rows = n_rows;
  s.n_ao = n_ao;
  s.n_mo = n_mo;
  s.n_pairs = n_ao * (n_ao + 1) / 2;
  s.np8 = (n_ao + 7) / 8 * 8;
  s.mq = (n_mo + 15) / 16 * 16;
  s.ld = s.np8 + 4;
  s.panel = staged ? s.np8 : panel;
  s.ldt = s.panel + 4;
  s.run = staged ? run : 1;
  s.n_jobs1 = n_jobs1;
  s.n_jobs2 = n_jobs2;
  s.row_stride = row_stride;
  s.col_stride = col_stride;
  if (n_ao > 0xffff || s.run < 1 || s.panel < 8 || s.panel % 8 != 0 || s.np8 % s.panel != 0)
    return cudaErrorInvalidValue;
  if (staged && col_stride == 1 && row_stride != s.n_pairs) return cudaErrorInvalidValue;
  size_t doubles = staged ? static_cast<size_t>(s.mq) * s.ld + static_cast<size_t>(s.np8) * s.ld +
                                static_cast<size_t>(s.mq) * s.ldt +
                                static_cast<size_t>(s.run) * s.n_pairs
                          : static_cast<size_t>(s.panel) * s.ld +
                                static_cast<size_t>(s.mq) * s.ldt;
  const int smem = static_cast<int>(doubles * sizeof(double));
  auto kernel = staged ? half_transform_kernel<true> : half_transform_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int work = staged ? (n_rows + s.run - 1) / s.run : n_rows;
  const int blocks = work < sms * per_sm ? work : sms * per_sm;
  kernel<<<blocks, kThreads, smem, stream>>>(s, M, pair_kl, W, table, out);
  return cudaGetLastError();
}
