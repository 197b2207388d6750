// K2u: unrestricted (spin-orbital) (T) / [T] triples energy.
//
// Replaces tuna_tpu/post/cc.py::_unrestricted_T_tensors and the contraction
// in unrestricted_CCSD_T (cc.py:1783-1811):
//   conn_ijk[abc] = sum_e t2[jkae] <ei||bc> - sum_m t2[imbc] <ma||jk>
//   disc_ijk[abc] = t1[ia] <jk||bc>
//   A = P(i/jk) P(a/bc),  x -> x - x_(ij) - x_(ik) and x - x_(ab) - x_(ac)
//   E = 1/36 sum_ijkabc A(conn) (A(conn) + s A(disc)) / D,  s = 1 (CC), 2 (QCISD)
//   D = e_i + e_j + e_k - e_a - e_b - e_c
//
// A(conn) and A(disc) are antisymmetric in (ijk) and in (abc) (t2 and the
// integrals are antisymmetric in each pair), so every term with a repeated
// index is zero and each i < j < k, a < b < c stands for 36 equal terms:
// the kernel sums only those, with no 1/36.
//
// What bounds it on an H100: stage A's products, 2 C(o,3) v C(v,2) 3(v + o)
// operations (2.25e11 at o = 16, v = 104: 3.44 ms at the float64
// tensor-core (DMMA) rate, 67 TFLOP/s); stage B does ~30 operations a
// (triple, orbit).  Bytes: the inputs once (0.17 GB at o = 16, v = 104)
// and X written and read once (v C(v, 2) doubles a triple, 2.5 GB in all
// there: >= 1.5 ms at 3.35 TB/s, under the operation bound of both stages).
//
// Design, in two kernels a batch of occupied triples i < j < k:
//
// Stage A (u_triples_raw_kernel) forms X_ijk[a, (b < c)] = P(i/jk) conn_ijk
// [a, b, c] as one product of depth 3 (v + o): the three occupied orderings
// (r, p, q) = (i, j, k), (j, i, k), (k, j, i) with signs +, -, -, each
//   [ t2[p, q, a, :] | -<: a || p q> ]  (v x (v + o))
//   [ <: r || b c> ; t2[r, :, b, c] ]   ((v + o) x C(v,2)),
// concatenated along the depth.  A block takes one triple and a 64 x 128
// tile of (a, pair); each of its 8 warps holds a 32 x 32 sub-tile, 2 x 4
// m16n8k8 tiles (csrc/dmma.cuh), so each A fragment feeds 4 products and
// each B fragment 2.  The depth is staged 16 at a time by cp.async into one
// of two shared buffers while the products run on the other (zero past the
// end); rows are 20 doubles apart, so a half-warp's fragment reads hit 32
// distinct banks.  Both operands are read along runs: the left one along e
// of t2[p, q, a, :] and along m of <: a || p q>, which the wrapper hands
// over transposed as [p][q][a][m] (o^3 v doubles); the right one along c
// of <e r || b c> and t2[r, m, b, c], through a table of b v + c for each
// pair that a block loads once.  The signs of the orderings and of the
// integral part are applied to the A fragments, since cp.async copies
// values as they are.  X is antisymmetric in (b, c), so only b < c is
// kept: half of the v^3 a triple would need.
//
// Stage B (u_triples_energy_kernel) takes one (triple, orbit a < b < c) a
// thread: A(conn) = X[a, bc] - X[b, ac] + X[c, ab] from the workspace, and
// A(disc) = sum over the three occupied and three virtual positions of
// +-t1 at one position times the integral at the other two, read from t1
// and <oo||vv> directly.  Each block reduces its threads in a fixed-order
// tree into one partial, which the wrapper sums: two calls agree bitwise
// (no atomics).
//
// Memory: the workspace holds X of one batch of triples only, v C(v,2)
// doubles a triple, sized by the wrapper (tuna_tpu_torch/post/cc.py::
// U_TRIPLES_WORKSPACE_BYTES, at least one triple); no o^3 v^3 tensor is
// allocated.  One C call runs every batch on the caller's stream.
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int kRows = 64;           // a per stage-A block
constexpr int kCols = 128;          // pairs per stage-A block
constexpr int kDepth = 16;          // depth staged per step
constexpr int kLd = kDepth + 4;     // row stride: 4 mod 16 doubles, no bank conflicts on reads
constexpr int kStage = (kRows + kCols) * kLd;   // doubles of one buffer
constexpr int kThreadsA = 256;      // 8 warps: 2 (rows of 32) x 4 (columns of 32)
constexpr int kThreadsB = 128;
constexpr int kOrbitBits = 21;      // bits of each virtual in a packed orbit

// Index of the pair (y, z), y < z, in the row-major order of pairs.
__device__ __forceinline__ long long pair_of(int nv, int y, int z) {
  return static_cast<long long>(y) * nv - static_cast<long long>(y) * (y + 1) / 2 + (z - y - 1);
}

// Shared memory of a stage-A block: two buffers of kStage doubles, then
// for each depth kappa (depth_pad of them, a multiple of kDepth) where the
// left operand's row a = 0 starts and its step along a, where the right
// operand's row starts, and the sign bit the A fragments take there.
__host__ __device__ inline size_t raw_shared_bytes(int depth_pad) {
  return sizeof(double) * 2 * kStage +
         static_cast<size_t>(depth_pad) * (2 * sizeof(double*) + 2 * sizeof(int));
}

// x with its sign bit flipped where `bit` is the sign bit (0x80000000)
__device__ __forceinline__ double flip(double x, int bit) {
  return __hiloint2double(__double2hiint(x) ^ bit, __double2loint(x));
}

// triples (n, 3): i < j < k of the batch; pair_offsets (n_pairs): b v + c
// of each pair b < c.  g_ovoo_t: <m a || p q> at [p][q][a][m].  X: the
// batch's slots, each (v, n_pairs), pairs fastest.
__global__ void __launch_bounds__(kThreadsA, 2)
u_triples_raw_kernel(int no, int nv, int n_pairs, int a_tiles, int depth_pad,
                     const int* __restrict__ triples, const int* __restrict__ pair_offsets,
                     const double* __restrict__ g_vovv, const double* __restrict__ g_ovoo_t,
                     const double* __restrict__ t2, double* __restrict__ X) {
  extern __shared__ double staged[];
  __shared__ int offsets[kCols];
  const double** a_from = reinterpret_cast<const double**>(staged + 2 * kStage);
  const double** b_from = a_from + depth_pad;
  int* sign = reinterpret_cast<int*>(b_from + depth_pad);
  int* a_step = sign + depth_pad;

  const int slot = blockIdx.x / a_tiles;
  const int a0 = (blockIdx.x % a_tiles) * kRows, p0 = blockIdx.y * kCols;
  const int i = triples[3 * slot], j = triples[3 * slot + 1], k = triples[3 * slot + 2];
  const int segment = nv + no, depth = 3 * segment;
  const int steps = depth_pad / kDepth;
  const size_t v2 = static_cast<size_t>(nv) * nv;
  for (int c = threadIdx.x; c < kCols; c += kThreadsA)
    offsets[c] = p0 + c < n_pairs ? pair_offsets[p0 + c] : -1;
  // depth kappa: ordering s, (r, p, q) = (i, j, k), (j, i, k), (k, j, i),
  // sign + for s = 0, times - for the integral part x >= v
  for (int kappa = threadIdx.x; kappa < depth_pad; kappa += kThreadsA) {
    if (kappa >= depth) {
      a_from[kappa] = b_from[kappa] = nullptr;
      a_step[kappa] = 0;
      sign[kappa] = 0;
      continue;
    }
    const int s = kappa / segment, x = kappa - s * segment;
    const int r = s == 0 ? i : (s == 1 ? j : k);
    const int p = s == 1 ? i : j, q = s == 2 ? i : k;
    const size_t pq = static_cast<size_t>(p) * no + q;
    a_from[kappa] = x < nv ? t2 + pq * v2 + x : g_ovoo_t + pq * nv * no + (x - nv);
    a_step[kappa] = x < nv ? nv : no;
    b_from[kappa] = x < nv ? g_vovv + (static_cast<size_t>(x) * no + r) * v2
                           : t2 + (static_cast<size_t>(r) * no + (x - nv)) * v2;
    sign[kappa] = (s == 0) == (x < nv) ? 0 : static_cast<int>(0x80000000u);
  }
  __syncthreads();

  // each thread copies A at one depth and rows a_row + 16 t, and B at one
  // pair and depths b_depth + 2 t
  const int a_depth = threadIdx.x % kDepth, a_row = threadIdx.x / kDepth;
  const int b_col = threadIdx.x % kCols, b_depth = threadIdx.x / kCols;
  const int b_offset = offsets[b_col];
  auto stage = [&](int k0, int buffer) {
    double* As = staged + buffer * kStage;
    double* Bs = As + kRows * kLd;
    const double* from = a_from[k0 + a_depth];
    const int step = a_step[k0 + a_depth];
#pragma unroll
    for (int t = 0; t < kRows * kDepth / kThreadsA; ++t) {
      const int r = a_row + (kThreadsA / kDepth) * t, a = a0 + r;
      const bool valid = from != nullptr && a < nv;
      cp_async8_zfill(As + r * kLd + a_depth, valid ? from + static_cast<size_t>(a) * step : t2,
                      valid);
    }
#pragma unroll
    for (int t = 0; t < kCols * kDepth / kThreadsA; ++t) {
      const int kk = b_depth + (kThreadsA / kCols) * t;
      const double* row = b_from[k0 + kk];
      const bool valid = row != nullptr && b_offset >= 0;
      cp_async8_zfill(Bs + b_col * kLd + kk, valid ? row + b_offset : t2, valid);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / 4, quad = lane % 4;
  const int row0 = 32 * (warp % 2), col0 = 32 * (warp / 2);

  double acc[2][4][4] = {};
  stage(0, 0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) stage((step + 1) * kDepth, (step + 1) & 1);
    else cp_async_commit();   // an empty group keeps the count of pending groups
    cp_async_wait<1>();
    __syncthreads();
    const double* As = staged + (step & 1) * kStage;
    const double* Bs = As + kRows * kLd;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
      const int s_lo = sign[step * kDepth + kk + quad];
      const int s_hi = sign[step * kDepth + kk + quad + 4];
      double a[2][4];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        const double* row = As + (row0 + 16 * rt + group) * kLd + kk + quad;
        a[rt][0] = flip(row[0], s_lo);
        a[rt][1] = flip(row[8 * kLd], s_lo);
        a[rt][2] = flip(row[4], s_hi);
        a[rt][3] = flip(row[8 * kLd + 4], s_hi);
      }
#pragma unroll
      for (int ct = 0; ct < 4; ++ct) {
        const double* column = Bs + (col0 + 8 * ct + group) * kLd + kk + quad;
        const double b0 = column[0], b1 = column[4];
        mma_f64(acc[0][ct], a[0], b0, b1);
        mma_f64(acc[1][ct], a[1], b0, b1);
      }
    }
    __syncthreads();   // the next step's copies overwrite this buffer
  }

  double* X_slot = X + static_cast<long long>(slot) * nv * n_pairs;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = a0 + row0 + 16 * rt + 8 * h + group;
      if (a >= nv) continue;
#pragma unroll
      for (int ct = 0; ct < 4; ++ct) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pair = p0 + col0 + 8 * ct + 2 * quad + r;
          if (pair < n_pairs)
            X_slot[static_cast<long long>(a) * n_pairs + pair] = acc[rt][ct][2 * h + r];
        }
      }
    }
  }
}

// orbits (n_orbits): a | b << 21 | c << 42 with a < b < c.
__global__ void __launch_bounds__(kThreadsB)
u_triples_energy_kernel(int no, int nv, int n_pairs, int n_triples, int n_orbits,
                        const int* __restrict__ triples, const long long* __restrict__ orbits,
                        const double* __restrict__ X, const double* __restrict__ g_oovv,
                        const double* __restrict__ t1, const double* __restrict__ eps_o,
                        const double* __restrict__ eps_v, double v_scale,
                        double* __restrict__ partial) {
  __shared__ double reduce[kThreadsB];
  const long long item = static_cast<long long>(blockIdx.x) * kThreadsB + threadIdx.x;
  double acc = 0.0;
  if (item < static_cast<long long>(n_triples) * n_orbits) {
    const long long slot = item / n_orbits;
    const int* o3 = triples + 3 * slot;
    const long long packed = orbits[item % n_orbits];
    constexpr long long kMask = (1LL << kOrbitBits) - 1;
    const int v3[3] = {static_cast<int>(packed & kMask),
                       static_cast<int>((packed >> kOrbitBits) & kMask),
                       static_cast<int>(packed >> 2 * kOrbitBits)};
    const double* X_slot = X + slot * nv * n_pairs;
    const long long row = n_pairs;   // X_slot[a * row + pair]
    const double conn = X_slot[v3[0] * row + pair_of(nv, v3[1], v3[2])]
                        - X_slot[v3[1] * row + pair_of(nv, v3[0], v3[2])]
                        + X_slot[v3[2] * row + pair_of(nv, v3[0], v3[1])];
    // P(i/jk) P(a/bc) t1[ia] <jk||bc>: position x of (ijk) and u of (abc)
    // take t1, the other two (in order) the integral; signs +, -, +
    const size_t v2 = static_cast<size_t>(nv) * nv;
    double disc = 0.0;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const int x1 = x == 0 ? 1 : 0, x2 = x == 2 ? 1 : 2;
      const double* g_xx = g_oovv + (static_cast<size_t>(o3[x1]) * no + o3[x2]) * v2;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int u1 = u == 0 ? 1 : 0, u2 = u == 2 ? 1 : 2;
        const double term = t1[o3[x] * nv + v3[u]] * g_xx[v3[u1] * nv + v3[u2]];
        disc += (x + u) % 2 == 0 ? term : -term;
      }
    }
    acc = conn * (conn + v_scale * disc) /
          (eps_o[o3[0]] + eps_o[o3[1]] + eps_o[o3[2]] - eps_v[v3[0]] - eps_v[v3[1]] - eps_v[v3[2]]);
  }
  reduce[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreadsB / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) reduce[threadIdx.x] += reduce[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = reduce[0];
}

}  // namespace

// batches (host, n_batches x 2): the range of triples of each batch.
// triples (n_triples, 3), pair_offsets (n_pairs) and orbits (n_orbits) on
// the device; g_ovoo_t is <m a || p q> at [p][q][a][m].  workspace holds
// the largest batch's slots, v n_pairs doubles each; partial one double a
// stage-B block of every batch, batch after batch (ceil(triples * orbits /
// 128)).
extern "C" int tuna_uccsd_t_energy(int no, int nv, int n_batches, const int* batches,
                                   const int* triples, const int* pair_offsets,
                                   const long long* orbits, const double* g_oovv,
                                   const double* g_vovv, const double* g_ovoo_t, const double* t1,
                                   const double* t2, const double* eps_o, const double* eps_v,
                                   double v_scale, double* workspace, double* partial,
                                   cudaStream_t stream) {
  if (no < 3 || nv < 3) return cudaSuccess;
  const int n_pairs = nv * (nv - 1) / 2;
  const int n_orbits = static_cast<int>(static_cast<long long>(nv) * (nv - 1) * (nv - 2) / 6);
  const int a_tiles = (nv + kRows - 1) / kRows, pair_tiles = (n_pairs + kCols - 1) / kCols;
  const int depth_pad = (3 * (nv + no) + kDepth - 1) / kDepth * kDepth;
  const int shared = static_cast<int>(raw_shared_bytes(depth_pad));
  cudaError_t err = cudaFuncSetAttribute(u_triples_raw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  long long partial_offset = 0;
  for (int batch = 0; batch < n_batches; ++batch) {
    const int begin = batches[2 * batch], n_triples = batches[2 * batch + 1] - begin;
    if (n_triples <= 0) continue;
    const dim3 grid(static_cast<unsigned>(n_triples * a_tiles), static_cast<unsigned>(pair_tiles));
    u_triples_raw_kernel<<<grid, kThreadsA, shared, stream>>>(
        no, nv, n_pairs, a_tiles, depth_pad, triples + 3 * begin, pair_offsets, g_vovv,
        g_ovoo_t, t2, workspace);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long items = static_cast<long long>(n_triples) * n_orbits;
    const long long blocks = (items + kThreadsB - 1) / kThreadsB;
    u_triples_energy_kernel<<<static_cast<unsigned>(blocks), kThreadsB, 0, stream>>>(
        no, nv, n_pairs, n_triples, n_orbits, triples + 3 * begin, orbits, workspace, g_oovv, t1,
        eps_o, eps_v, v_scale, partial + partial_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    partial_offset += blocks;
  }
  return cudaSuccess;
}
