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
// operations (2.3e11 at o = 16, v = 104) at the float64 tensor-core (DMMA)
// rate, 67 TFLOP/s; stage B does ~30 operations a (triple, orbit).
//
// Design, in two kernels a batch of occupied triples i < j < k:
//
// Stage A (u_triples_raw_kernel) forms X_ijk[a, (b < c)] = P(i/jk) conn_ijk
// [a, b, c] as one product of depth 3 (v + o): the three occupied orderings
// (r, p, q) = (i, j, k), (j, i, k), (k, j, i) with signs +, -, -, each
//   [ t2[p, q, a, :] | -<: a || p q> ]  (v x (v + o))
//   [ <: r || b c> ; t2[r, :, b, c] ]   ((v + o) x C(v,2)),
// concatenated along the depth with their signs folded into the left
// operand.  A block takes one triple and a 64 x 64 tile of (a, pair); the
// depth is staged through shared memory 32 at a time (zero past the end),
// and each of 8 warps runs mma.sync.m16n8k4.f64 on a 16 x 32 sub-tile, as
// K2's stage A does.  X is antisymmetric in (b, c), so only b < c is kept:
// half of the v^3 a triple would need.
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

namespace {

constexpr int kTile = 64;           // a and pairs per stage-A block
constexpr int kDepth = 32;          // depth staged per step
constexpr int kLd = kDepth + 4;     // row stride: 4 mod 16 doubles, no bank conflicts on reads
constexpr int kThreadsA = 256;      // 8 warps: 4 (rows of 16) x 2 (columns of 32)
constexpr int kThreadsB = 128;
constexpr int kOrbitBits = 21;      // bits of each virtual in a packed orbit

// D (16x8) += A (16x4, row) . B (4x8, col) in float64 on the tensor cores
// (Hopper's m16n8k4 shape).  With g = lane / 4, q = lane % 4: a_lo =
// A[g][q], a_hi = A[g + 8][q], b = B[q][g], c = C[g][2q], C[g][2q + 1],
// C[g + 8][2q], C[g + 8][2q + 1].
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a0), "d"(a1), "d"(b));
}

// Index of the pair (y, z), y < z, in the row-major order of pairs.
__device__ __forceinline__ long long pair_of(int nv, int y, int z) {
  return static_cast<long long>(y) * nv - static_cast<long long>(y) * (y + 1) / 2 + (z - y - 1);
}

// triples (n, 3): i < j < k of the batch; pairs (n_pairs, 2): b < c.
// X: the batch's slots, each (v, n_pairs), pairs fastest.
__global__ void __launch_bounds__(kThreadsA)
u_triples_raw_kernel(int no, int nv, int n_pairs, int a_tiles, const int* __restrict__ triples,
                     const int* __restrict__ pairs, const double* __restrict__ g_vovv,
                     const double* __restrict__ g_ovoo, const double* __restrict__ t2,
                     double* __restrict__ X) {
  __shared__ double As[kTile][kLd];   // As[a][kappa]
  __shared__ double Bs[kTile][kLd];   // Bs[pair][kappa] = B[kappa][pair]

  const int slot = blockIdx.x / a_tiles;
  const int a0 = (blockIdx.x % a_tiles) * kTile, p0 = blockIdx.y * kTile;
  const int o3[3] = {triples[3 * slot], triples[3 * slot + 1], triples[3 * slot + 2]};
  const int segment = nv + no, depth = 3 * segment;
  const size_t v2 = static_cast<size_t>(nv) * nv;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / 4, quad = lane % 4;
  const int row0 = 16 * (warp % 4), col0 = 32 * (warp / 4);

  double acc[4][4] = {};
  for (int k0 = 0; k0 < depth; k0 += kDepth) {
    // left operand: a rows, depth fastest (t2[p, q, a, e] is contiguous in e)
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreadsA) {
      const int r = e / kDepth, kk = e % kDepth, kappa = k0 + kk, a = a0 + r;
      double value = 0.0;
      if (kappa < depth && a < nv) {
        const int s = kappa / segment, x = kappa % segment;
        // ordering s: (r, p, q) = (i, j, k), (j, i, k), (k, j, i)
        const int p = s == 1 ? o3[0] : o3[1], q = s == 2 ? o3[0] : o3[2];
        const double sign = s == 0 ? 1.0 : -1.0;
        const size_t pq = static_cast<size_t>(p) * no + q;
        value = x < nv ? sign * t2[pq * v2 + static_cast<size_t>(a) * nv + x]
                       : -sign * g_ovoo[(static_cast<size_t>(x - nv) * nv + a) * no * no + pq];
      }
      As[r][kk] = value;
    }
    // right operand: pairs fastest (<e r||b c> and t2[r, m, b, c] run along c)
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreadsA) {
      const int col = e % kTile, kk = e / kTile, kappa = k0 + kk, pair = p0 + col;
      double value = 0.0;
      if (kappa < depth && pair < n_pairs) {
        const int s = kappa / segment, x = kappa % segment, r = o3[s];
        const size_t bc = static_cast<size_t>(pairs[2 * pair]) * nv + pairs[2 * pair + 1];
        value = x < nv ? g_vovv[(static_cast<size_t>(x) * no + r) * v2 + bc]
                       : t2[(static_cast<size_t>(r) * no + (x - nv)) * v2 + bc];
      }
      Bs[col][kk] = value;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 4) {
      const double a_lo = As[row0 + group][kk + quad], a_hi = As[row0 + 8 + group][kk + quad];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_f64(acc[ni], a_lo, a_hi, Bs[col0 + 8 * ni + group][kk + quad]);
    }
    __syncthreads();
  }

  double* X_slot = X + static_cast<long long>(slot) * nv * n_pairs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = a0 + row0 + 8 * h + group;
    if (a >= nv) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pair = p0 + col0 + 8 * ni + 2 * quad + r;
        if (pair < n_pairs)
          X_slot[static_cast<long long>(a) * n_pairs + pair] = acc[ni][2 * h + r];
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
// triples (n_triples, 3), pairs (n_pairs, 2) and orbits (n_orbits) on the
// device.  workspace holds the largest batch's slots, v n_pairs doubles
// each; partial one double a stage-B block of every batch, batch after
// batch (ceil(triples * orbits / 128)).
extern "C" int tuna_uccsd_t_energy(int no, int nv, int n_batches, const int* batches,
                                   const int* triples, const int* pairs, const long long* orbits,
                                   const double* g_oovv, const double* g_vovv,
                                   const double* g_ovoo, const double* t1, const double* t2,
                                   const double* eps_o, const double* eps_v, double v_scale,
                                   double* workspace, double* partial, cudaStream_t stream) {
  if (no < 3 || nv < 3) return cudaSuccess;
  const int n_pairs = nv * (nv - 1) / 2;
  const int n_orbits = static_cast<int>(static_cast<long long>(nv) * (nv - 1) * (nv - 2) / 6);
  const int a_tiles = (nv + kTile - 1) / kTile, pair_tiles = (n_pairs + kTile - 1) / kTile;
  long long partial_offset = 0;
  for (int batch = 0; batch < n_batches; ++batch) {
    const int begin = batches[2 * batch], n_triples = batches[2 * batch + 1] - begin;
    if (n_triples <= 0) continue;
    const dim3 grid(static_cast<unsigned>(n_triples * a_tiles), static_cast<unsigned>(pair_tiles));
    u_triples_raw_kernel<<<grid, kThreadsA, 0, stream>>>(
        no, nv, n_pairs, a_tiles, triples + 3 * begin, pairs, g_vovv, g_ovoo, t2, workspace);
    cudaError_t err = cudaGetLastError();
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
