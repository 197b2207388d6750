// K2: restricted (T) / [T] triples energy, spin-adapted Lee formulation.
//
// Replaces tuna_tpu/post/cc.py::_restricted_T_tensors and the contraction
// in restricted_CCSD_T (cc.py:1775):
//   R_ijk[abc] = sum_f <ib|af> t2[kjcf] - sum_m <ij|am> t2[mkbc]
//   W_ijk[abc] = R_ijk[abc] + R_jik[bac] + R_kji[cba] + R_ikj[acb] + R_jki[bca] + R_kij[cab]
//   V_ijk[abc] = s (<jk|bc> t1[ia] + <ik|ac> t1[jb] + <ij|ab> t1[kc]),  s = 1 (CC), 2 (QCISD)
//   Ww         = 4 W_ijk + W_jki + W_kij - 4 W_kji - W_ikj - W_jik   (same abc)
//   E          = 1/3 sum (W + V) Ww / (e_i + e_j + e_k - e_a - e_b - e_c)
//
// What bounds it on an H100: the contraction R, o^3 v^3 (v + o) multiply-adds
// (6.1e9 operations at o = 7, v = 53), at the float64 tensor-core (DMMA)
// rate, 67 TFLOP/s; the rest is ~26 operations an (ijk, abc).
//
// Design, in two kernels a batch of occupied multisets {i <= j <= k}:
//
// Stage A (triples_raw_kernel) computes R once an element, on DMMA.  For one
// ordered triple (i, j, k) and one b, R_ijk[:, b, :] is one v x v product of
// concatenated depth v + o:
//   [G_ib | -O_ij] (v x (v + o)) . [T_kj^T ; T_kb] ((v + o) x v),
//   G_ib[a, f] = <ib|af>, O_ij[a, m] = <ij|am>, T_kj[c, f] = t2[kjcf],
//   T_kb[m, c] = t2[mkbc].
// A block takes one (ordered triple, b) and a 64 x 64 tile of (a, c); the
// depth is staged through shared memory 32 at a time (zero-padded past v and
// v + o, so the edge is masked by zeros), and each of 8 warps runs
// mma.sync.m16n8k4.f64 on a 16 x 32 sub-tile, accumulating in registers.
// Only the distinct orderings of each multiset are computed: 343 ordered
// triples at o = 7, from 84 multisets.  On the H100 the stage runs at ~14%
// of the DMMA rate, near cuBLAS's batched DGEMM on the same 53 x 60 x 53
// products (PERF.md).
//
// Stage B (triples_energy_kernel) takes one multiset and one virtual orbit
// {a <= b <= c} a thread.  It reads the 36 values R_q[t(abc)] of the six
// orderings q of the multiset and the six orderings t of (a, b, c) -- each
// element of the workspace once -- and forms W, Ww and V for every ordering
// pair in registers; the sum over the distinct orderings of (ijk) and of
// (abc) reproduces the sum over all o^3 v^3 ordered terms exactly.  The
// denominator is permutation invariant: one division a thread.  Each block
// reduces its threads in a fixed-order tree into one partial, which the
// wrapper sums: two calls agree bitwise (no atomics).
//
// Memory: the workspace holds R of one batch only, sized by the wrapper
// (tuna_tpu_torch/post/cc.py::TRIPLES_WORKSPACE_BYTES); no o^3 v^3 tensor
// is allocated.  A batch covers the orbits whose least virtual a lies in
// [a0, a1): all of them (a0 = 0, a1 = v) unless one multiset's v^3 doubles
// an ordering exceed the cap.  Its stage B reads R_q[x, y, z] only where
// min(x, y, z) is in [a0, a1), so a slot holds just those elements, as three
// boxes (Slab), (v - a0)^3 - (v - a1)^3 doubles; with a0 = 0, a1 = v the
// first box is the whole (v, v, v) and the others are empty.  One C call
// runs every batch on the caller's stream: a stage-A launch a nonempty box,
// then stage B.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // a and c per stage-A block
constexpr int kDepth = 32;          // depth staged per step
constexpr int kLd = kDepth + 4;     // row stride: 4 mod 16 doubles, no bank conflicts
constexpr int kThreadsA = 256;      // 8 warps: 4 (rows of 16) x 2 (columns of 32)
constexpr int kThreadsB = 128;
constexpr int kOrbitBits = 21;      // bits of each virtual in a packed orbit

// The elements (x, y, z) of one slot with min(x, y, z) in [a0, a1), L = v -
// a0, w = a1 - a0, L1 = v - a1, as three (x, y, z) boxes, x slowest:
//   0: x in [a0, a1), y, z in [a0, v)            w L L at 0
//   1: x in [a1, v), y in [a0, a1), z in [a0, v)  L1 w L after box 0
//   2: x, y in [a1, v), z in [a0, a1)             L1 L1 w after box 1
struct Slab {
  int a0, a1, nv;
  __host__ __device__ long long L() const { return nv - a0; }
  __host__ __device__ long long w() const { return a1 - a0; }
  __host__ __device__ long long L1() const { return nv - a1; }
  __host__ __device__ long long doubles() const {
    return w() * (L() * L() + L() * L1() + L1() * L1());
  }
  __host__ __device__ long long at(int x, int y, int z) const {
    if (x < a1) return ((x - a0) * L() + (y - a0)) * L() + (z - a0);
    if (y < a1) return w() * L() * L() + ((x - a1) * w() + (y - a0)) * L() + (z - a0);
    return w() * L() * (L() + L1()) + ((x - a1) * L1() + (y - a1)) * w() + (z - a0);
  }
};

// The six orderings of three positions, in the order of the W formula's
// terms: (012) (102) (210) (021) (120) (201).
__host__ __device__ constexpr int perm_at(int p, int d) {
  return d == 0 ? (p == 0 ? 0 : p == 1 ? 1 : p == 2 ? 2 : p == 3 ? 0 : p == 4 ? 1 : 2)
       : d == 1 ? (p == 0 ? 1 : p == 1 ? 0 : p == 2 ? 1 : p == 3 ? 2 : p == 4 ? 2 : 0)
                : (p == 0 ? 2 : p == 1 ? 2 : p == 2 ? 0 : p == 3 ? 1 : p == 4 ? 0 : 1);
}

// Index of the ordering (x, y, z); the first two positions determine it.
__host__ __device__ constexpr int perm_of(int x, int y) {
  return x == 0 ? (y == 1 ? 0 : 3) : x == 1 ? (y == 0 ? 1 : 4) : (y == 1 ? 2 : 5);
}

// p after s: position d of the result is p[s[d]].
__host__ __device__ constexpr int compose(int p, int s) {
  return perm_of(perm_at(p, perm_at(s, 0)), perm_at(p, perm_at(s, 1)));
}

__device__ __forceinline__ int pick(int d, int x0, int x1, int x2) {
  return d == 0 ? x0 : d == 1 ? x1 : x2;
}

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

// One box of R_ijk[a, b, c]: a in [a_lo, a_end), b in [b_lo, b_lo + b_n),
// c in [c_lo, c_end), stored (a, b, c) with c fastest from R + slot *
// slot_stride.  slots (n_slots, 3): the ordered triples of the batch.
struct Box {
  int a_lo, a_end, b_lo, b_n, c_lo, c_end;
};

__global__ void __launch_bounds__(kThreadsA)
triples_raw_kernel(int no, int nv, const int* __restrict__ slots, Box box,
                   long long slot_stride, const double* __restrict__ g_ovvv,
                   const double* __restrict__ g_oovo, const double* __restrict__ t2,
                   double* __restrict__ R) {
  __shared__ double As[kTile][kLd];   // As[a][kappa]
  __shared__ double Bs[kTile][kLd];   // Bs[c][kappa] = B[kappa][c]

  const int slot = blockIdx.x / box.b_n, b = box.b_lo + blockIdx.x % box.b_n;
  const int i = slots[3 * slot], j = slots[3 * slot + 1], k = slots[3 * slot + 2];
  const int c_n = box.c_end - box.c_lo, c_tiles = (c_n + kTile - 1) / kTile;
  const int a0 = box.a_lo + (blockIdx.y / c_tiles) * kTile;
  const int c0 = box.c_lo + (blockIdx.y % c_tiles) * kTile;
  const int depth = nv + no;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / 4, quad = lane % 4;
  const int row0 = 16 * (warp % 4), col0 = 32 * (warp / 4);

  const double* g_ib = g_ovvv + (static_cast<size_t>(i) * nv + b) * nv * nv;   // [a][f]
  const double* o_ij = g_oovo + (static_cast<size_t>(i) * no + j) * nv * no;   // [a][m]
  const double* t_kj = t2 + (static_cast<size_t>(k) * no + j) * nv * nv;       // [c][f]
  const size_t m_stride = static_cast<size_t>(no) * nv * nv;
  const double* t_kb = t2 + (static_cast<size_t>(k) * nv + b) * nv;            // [m * m_stride + c]

  double acc[4][4] = {};
  for (int k0 = 0; k0 < depth; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreadsA) {
      const int r = e / kDepth, kk = e % kDepth, kappa = k0 + kk;
      const int a = a0 + r, c = c0 + r;
      double va = 0.0, vb = 0.0;
      if (kappa < nv) {
        if (a < box.a_end) va = g_ib[static_cast<size_t>(a) * nv + kappa];
        if (c < box.c_end) vb = t_kj[static_cast<size_t>(c) * nv + kappa];
      } else if (kappa < depth) {
        const int m = kappa - nv;
        if (a < box.a_end) va = -o_ij[a * no + m];
        if (c < box.c_end) vb = t_kb[m * m_stride + c];
      }
      As[r][kk] = va;
      Bs[r][kk] = vb;
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

  double* R_row = R + slot * slot_stride + static_cast<long long>(b - box.b_lo) * c_n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = a0 + row0 + 8 * h + group;
    if (a >= box.a_end) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = c0 + col0 + 8 * ni + 2 * quad + r;
        if (c < box.c_end)
          R_row[static_cast<long long>(a - box.a_lo) * box.b_n * c_n + (c - box.c_lo)] =
              acc[ni][2 * h + r];
      }
    }
  }
}

// multisets (n, 9): i <= j <= k, then the batch slot of ordering q of
// (i, j, k) for q = 0..5.  orbits (n_orbits): a | b << 21 | c << 42 with
// a <= b <= c, a in the batch's [a0, a1); R: the batch's slots, each laid
// out as slab.
__global__ void __launch_bounds__(kThreadsB)
triples_energy_kernel(int no, int nv, int n_multisets, int n_orbits, Slab slab,
                      const int* __restrict__ multisets, const long long* __restrict__ orbits,
                      const double* __restrict__ R, const double* __restrict__ g_oovv,
                      const double* __restrict__ t1, const double* __restrict__ eps_o,
                      const double* __restrict__ eps_v, double v_scale,
                      double* __restrict__ partial) {
  __shared__ double reduce[kThreadsB];
  const long long item = static_cast<long long>(blockIdx.x) * kThreadsB + threadIdx.x;
  double acc = 0.0;
  if (item < static_cast<long long>(n_multisets) * n_orbits) {
    const int* info = multisets + 9 * (item / n_orbits);
    const long long packed = orbits[item % n_orbits];
    const int o3[3] = {info[0], info[1], info[2]};
    constexpr long long kMask = (1LL << kOrbitBits) - 1;
    const int v3[3] = {static_cast<int>(packed & kMask),
                       static_cast<int>((packed >> kOrbitBits) & kMask),
                       static_cast<int>(packed >> 2 * kOrbitBits)};
    const size_t v2 = static_cast<size_t>(nv) * nv;

    // R[q][t] = R_{q(ijk)}[t(abc)]
    long long at[6];
#pragma unroll
    for (int t = 0; t < 6; ++t)
      at[t] = slab.at(pick(perm_at(t, 0), v3[0], v3[1], v3[2]),
                      pick(perm_at(t, 1), v3[0], v3[1], v3[2]),
                      pick(perm_at(t, 2), v3[0], v3[1], v3[2]));
    double Rq[6][6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const double* R_slot = R + info[3 + q] * slab.doubles();
#pragma unroll
      for (int t = 0; t < 6; ++t) Rq[q][t] = R_slot[at[t]];
    }
    // t1[o3[x], v3[u]] and <o3[P0] o3[P1] | v3[Q0] v3[Q1]> for the ordered
    // position pairs P, Q (an ordered pair extends to one ordering)
    double t1v[3][3], gv[6][6];
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int u = 0; u < 3; ++u) t1v[x][u] = t1[o3[x] * nv + v3[u]];
#pragma unroll
    for (int P = 0; P < 6; ++P) {
      const double* g_xy = g_oovv + (static_cast<size_t>(o3[perm_at(P, 0)]) * no
                                     + o3[perm_at(P, 1)]) * v2;
#pragma unroll
      for (int Q = 0; Q < 6; ++Q)
        gv[P][Q] = g_xy[v3[perm_at(Q, 0)] * nv + v3[perm_at(Q, 1)]];
    }
    // orderings that repeat an earlier one (equal indices) are skipped
    bool first_p[6], first_t[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      first_p[p] = first_t[p] = true;
#pragma unroll
      for (int e = 0; e < p; ++e) {
        bool same_o = true, same_v = true;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          same_o = same_o && o3[perm_at(p, d)] == o3[perm_at(e, d)];
          same_v = same_v && v3[perm_at(p, d)] == v3[perm_at(e, d)];
        }
        if (same_o) first_p[p] = false;
        if (same_v) first_t[p] = false;
      }
    }

#pragma unroll
    for (int t = 0; t < 6; ++t) {
      if (!first_t[t]) continue;
      // W[p] = W_{p(ijk)}[t(abc)] = sum_s R[p after s][t after s]
      double W[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        double w = 0.0;
#pragma unroll
        for (int s = 0; s < 6; ++s) w += Rq[compose(p, s)][compose(t, s)];
        W[p] = w;
      }
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        if (!first_p[p]) continue;
        const double w_weighted = 4.0 * W[p] + W[compose(p, 4)] + W[compose(p, 5)]
                                  - 4.0 * W[compose(p, 2)] - W[compose(p, 3)] - W[compose(p, 1)];
        // V: for each position d, t1 at d and the integral at the other two
        double v = 0.0;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int e1 = d == 0 ? 1 : 0, e2 = d == 2 ? 1 : 2;
          v += t1v[perm_at(p, d)][perm_at(t, d)] *
               gv[perm_of(perm_at(p, e1), perm_at(p, e2))][perm_of(perm_at(t, e1), perm_at(t, e2))];
        }
        acc += (W[p] + v_scale * v) * w_weighted;
      }
    }
    acc /= eps_o[o3[0]] + eps_o[o3[1]] + eps_o[o3[2]] - eps_v[v3[0]] - eps_v[v3[1]] - eps_v[v3[2]];
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

// batches (host, n_batches x 8): slot begin and end, multiset begin and end,
// a0 and a1, orbit begin and end.  slots (n_slots, 3) and multisets
// (n_multisets, 9) on the device, the multisets' slots counted from their
// batch's first slot.  workspace holds the largest batch's slots, each
// Slab{a0, a1, v}.doubles(); partial one double a stage-B block of every
// batch, batch after batch (ceil(multisets * orbits / 128)).
extern "C" int tuna_ccsd_t_energy(int no, int nv, int n_batches, const int* batches,
                                  const int* slots, const int* multisets,
                                  const long long* orbits, const double* g_oovv,
                                  const double* g_ovvv, const double* g_oovo, const double* t1,
                                  const double* t2, const double* eps_o, const double* eps_v,
                                  double v_scale, double* workspace, double* partial,
                                  cudaStream_t stream) {
  if (nv == 0 || no == 0) return cudaSuccess;
  long long partial_offset = 0;
  for (int batch = 0; batch < n_batches; ++batch) {
    const int* row = batches + 8 * batch;
    const int n_slots = row[1] - row[0], n_multisets = row[3] - row[2];
    const Slab slab{row[4], row[5], nv};
    const int a0 = row[4], a1 = row[5];
    // the three boxes of Slab, in its order: (a, b, c) ranges and offset
    const Box boxes[3] = {{a0, a1, a0, nv - a0, a0, nv},
                          {a1, nv, a0, a1 - a0, a0, nv},
                          {a1, nv, a1, nv - a1, a0, a1}};
    const long long offsets[3] = {0, slab.at(a1, a0, a0), slab.at(a1, a1, a0)};
    for (int part = 0; part < 3; ++part) {
      const Box& box = boxes[part];
      const int a_n = box.a_end - box.a_lo, c_n = box.c_end - box.c_lo;
      if (a_n <= 0 || box.b_n <= 0 || c_n <= 0) continue;
      const dim3 grid(n_slots * box.b_n, ((a_n + kTile - 1) / kTile) * ((c_n + kTile - 1) / kTile));
      triples_raw_kernel<<<grid, kThreadsA, 0, stream>>>(
          no, nv, slots + 3 * row[0], box, slab.doubles(), g_ovvv, g_oovo, t2,
          workspace + offsets[part]);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    const int n_orbits = row[7] - row[6];
    const long long items = static_cast<long long>(n_multisets) * n_orbits;
    const long long blocks = (items + kThreadsB - 1) / kThreadsB;
    triples_energy_kernel<<<static_cast<unsigned>(blocks), kThreadsB, 0, stream>>>(
        no, nv, n_multisets, n_orbits, slab, multisets + 9 * row[2], orbits + row[6], workspace,
        g_oovv, t1, eps_o, eps_v, v_scale, partial + partial_offset);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    partial_offset += blocks;
  }
  return cudaSuccess;
}
