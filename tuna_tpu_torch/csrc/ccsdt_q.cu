// K9: the (Q) correction of CCSDT[Q] and CCSDT(Q), E_MP5 and E_MP6.
//
// Replaces tuna_tpu/post/cc.py::restricted_CCSDT_Q (cc.py:1821), which
// forms t4 = e * G / 2 and its MP6 intermediates as o^4 v^4 arrays:
//   Graw[ijkl abcd] =   sum_e (ia|be) t3[jkl ecd]        - sum_m (ia|mj) t3[mkl bcd]
//                     + sum_mn (mi|nj) t2[mkac] t2[nlbd] - 2 sum_me (ia|me) t2[kjeb] t2[mlcd]
//                     + sum_ef (cf|ae) t2[ijeb] t2[klfd] - 2 sum_em (be|mi) t2[kjce] t2[mlad]
//   t4 = e / 2 * sum_sigma Graw[(ijkl).sigma, (abcd).sigma]   (24 simultaneous permutations)
//   E_MP5 = sum t4 Z5, E_MP6 = sum t4 Z6,
// with Z5 = u[klab] K[ijcd] - 2 u[klbd] L[ijac] + u[klcd] L[ijab] (u = 2 t2 -
// t2^T, K[ijab] = (ia|jb), L = 2 K - K^T) and Z6 = 2 (-2 al[abcd] - al[cdab]
// + al[bacd]) + 2 (2 be[dbac] - be[bdac] + 2 be[cbda] - be[bcda]), where al
// and be are tuna_tpu's alpha and beta of the same (ijkl):
//   S1 = sum_m t3[mjicba] (ld|km), S3 = sum_m t3[mjicba] (kd|lm),
//   T1 = sum_e t3[kjieba] (ld|ce), T2 = sum_e t3[ljieba] (kd|ce),
//   al = 2 S1 - S1[abdc] - 2 T1 + T2,  be = 2 S3 - S3[abdc] - 2 T2 + T1.
// (tuna_tpu_torch/post/cc.py derives this form; its plain version,
// _ccsdt_q_energy_plain, runs the same plan in torch.einsum.)
//
// What bounds it on an H100: operations.  The function needs the raw terms
// and alpha and beta, 4 v + 6 o multiply-adds an element of every ordering
// (S2 and S4 below are S1 and S3 with c and d exchanged), plus the vvvv
// term's half W once a pair (i, j): ~8.7e10 operations at o = 7, v = 19
// (1.30 ms at the float64 tensor-core rate, 67 TFLOP/s) and ~1.0e13 at
// v = 53 (156 ms), against ~1e8 bytes of inputs.  What it moves: each slot
// (below) writes Graw, alpha and beta once and the energy stage reads them
// back, Graw once for each permutation that reaches the slot and alpha and
// beta at the 3 and 4 permutations of Z6: ~12 doubles an element of every
// ordering, 30 GB at (7, 19) (9 ms at 3.35 TB/s if none stayed in the
// 50 MB L2) and 1.8 TB at (7, 53) (0.55 s).  Forming W once a pair would
// need o^2 v^4 doubles held across the batches (51 MB at (7, 19), 3.1 GB
// at (7, 53)), so the raw stage forms the vvvv term as two products a (c,
// a), v^3 each, one more than W once a pair would leave: ~6% of the
// operations at v = 19.  The raw stage is held back by what its blocks
// move, not by its products: a build with every product and sum taken out
// kept most of its time (the copies into shared memory, the loads of the
// depth-m operands and the stores of its three arrays, 8 bytes a lane).
//
// Design.  t4 is symmetric under every sigma, so the sum over the o^4 ordered
// (ijkl) is a sum over the multisets {i <= j <= k <= l} of
//   1/2 sum_y e[x, y] Gsym[y] Zsym[y],
//   Gsym[y] = sum_sigma Graw[x.sigma, y.sigma], Zsym[y] = sum_tau Z[x.tau, y.tau],
// x the multiset's sorted quadruple, tau one permutation for each distinct
// ordering of x, (y.sigma)_p = y_sigma(p).  Each distinct ordering (a slot)
// needs Graw, alpha and beta as three blocks, and nothing is o^4 v^4.
// Permuting y keeps min(y), so the sum over y also splits over ranges
// [a0, a1) of min(y): a batch of the host plan (post/cc.py::quadruples_plan)
// takes one range, and its slots hold Graw, alpha and beta only at the
// (a, b, c, d) with min in the range, as four boxes (Cut, below; the range
// [0, v) is one box of v^4).  A batch runs three kernels:
//   quadruples_xyv_kernel: X[nac] = sum_m (mi|nj) t2[mkac], Y[amb] = sum_e
//       (ia|me) t2[kjeb], V[cmb] = sum_e (be|mi) t2[kjce], o v^2 each, a
//       thread an element;
//   quadruples_raw_kernel: Graw, alpha and beta on the float64 tensor
//       cores (mma.sync.m16n8k8, csrc/dmma.cuh).  A block takes one (slot,
//       box, a, group of 8 d, group of 32 b); with a and c fixed, rows b
//       (16 a tile) and columns d, every term but four is a product: sum_e
//       (ia|be) t3[jkl ecd], T1 and T2 (depth e), the vvvv term as sum_e
//       t2[ijeb] P[ed] with P[ed] = sum_f (cf|ae) t2[klfd] formed first into
//       shared memory (shared by the block's b tiles), and -2 Y[amb]
//       t2[mlcd], -2 V[cmb] t2[mlad], S1 and S3 (depth m).  The other four,
//       -(ia|mj) t3[mkl bcd], X[nac] t2[nlbd], S2 and S4, are o-deep sums
//       on the CUDA cores in the epilogue, from tables the block stages
//       once (t2[nl b d] and t3[mji d b a] at its b and d, X, (lc|km) and
//       (kc|lm) at every c) and t3 along d, four values of m at a time.
//       The operands are read along runs: the wrapper hands over t3 also as
//       t3t[j][i][a][m][c][b] = t3[mjicba] (the reversed orderings of T1,
//       T2 and the S terms then run along b), (ia|be) as [i][a][b][e],
//       (ld|ce) as [l][c][e][d] and (ld|km) as [l][k][m][d].  The block's
//       tables go into shared memory by cp.async, all in flight at once;
//       warps take (c, b tile) tasks, 4 values of c at a time, so v = 19
//       keeps all 8 busy; each loop loads its next step's operands before
//       this step's products.  A block's shared memory (raw_shared_doubles)
//       is 69 KB at (7, 19) and 115 KB at (7, 53); above 227 KB (o = 16 at
//       v = 104) the C entry refuses;
//   quadruples_energy_kernel: a block takes a multiset and 4-D tiles of y
//       (at most 4 along each axis, none across a1, so each permuted tile
//       is a box of one of a slot's boxes); a thread takes an element, so a
//       warp reads a 2 x 4 x 4 box of each permuted tile, along d in the
//       slot for 18 of the 24 permutations, at an offset of four
//       multiply-adds from a table the block makes for each tile; then
//       Gsym, the two Zsym (Z5 from t2 and c), and 1/2 e Gsym Zsym with
//       fixed-order block partials (two calls agree bitwise: no atomics).
// A multiset with more slots than the workspace holds is cut over its slots:
// its batches carry Gsym, Zsym5 and Zsym6 (3 Cut elements at the front of
// the workspace, there only in such batches) from one to the next, and only
// the last adds energy.
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;                       // energy tiles: up to 4 along each axis

__constant__ int kPerm[24][4] = {
    {0, 1, 2, 3}, {0, 1, 3, 2}, {0, 2, 1, 3}, {0, 2, 3, 1}, {0, 3, 1, 2}, {0, 3, 2, 1},
    {1, 0, 2, 3}, {1, 0, 3, 2}, {1, 2, 0, 3}, {1, 2, 3, 0}, {1, 3, 0, 2}, {1, 3, 2, 0},
    {2, 0, 1, 3}, {2, 0, 3, 1}, {2, 1, 0, 3}, {2, 1, 3, 0}, {2, 3, 0, 1}, {2, 3, 1, 0},
    {3, 0, 1, 2}, {3, 0, 2, 1}, {3, 1, 0, 2}, {3, 1, 2, 0}, {3, 2, 0, 1}, {3, 2, 1, 0}};

// Z6's reads of alpha (first 3) and beta (last 4) at (a, b, c, d) = y.sigma:
// al at (abcd), (cdab), (bacd), be at (dbac), (bdac), (cbda), (bcda), as
// position maps pi (the read is at w_q = (y.sigma)_pi(q)), with Z6's
// coefficients over 2.
__constant__ int kZ6Perm[7][4] = {{0, 1, 2, 3}, {2, 3, 0, 1}, {1, 0, 2, 3}, {3, 1, 0, 2},
                                  {1, 3, 0, 2}, {2, 1, 3, 0}, {1, 2, 3, 0}};
__constant__ double kZ6Coef[7] = {-2.0, -1.0, 1.0, 2.0, -1.0, 2.0, -1.0};

// Shapes and strides of the inputs: c is the correlated window's chemists'
// (pq|rs), n = no + nv a side, virtual a at n index no + a.
struct Dims {
  int no, nv, n;
  __device__ long long c(int p, int q, int r, int s) const {
    return ((static_cast<long long>(p) * n + q) * n + r) * n + s;
  }
  __device__ long long t2(int i, int j, int a, int b) const {
    return ((static_cast<long long>(i) * no + j) * nv + a) * nv + b;
  }
  __device__ long long t3(int i, int j, int k, int a, int b, int c) const {
    return ((((static_cast<long long>(i) * no + j) * no + k) * nv + a) * nv + b) * nv + c;
  }
};

// The (a, b, c, d) with min in [a0, a1) as four boxes: box p holds those
// whose first index below a1 is at position p, so a position q < p runs over
// [a1, v), p over [a0, a1) and q > p over [a0, v).  Graw, alpha, beta and
// the carried sums are stored box after box, each box row-major.  A slot's
// doubles: Graw, alpha, beta, then X, Y, V (o v^2 each).  The raw stage
// takes blocks (box, a, group of 8 d, group of 32 b) of each slot, block_offset[p] the
// first of box p; the energy stage tiles of y, tile_offset[p] the first of
// box p, each axis of a box cut at a1 and tiled by kTile from the start of
// each part (post/cc.py::quadruples_tiles mirrors the order).
struct Cut {
  int a0, a1, nv;
  long long offset[5];        // first element of box p; offset[4] = elements
  long long ov2;
  int block_offset[5];        // first raw block of box p
  int tile_offset[5];         // first energy tile of box p
  __host__ __device__ int lo(int p, int q) const { return q < p ? a1 : a0; }
  __host__ __device__ int len(int p, int q) const {
    return q < p ? nv - a1 : (q == p ? a1 - a0 : nv - a0);
  }
  // the two parts of axis q of box p, [lo, mid) and [mid, hi): below and
  // above a1 where the axis runs over [a0, v), the whole axis otherwise
  __host__ __device__ int mid(int p, int q) const { return q > p ? a1 : lo(p, q) + len(p, q); }
  __host__ __device__ int tiles(int p, int q) const {
    const int below = mid(p, q) - lo(p, q), above = lo(p, q) + len(p, q) - mid(p, q);
    return (below + kTile - 1) / kTile + (above + kTile - 1) / kTile;
  }
  __host__ void set(int a0_, int a1_, int nv_, long long ov2_) {
    a0 = a0_;
    a1 = a1_;
    nv = nv_;
    ov2 = ov2_;
    offset[0] = 0;
    block_offset[0] = tile_offset[0] = 0;
    for (int p = 0; p < 4; ++p) {
      const long long ab = static_cast<long long>(len(p, 0)) * len(p, 1);
      const long long bcd = static_cast<long long>(len(p, 1)) * len(p, 2) * len(p, 3);
      offset[p + 1] = offset[p] + ab * len(p, 2) * len(p, 3);
      block_offset[p + 1] = block_offset[p] +
                            (bcd > 0 ? len(p, 0) * ((len(p, 3) + 7) / 8) * ((len(p, 1) + 31) / 32)
                                     : 0);
      tile_offset[p + 1] = tile_offset[p] + tiles(p, 0) * tiles(p, 1) * tiles(p, 2) * tiles(p, 3);
    }
  }
  // offset[p], block_offset[p] and tile_offset[p] for a runtime p, by
  // selects: indexing the kernel parameter would copy it to local memory
  __device__ long long offset_of(int p) const {
    return p == 0 ? offset[0] : (p == 1 ? offset[1] : (p == 2 ? offset[2] : offset[3]));
  }
  __device__ int block_offset_of(int p) const {
    return p == 0 ? block_offset[0]
                  : (p == 1 ? block_offset[1] : (p == 2 ? block_offset[2] : block_offset[3]));
  }
  __device__ int tile_offset_of(int p) const {
    return p == 0 ? tile_offset[0]
                  : (p == 1 ? tile_offset[1] : (p == 2 ? tile_offset[2] : tile_offset[3]));
  }
  __host__ __device__ long long elements() const { return offset[4]; }
  __host__ __device__ long long slot_doubles() const { return 3 * offset[4] + 3 * ov2; }
  // the box of a y with min in [a0, a1)
  __device__ int box(int a, int b, int c) const {
    return a < a1 ? 0 : (b < a1 ? 1 : (c < a1 ? 2 : 3));
  }
};

__global__ void __launch_bounds__(kThreads, 4)
quadruples_xyv_kernel(Dims D, Cut R, const int* __restrict__ slots, int blocks_per_slot,
                      const double* __restrict__ c, const double* __restrict__ t2,
                      double* __restrict__ work) {
  const int slot = blockIdx.x / blocks_per_slot;
  const long long q =
      static_cast<long long>(blockIdx.x % blocks_per_slot) * kThreads + threadIdx.x;
  if (q >= 3 * R.ov2) return;
  const int no = D.no, nv = D.nv;
  const int i = slots[4 * slot], j = slots[4 * slot + 1], k = slots[4 * slot + 2];
  double* out = work + R.slot_doubles() * slot + 3 * R.elements();
  const int part = static_cast<int>(q / R.ov2);
  const int r = static_cast<int>(q % R.ov2);
  double acc = 0.0;
  if (part == 0) {          // X[n a c], r = (n * v + a) * v + c
    const int x = r / (nv * nv), y = (r / nv) % nv, z = r % nv;
    for (int m = 0; m < no; ++m) acc += c[D.c(m, i, x, j)] * t2[D.t2(m, k, y, z)];
    out[r] = acc;
  } else if (part == 1) {   // Y[a m b], r = (a * o + m) * v + b
    const int a = r / (no * nv), m = (r / nv) % no, b = r % nv;
    for (int e = 0; e < nv; ++e) acc += c[D.c(i, no + a, m, no + e)] * t2[D.t2(k, j, e, b)];
    out[R.ov2 + r] = acc;
  } else {                  // V[c m b], r = (c * o + m) * v + b: the raw stage reads it along b
    const int cc = r / (no * nv), m = (r / nv) % no, b = r % nv;
    for (int e = 0; e < nv; ++e) acc += c[D.c(no + b, no + e, m, i)] * t2[D.t2(k, j, cc, e)];
    out[2 * R.ov2 + r] = acc;
  }
}

// The raw stage's blocks: (box, a, group of 8 d, group of kBRows b).
constexpr int kBRows = 32;                      // b a raw block: two m16n8k8 row tiles
constexpr int kChunk = kWarps / (kBRows / 16);  // values of c a chunk, one warp a (c, b tile)

// Row stride of a staged (b x e) operand: e padded to 8, plus 4, so a
// half-warp's fragment reads hit distinct banks.
__host__ __device__ inline int raw_ld(int nv) { return 8 * ((nv + 7) / 8) + 4; }
// The raw stage's shared doubles: the four (b x e) A operands of the block
// ((ia|be), t2[ijeb], t3[kji e b a], t3[lji e b a]; kBRows x raw_ld), P of
// kChunk values of c (16 ceil(v / 16) x 8 each), t3[m j i d b a] and t2[n l
// b d] at the block's b and d (o x 8 x kBRows each), X[n a c], (lc|km) and
// (kc|lm) at every c (3 o v) and (ia|mj) (o).
__host__ __device__ inline long long raw_shared_doubles(int no, int nv) {
  return 4LL * kBRows * raw_ld(nv) + 128LL * kChunk * ((nv + 15) / 16) +
         16LL * no * kBRows + 3LL * no * nv + no;
}

// One block a (slot, box, a, group of 8 d, group of kBRows b): Graw, alpha
// and beta there for every c of the box.  cov (ia|be) as [i][a][b][e]; cvt
// (ld|ce) as [l][c][e][d]; clk (ld|km) as [l][k][m][d]; t3t[j][i][a][m][c]
// [b] = t3[mjicba].  Fragments come from shared memory, zero-padded, or
// from device memory at clamped indices, so no load waits on a branch:
// depth past the end is zero on one side of each product, and rows and
// columns past the end are computed and not stored.
__global__ void __launch_bounds__(kThreads)
quadruples_raw_kernel(Dims D, Cut R, const int* __restrict__ slots,
                      const double* __restrict__ c, const double* __restrict__ cov,
                      const double* __restrict__ cvt, const double* __restrict__ clk,
                      const double* __restrict__ t2, const double* __restrict__ t3,
                      const double* __restrict__ t3t, double* __restrict__ work) {
  extern __shared__ double shared[];
  const int no = D.no, nv = D.nv;
  const int per_slot = R.block_offset[4];
  const int slot = blockIdx.x / per_slot;
  const int block = blockIdx.x % per_slot;
  const int p = block >= R.block_offset[3] ? 3
                : (block >= R.block_offset[2] ? 2 : (block >= R.block_offset[1] ? 1 : 0));
  const int n1 = R.len(p, 1), n2 = R.len(p, 2), n3 = R.len(p, 3);
  const int d_groups = (n3 + 7) / 8, b_groups = (n1 + kBRows - 1) / kBRows;
  int rest = block - R.block_offset_of(p);
  const int b_group = rest % b_groups;
  rest /= b_groups;
  const int group = rest % d_groups, a_local = rest / d_groups;
  const int a = R.lo(p, 0) + a_local, lo2 = R.lo(p, 2);
  const int b_first = 32 * b_group;                           // within the box
  const int lo1 = R.lo(p, 1) + b_first, nb = min(kBRows, n1 - b_first);
  const int d0 = R.lo(p, 3) + 8 * group, nd = min(8, n3 - 8 * group);
  const int i = slots[4 * slot], j = slots[4 * slot + 1];
  const int k = slots[4 * slot + 2], l = slots[4 * slot + 3];
  double* base = work + R.slot_doubles() * slot;
  const double* X = base + 3 * R.elements();
  const double* Y = X + R.ov2;
  const double* V = Y + R.ov2;
  const long long v2 = static_cast<long long>(nv) * nv, v3 = v2 * nv;
  const long long n_ = D.n;
  const int ld = raw_ld(nv), e_pad = ld - 4;
  const int e_tiles = (nv + 15) / 16, p_rows = 16 * e_tiles;

  double* Ab = shared;                          // [operand][b'][e], kBRows x ld each
  double* P = Ab + 4 * kBRows * ld;             // [chunk c][e][dd]
  double* t3d = P + kChunk * p_rows * 8;        // t3[m j i d b a], [m][dd][b']
  double* t2lbd = t3d + 8 * no * kBRows;        // t2[n l b d], [n][b'][dd]
  double* xa = t2lbd + 8 * no * kBRows;         // X[n a c], [n][c']
  double* clc = xa + no * nv;                   // (lc|km), [m][c']
  double* kcl = clc + no * nv;                  // (kc|lm), [m][c']
  double* cam = kcl + no * nv;                  // (ia|mj), m
  const double* t3ji_a = t3t + ((static_cast<long long>(j) * no + i) * nv + a) * no * v2;
  const double* cov_ia = cov + (static_cast<long long>(i) * nv + a) * v2;     // [b][e]
  const double* t2ij = t2 + D.t2(i, j, 0, 0);                                 // [e][b]
  const double* t3k = t3ji_a + k * v2;                                        // [e][b]
  const double* t3l = t3ji_a + l * v2;
  // the block's tables by cp.async, zero past the ends, all in flight at once
  for (int x = threadIdx.x; x < kBRows * ld; x += kThreads) {
    const int b = x / ld, e = x % ld;
    const bool in = b < nb && e < nv;
    cp_async8_zfill(Ab + x, in ? cov_ia + (lo1 + b) * nv + e : c, in);
  }
  for (int x = threadIdx.x; x < kBRows * e_pad; x += kThreads) {
    const int e = x / kBRows, b = x % kBRows;                 // along b, as t2 and t3t run
    const bool in = b < nb && e < nv;
    const long long from = in ? static_cast<long long>(e) * nv + lo1 + b : 0;
    cp_async8_zfill(Ab + (kBRows + b) * ld + e, t2ij + from, in);
    cp_async8_zfill(Ab + (2 * kBRows + b) * ld + e, t3k + from, in);
    cp_async8_zfill(Ab + (3 * kBRows + b) * ld + e, t3l + from, in);
  }
  for (int x = threadIdx.x; x < no * 8 * kBRows; x += kThreads) {
    const int m = x / (8 * kBRows), dd = (x / kBRows) % 8, b = x % kBRows;
    const bool in = dd < nd && b < nb;
    cp_async8_zfill(t3d + x, in ? t3ji_a + (static_cast<long long>(m) * nv + d0 + dd) * nv + lo1 + b
                                : c, in);
  }
  for (int x = threadIdx.x; x < no * kBRows * 8; x += kThreads) {
    const int n = x / (8 * kBRows), b = (x / 8) % kBRows, dd = x % 8;
    const bool in = dd < nd && b < nb;
    cp_async8_zfill(t2lbd + x, in ? t2 + D.t2(n, l, lo1 + b, d0 + dd) : c, in);
  }
  for (int x = threadIdx.x; x < no * n2; x += kThreads) {
    const int m = x / n2, cv = lo2 + x % n2;
    cp_async8(xa + x, X + (static_cast<long long>(m) * nv + a) * nv + cv);
    cp_async8(clc + x, clk + ((static_cast<long long>(l) * no + k) * no + m) * nv + cv);
    cp_async8(kcl + x, clk + ((static_cast<long long>(k) * no + l) * no + m) * nv + cv);
  }
  for (int m = threadIdx.x; m < no; m += kThreads) cp_async8(cam + m, c + D.c(i, no + a, m, j));
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int b_tiles = (nb + 15) / 16;
  const int dg = d0 + min(g, nd - 1);          // this lane's column, clamped
  const double* t2kl = t2 + D.t2(k, l, 0, 0);                                 // [f][d]
  const double* t3jkl = t3 + D.t3(j, k, l, 0, 0, 0);                          // [e][c][d]
  const double* cvt_l = cvt + static_cast<long long>(l) * v3;                 // [c][e][d]
  const double* cvt_k = cvt + static_cast<long long>(k) * v3;
  const double* clk_lk = clk + (static_cast<long long>(l) * no + k) * no * nv;  // [m][d]
  const double* clk_kl = clk + (static_cast<long long>(k) * no + l) * no * nv;
  const double* Ya = Y + static_cast<long long>(a) * no * nv;                 // [m][b]

  for (int c0 = 0; c0 < n2; c0 += kChunk) {
    const int n_c = min(kChunk, n2 - c0);
    // P[e][d] = sum_f (cf|ae) t2[kl f d] for each c of the chunk; the next
    // step's operands are loaded before this step's product
    for (int task = warp; task < n_c * e_tiles; task += kWarps) {
      const int cc = task / e_tiles, e0 = 16 * (task % e_tiles), cv = lo2 + c0 + cc;
      const double* cfa = c + D.c(no + cv, no, no + a, no);                   // [f] n^2, [e] 1
      const int e_lo = min(e0 + g, nv - 1), e_hi = min(e0 + g + 8, nv - 1);
      auto load = [&](int f0, double (&fa)[4], double& b0, double& b1) {
        const int f_lo = min(f0 + q, nv - 1), f_hi = min(f0 + q + 4, nv - 1);
        const double u_lo = f0 + q < nv ? 1.0 : 0.0, u_hi = f0 + q + 4 < nv ? 1.0 : 0.0;
        fa[0] = u_lo * cfa[f_lo * n_ * n_ + e_lo];
        fa[1] = u_lo * cfa[f_lo * n_ * n_ + e_hi];
        fa[2] = u_hi * cfa[f_hi * n_ * n_ + e_lo];
        fa[3] = u_hi * cfa[f_hi * n_ * n_ + e_hi];
        b0 = t2kl[f_lo * nv + dg];
        b1 = t2kl[f_hi * nv + dg];
      };
      double acc[4] = {0.0, 0.0, 0.0, 0.0}, fa[4], b0, b1;
      load(0, fa, b0, b1);
      for (int f0 = 0; f0 < nv; f0 += 8) {
        double next[4] = {0.0, 0.0, 0.0, 0.0}, n0 = 0.0, n1_ = 0.0;
        if (f0 + 8 < nv) load(f0 + 8, next, n0, n1_);
        mma_f64(acc, fa, b0, b1);
        fa[0] = next[0];
        fa[1] = next[1];
        fa[2] = next[2];
        fa[3] = next[3];
        b0 = n0;
        b1 = n1_;
      }
      double* out = P + (cc * p_rows + e0 + g) * 8 + 2 * q;
      out[0] = acc[0];
      out[1] = acc[1];
      out[64] = acc[2];
      out[65] = acc[3];
    }
    __syncthreads();
    for (int task = warp; task < n_c * b_tiles; task += kWarps) {
      const int cc = task / b_tiles, bt = 16 * (task % b_tiles);
      const int c_local = c0 + cc, cv = lo2 + c_local;
      const double* Pc = P + cc * p_rows * 8;
      double graw[4] = {0.0, 0.0, 0.0, 0.0}, s1[4] = {0.0, 0.0, 0.0, 0.0};
      double s3[4] = {0.0, 0.0, 0.0, 0.0}, tt1[4] = {0.0, 0.0, 0.0, 0.0};
      double tt2[4] = {0.0, 0.0, 0.0, 0.0};
      const double* t3c = t3jkl + static_cast<long long>(cv) * nv + dg;      // [e] v^2
      const double* cl = cvt_l + static_cast<long long>(cv) * v2 + dg;       // [e] v
      const double* ck = cvt_k + static_cast<long long>(cv) * v2 + dg;
      const double* row = Ab + (bt + g) * ld + q;
      // depth m first (its loads go out together): -2 Y[amb] t2[mlcd] - 2
      // V[cmb] t2[mlad]; S1; S3
      const double* Vc = V + static_cast<long long>(cv) * no * nv;            // [m][b]
      const double* t3ji_c = t3ji_a + static_cast<long long>(cv) * nv;        // [m] v^2, [b] 1
      const int b_lo = lo1 + min(bt + g, nb - 1), b_hi = lo1 + min(bt + g + 8, nb - 1);
      for (int m0 = 0; m0 < no; m0 += 8) {
        const int ml = min(m0 + q, no - 1), mh = min(m0 + q + 4, no - 1);
        const double wl = m0 + q < no ? 1.0 : 0.0, wh = m0 + q + 4 < no ? 1.0 : 0.0;
        const double fy[4] = {-2.0 * wl * Ya[ml * nv + b_lo], -2.0 * wl * Ya[ml * nv + b_hi],
                              -2.0 * wh * Ya[mh * nv + b_lo], -2.0 * wh * Ya[mh * nv + b_hi]};
        const double fv[4] = {-2.0 * wl * Vc[ml * nv + b_lo], -2.0 * wl * Vc[ml * nv + b_hi],
                              -2.0 * wh * Vc[mh * nv + b_lo], -2.0 * wh * Vc[mh * nv + b_hi]};
        const double fs[4] = {wl * t3ji_c[ml * v2 + b_lo], wl * t3ji_c[ml * v2 + b_hi],
                              wh * t3ji_c[mh * v2 + b_lo], wh * t3ji_c[mh * v2 + b_hi]};
        const double by0 = t2[D.t2(ml, l, cv, dg)], by1 = t2[D.t2(mh, l, cv, dg)];
        const double bv0 = t2[D.t2(ml, l, a, dg)], bv1 = t2[D.t2(mh, l, a, dg)];
        const double bl0 = clk_lk[ml * nv + dg], bl1 = clk_lk[mh * nv + dg];
        const double bk0 = clk_kl[ml * nv + dg], bk1 = clk_kl[mh * nv + dg];
        mma_f64(graw, fy, by0, by1);
        mma_f64(graw, fv, bv0, bv1);
        mma_f64(s1, fs, bl0, bl1);
        mma_f64(s3, fs, bk0, bk1);
      }
      // depth e: sum_e (ia|be) t3[jkl ecd] + t2[ijeb] P[ed]; T1; T2, with
      // the next step's B operands loaded before this step's products
      double bt0, bt1, bl0, bl1, bk0, bk1;
      auto load_b = [&](int e0, double& x0, double& x1, double& y0, double& y1, double& z0,
                        double& z1) {
        const int e_lo = min(e0 + q, nv - 1), e_hi = min(e0 + q + 4, nv - 1);
        x0 = t3c[e_lo * v2];
        x1 = t3c[e_hi * v2];
        y0 = cl[e_lo * nv];
        y1 = cl[e_hi * nv];
        z0 = ck[e_lo * nv];
        z1 = ck[e_hi * nv];
      };
      load_b(0, bt0, bt1, bl0, bl1, bk0, bk1);
      for (int e0 = 0; e0 < e_pad; e0 += 8) {
        double nt0 = 0.0, nt1 = 0.0, nl0 = 0.0, nl1 = 0.0, nk0 = 0.0, nk1 = 0.0;
        if (e0 + 8 < e_pad) load_b(e0 + 8, nt0, nt1, nl0, nl1, nk0, nk1);
        double fa[4];
        const double* r0 = row + e0;
#define TUNA_A(op) fa[0] = r0[(op) * kBRows * ld]; fa[1] = r0[(op) * kBRows * ld + 8 * ld]; \
                   fa[2] = r0[(op) * kBRows * ld + 4]; fa[3] = r0[(op) * kBRows * ld + 8 * ld + 4]
        TUNA_A(0);
        mma_f64(graw, fa, bt0, bt1);
        TUNA_A(1);
        mma_f64(graw, fa, Pc[(e0 + q) * 8 + g], Pc[(e0 + q + 4) * 8 + g]);
        TUNA_A(2);
        mma_f64(tt1, fa, bl0, bl1);
        TUNA_A(3);
        mma_f64(tt2, fa, bk0, bk1);
#undef TUNA_A
        bt0 = nt0;
        bt1 = nt1;
        bl0 = nl0;
        bl1 = nl1;
        bk0 = nk0;
        bk1 = nk1;
      }
      // the epilogue: the four o-deep sums that are no product here, then
      // Graw, alpha and beta of the fragment's (b, d); -(ia|mj) t3[mkl bcd]
      // reads t3 four values of m at a time for all four elements at once
      const long long m_stride = static_cast<long long>(no) * no * v3;
      const double* t3m[4];
#pragma unroll
      for (int at = 0; at < 4; ++at) {
        const int b = min(bt + g + 8 * (at / 2), nb - 1), dd = min(2 * q + at % 2, nd - 1);
        t3m[at] = t3 + D.t3(0, k, l, lo1 + b, cv, d0 + dd);
      }
      double cams[4] = {0.0, 0.0, 0.0, 0.0};
      for (int m0 = 0; m0 < no; m0 += 4) {
        double tv[4][4];
#pragma unroll
        for (int at = 0; at < 4; ++at)
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) tv[at][mm] = t3m[at][min(m0 + mm, no - 1) * m_stride];
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const double w = m0 + mm < no ? cam[m0 + mm] : 0.0;
#pragma unroll
          for (int at = 0; at < 4; ++at) cams[at] += w * tv[at][mm];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int b = bt + g + 8 * h, dd = 2 * q + r, at = 2 * h + r;
          if (b >= nb || dd >= nd) continue;
          double G = graw[at] - cams[at], s2 = 0.0, s4 = 0.0;
          for (int m = 0; m < no; ++m) {
            G += xa[m * n2 + c_local] * t2lbd[(m * kBRows + b) * 8 + dd];
            const double t = t3d[(m * 8 + dd) * kBRows + b];
            s2 += t * clc[m * n2 + c_local];
            s4 += t * kcl[m * n2 + c_local];
          }
          const long long out = R.offset_of(p) +
              ((static_cast<long long>(a_local) * n1 + b_first + b) * n2 + c_local) * n3 +
              8 * group + dd;
          base[out] = G;
          base[R.elements() + out] = 2.0 * s1[at] - s2 - 2.0 * tt1[at] + tt2[at];   // alpha
          base[2 * R.elements() + out] = 2.0 * s3[at] - s4 - 2.0 * tt2[at] + tt1[at];   // beta
        }
      }
    }
    __syncthreads();   // the next chunk's P overwrites this one's
  }
}

// u[klxy] = 2 t2[klxy] - t2[klyx]; K[ijxy] = (ix|jy); L = 2 K - K^T
__device__ double u_of(const Dims& D, const double* t2, int k, int l, int x, int y) {
  return 2.0 * t2[D.t2(k, l, x, y)] - t2[D.t2(k, l, y, x)];
}
__device__ double k_of(const Dims& D, const double* c, int i, int j, int x, int y) {
  return c[D.c(i, D.no + x, j, D.no + y)];
}
__device__ double l_of(const Dims& D, const double* c, int i, int j, int x, int y) {
  return 2.0 * k_of(D, c, i, j, x, y) - k_of(D, c, i, j, y, x);
}

// An energy tile: box p, the start and extent of each axis.
struct Tile {
  int p, start[4], extent[4];
};

// x[i] for a runtime i, without indexing the array (which would put it in
// local memory)
__device__ __forceinline__ int pick(const int (&x)[4], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : (i == 2 ? x[2] : x[3]));
}

__device__ __forceinline__ Tile tile_at(const Cut& R, int index) {
  Tile t;
  t.p = index >= R.tile_offset[3] ? 3
        : (index >= R.tile_offset[2] ? 2 : (index >= R.tile_offset[1] ? 1 : 0));
  int rest = index - R.tile_offset_of(t.p);
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    const int n = R.tiles(t.p, q), u = rest % n;
    rest /= n;
    const int lo = R.lo(t.p, q), mid = R.mid(t.p, q), hi = lo + R.len(t.p, q);
    const int below = (mid - lo + kTile - 1) / kTile;
    t.start[q] = u < below ? lo + kTile * u : mid + kTile * (u - below);
    t.extent[q] = min(kTile, (u < below ? mid : hi) - t.start[q]);
  }
  return t;
}

// The index of a permutation in kPerm's lexicographic order.
__device__ __forceinline__ int perm_index(int r0, int r1, int r2) {
  return 6 * r0 + 2 * (r1 - (r1 > r0)) + (r2 - (r2 > r0) - (r2 > r1));
}

// multisets: (i, j, k, l), 24 global slots, the mask of first permutations.
// blocks_per_multiset blocks take one multiset of the batch, each the tiles
// t = b, b + blocks_per_multiset, ... of the range in turn (a fixed order),
// thread u the element of the tile at offsets (u >> 6, u >> 4 & 3, u >> 2 &
// 3, u & 3), so that a warp reads a 2 x 4 x 4 box of every permuted tile,
// along d in the slot for 18 of the 24 permutations.  For each tile the
// block first finds, for each permutation rho, where the permuted tile
// starts in a slot (its box is the same for all its elements, since no
// tile crosses a1) and the stride of each of the tile's own axes there;
// an element's read is then four multiply-adds.  Only the batch that ends
// its multisets (last) writes partials, two (MP5, MP6) a block.
__global__ void __launch_bounds__(kThreads)
quadruples_energy_kernel(Dims D, Cut R, const int* __restrict__ slots,
                         const int* __restrict__ multisets, int slot_begin, int slot_end,
                         int blocks_per_multiset, int first, int last,
                         const double* __restrict__ c, const double* __restrict__ t2,
                         const double* __restrict__ eps_o, const double* __restrict__ eps_v,
                         const double* __restrict__ work, double* __restrict__ carry,
                         double* __restrict__ partial) {
  __shared__ double reduce5[kThreads];
  __shared__ double reduce6[kThreads];
  __shared__ long long origin[24];                  // the permuted tile's first element
  __shared__ int4 along[24];                        // its stride along each axis of the tile
  __shared__ unsigned char composed[24][7];         // sigma . pi of Z6's reads
  const int* row = multisets + 29 * (blockIdx.x / blocks_per_multiset);
  const int mask = row[28];
  const long long n = R.elements();
  const double eps_ijkl = eps_o[row[0]] + eps_o[row[1]] + eps_o[row[2]] + eps_o[row[3]];
  const int u0 = threadIdx.x >> 6, u1 = (threadIdx.x >> 4) & 3, u2 = (threadIdx.x >> 2) & 3,
            u3 = threadIdx.x & 3;
  if (threadIdx.x < 24 * 7) {
    const int s = threadIdx.x / 7, z = threadIdx.x % 7;
    composed[s][z] = static_cast<unsigned char>(perm_index(
        kPerm[s][kZ6Perm[z][0]], kPerm[s][kZ6Perm[z][1]], kPerm[s][kZ6Perm[z][2]]));
  }
  double e5 = 0.0, e6 = 0.0;
  for (int index = blockIdx.x % blocks_per_multiset; index < R.tile_offset[4];
       index += blocks_per_multiset) {
    const Tile t = tile_at(R, index);
    __syncthreads();   // the previous tile's geometry is read
    if (threadIdx.x < 24) {
      // the read of rho is at w_q = y_rho(q): tile axis rho(q) runs along
      // the slot's axis q
      const int r = threadIdx.x;
      const int rho[4] = {kPerm[r][0], kPerm[r][1], kPerm[r][2], kPerm[r][3]};
      const int w[4] = {pick(t.start, rho[0]), pick(t.start, rho[1]), pick(t.start, rho[2]),
                        pick(t.start, rho[3])};
      const int p = R.box(w[0], w[1], w[2]);
      const int s[4] = {R.len(p, 1) * R.len(p, 2) * R.len(p, 3), R.len(p, 2) * R.len(p, 3),
                        R.len(p, 3), 1};
      origin[r] = R.offset_of(p) + static_cast<long long>(w[0] - R.lo(p, 0)) * s[0] +
                  static_cast<long long>(w[1] - R.lo(p, 1)) * s[1] +
                  static_cast<long long>(w[2] - R.lo(p, 2)) * s[2] + (w[3] - R.lo(p, 3));
      int by_axis[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        by_axis[0] += rho[q] == 0 ? s[q] : 0;
        by_axis[1] += rho[q] == 1 ? s[q] : 0;
        by_axis[2] += rho[q] == 2 ? s[q] : 0;
        by_axis[3] += rho[q] == 3 ? s[q] : 0;
      }
      along[r] = make_int4(by_axis[0], by_axis[1], by_axis[2], by_axis[3]);
    }
    __syncthreads();
    const bool active = u0 < t.extent[0] && u1 < t.extent[1] && u2 < t.extent[2] &&
                        u3 < t.extent[3];
    if (!active) continue;   // no barrier below until the next tile
    const int y[4] = {t.start[0] + u0, t.start[1] + u1, t.start[2] + u2, t.start[3] + u3};
    // where this thread's element of the tile permuted by rho lies in a slot
    auto offset = [&](int r) {
      const int4 a = along[r];
      return origin[r] + u0 * a.x + u1 * a.y + u2 * a.z + u3 * a.w;
    };
    const long long at = offset(0);   // the identity: y itself, in the Cut's layout
    double gs = 0.0, z5 = 0.0, z6 = 0.0;
    if (!first) {
      gs = carry[at];
      z5 = carry[n + at];
      z6 = carry[2 * n + at];
    }
    for (int s = 0; s < 24; ++s) {
      const int slot = row[4 + s];
      if (slot < slot_begin || slot >= slot_end) continue;
      const double* base = work + R.slot_doubles() * (slot - slot_begin);
      gs += base[offset(s)];
      if (!((mask >> s) & 1)) continue;
      const int* o4 = slots + 4 * slot;
      const int i = o4[0], j = o4[1], k = o4[2], l = o4[3];
      const int a = pick(y, kPerm[s][0]), b = pick(y, kPerm[s][1]), cv = pick(y, kPerm[s][2]),
                d = pick(y, kPerm[s][3]);
      z5 += u_of(D, t2, k, l, a, b) * k_of(D, c, i, j, cv, d)
            - 2.0 * u_of(D, t2, k, l, b, d) * l_of(D, c, i, j, a, cv)
            + u_of(D, t2, k, l, cv, d) * l_of(D, c, i, j, a, b);
      double sum = 0.0;
#pragma unroll
      for (int z = 0; z < 7; ++z)
        sum += kZ6Coef[z] * base[(z < 3 ? n : 2 * n) + offset(composed[s][z])];
      z6 += 2.0 * sum;
    }
    if (last) {
      const double weighted =
          0.5 * gs / (eps_ijkl - eps_v[y[0]] - eps_v[y[1]] - eps_v[y[2]] - eps_v[y[3]]);
      e5 += weighted * z5;
      e6 += weighted * z6;
    } else {
      carry[at] = gs;
      carry[n + at] = z5;
      carry[2 * n + at] = z6;
    }
  }
  if (!last) return;   // uniform over the launch
  reduce5[threadIdx.x] = e5;
  reduce6[threadIdx.x] = e6;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      reduce5[threadIdx.x] += reduce5[threadIdx.x + half];
      reduce6[threadIdx.x] += reduce6[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = reduce5[0];
    partial[2 * blockIdx.x + 1] = reduce6[0];
  }
}

}  // namespace

// batches (host, n_batches x 8): slot begin and end, multiset begin and end,
// first (the batch starts its multisets) and last (it ends them), and the
// range [a0, a1) of min(y).  slots (n_slots, 4) and multisets (n_multisets,
// 29) on the device, the multisets' slots global.  c (n, n, n, n), n = no +
// nv; cov (no, nv, nv, nv), (ia|be) at [i][a][b][e]; cvt (no, nv, nv, nv),
// (ld|ce) at [l][c][e][d]; clk (no, no, no, nv), (ld|km) at [l][k][m][d];
// t2 (no, no, nv, nv); t3 (no, no, no, nv, nv, nv) and t3t, t3[mjicba] at
// [j][i][a][m][c][b].  workspace: in a batch that does not both start and
// end its multiset, the carried sums (3 Cut elements), then the batch's
// slots, Cut::slot_doubles() each, workspace_doubles in all.
// energy_blocks blocks take each multiset of a batch in the energy stage;
// partial holds two doubles (MP5, MP6) for each of them in every batch that
// ends its multisets, batch after batch, partial_doubles in all.  A plan
// that does not fit the two buffers, or a v above 255 (the energy tiles'
// bounds), or a raw stage above the shared memory of a block is refused
// before any launch.
extern "C" int tuna_ccsdt_q_energy(int no, int nv, int n_batches, const int* batches,
                                   const int* slots, const int* multisets, const double* c,
                                   const double* cov, const double* cvt, const double* clk,
                                   const double* t2, const double* t3, const double* t3t,
                                   const double* eps_o, const double* eps_v, int energy_blocks,
                                   double* workspace, long long workspace_doubles,
                                   double* partial, long long partial_doubles,
                                   cudaStream_t stream) {
  if (no == 0 || nv == 0) return cudaSuccess;
  if (energy_blocks < 1 || nv > 255) return cudaErrorInvalidValue;
  const long long ov2 = static_cast<long long>(no) * nv * nv;
  long long partials = 0;
  for (int batch = 0; batch < n_batches; ++batch) {
    const int* row = batches + 8 * batch;
    Cut R;
    R.set(row[6], row[7], nv, ov2);
    const long long carried = row[4] && row[5] ? 0 : 3 * R.elements();
    if (carried + (row[1] - row[0]) * R.slot_doubles() > workspace_doubles)
      return cudaErrorInvalidValue;
    if (row[5]) partials += 2LL * (row[3] - row[2]) * energy_blocks;
  }
  if (partials > partial_doubles) return cudaErrorInvalidValue;
  Dims D;
  D.no = no;
  D.nv = nv;
  D.n = no + nv;
  const long long raw_shared = 8 * raw_shared_doubles(no, nv);
  if (raw_shared > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(quadruples_raw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(raw_shared));
  if (err != cudaSuccess) return err;
  double* carry = workspace;
  const int blocks_xyv = static_cast<int>((3 * ov2 + kThreads - 1) / kThreads);
  long long partial_offset = 0;
  for (int batch = 0; batch < n_batches; ++batch) {
    const int* row = batches + 8 * batch;
    const int n_slots = row[1] - row[0], n_multisets = row[3] - row[2];
    const int* batch_slots = slots + 4 * static_cast<long long>(row[0]);
    Cut R;
    R.set(row[6], row[7], nv, ov2);
    double* work = workspace + (row[4] && row[5] ? 0 : 3 * R.elements());
    quadruples_xyv_kernel<<<n_slots * blocks_xyv, kThreads, 0, stream>>>(
        D, R, batch_slots, blocks_xyv, c, t2, work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (R.block_offset[4] > 0) {
      quadruples_raw_kernel<<<static_cast<unsigned>(n_slots) * R.block_offset[4], kThreads,
                              raw_shared, stream>>>(D, R, batch_slots, c, cov, cvt, clk, t2, t3,
                                                    t3t, work);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    quadruples_energy_kernel<<<n_multisets * energy_blocks, kThreads, 0, stream>>>(
        D, R, slots, multisets + 29 * static_cast<long long>(row[2]), row[0], row[1],
        energy_blocks, row[4], row[5], c, t2, eps_o, eps_v, work, carry,
        partial + partial_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (row[5]) partial_offset += 2LL * n_multisets * energy_blocks;
  }
  return cudaSuccess;
}
