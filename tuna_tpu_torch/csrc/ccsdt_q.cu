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
// (S2 and S4 below are S1 and S3 with c and d exchanged), plus W once a
// pair (i, j); K9 forms S2 and S4 itself (4 v + 8 o) and W once an ordering
// and range (~v more an element): ~1.2e11 operations at o = 7, v = 19 and
// ~1.2e13 at v = 53, against ~1e8 bytes of inputs.
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
// [0, v) is one box of v^4).  A batch runs four kernels, each a plain
// float64 FMA loop:
//   quadruples_xyv_kernel: X[nac] = sum_m (mi|nj) t2[mkac], Y[amb] = sum_e
//       (ia|me) t2[kjeb], V[bmc] = sum_e (be|mi) t2[kjce], o v^2 each, a
//       thread an element;
//   quadruples_w_kernel: the vvvv term's half, a thread an element: W[abcf]
//       = sum_e (cf|ae) t2[ijeb] at the (a, b, c) of boxes 0-2, every f,
//       and, for box 3, where only d is in the range, U[acde] = sum_f
//       (cf|ae) t2[klfd] at its (a, c, d), every e (the term is then
//       sum_e U[acde] t2[ijeb]; W there would need every (a, b, c));
//   quadruples_raw_kernel: Graw, alpha and beta of the slot in the boxes; a
//       block a (slot, box, a, b) stages the vectors and o x v tables of
//       (a, b) in shared memory, and its threads loop over the box's (c, d),
//       d fastest, so a warp's reads of t3, t2, W and of (ld|ce) (passed as
//       cvt[l][c][e][d]) are contiguous or shared;
//   quadruples_energy_kernel: a thread a run of (multiset, y): Gsym and the
//       two Zsym from the slots in the batch, then 1/2 e Gsym Zsym, with
//       fixed-order block partials (two calls agree bitwise: no atomics).
// A multiset with more slots than the workspace holds is cut over its slots:
// its batches carry Gsym, Zsym5 and Zsym6 (3 Cut elements at the front of
// the workspace, there only in such batches) from one to the next, and only
// the last adds energy.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__constant__ int kPerm[24][4] = {
    {0, 1, 2, 3}, {0, 1, 3, 2}, {0, 2, 1, 3}, {0, 2, 3, 1}, {0, 3, 1, 2}, {0, 3, 2, 1},
    {1, 0, 2, 3}, {1, 0, 3, 2}, {1, 2, 0, 3}, {1, 2, 3, 0}, {1, 3, 0, 2}, {1, 3, 2, 0},
    {2, 0, 1, 3}, {2, 0, 3, 1}, {2, 1, 0, 3}, {2, 1, 3, 0}, {2, 3, 0, 1}, {2, 3, 1, 0},
    {3, 0, 1, 2}, {3, 0, 2, 1}, {3, 1, 0, 2}, {3, 1, 2, 0}, {3, 2, 0, 1}, {3, 2, 1, 0}};

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
// the carried sums are stored box after box, each box row-major; the vvvv
// half's boxes hold W at the (a, b, c) of boxes 0-2 and U at the (a, c, d)
// of box 3, by v each.  A slot's doubles: Graw, alpha, beta, W and U, then
// X, Y, V (o v^2 each).
struct Cut {
  int a0, a1, nv;
  long long offset[5];     // first element of box p; offset[4] = elements
  long long ab_offset[5];  // first (a, b) pair of box p
  long long w_offset[5];   // first W (U for p = 3) double of box p
  long long ov2;
  __host__ __device__ int lo(int p, int q) const { return q < p ? a1 : a0; }
  __host__ __device__ int len(int p, int q) const {
    return q < p ? nv - a1 : (q == p ? a1 - a0 : nv - a0);
  }
  __host__ void set(int a0_, int a1_, int nv_, long long ov2_) {
    a0 = a0_;
    a1 = a1_;
    nv = nv_;
    ov2 = ov2_;
    offset[0] = ab_offset[0] = w_offset[0] = 0;
    for (int p = 0; p < 4; ++p) {
      const long long ab = static_cast<long long>(len(p, 0)) * len(p, 1);
      offset[p + 1] = offset[p] + ab * len(p, 2) * len(p, 3);
      ab_offset[p + 1] = ab_offset[p] + ab;
      w_offset[p + 1] = w_offset[p] + (p < 3 ? ab * len(p, 2) : static_cast<long long>(
          len(p, 0)) * len(p, 2) * len(p, 3)) * nv;
    }
  }
  __host__ __device__ long long elements() const { return offset[4]; }
  __host__ __device__ long long slot_doubles() const {
    return 3 * offset[4] + w_offset[4] + 3 * ov2;
  }
  // where (a, b, c, d), min in [a0, a1), lies in a box
  __device__ long long at(int a, int b, int c, int d) const {
    const int p = a < a1 ? 0 : (b < a1 ? 1 : (c < a1 ? 2 : 3));
    return offset[p] +
           ((static_cast<long long>(a - lo(p, 0)) * len(p, 1) + (b - lo(p, 1))) * len(p, 2) +
            (c - lo(p, 2))) * len(p, 3) + (d - lo(p, 3));
  }
  // the box of element q (q < elements())
  __device__ int box_of(long long q) const {
    return q >= offset[3] ? 3 : (q >= offset[2] ? 2 : (q >= offset[1] ? 1 : 0));
  }
};

__global__ void __launch_bounds__(kThreads)
quadruples_xyv_kernel(Dims D, Cut R, const int* __restrict__ slots, int blocks_per_slot,
                      const double* __restrict__ c, const double* __restrict__ t2,
                      double* __restrict__ work) {
  const int slot = blockIdx.x / blocks_per_slot;
  const long long q =
      static_cast<long long>(blockIdx.x % blocks_per_slot) * kThreads + threadIdx.x;
  if (q >= 3 * R.ov2) return;
  const int no = D.no, nv = D.nv;
  const int i = slots[4 * slot], j = slots[4 * slot + 1], k = slots[4 * slot + 2];
  double* out = work + R.slot_doubles() * slot + 3 * R.elements() + R.w_offset[4];
  const int part = static_cast<int>(q / R.ov2);
  const int r = static_cast<int>(q % R.ov2);
  const int x = r / (nv * nv), y = (r / nv) % nv, z = r % nv;
  double acc = 0.0;
  if (part == 0) {          // X[n a c], x = n, y = a, z = c
    for (int m = 0; m < no; ++m) acc += c[D.c(m, i, x, j)] * t2[D.t2(m, k, y, z)];
    out[r] = acc;
  } else if (part == 1) {   // Y[a m b], r = (a * o + m) * v + b
    const int a = r / (no * nv), m = (r / nv) % no, b = r % nv;
    for (int e = 0; e < nv; ++e) acc += c[D.c(i, no + a, m, no + e)] * t2[D.t2(k, j, e, b)];
    out[R.ov2 + r] = acc;
  } else {                  // V[b m c], r = (b * o + m) * v + c
    const int b = r / (no * nv), m = (r / nv) % no, cc = r % nv;
    for (int e = 0; e < nv; ++e) acc += c[D.c(no + b, no + e, m, i)] * t2[D.t2(k, j, cc, e)];
    out[2 * R.ov2 + r] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
quadruples_w_kernel(Dims D, Cut R, const int* __restrict__ slots, int blocks_per_slot,
                    const double* __restrict__ c, const double* __restrict__ t2,
                    double* __restrict__ work) {
  const int slot = blockIdx.x / blocks_per_slot;
  const long long q =
      static_cast<long long>(blockIdx.x % blocks_per_slot) * kThreads + threadIdx.x;
  if (q >= R.w_offset[4]) return;
  const int no = D.no, nv = D.nv;
  const int i = slots[4 * slot], j = slots[4 * slot + 1];
  const int p = q >= R.w_offset[3] ? 3 : (q >= R.w_offset[2] ? 2 : (q >= R.w_offset[1] ? 1 : 0));
  long long r = q - R.w_offset[p];
  double acc = 0.0;
  if (p < 3) {
    // W[a b c f] = sum_e (cf|ae) t2[ijeb]; b fastest, so the t2 reads of a
    // warp are contiguous and its (cf|ae) rows shared
    const int n1 = R.len(p, 1), n2 = R.len(p, 2);
    const int b = static_cast<int>(r % n1);
    r /= n1;
    const int f = static_cast<int>(r % nv);
    r /= nv;
    const int cv = static_cast<int>(r % n2);
    const int a = static_cast<int>(r / n2);
    const double* crow = c + D.c(no + R.lo(p, 2) + cv, no + f, no + R.lo(p, 0) + a, no);
    const double* trow = t2 + D.t2(i, j, 0, R.lo(p, 1) + b);
    for (int e = 0; e < nv; ++e) acc += crow[e] * trow[static_cast<long long>(e) * nv];
    work[R.slot_doubles() * slot + 3 * R.elements() + R.w_offset[p] +
         ((static_cast<long long>(a) * n1 + b) * n2 + cv) * nv + f] = acc;
  } else {
    // U[a c d e] = sum_f (cf|ae) t2[klfd]; d fastest, so the t2 reads of a
    // warp are contiguous and its (cf|ae) reads shared
    const int k = slots[4 * slot + 2], l = slots[4 * slot + 3];
    const int n2 = R.len(3, 2), n3 = R.len(3, 3);
    const int d = static_cast<int>(r % n3);
    r /= n3;
    const int e = static_cast<int>(r % nv);
    r /= nv;
    const int cv = static_cast<int>(r % n2);
    const int a = static_cast<int>(r / n2);
    const long long f_stride = static_cast<long long>(D.n) * D.n;
    const double* ccol = c + D.c(no + R.lo(3, 2) + cv, no, no + R.lo(3, 0) + a, no + e);
    const double* tcol = t2 + D.t2(k, l, 0, R.lo(3, 3) + d);
    for (int f = 0; f < nv; ++f) acc += ccol[f * f_stride] * tcol[static_cast<long long>(f) * nv];
    work[R.slot_doubles() * slot + 3 * R.elements() + R.w_offset[3] +
         ((static_cast<long long>(a) * n2 + cv) * n3 + d) * nv + e] = acc;
  }
}

// Shared doubles of a quadruples_raw_kernel block: the vectors and o x v
// tables of its (slot, a, b) that every (c, d) of the block reads.
__host__ __device__ inline int raw_shared_doubles(int no, int nv) {
  return 3 * nv + 2 * no + 7 * no * nv;
}

// One block a (slot, box, a, b); its threads loop over the box's (c, d), d
// fastest.  cvt is (ld|ce) stored as cvt[l][c][e][d], so the T1 and T2 reads
// of a warp are contiguous.
__global__ void __launch_bounds__(kThreads)
quadruples_raw_kernel(Dims D, Cut R, const int* __restrict__ slots,
                      const double* __restrict__ c, const double* __restrict__ cvt,
                      const double* __restrict__ t2, const double* __restrict__ t3,
                      double* __restrict__ work) {
  extern __shared__ double shared[];
  const int no = D.no, nv = D.nv;
  const int v2 = nv * nv;
  const long long pairs = R.ab_offset[4];
  const int slot = static_cast<int>(blockIdx.x / pairs);
  const long long pair = blockIdx.x % pairs;
  const int p = pair >= R.ab_offset[3] ? 3
                : (pair >= R.ab_offset[2] ? 2 : (pair >= R.ab_offset[1] ? 1 : 0));
  const int n1 = R.len(p, 1), n2 = R.len(p, 2), n3 = R.len(p, 3);
  const long long ab = pair - R.ab_offset[p];
  const int a = R.lo(p, 0) + static_cast<int>(ab / n1), b = R.lo(p, 1) + static_cast<int>(ab % n1);
  const int i = slots[4 * slot], j = slots[4 * slot + 1];
  const int k = slots[4 * slot + 2], l = slots[4 * slot + 3];
  double* base = work + R.slot_doubles() * slot;
  const double* X = base + 3 * R.elements() + R.w_offset[4];
  const double* Y = X + R.ov2;
  const double* V = Y + R.ov2;

  double* cab = shared;              // (ia|be), e
  double* tk = cab + nv;             // t3[kji e b a], e
  double* tl = tk + nv;              // t3[lji e b a], e
  double* cam = tl + nv;             // (ia|mj), m
  double* yab = cam + no;            // Y[a m b], m
  double* xa = yab + no;             // X[m a c], (m, c)
  double* t2lb = xa + no * nv;       // t2[m l b d], (m, d)
  double* vb = t2lb + no * nv;       // V[b m c], (m, c)
  double* t2la = vb + no * nv;       // t2[m l a d], (m, d)
  double* t3ji = t2la + no * nv;     // t3[m j i c b a], (m, c)
  double* clk = t3ji + no * nv;      // (ld|km), (m, d)
  double* ckl = clk + no * nv;       // (kd|lm), (m, d)
  for (int x = threadIdx.x; x < nv; x += kThreads) {
    cab[x] = c[D.c(i, no + a, no + b, no + x)];
    tk[x] = t3[D.t3(k, j, i, x, b, a)];
    tl[x] = t3[D.t3(l, j, i, x, b, a)];
  }
  for (int m = threadIdx.x; m < no; m += kThreads) {
    cam[m] = c[D.c(i, no + a, m, j)];
    yab[m] = Y[(a * no + m) * nv + b];
  }
  for (int x = threadIdx.x; x < no * nv; x += kThreads) {
    const int m = x / nv, y = x % nv;
    xa[x] = X[(m * nv + a) * nv + y];
    t2lb[x] = t2[D.t2(m, l, b, y)];
    vb[x] = V[(b * no + m) * nv + y];
    t2la[x] = t2[D.t2(m, l, a, y)];
    t3ji[x] = t3[D.t3(m, j, i, y, b, a)];
    clk[x] = c[D.c(l, no + y, k, m)];
    ckl[x] = c[D.c(k, no + y, l, m)];
  }
  __syncthreads();

  // the vvvv half: W[a b c f] t2[kl f d] over f in boxes 0-2, U[a c d e]
  // t2[ij e b] over e in box 3
  const double* W = base + 3 * R.elements() + R.w_offset[p];
  const double* t3jkl = t3 + D.t3(j, k, l, 0, 0, 0);    // t3[jkl e c d]
  const double* t3kl = t3 + D.t3(0, k, l, b, 0, 0);     // t3[m kl b c d]
  const double* t2kl = t2 + D.t2(k, l, 0, 0);           // t2[kl f d]
  const double* t2ij = t2 + D.t2(i, j, 0, b);           // t2[ij e b]
  const double* cl = cvt + static_cast<long long>(l) * nv * v2;   // (ld|ce) as [c][e][d]
  const double* ck = cvt + static_cast<long long>(k) * nv * v2;
  const long long m_stride3 = static_cast<long long>(no) * no * nv * v2;   // t3, m
  const long long m_stride2 = static_cast<long long>(no) * v2;             // t2, m
  const long long out = R.offset[p] + ab * n2 * n3;
  for (int cd = threadIdx.x; cd < n2 * n3; cd += kThreads) {
    const int cw = cd / n3;
    const int cv = R.lo(p, 2) + cw, d = R.lo(p, 3) + cd % n3;
    const int vcd = cv * nv + d;
    double g = 0.0, tt1 = 0.0, tt2 = 0.0;   // Graw; T1, T2
    const double* wrow;
    const double* tcol;
    if (p < 3) {
      wrow = W + (ab * n2 + cw) * nv;
      tcol = t2kl + d;
    } else {
      wrow = W + ((static_cast<long long>(a - R.lo(3, 0)) * n2 + cw) * n3 + cd % n3) * nv;
      tcol = t2ij;
    }
    const double* crow_l = cl + static_cast<long long>(cv) * v2 + d;
    const double* crow_k = ck + static_cast<long long>(cv) * v2 + d;
    for (int e = 0; e < nv; ++e) {
      // sum_e (ia|be) t3[jkl ecd] + the vvvv half
      g += cab[e] * t3jkl[static_cast<long long>(e) * v2 + vcd];
      g += wrow[e] * tcol[e * nv];
      tt1 += tk[e] * crow_l[e * nv];
      tt2 += tl[e] * crow_k[e * nv];
    }
    // - sum_m (ia|mj) t3[mkl bcd] + sum_n X[nac] t2[nlbd]
    // - 2 sum_m Y[amb] t2[mlcd] - 2 sum_m V[bmc] t2[mlad]
    double two = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0, s4 = 0.0;
    for (int m = 0; m < no; ++m) {
      g -= cam[m] * t3kl[m * m_stride3 + vcd];
      g += xa[m * nv + cv] * t2lb[m * nv + d];
      two += yab[m] * t2[m * m_stride2 + static_cast<long long>(l) * v2 + vcd];
      two += vb[m * nv + cv] * t2la[m * nv + d];
      const double t_c = t3ji[m * nv + cv], t_d = t3ji[m * nv + d];
      s1 += t_c * clk[m * nv + d];
      s2 += t_d * clk[m * nv + cv];
      s3 += t_c * ckl[m * nv + d];
      s4 += t_d * ckl[m * nv + cv];
    }
    g -= 2.0 * two;
    const long long at = out + cd;
    base[at] = g;
    base[R.elements() + at] = 2.0 * s1 - s2 - 2.0 * tt1 + tt2;       // alpha
    base[2 * R.elements() + at] = 2.0 * s3 - s4 - 2.0 * tt2 + tt1;   // beta
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

// multisets: (i, j, k, l), 24 global slots, the mask of first permutations.
// blocks_per_multiset blocks take one multiset of the batch, each thread the
// y = q, q + stride, ... of the range's boxes in turn (a fixed order).  Only
// the batch that ends its multisets (last) writes partials, two (MP5, MP6) a
// block.
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
  const int* row = multisets + 29 * (blockIdx.x / blocks_per_multiset);
  const int mask = row[28];
  const long long n = R.elements();
  const double eps_ijkl = eps_o[row[0]] + eps_o[row[1]] + eps_o[row[2]] + eps_o[row[3]];
  const long long stride = static_cast<long long>(blocks_per_multiset) * kThreads;
  double e5 = 0.0, e6 = 0.0;
  for (long long q = static_cast<long long>(blockIdx.x % blocks_per_multiset) * kThreads
                     + threadIdx.x;
       q < n; q += stride) {
    const int p = R.box_of(q);
    long long r = q - R.offset[p];
    int y[4];
    for (int t = 3; t >= 0; --t) {
      const int extent = R.len(p, t);
      y[t] = R.lo(p, t) + static_cast<int>(r % extent);
      r /= extent;
    }
    double gs = 0.0, z5 = 0.0, z6 = 0.0;
    if (!first) {
      gs = carry[q];
      z5 = carry[n + q];
      z6 = carry[2 * n + q];
    }
    for (int s = 0; s < 24; ++s) {
      const int slot = row[4 + s];
      if (slot < slot_begin || slot >= slot_end) continue;
      const double* base = work + R.slot_doubles() * (slot - slot_begin);
      const int a = y[kPerm[s][0]], b = y[kPerm[s][1]], cv = y[kPerm[s][2]], d = y[kPerm[s][3]];
      gs += base[R.at(a, b, cv, d)];
      if ((mask >> s) & 1) {
        const int* o4 = slots + 4 * slot;
        const int i = o4[0], j = o4[1], k = o4[2], l = o4[3];
        z5 += u_of(D, t2, k, l, a, b) * k_of(D, c, i, j, cv, d)
              - 2.0 * u_of(D, t2, k, l, b, d) * l_of(D, c, i, j, a, cv)
              + u_of(D, t2, k, l, cv, d) * l_of(D, c, i, j, a, b);
        const double* al = base + n;
        const double* be = base + 2 * n;
        z6 += 2.0 * (-2.0 * al[R.at(a, b, cv, d)] - al[R.at(cv, d, a, b)]
                     + al[R.at(b, a, cv, d)])
              + 2.0 * (2.0 * be[R.at(d, b, a, cv)] - be[R.at(b, d, a, cv)]
                       + 2.0 * be[R.at(cv, b, d, a)] - be[R.at(b, cv, d, a)]);
      }
    }
    if (last) {
      const double weighted =
          0.5 * gs / (eps_ijkl - eps_v[y[0]] - eps_v[y[1]] - eps_v[y[2]] - eps_v[y[3]]);
      e5 += weighted * z5;
      e6 += weighted * z6;
    } else {
      carry[q] = gs;
      carry[n + q] = z5;
      carry[2 * n + q] = z6;
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
// nv; cvt (no, nv, nv, nv), (ld|ce) at [l][c][e][d]; t2 (no, no, nv, nv); t3
// (no, no, no, nv, nv, nv).  workspace: in a batch that does not both start
// and end its multiset, the carried sums (3 Cut elements), then the
// batch's slots, Cut::slot_doubles() each, workspace_doubles in all.
// energy_blocks blocks take each multiset of a batch in the energy stage;
// partial holds two doubles (MP5, MP6) for each of them in every batch that
// ends its multisets, batch after batch, partial_doubles in all.  A plan
// that does not fit the two buffers is refused before any launch.
extern "C" int tuna_ccsdt_q_energy(int no, int nv, int n_batches, const int* batches,
                                   const int* slots, const int* multisets, const double* c,
                                   const double* cvt, const double* t2, const double* t3,
                                   const double* eps_o, const double* eps_v,
                                   int energy_blocks, double* workspace,
                                   long long workspace_doubles, double* partial,
                                   long long partial_doubles, cudaStream_t stream) {
  if (no == 0 || nv == 0) return cudaSuccess;
  if (energy_blocks < 1) return cudaErrorInvalidValue;
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
  const size_t raw_shared = sizeof(double) * raw_shared_doubles(no, nv);
  if (raw_shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quadruples_raw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(raw_shared));
    if (err != cudaSuccess) return err;
  }
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
    const int blocks_w = static_cast<int>((R.w_offset[4] + kThreads - 1) / kThreads);
    quadruples_xyv_kernel<<<n_slots * blocks_xyv, kThreads, 0, stream>>>(
        D, R, batch_slots, blocks_xyv, c, t2, work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    quadruples_w_kernel<<<n_slots * blocks_w, kThreads, 0, stream>>>(
        D, R, batch_slots, blocks_w, c, t2, work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    quadruples_raw_kernel<<<static_cast<unsigned>(n_slots * R.ab_offset[4]), kThreads,
                            raw_shared, stream>>>(D, R, batch_slots, c, cvt, t2, t3, work);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
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
