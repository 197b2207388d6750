"""Molecular integrals: McMurchie-Davidson with the diatomic z-axis
specialisation, as plain torch and as hand-written CUDA kernels.

Twin of tuna_tpu/ops/integrals.py.  `IntegralPlan` enumerates the primitive
pairs on the host exactly as the JAX plan does.  Its three device kernels
dispatch on the device of the coordinates they are given:

  * one_electron (S, T, V_NE, D, Q): csrc/one_electron.cu on a CUDA tensor,
    `_one_electron_plain` on a CPU tensor;
  * eri_pair_packed (the packed (n_pairs, n_pairs) ERI matrix): csrc/eri.cu
    on a CUDA tensor, `_eri_packed_plain` on a CPU tensor;
  * fock_direct (J and K of a density, the integral-direct SCF's Fock
    build, the N^4 tensor never stored): csrc/fock_direct.cu on a CUDA
    tensor, `_fock_direct_plain` on a CPU tensor;
  * one_electron_deriv, eri_deriv_energy and eri_deriv_energy_unrestricted
    (the R-tangents of the one-electron integrals and of the two-electron
    energy at fixed densities, atom 1 moving along +z, for
    drivers/gradients.py): csrc/one_electron_deriv.cu and csrc/eri_deriv.cu
    (K8b, K8bu) on a CUDA tensor, `_one_electron_deriv_plain`,
    `_eri_deriv_energy_plain` and `_eri_deriv_energy_unrestricted_plain` on
    a CPU tensor.

The quartet kernels share csrc/quartet.cuh and walk the plan's work list
(`IntegralPlan.work_list`), built on the host once per basis; K8b and K8bu
take its live quartets by shell quartet (`IntegralPlan.shell_quartets`,
`deriv_schedule`, `deriv_tables`).

The plain versions mirror the JAX functions, including the TPU's scaled
Hermite form (Rt[v,n] = R[v,n] / (2 alpha)^(n+v)); the kernels work
unscaled in native float64 (csrc/hermite.cuh).  Both assume every atom on
the z axis, as drivers/common.py enforces.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from .boys import boys_table, taylor_table

TWO_PI_POW_2_5 = 2.0 * math.pi ** 2.5  # 34.9868366552497...
PI_POW_1_5 = math.pi ** 1.5
# The highest lmax instantiated in csrc/ for each kernel, by its name in
# _kernels.launches, with its label: every kernel to h shells, so K1 and K4
# (and the pair rows they share) to quartet classes (10, 10) and Boys order
# 20, the gradient kernels K8b and K8bu to derivative classes (10, 10) and
# Boys order 21, K8a to Boys order 11.  Every basis of the library stops at h.
KERNEL_MAX_LMAX = {"eri_packed": ("K1", 5), "fock_direct": ("K4", 5),
                   "one_electron": ("K3", 5), "one_electron_deriv": ("K8a", 5),
                   "eri_deriv_energy": ("K8b", 5), "eri_deriv_energy_unrestricted": ("K8bu", 5)}
# Primitive quartets above which a work-list quartet gets a warp of its own
# instead of a thread (csrc/quartet.cuh); tuned on the card (PERF.md).
HEAVY_THRESHOLD = 16
# K8b's and K8bu's tasks (csrc/eri_deriv.cu kTaskThreads): a block of
# SHELL_TASK_THREADS threads takes a run of at most SHELL_TASK_THREADS
# primitive quartets of one shell quartet (a thread each) with its
# components, cut into several tasks where they would take more than
# SHELL_TASK_OPS float64 operations of own part a thread
# (deriv_quartet_operations); SHELL_TASK_OPS was tuned on the card
# (PERF.md).  Tests monkeypatch SHELL_TASK_OPS before building a plan.
SHELL_TASK_THREADS = 128
SHELL_TASK_OPS = 2000
# Shared memory of a heavy class kernel's block (csrc/quartet.cuh): the Boys
# Taylor table (TUNA_BOYS_TABLE_SIZE doubles, csrc/boys.cuh) and, for each of
# its kHeavyWarps warps, the staged bra and ket rows.  An H100 gives a block
# at most 227 KB.
_HEAVY_WARPS = 4
_BOYS_TABLE_BYTES = 8 * 301 * 10
SHARED_MEMORY_PER_BLOCK = 227 * 1024
_F64 = torch.float64


def _double_factorial(n: int) -> float:
    result = 1.0
    while n > 1:
        result *= n
        n -= 2
    return result


def quartet_operations(l_bra: int, l_ket: int) -> tuple[int, int]:
    """Float64 operations of one primitive quartet of class (l_bra, l_ket)
    in csrc/quartet.cuh::primitive_quartet, as (shared, own); exp, sqrt and
    a division count as one operation each.

    `shared` depends only on the two primitive pairs' exponents and
    centres, so every Cartesian component of a shell quartet could share
    it: alpha and T, the Boys evaluation of order l_bra + l_ket, the
    R^n_00v recursion and the exponent part of the prefactor.  `own` is
    the rest: the Hermite products to l + 1 orders an axis, the x/y
    pairing, their contraction with R^n_00v and the coefficients."""
    ta, tb, nm = l_bra + 1, l_ket + 1, l_bra + l_ket
    nxy = nm // 2
    hermite = 2 * ta * tb + 4 * ((ta * tb + 1) // 2)
    pairing = 3 * (nxy + 1) * (nxy + 2) // 2
    boys = 23 + 4 * nm
    recursion = 2 * (nm + 1) + 3 * nm * (nm + 1) // 2
    dots = sum(min(nxy, (nm - v) // 2) + 1 for v in range(nm + 1))
    contraction = 2 * dots + 2 * nm + 1
    return 6 + boys + recursion + 4, hermite + pairing + contraction + 4


def deriv_quartet_operations(l_bra: int, l_ket: int) -> tuple[int, int]:
    """(shared, own) float64 operations of one derivative primitive quartet
    of class (l_bra, l_ket) for K8b and K8bu (csrc/eri_deriv.cu):
    quartet_operations' with the Boys order and the R^n_00v recursion one
    order higher, plus the second z product of [d bra | ket] + [bra | d ket]
    (two operations a term)."""
    shared = quartet_operations(l_bra, l_ket + 1)[0]
    own = quartet_operations(l_bra, l_ket)[1] + 2 * (l_bra + 2) * (l_ket + 2)
    return shared, own


def coulomb_entries(l_sum: int) -> int:
    """Entries R^n_00v of a derivative quartet's Coulomb table with
    L_bra + L_ket = l_sum that K8b's own part reads (csrc/eri_deriv.cu
    CoulombShape): n <= l_sum // 2 and v + 2n <= l_sum + 1."""
    nm = l_sum + 1
    return sum(min((nm - v) // 2, l_sum // 2) + 1 for v in range(nm + 1))


def heavy_shared_bytes(classes: np.ndarray) -> np.ndarray:
    """Shared memory of the block of each class's heavy kernel, for the rows
    of `IntegralPlan.work_list`'s class table (0 for a class without a
    heavy part).  A staged row has 3 (L + 1) + 3 doubles, rounded up to an
    odd count (csrc/quartet.cuh::ClassShape)."""
    la, lb, split, end, max_bra, max_ket = (classes[:, k].astype(np.int64)
                                            for k in (0, 1, 3, 4, 5, 6))
    rows = max_bra * ((3 * la + 6) | 1) + max_ket * ((3 * lb + 6) | 1)
    return np.where(end > split, _BOYS_TABLE_BYTES + 8 * _HEAVY_WARPS * rows, 0)


def _powers(base, n: int):
    """base^0..base^n along a new last axis, by repeated multiplication."""
    outs = [torch.ones_like(base)]
    for _ in range(n):
        outs.append(outs[-1] * base)
    return torch.stack(outs, dim=-1)


# =========================================================================
# Hermite expansion coefficient tables (vectorised over a batch of pairs)
# =========================================================================

def build_E_table(l1max: int, l2max: int, AB, a, b, include_exp=True):
    """E_t^{ij} tables for one Cartesian direction, batched.

    Returns list-of-lists E[i][j] -> (batch, i+j+1) tensors."""
    p = a + b
    mu = a * b / p
    one_over_2p = 0.5 / p
    shift1 = -(mu / a) * AB   # X_PA
    shift2 = (mu / b) * AB    # X_PB

    base = torch.exp(-mu * AB * AB) if include_exp else torch.ones_like(p)

    E = [[None] * (l2max + 1) for _ in range(l1max + 1)]
    E[0][0] = base[:, None]  # (batch, 1)

    def raise_index(prev, shift, nt_prev):
        nt = nt_prev + 1
        cols = []
        for t in range(nt):
            val = torch.zeros_like(p)
            if t - 1 >= 0:
                val = one_over_2p * prev[:, t - 1]
            if t < nt_prev:
                val = val + shift * prev[:, t]
            if t + 1 < nt_prev:
                val = val + (t + 1) * prev[:, t + 1]
            cols.append(val)
        return torch.stack(cols, dim=-1)

    for i in range(1, l1max + 1):
        E[i][0] = raise_index(E[i - 1][0], shift1, i)
    for i in range(l1max + 1):
        for j in range(1, l2max + 1):
            E[i][j] = raise_index(E[i][j - 1], shift2, i + j)
    return E


def stack_E_table(E, l1max, l2max, tmax):
    """Stack ragged E[i][j] into (l1max+1, l2max+1, tmax+1, batch)."""
    rows = []
    for i in range(l1max + 1):
        cols = []
        for j in range(l2max + 1):
            tab = E[i][j]  # (batch, i+j+1)
            pad = tmax + 1 - tab.shape[1]
            if pad > 0:
                tab = torch.nn.functional.pad(tab, (0, pad))
            cols.append(tab[:, :tmax + 1].T)  # (tmax+1, batch)
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def gather_E_row(E_stacked, l1_idx, l2_idx):
    """Select E[l1, l2, :, k] per batch element -> (batch, tmax+1)."""
    I, J, T, batch = E_stacked.shape
    flat = E_stacked.reshape(I * J, T, batch)
    lin = l1_idx * J + l2_idx
    return flat[lin, :, torch.arange(batch, device=flat.device)]


def gather_E_scalar(E_stacked, l1_idx, l2_idx, t: int):
    I, J, T, batch = E_stacked.shape
    flat = E_stacked.reshape(I * J * T, batch)
    lin = (l1_idx * J + l2_idx) * T + t
    return flat[lin, torch.arange(batch, device=flat.device)]


# =========================================================================
# Scaled z-axis Coulomb Hermite table
# =========================================================================

def build_scaled_Rz_table(vmax: int, nmax: int, PQz, alpha):
    """Rt[v][n] = R^n_{00v} / (2 alpha)^(n+v), built from (-1)^n F_n.

    Returns (batch, vmax+1, nmax+1); only the entries n <= nmax - v are
    formed (each from entries of the same kind), the others are zero, and
    callers only touch valid (v, n)."""
    F = boys_table(nmax, alpha * PQz * PQz)  # (batch, nmax+1)
    signs = torch.tensor([(-1.0) ** n for n in range(nmax + 1)], dtype=F.dtype,
                         device=F.device)
    R = torch.zeros(F.shape[:1] + (vmax + 1, nmax + 1), dtype=F.dtype, device=F.device)
    R[:, 0] = F * signs
    inv_s = 0.5 / alpha
    for v in range(1, min(vmax, nmax) + 1):
        top = nmax - v + 1
        row = PQz[:, None] * R[:, v - 1, 1:top + 1]
        if v > 1:
            row = row + ((v - 1) * inv_s)[:, None] * R[:, v - 2, 1:top + 1]
        R[:, v, :top] = row
    return R


# =========================================================================
# Integral plan: host-side primitive-pair enumeration + device kernels
# =========================================================================

# Workspace per block pair of the plain ERI sweep on the host and on a card
# (where the sweep's time is its launches: larger blocks, fewer of them); the
# block edge follows.
_PLAIN_BLOCK_BYTES = 64e6
_PLAIN_BLOCK_BYTES_CARD = 1e9


class IntegralPlan:
    """Static (per chemical system + basis) plan for all AO integrals.

    The host enumerates the primitive pairs of every AO pair (i >= j) once,
    contiguous per AO pair; the kernels take only the coordinates (and the
    charges and dipole origin)."""

    def __init__(self, basis_functions, n_atoms: int):
        N = len(basis_functions)
        ao_i, ao_j, pair_id = [], [], []
        a_list, b_list, coef_list = [], [], []
        l1_list, l2_list = [], []
        atom1, atom2 = [], []
        pid = 0
        pair_index = np.zeros((N, N), dtype=np.int32)
        for i in range(N):
            bi = basis_functions[i]
            for j in range(i + 1):
                bj = basis_functions[j]
                pair_index[i, j] = pair_index[j, i] = pid
                for k in range(bi.num_exps):
                    for l in range(bj.num_exps):
                        ao_i.append(i)
                        ao_j.append(j)
                        pair_id.append(pid)
                        a_list.append(bi.exps[k])
                        b_list.append(bj.exps[l])
                        coef_list.append(bi.coefs[k] * bi.norms[k] * bj.coefs[l] * bj.norms[l])
                        l1_list.append(bi.lmn)
                        l2_list.append(bj.lmn)
                        atom1.append(bi.atom_index)
                        atom2.append(bj.atom_index)
                pid += 1
        self._set_arrays(a_list, b_list, coef_list, l1_list, l2_list, atom1, atom2,
                         ao_i, ao_j, pair_id, pair_index, n_atoms)

    @classmethod
    def from_arrays(cls, a, b, coef, l1, l2, atom1, atom2, ao_i, ao_j, pair_id,
                    pair_index, n_atoms: int) -> "IntegralPlan":
        """A plan over given primitive-pair arrays (numpy or array-likes),
        e.g. those of a `tuna_tpu` plan, so that two engines integrate
        identical primitive data."""
        plan = cls.__new__(cls)
        plan._set_arrays(a, b, coef, l1, l2, atom1, atom2, ao_i, ao_j, pair_id,
                         pair_index, n_atoms)
        return plan

    def _set_arrays(self, a, b, coef, l1, l2, atom1, atom2, ao_i, ao_j, pair_id,
                    pair_index, n_atoms):
        self.a = np.array(a, dtype=np.float64)
        self.b = np.array(b, dtype=np.float64)
        self.coef = np.array(coef, dtype=np.float64)
        self.l1 = np.array(l1, dtype=np.int32).reshape(-1, 3)
        self.l2 = np.array(l2, dtype=np.int32).reshape(-1, 3)
        self.atom1 = np.array(atom1, dtype=np.int32)
        self.atom2 = np.array(atom2, dtype=np.int32)
        self.ao_i = np.array(ao_i, dtype=np.int32)
        self.ao_j = np.array(ao_j, dtype=np.int32)
        self.pair_id = np.array(pair_id, dtype=np.int32)
        self.pair_index = np.array(pair_index, dtype=np.int32)
        self.n_atoms = int(n_atoms)
        self.n_basis = N = self.pair_index.shape[0]
        self.n_pairs = N * (N + 1) // 2
        self.n_prim_pairs = len(self.a)
        self.lmax = int(max(self.l1.sum(axis=1).max(), self.l2.sum(axis=1).max()))
        if np.any(np.diff(self.pair_id) < 0):
            raise ValueError("primitive pairs must be contiguous per AO pair")
        # AO indices (i >= j) of each AO pair
        tri_i, tri_j = np.tril_indices(N)
        self.pid_i = np.zeros(self.n_pairs, dtype=np.int32)
        self.pid_j = np.zeros(self.n_pairs, dtype=np.int32)
        self.pid_i[self.pair_index[tri_i, tri_j]] = tri_i
        self.pid_j[self.pair_index[tri_i, tri_j]] = tri_j
        # CSR offsets of each AO pair's primitive pairs
        self.pair_start = np.searchsorted(
            self.pair_id, np.arange(self.n_pairs + 1)).astype(np.int32)
        self._device_tensors: dict = {}
        self._work_list = None
        self._lane_schedule = None
        self._shell_pairs = None
        self._shell_quartets = None
        self._deriv_schedule = None
        self._deriv_tables = None
        self._device_quartets: dict = {}  # device -> the work list's quartets
        self._device_deriv: dict = {}     # device -> K8b's components and tasks
        self._plain_layouts: dict = {}   # block bytes -> the plain sweep's blocks

    def _plain_layout(self, block_bytes: float):
        """(blocks, block pairs) of the parity-blocked symmetric quartet
        sweep of the plain ERI version, blocks of about `block_bytes` of
        workspace a block pair (cached).

        For molecules on the z axis a quartet vanishes unless its bra and
        ket pairs have matching x and matching y Hermite parities, so the
        primitive pairs are grouped into 4 parity classes and the sweep
        visits class-diagonal, upper-triangular block pairs only
        (tuna_tpu/ops/integrals.py:226-276)."""
        if block_bytes in self._plain_layouts:
            return self._plain_layouts[block_bytes]
        parity_cls = (2 * ((self.l1[:, 0] + self.l2[:, 0]) & 1)
                      + ((self.l1[:, 1] + self.l2[:, 1]) & 1))
        npp = self.n_prim_pairs
        class_idx = [np.where(parity_cls == k)[0] for k in range(4)]
        lmax = self.lmax
        per_quartet_bytes = 8 * ((4 * lmax + 1) * (4 * lmax + 1)
                                 + 14 * (2 * lmax + 1))
        T = int(np.sqrt(block_bytes / per_quartet_bytes))
        max_class = max((len(ix) for ix in class_idx if len(ix)), default=1)
        T = max(8, min(T, (max_class + 3) // 4))
        blocks, block_pairs = [], []
        for ix in class_idx:
            if len(ix) == 0:
                continue
            nb = (len(ix) + T - 1) // T
            padded = np.full(nb * T, npp, dtype=np.int64)  # npp = sentinel
            padded[:len(ix)] = ix
            base = len(blocks)
            blocks.extend(padded.reshape(nb, T))
            for bi in range(nb):
                for bj in range(bi, nb):
                    block_pairs.append((base + bi, base + bj))
        layout = (np.asarray(blocks, dtype=np.int64).reshape(-1, T), block_pairs)
        self._plain_layouts[block_bytes] = layout
        return layout

    def tensors(self, device) -> dict:
        """The plan's arrays as contiguous tensors on `device` (cached)."""
        device = torch.device(device)
        cached = self._device_tensors.get(device)
        if cached is None:
            def f64(x):
                return torch.as_tensor(x, dtype=_F64, device=device).contiguous()

            def i32(x):
                return torch.as_tensor(x, dtype=torch.int32, device=device).contiguous()

            cached = {
                "a": f64(self.a), "b": f64(self.b), "coef": f64(self.coef),
                "l1": i32(self.l1), "l2": i32(self.l2),
                "atom1": i32(self.atom1), "atom2": i32(self.atom2),
                "ao_i": i32(self.ao_i), "ao_j": i32(self.ao_j),
                "pair_id": i32(self.pair_id), "pair_start": i32(self.pair_start),
                "pid_i": i32(self.pid_i), "pid_j": i32(self.pid_j),
                "pair_index": torch.as_tensor(self.pair_index, dtype=torch.int64,
                                              device=device),
                "lanes": i32(self.lane_schedule()),
                # the quartet kernels' Taylor tables, Boys orders 0..4 lmax + 1
                # (the derivative quartets of K8b go one order higher)
                "boys_quartets": torch.stack([taylor_table(n, device)
                                              for n in range(4 * self.lmax + 2)]).contiguous(),
                "boys_one_electron": taylor_table(2 * self.lmax, device).contiguous(),
                "boys_one_electron_deriv": taylor_table(2 * self.lmax + 1, device).contiguous(),
            }
            self._device_tensors[device] = cached
        return cached

    def work_list(self) -> tuple[np.ndarray, np.ndarray]:
        """(quartets, classes): the quartet kernels' work list
        (csrc/quartet.cuh), split at HEAVY_THRESHOLD.

        quartets, (n, 2) int32, holds every unordered AO-pair quartet whose
        x and y Hermite parities match, each once, as (bra, ket) with
        L_bra >= L_ket (L = |l1| + |l2| of the pair), grouped by class
        (L_bra, L_ket).  A class is its light part (primitive-quartet counts
        up to the threshold, one thread a quartet), then its heavy part (one
        warp a quartet), each sorted by count, largest first, so that the
        lanes of a warp do equal work and the longest quartets start first.
        classes, (n_classes, 7) int32, has one row per non-empty class:
        L_bra, L_ket, begin, split, end ([begin, split) light, [split, end)
        heavy), and the most primitive pairs of a bra and of a ket in the
        heavy part.  Its rows are in launch order: the longest serial chain
        of a thread or lane first, then the most work.  It depends on the
        basis only, so it is built once."""
        if self._work_list is not None:
            return self._work_list
        first = self.pair_start[:-1]
        L = (self.l1[first].sum(axis=1) + self.l2[first].sum(axis=1)).astype(np.int64)
        parity = (2 * ((self.l1[first, 0] + self.l2[first, 0]) & 1)
                  + ((self.l1[first, 1] + self.l2[first, 1]) & 1)).astype(np.int64)
        n_prim = np.diff(self.pair_start).astype(np.int64)
        # The AO pairs sorted by (L, parity, primitive pairs, index): the kets
        # of a bra at a given count form one run of `runs` whose key is
        # `prefix`; the quartets of a class come out run by run in the order
        # of the keys (count, bra, ket) with no sort over the quartets.
        width = int(n_prim.max(initial=0)) + 1
        prefix = (L * 4 + parity) * width + n_prim
        runs = np.lexsort((np.arange(self.n_pairs), prefix))
        keys = prefix[runs] * self.n_pairs + runs
        quartets, classes, chain, work = [], [], [], []
        begin = 0
        for la in range(int(L.max(initial=-1)) + 1):
            bras = np.flatnonzero(L == la)
            for lb in range(la + 1):
                kets = L == lb
                counts = np.unique(np.concatenate(
                    [np.outer(np.unique(n_prim[bras[parity[bras] == c]]),
                              np.unique(n_prim[kets & (parity == c)])).ravel()
                     for c in range(4)]))
                # light counts, then heavy ones, each largest first
                counts = np.r_[counts[counts <= HEAVY_THRESHOLD][::-1],
                               counts[counts > HEAVY_THRESHOLD][::-1]]
                parts, sizes, max_bra, max_ket = [], [], 0, 0
                for count in counts:
                    b = bras[(count % n_prim[bras] == 0) & (count // n_prim[bras] < width)]
                    n_ket = count // n_prim[b]
                    key = ((lb * 4 + parity[b]) * width + n_ket) * self.n_pairs
                    start = np.searchsorted(keys, key)
                    stop = np.searchsorted(keys, key + (b + 1 if la == lb else self.n_pairs))
                    lengths = stop - start
                    if not lengths.any():
                        continue
                    total = int(lengths.sum())
                    offsets = np.cumsum(lengths) - lengths
                    ket = runs[np.arange(total) - np.repeat(offsets - start, lengths)]
                    parts.append(np.stack([np.repeat(b, lengths), ket], axis=1).astype(np.int32))
                    sizes.append((int(count), total))
                    if count > HEAVY_THRESHOLD:
                        max_bra = max(max_bra, int(n_prim[b[lengths > 0]].max()))
                        max_ket = max(max_ket, int(n_ket[lengths > 0].max()))
                if not parts:
                    continue
                n = sum(total for _, total in sizes)
                n_light = sum(total for count, total in sizes if count <= HEAVY_THRESHOLD)
                quartets.extend(parts)
                classes.append((la, lb, begin, begin + n_light, begin + n, max_bra, max_ket))
                ops = sum(quartet_operations(la, lb))
                light = [count for count, _ in sizes if count <= HEAVY_THRESHOLD]
                heavy = [count for count, _ in sizes if count > HEAVY_THRESHOLD]
                # iterations of the busiest thread (light) or lane (heavy), first in each part
                chain.append(ops * max(light[0] if light else 0,
                                       -(-heavy[0] // 32) if heavy else 0))
                work.append(ops * sum(count * total for count, total in sizes))
                begin += n
        quartets = np.concatenate(quartets) if quartets else np.empty((0, 2), dtype=np.int32)
        # rows of csrc/quartet.cuh::ClassPart
        classes = np.array([classes[k] for k in np.lexsort((-np.array(work), -np.array(chain)))],
                           dtype=np.int32).reshape(-1, 7)
        self._work_list = (quartets, classes)
        return self._work_list

    def lane_schedule(self) -> np.ndarray:
        """The lanes of K3 and K8a (csrc/one_electron.cu,
        csrc/one_electron_deriv.cu), (n_lanes, 2) int32 with n_lanes
        a multiple of 32: each lane's AO pair (-1 for none) and the width of
        its group.  An AO pair with c primitive pairs gets a group of w
        lanes, w the smallest power of two >= c, at most 32, whose lane r
        takes its primitive pairs r, r + w, ...  The AO pairs come sorted
        by c, largest first (ties by pair index), packed into warps in that
        order: widths only shrink along a warp, so every group starts at a
        lane that is a multiple of its width.  It depends on the basis only,
        so it is built once."""
        if self._lane_schedule is not None:
            return self._lane_schedule
        count = np.diff(self.pair_start).astype(np.int64)
        order = np.lexsort((np.arange(self.n_pairs), -count))
        width = np.minimum(32, 1 << np.ceil(np.log2(np.maximum(count[order], 1))).astype(np.int64))
        first = np.concatenate([[0], np.cumsum(width)[:-1]])
        n_lanes = -(-int(width.sum()) // 32) * 32
        lanes = np.full((n_lanes, 2), (-1, 1), dtype=np.int32)
        for pair, w, lane in zip(order, width, first):
            lanes[lane:lane + w] = (pair, w)
        self._lane_schedule = lanes
        return lanes

    def shell_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(shell pair of each AO pair, primitive pairs of each shell pair),
        int64.  The AOs of one atom with one total angular momentum and the
        same primitive exponents form a shell (a general contraction's
        shells merge).  The AO pair (i, j), i >= j, belongs to the shell pair
        (shell of i, shell of j) in that order, so every AO pair of a shell
        pair lists the same primitive pairs in the same order: the same
        count, p and P_z, whatever its Cartesian components.  It depends on
        the basis only, so it is built once."""
        if self._shell_pairs is None:
            n_prim = np.diff(self.pair_start).astype(np.int64)
            shell_of, shells = np.empty(self.n_basis, dtype=np.int64), {}
            for i in range(self.n_basis):
                diagonal = self.pair_index[i, i]
                s, n = self.pair_start[diagonal], int(round(np.sqrt(n_prim[diagonal])))
                key = (int(self.atom1[s]), int(self.l1[s].sum()), self.b[s:s + n].tobytes())
                shell_of[i] = shells.setdefault(key, len(shells))
            key = shell_of[self.pid_i] * len(shells) + shell_of[self.pid_j]
            _, first, ids = np.unique(key, return_index=True, return_inverse=True)
            self._shell_pairs = (ids.astype(np.int64), n_prim[first])
        return self._shell_pairs

    def shell_quartets(self) -> tuple[np.ndarray, np.ndarray]:
        """(components, quartets): the live shell quartets, K8b's and K8bu's
        unit of work (csrc/eri_deriv.cu).  It depends on the basis only, so
        it is built once.

        components, (n, 2) int32, holds every AO-pair quartet of
        work_list() whose four functions do not all sit on one atom, each
        once, as (A, B) with A in its shell quartet's bra shell pair,
        grouped by shell quartet and sorted by (A, B) within one.  quartets,
        (n_shell_quartets, 6) int32, has one row each: L_bra, L_ket, the
        bra's and the ket's shell pair (shell_pairs) and its components
        [begin, end).  The bra is the shell pair of the larger L, at equal L
        the one of the larger index; the rows are sorted by class (L_bra,
        L_ket), then bra, then ket.

        Built shell quartet by shell quartet, with no sort over the AO-pair
        quartets (10^8 of them at N2/cc-pV5Z): L and the atoms of an AO pair
        are its shell pair's, so a shell quartet is live or not as a whole,
        and its components are, for each bra AO pair A in index order, the
        ket shell pair's AO pairs of A's x/y parity in index order (at the
        same shell pair those up to A: each unordered quartet once, as in
        work_list)."""
        if self._shell_quartets is not None:
            return self._shell_quartets
        n_pairs = self.n_pairs
        first = self.pair_start[:-1]
        L = (self.l1[first].sum(axis=1) + self.l2[first].sum(axis=1)).astype(np.int64)
        parity = (2 * ((self.l1[first, 0] + self.l2[first, 0]) & 1)
                  + ((self.l1[first, 1] + self.l2[first, 1]) & 1)).astype(np.int64)
        atom = np.where(self.atom1[first] == self.atom2[first], self.atom1[first], -1)
        shell_pair, _ = self.shell_pairs()
        n_sp = int(shell_pair.max(initial=-1)) + 1
        sp_L, sp_atom = np.zeros(n_sp, dtype=np.int64), np.zeros(n_sp, dtype=np.int64)
        sp_L[shell_pair], sp_atom[shell_pair] = L, atom
        index = np.arange(n_pairs)
        # the bra AO pairs of each shell pair, and its AO pairs of each
        # parity (group 4 s + c), each in index order
        by_pair = np.lexsort((index, shell_pair))
        pair_first = np.searchsorted(shell_pair[by_pair], np.arange(n_sp + 1))
        grouped = np.lexsort((index, parity, shell_pair))
        group = (shell_pair * 4 + parity)[grouped]
        group_first = np.searchsorted(group, np.arange(4 * n_sp + 1))
        rank = np.empty(n_pairs, dtype=np.int64)
        rank[grouped] = np.arange(n_pairs) - group_first[group]
        # the live shell quartets in (L_bra, L_ket, bra, ket) order
        sa, sb = np.divmod(np.arange(n_sp * n_sp, dtype=np.int64), n_sp)
        keep = ((sp_L[sa] > sp_L[sb]) | ((sp_L[sa] == sp_L[sb]) & (sa >= sb))) & ~(
            (sp_atom[sa] >= 0) & (sp_atom[sa] == sp_atom[sb]))
        sa, sb = sa[keep], sb[keep]
        order = np.lexsort((sb, sa, sp_L[sb], sp_L[sa]))
        sa, sb = sa[order], sb[order]
        # one run of kets a (shell quartet, bra AO pair)
        bras = pair_first[sa + 1] - pair_first[sa]
        run_quartet = np.repeat(np.arange(len(sa)), bras)
        run_A = by_pair[np.repeat(pair_first[sa] - (np.cumsum(bras) - bras), bras)
                        + np.arange(len(run_quartet))]
        run_start = group_first[sb[run_quartet] * 4 + parity[run_A]]
        same = sa[run_quartet] == sb[run_quartet]
        run_length = np.where(same, rank[run_A] + 1,
                              group_first[sb[run_quartet] * 4 + parity[run_A] + 1] - run_start)
        count = np.bincount(run_quartet, weights=run_length, minlength=len(sa)).astype(np.int64)
        end = np.cumsum(count)
        components = np.empty((int(end[-1]) if len(end) else 0, 2), dtype=np.int32)
        # the runs expanded in pieces of about 2^24 components
        run_end = np.cumsum(run_length)
        cuts = np.unique(np.searchsorted(
            run_end, np.arange(0, run_end[-1] if len(run_end) else 0, 1 << 24), side="right"))
        for r0, r1 in zip(cuts, np.r_[cuts[1:], len(run_end)]):
            lengths = run_length[r0:r1]
            c0 = int(run_end[r0] - lengths[0])
            offsets = np.cumsum(lengths) - lengths
            n = int(lengths.sum())
            components[c0:c0 + n, 0] = np.repeat(run_A[r0:r1], lengths)
            components[c0:c0 + n, 1] = grouped[np.repeat(run_start[r0:r1] - offsets, lengths)
                                               + np.arange(n)]
        live = count > 0
        table = np.stack([sp_L[sa], sp_L[sb], sa, sb, end - count, end], axis=1)[live]
        self._shell_quartets = (components, table.astype(np.int32).reshape(-1, 6))
        return self._shell_quartets

    def deriv_schedule(self) -> tuple[np.ndarray, np.ndarray]:
        """(tasks, classes): K8b's and K8bu's schedule over shell_quartets()
        (csrc/eri_deriv.cu), one block of SHELL_TASK_THREADS threads a task.
        It depends on the basis only, so it is built once.

        A shell quartet of nr x nc primitive quartets (g -> bra primitive
        pair g // nc, ket g % nc) and M components is cut into runs of at
        most SHELL_TASK_THREADS primitive quartets; a run of n takes all M
        components in one task unless n x M x own > SHELL_TASK_THREADS x
        SHELL_TASK_OPS (own: deriv_quartet_operations), and is then cut
        into several tasks of runs of its components, which read its
        primitive quartets' shared parts from deriv_tables.  So each shared
        part is formed once.  tasks, (n, 8) int32, one row each: the first
        primitive pair of its shell quartet's first component's A and of
        its B (the shared part reads p and P_z there), nc, the first
        primitive quartet g0 and the count n of its primitive quartets, its
        components [c0, c1), and where its run's shared parts start in the
        tables (-1: the task forms them).  The tasks of a class are
        contiguous, sorted by the items a thread takes, largest first.
        classes, (n_classes, 5) int32: L_bra, L_ket, the class's tasks
        [begin, end) and the most primitive quartets of one of them, in
        launch order: the longest serial chain of a thread first, then the
        most work."""
        if self._deriv_schedule is None:
            self._build_deriv_schedule()
        return self._deriv_schedule

    def deriv_tables(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(runs, owner, doubles): the runs of primitive quartets that
        deriv_schedule cuts into several tasks, whose shared parts K8b's
        pass deriv_shared_kernel (csrc/eri_deriv.cu) forms once, a thread
        each, into tables of `doubles` doubles.  runs, (n_runs, 8) int32:
        the first primitive pair of the shell quartet's bra and of its ket,
        nc, L_bra + L_ket, the run's first primitive quartet g0 and its
        count n, the offset of its tables (entry e of its primitive quartet
        k at offset + e n + k, coulomb_entries(L_bra + L_ket) entries each)
        and its first primitive quartet in the flat count over the runs;
        owner, (n_shared,) int32: the run of each primitive quartet in that
        count."""
        if self._deriv_tables is None:
            self._build_deriv_schedule()
        return self._deriv_tables

    def _build_deriv_schedule(self):
        components, quartets = self.shell_quartets()
        _, shell_prim = self.shell_pairs()
        la, lb, sa, sb, begin, end = (quartets[:, k].astype(np.int64) for k in range(6))
        nc = shell_prim[sb]
        prims, count = shell_prim[sa] * nc, end - begin
        head = components[begin].astype(np.int64)
        bra0, ket0 = self.pair_start[head[:, 0]], self.pair_start[head[:, 1]]
        top = int(la.max(initial=0)) + 1
        own = np.array([[deriv_quartet_operations(a, b)[1] for b in range(top)]
                        for a in range(top)], dtype=np.int64).reshape(top, top)[la, lb]
        # runs of primitive quartets
        width = SHELL_TASK_THREADS
        chunks = -(-prims // width)
        sq = np.repeat(np.arange(len(quartets)), chunks)
        g0 = (np.arange(len(sq)) - np.repeat(np.cumsum(chunks) - chunks, chunks)) * width
        n = np.minimum(width, prims[sq] - g0)
        per = np.maximum(1, (width * SHELL_TASK_OPS) // (n * own[sq]))
        pieces = -(-count[sq] // per)
        # the runs cut into several tasks: their shared parts in the tables
        cut = np.flatnonzero(pieces > 1)
        l_sum = la + lb
        entries = np.array([coulomb_entries(k) for k in range(int(l_sum.max(initial=0)) + 1)],
                           dtype=np.int64)
        size = n[cut] * entries[l_sum[sq[cut]]]
        offset = np.full(len(sq), -1, dtype=np.int64)
        offset[cut] = np.cumsum(size) - size
        first = np.cumsum(n[cut]) - n[cut]
        runs = np.stack([bra0[sq[cut]], ket0[sq[cut]], nc[sq[cut]], l_sum[sq[cut]], g0[cut],
                         n[cut], offset[cut], first], axis=1)
        owner = np.repeat(np.arange(len(cut)), n[cut])
        # tasks: each run's components in pieces
        task = np.repeat(np.arange(len(sq)), pieces)   # the run of each task
        piece = np.arange(len(task)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
        sq, g0, n, per, formed = sq[task], g0[task], n[task], per[task], offset[task]
        c0 = begin[sq] + piece * per
        c1 = np.minimum(c0 + per, end[sq])
        thread_items = -(-(n * (c1 - c0)) // width)
        order = np.lexsort((c0, task, -thread_items, lb[sq], la[sq]))
        sq, g0, n, c0, c1, formed, thread_items = (
            x[order] for x in (sq, g0, n, c0, c1, formed, thread_items))
        tasks = np.stack([bra0[sq], ket0[sq], nc[sq], g0, n, c0, c1, formed], axis=1)
        cls = la[sq] * 16 + lb[sq]
        starts = np.flatnonzero(np.r_[len(cls) > 0, cls[1:] != cls[:-1]])
        stops = np.r_[starts[1:], len(cls)].astype(np.int64)
        rows, chain, work = [], [], []
        for s, e in zip(starts, stops):
            shared, own_ops = deriv_quartet_operations(int(la[sq[s]]), int(lb[sq[s]]))
            rows.append((la[sq[s]], lb[sq[s]], s, e, n[s:e].max()))
            chain.append(shared + own_ops * int(thread_items[s]))
            work.append(int(np.sum(shared * n[s:e] + own_ops * n[s:e] * (c1[s:e] - c0[s:e]))))
        launch = np.lexsort((-np.array(work, dtype=np.int64), -np.array(chain, dtype=np.int64)))
        classes = np.array([rows[k] for k in launch], dtype=np.int32).reshape(-1, 5)
        self._deriv_schedule = (np.ascontiguousarray(tasks, dtype=np.int32).reshape(-1, 8),
                                classes)
        self._deriv_tables = (np.ascontiguousarray(runs, dtype=np.int32).reshape(-1, 8),
                              np.ascontiguousarray(owner, dtype=np.int32), int(size.sum()))

    def _kernel_deriv_schedule(self, device):
        """K8b's components, their first primitive pairs, its tasks, and its
        shared runs and their owners on `device` (cached), and its class
        table, which stays on the host."""
        tasks, classes = self.deriv_schedule()
        runs, owner, _ = self.deriv_tables()
        device = torch.device(device)
        cached = self._device_deriv.get(device)
        if cached is None:
            components, _ = self.shell_quartets()
            cached = self._device_deriv[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=device)
                for x in (components, self.pair_start[components], tasks, runs, owner))
        return (*cached, classes)

    def _kernel_work_list(self, device):
        """The work list's quartets on `device` (cached) and its class table,
        which stays on the host."""
        quartets, classes = self.work_list()
        need = heavy_shared_bytes(classes)
        if need.max(initial=0) > SHARED_MEMORY_PER_BLOCK:
            worst = classes[int(np.argmax(need))]
            raise NotImplementedError(
                f"the heavy quartet kernel of class ({worst[0]}, {worst[1]}) would stage "
                f"{worst[5]} bra and {worst[6]} ket primitive pairs, {int(need.max())} bytes of "
                f"shared memory, more than a block's {SHARED_MEMORY_PER_BLOCK}")
        device = torch.device(device)
        on_device = self._device_quartets.get(device)
        if on_device is None:
            on_device = self._device_quartets[device] = torch.as_tensor(quartets, device=device)
        return on_device, classes

    # ------------------------------------------------------------------
    # One-electron integrals: S, T, V_NE, D (3), Q (3)  [Cartesian basis]
    # ------------------------------------------------------------------

    def one_electron(self, coords, charges, dipole_origin_z):
        """(S, T, V_NE, D, Q) for float64 coords (n_atoms, 3) and charges
        (n_atoms,): the K3 kernel on a CUDA tensor, the plain version on a
        CPU tensor."""
        if coords.device.type == "cpu":
            return self._one_electron_plain(coords, charges, dipole_origin_z)
        if coords.device.type == "cuda":
            return self._one_electron_kernel(coords, charges, dipole_origin_z)
        raise ValueError(f"no one-electron integrals for device {coords.device}")

    def _one_electron_kernel(self, coords, charges, dipole_origin_z):
        self._check_kernel_lmax("one_electron")
        device = coords.device
        N, n_atoms = self.n_basis, self.n_atoms
        _kernels.check_tensor("coords", coords, (n_atoms, 3), _F64, device)
        _kernels.check_tensor("charges", charges, (n_atoms,), _F64, device)
        t = self.tensors(device)
        out = torch.empty((9, N, N), dtype=_F64, device=device)
        _kernels.launch(
            "one_electron", "tuna_one_electron", device,
            self.lmax, n_atoms, N, t["lanes"].shape[0],
            coords.data_ptr(), charges.data_ptr(), t["a"].data_ptr(),
            t["b"].data_ptr(), t["coef"].data_ptr(), t["l1"].data_ptr(),
            t["l2"].data_ptr(), t["atom1"].data_ptr(), t["atom2"].data_ptr(),
            t["ao_i"].data_ptr(), t["ao_j"].data_ptr(), t["pair_start"].data_ptr(),
            t["lanes"].data_ptr(), t["boys_one_electron"].data_ptr(),
            float(dipole_origin_z), out.data_ptr())
        return out[0], out[1], out[2], out[3:6], out[6:9]

    def _one_electron_plain(self, coords, charges, dipole_origin_z):
        t = self.tensors(coords.device)
        lmax = self.lmax
        A = coords[t["atom1"].long()]  # (Npp, 3)
        B = coords[t["atom2"].long()]
        a, b = t["a"], t["b"]
        p = a + b
        prefactor = t["coef"] * PI_POW_1_5 / (p * torch.sqrt(p))

        # E tables per axis, up to l2 + 2 on the second index (kinetic and
        # quadrupole raise the second function's angular momentum by 2).
        tmax = 2 * lmax + 2
        E_axes = []
        for axis in range(3):
            E = build_E_table(lmax, lmax + 2, A[:, axis] - B[:, axis], a, b)
            E_axes.append(stack_E_table(E, lmax, lmax + 2, tmax))

        l1, l2 = t["l1"].long(), t["l2"].long()
        S_axis, T_axis, D_axis, Q_axis = [], [], [], []
        P_coord = (a[:, None] * A + b[:, None] * B) / p[:, None]
        origin = [0.0, 0.0, float(dipole_origin_z)]
        for axis in range(3):
            Etab = E_axes[axis]
            l1x, l2x = l1[:, axis], l2[:, axis]
            S0 = gather_E_scalar(Etab, l1x, l2x, 0)
            E1 = gather_E_scalar(Etab, l1x, l2x, 1)
            E2 = gather_E_scalar(Etab, l1x, l2x, 2)
            S_plus2 = gather_E_scalar(Etab, l1x, l2x + 2, 0)
            S_minus2 = torch.where(
                l2x >= 2, gather_E_scalar(Etab, l1x, torch.clamp(l2x - 2, min=0), 0), 0.0)
            Tx = ((2 * l2x + 1) * b * S0
                  - 2.0 * b * b * S_plus2
                  - 0.5 * (l2x * (l2x - 1)) * S_minus2)
            Px = P_coord[:, axis] - origin[axis]
            Dx = E1 + Px * S0
            Qx = 2.0 * E2 + 2.0 * Px * E1 + (Px * Px + 0.5 / p) * S0
            S_axis.append(S0)
            T_axis.append(Tx)
            D_axis.append(Dx)
            Q_axis.append(Qx)

        Sx, Sy, Sz = S_axis
        s_val = prefactor * Sx * Sy * Sz
        t_val = prefactor * (T_axis[0] * Sy * Sz + Sx * T_axis[1] * Sz + Sx * Sy * T_axis[2])
        d_vals = [prefactor * D_axis[0] * Sy * Sz,
                  prefactor * Sx * D_axis[1] * Sz,
                  prefactor * Sx * Sy * D_axis[2]]
        q_vals = [prefactor * Q_axis[0] * Sy * Sz,
                  prefactor * Sx * Q_axis[1] * Sz,
                  prefactor * Sx * Sy * Q_axis[2]]

        # ---- nuclear attraction (z-axis Hermite table) -------------------
        # Scaled form: each Hermite coefficient picks up (2p)^(t/2) for x/y
        # and (2p)^v for z, matching Rt[v,n] = R[v,n]/(2p)^(n+v).
        Ex = gather_E_row(E_axes[0], l1[:, 0], l2[:, 0])[:, :2 * lmax + 1]
        Ey = gather_E_row(E_axes[1], l1[:, 1], l2[:, 1])[:, :2 * lmax + 1]
        Ez = gather_E_row(E_axes[2], l1[:, 2], l2[:, 2])[:, :2 * lmax + 1]
        half_powers = _powers(torch.sqrt(2.0 * p), 2 * lmax)
        full_powers = half_powers * half_powers
        Ex_s = Ex * half_powers
        Ey_s = Ey * half_powers
        Ez_s = Ez * full_powers

        mmax = lmax
        vmax = 2 * lmax
        nmax = 2 * lmax

        v_total = torch.zeros_like(p)
        for atom in range(self.n_atoms):
            PCz = P_coord[:, 2] - coords[atom, 2]
            Rz = build_scaled_Rz_table(vmax, nmax, PCz, p)  # (Npp, vmax+1, nmax+1)
            ax = torch.stack([Ex_s[:, 2 * m] * _double_factorial(2 * m - 1)
                              for m in range(mmax + 1)], dim=1)
            ay = torch.stack([Ey_s[:, 2 * m] * _double_factorial(2 * m - 1)
                              for m in range(mmax + 1)], dim=1)
            axy = torch.zeros((p.shape[0], nmax + 1), dtype=p.dtype, device=p.device)
            for m1 in range(mmax + 1):
                for m2 in range(mmax + 1):
                    axy[:, m1 + m2] += ax[:, m1] * ay[:, m2]
            contrib = torch.einsum("bv,bn,bvn->b", Ez_s, axy, Rz[:, :2 * lmax + 1, :])
            v_total = v_total - charges[atom] * contrib * 2.0 * math.pi / p

        v_val = t["coef"] * v_total
        return self._scatter_one_electron(t, s_val, t_val, v_val, d_vals, q_vals)

    def _scatter_one_electron(self, t, s_val, t_val, v_val, d_vals, q_vals):
        """Per-primitive-pair values summed into symmetric (N, N) matrices:
        (S, T, V, D (3), Q (3))."""
        ao_i, ao_j = t["ao_i"].long(), t["ao_j"].long()

        def scatter(values):
            M = torch.zeros((self.n_basis, self.n_basis), dtype=values.dtype,
                            device=values.device)
            M.index_put_((ao_i, ao_j), values, accumulate=True)
            return M + torch.triu(M.T, diagonal=1)

        return (scatter(s_val), scatter(t_val), scatter(v_val),
                torch.stack([scatter(v) for v in d_vals]),
                torch.stack([scatter(v) for v in q_vals]))

    # ------------------------------------------------------------------
    # R-tangents of the one-electron integrals  [Cartesian basis]
    # ------------------------------------------------------------------

    def one_electron_deriv(self, coords, charges, dipole_origin_z, origin_rate):
        """d/dR of (S, T, V_NE, D, Q) when atom 1 moves along +z at unit
        rate, its nucleus with it, and the multipole origin at
        `origin_rate` (the mass fraction of atom 1): the K8a kernel on a
        CUDA tensor, the plain version on a CPU tensor.  Same layout as
        `one_electron`."""
        if coords.device.type == "cpu":
            return self._one_electron_deriv_plain(coords, charges, dipole_origin_z, origin_rate)
        if coords.device.type == "cuda":
            return self._one_electron_deriv_kernel(coords, charges, dipole_origin_z, origin_rate)
        raise ValueError(f"no one-electron integral derivatives for device {coords.device}")

    def _one_electron_deriv_kernel(self, coords, charges, dipole_origin_z, origin_rate):
        self._check_kernel_lmax("one_electron_deriv")
        device = coords.device
        N, n_atoms = self.n_basis, self.n_atoms
        _kernels.check_tensor("coords", coords, (n_atoms, 3), _F64, device)
        _kernels.check_tensor("charges", charges, (n_atoms,), _F64, device)
        t = self.tensors(device)
        out = torch.empty((9, N, N), dtype=_F64, device=device)
        _kernels.launch(
            "one_electron_deriv", "tuna_one_electron_deriv", device,
            self.lmax, n_atoms, N, t["lanes"].shape[0],
            coords.data_ptr(), charges.data_ptr(), t["a"].data_ptr(),
            t["b"].data_ptr(), t["coef"].data_ptr(), t["l1"].data_ptr(),
            t["l2"].data_ptr(), t["atom1"].data_ptr(), t["atom2"].data_ptr(),
            t["ao_i"].data_ptr(), t["ao_j"].data_ptr(), t["pair_start"].data_ptr(),
            t["lanes"].data_ptr(), t["boys_one_electron_deriv"].data_ptr(),
            float(dipole_origin_z), float(origin_rate), out.data_ptr())
        return out[0], out[1], out[2], out[3:6], out[6:9]

    def _one_electron_deriv_plain(self, coords, charges, dipole_origin_z, origin_rate):
        """The tangent term by term.  Only z positions move, so of the
        three axis factors of S, T, D, Q only the z factor X^{ij} changes:

            dX^{ij} = cA (2a X^{i+1,j} - i X^{i-1,j})
                    + cB (2b X^{i,j+1} - j X^{i,j-1})   [- f S^{ij} for D,
                                                         - 2 f D^{ij} for Q]

        with cA, cB = 1 for a function on atom 1 (d/dA_z of a Cartesian
        Gaussian raises and lowers its z power) and f = origin_rate.  V_NE
        of nucleus C takes the same raised/lowered z Hermite rows with
        weights cA - [C = 1] and cB - [C = 1] (translation invariance,
        d/dC = -(d/dA + d/dB)), so its Hermite Coulomb table and Boys
        function go one order higher."""
        t = self.tensors(coords.device)
        lmax = self.lmax
        atom1, atom2 = t["atom1"].long(), t["atom2"].long()
        A, B = coords[atom1], coords[atom2]
        a, b = t["a"], t["b"]
        p = a + b
        prefactor = t["coef"] * PI_POW_1_5 / (p * torch.sqrt(p))
        cA, cB = (atom1 == 1).to(_F64), (atom2 == 1).to(_F64)
        f = float(origin_rate)
        l1, l2 = t["l1"].long(), t["l2"].long()
        P_coord = (a[:, None] * A + b[:, None] * B) / p[:, None]
        origin = [0.0, 0.0, float(dipole_origin_z)]

        # x and y up to (lmax, lmax + 2) as the forward, z up to (lmax + 1, lmax + 3)
        E_axes = []
        for axis, extra in ((0, 0), (1, 0), (2, 1)):
            E = build_E_table(lmax + extra, lmax + 2 + extra, A[:, axis] - B[:, axis], a, b)
            E_axes.append(stack_E_table(E, lmax + extra, lmax + 2 + extra,
                                        2 * lmax + 2 + 2 * extra))

        def one_d(axis, i, j):
            """S, T, D, Q of one axis at powers (i, j); entries at a negative
            power are garbage that callers weight by zero."""
            Etab = E_axes[axis]
            i, j = torch.clamp(i, min=0), torch.clamp(j, min=0)
            S0 = gather_E_scalar(Etab, i, j, 0)
            E1 = gather_E_scalar(Etab, i, j, 1)
            E2 = gather_E_scalar(Etab, i, j, 2)
            S_plus2 = gather_E_scalar(Etab, i, j + 2, 0)
            S_minus2 = torch.where(j >= 2, gather_E_scalar(Etab, i, torch.clamp(j - 2, min=0), 0),
                                   0.0)
            T = (2 * j + 1) * b * S0 - 2.0 * b * b * S_plus2 - 0.5 * (j * (j - 1)) * S_minus2
            Pc = P_coord[:, axis] - origin[axis]
            D = E1 + Pc * S0
            Q = 2.0 * E2 + 2.0 * Pc * E1 + (Pc * Pc + 0.5 / p) * S0
            return S0, T, D, Q

        Sx, Tx, Dx, Qx = one_d(0, l1[:, 0], l2[:, 0])
        Sy, Ty, Dy, Qy = one_d(1, l1[:, 1], l2[:, 1])
        iz, jz = l1[:, 2], l2[:, 2]
        Sz, _, Dz, _ = one_d(2, iz, jz)
        up_i, down_i = one_d(2, iz + 1, jz), one_d(2, iz - 1, jz)
        up_j, down_j = one_d(2, iz, jz + 1), one_d(2, iz, jz - 1)
        dS, dT, dD, dQ = (cA * (2 * a * ui - iz * di) + cB * (2 * b * uj - jz * dj)
                          for ui, di, uj, dj in zip(up_i, down_i, up_j, down_j))
        dD = dD - f * Sz
        dQ = dQ - 2.0 * f * Dz

        s_val = prefactor * Sx * Sy * dS
        t_val = prefactor * (Tx * Sy * dS + Sx * Ty * dS + Sx * Sy * dT)
        d_vals = [prefactor * Dx * Sy * dS, prefactor * Sx * Dy * dS, prefactor * Sx * Sy * dD]
        q_vals = [prefactor * Qx * Sy * dS, prefactor * Sx * Qy * dS, prefactor * Sx * Sy * dQ]

        # ---- nuclear attraction: the z rows of d/dA_z and d/dB_z ---------
        nz = 2 * lmax + 2
        Ex = gather_E_row(E_axes[0], l1[:, 0], l2[:, 0])[:, :2 * lmax + 1]
        Ey = gather_E_row(E_axes[1], l1[:, 1], l2[:, 1])[:, :2 * lmax + 1]

        def z_row(i, j):
            return gather_E_row(E_axes[2], torch.clamp(i, min=0), torch.clamp(j, min=0))[:, :nz]

        half_powers = _powers(torch.sqrt(2.0 * p), nz - 1)
        full_powers = half_powers * half_powers
        row_A = (2 * a[:, None] * z_row(iz + 1, jz) - iz[:, None] * z_row(iz - 1, jz)) * full_powers
        row_B = (2 * b[:, None] * z_row(iz, jz + 1) - jz[:, None] * z_row(iz, jz - 1)) * full_powers
        Ex_s = Ex * half_powers[:, :2 * lmax + 1]
        Ey_s = Ey * half_powers[:, :2 * lmax + 1]
        ax = torch.stack([Ex_s[:, 2 * m] * _double_factorial(2 * m - 1)
                          for m in range(lmax + 1)], dim=1)
        ay = torch.stack([Ey_s[:, 2 * m] * _double_factorial(2 * m - 1)
                          for m in range(lmax + 1)], dim=1)
        axy = torch.zeros((p.shape[0], nz), dtype=p.dtype, device=p.device)
        for m1 in range(lmax + 1):
            for m2 in range(lmax + 1):
                axy[:, m1 + m2] += ax[:, m1] * ay[:, m2]

        v_total = torch.zeros_like(p)
        for atom in range(self.n_atoms):
            moves = 1.0 if atom == 1 else 0.0
            gz = (cA - moves)[:, None] * row_A + (cB - moves)[:, None] * row_B
            Rz = build_scaled_Rz_table(nz - 1, nz - 1, P_coord[:, 2] - coords[atom, 2], p)
            contrib = torch.einsum("bv,bn,bvn->b", gz, axy, Rz)
            v_total = v_total - charges[atom] * contrib * 2.0 * math.pi / p
        v_val = t["coef"] * v_total
        return self._scatter_one_electron(t, s_val, t_val, v_val, d_vals, q_vals)

    # ------------------------------------------------------------------
    # Electron repulsion integrals  [Cartesian basis]
    # ------------------------------------------------------------------

    def eri(self, coords):
        """The dense (N, N, N, N) chemists' ERI tensor (ij|kl)."""
        packed = self.eri_pair_packed(coords)
        pidx = self.tensors(coords.device)["pair_index"]
        return packed[pidx[:, :, None, None], pidx[None, None, :, :]]

    def eri_pair_packed(self, coords):
        """Packed (n_pairs, n_pairs) matrix, element (pair_ij, pair_kl) =
        (ij|kl): the K1 kernel on a CUDA tensor, the plain version on a CPU
        tensor."""
        if coords.device.type == "cpu":
            return self._eri_packed_plain(coords)
        if coords.device.type == "cuda":
            return self._eri_packed_kernel(coords)
        raise ValueError(f"no electron repulsion integrals for device {coords.device}")

    def _check_kernel_lmax(self, kernel: str):
        """Raise unless the CUDA kernel `kernel` (a key of KERNEL_MAX_LMAX)
        is instantiated for this basis's lmax."""
        label, most = KERNEL_MAX_LMAX[kernel]
        if self.lmax > most:
            raise NotImplementedError(
                f"{label} ({kernel}) is not yet ported to tuna_tpu_torch above lmax {most}; "
                f"this basis has lmax {self.lmax}")

    def _eri_packed_kernel(self, coords):
        self._check_kernel_lmax("eri_packed")
        device = coords.device
        _kernels.check_tensor("coords", coords, (self.n_atoms, 3), _F64, device)
        t = self.tensors(device)
        quartets, classes = self._kernel_work_list(device)
        row_size = 3 * (2 * self.lmax + 1) + 3
        rows = torch.empty((self.n_prim_pairs, row_size), dtype=_F64, device=device)
        packed = torch.empty((self.n_pairs, self.n_pairs), dtype=_F64, device=device)
        _kernels.launch(
            "eri_packed", "tuna_eri_packed", device,
            self.lmax, self.n_pairs, self.n_prim_pairs,
            coords.data_ptr(), t["a"].data_ptr(), t["b"].data_ptr(),
            t["coef"].data_ptr(), t["l1"].data_ptr(), t["l2"].data_ptr(),
            t["atom1"].data_ptr(), t["atom2"].data_ptr(), t["pair_start"].data_ptr(),
            quartets.data_ptr(), len(classes), classes.ctypes.data,
            t["boys_quartets"].data_ptr(), rows.data_ptr(), packed.data_ptr())
        return packed

    def _pair_data(self, coords):
        """Per-primitive-pair scaled Hermite vectors for the ERI sweep."""
        t = self.tensors(coords.device)
        lmax = self.lmax
        tmax = 2 * lmax
        A = coords[t["atom1"].long()]
        B = coords[t["atom2"].long()]
        a, b = t["a"], t["b"]
        p = a + b
        Pz = (a * A[:, 2] + b * B[:, 2]) / p

        hs = []
        for axis in range(3):
            E = build_E_table(lmax, lmax, A[:, axis] - B[:, axis], a, b)
            Etab = stack_E_table(E, lmax, lmax, tmax)
            hs.append(gather_E_row(Etab, t["l1"][:, axis].long(), t["l2"][:, axis].long()))

        half_powers = _powers(torch.sqrt(2.0 * p), tmax)
        full_powers = half_powers * half_powers
        return hs[0] * half_powers, hs[1] * half_powers, hs[2] * full_powers, p, Pz

    def _pair_dz(self, coords):
        """Scaled R-tangent of each primitive pair's z Hermite row when atom
        1 moves along +z, orders 0..2 lmax + 1:
        cA (2a E^{i+1,j} - i E^{i-1,j}) + cB (2b E^{i,j+1} - j E^{i,j-1})
        on the z axis, times (2p)^t as _pair_data scales hz."""
        t = self.tensors(coords.device)
        lmax = self.lmax
        nz = 2 * lmax + 2
        atom1, atom2 = t["atom1"].long(), t["atom2"].long()
        a, b = t["a"], t["b"]
        p = a + b
        E = build_E_table(lmax + 1, lmax + 1, coords[atom1, 2] - coords[atom2, 2], a, b)
        Etab = stack_E_table(E, lmax + 1, lmax + 1, nz - 1)
        i, j = t["l1"][:, 2].long(), t["l2"][:, 2].long()

        def row(ii, jj):
            return gather_E_row(Etab, torch.clamp(ii, min=0), torch.clamp(jj, min=0))

        cA, cB = (atom1 == 1).to(_F64)[:, None], (atom2 == 1).to(_F64)[:, None]
        dz = (cA * (2 * a[:, None] * row(i + 1, j) - i[:, None] * row(i - 1, j))
              + cB * (2 * b[:, None] * row(i, j + 1) - j[:, None] * row(i, j - 1)))
        half_powers = _powers(torch.sqrt(2.0 * p), nz - 1)
        return dz * half_powers * half_powers

    def _plain_sweep(self, coords, derivative=False):
        """(data, block_values) of the plain parity-blocked quartet sweep,
        shared by the plain ERI and direct Fock builds and, with
        `derivative`, the plain R-tangent of the ERI (atom 1 moving).

        data holds the per-primitive-pair rows (Hermite vectors, p, P_z,
        coefficient, AO pair id) with one sentinel row at index npp that
        backs the block padding: its zero coefficient kills its
        contributions, p = 1 keeps alpha finite.  block_values(rows, cols)
        gives the (T, T) contracted primitive-quartet values of two blocks of
        primitive-pair indices (tuna_tpu/ops/integrals.py::_sweep_blocks).

        A derivative quartet is [d bra | ket] + [bra | d ket]: the z
        Hermite rows go one order higher (_pair_dz), so do the Coulomb table
        and the Boys order; x and y, and so the parity classes, are those of
        the forward.  Quartets whose four functions sit on one atom are set
        to zero (their tangent vanishes by translation invariance), as
        csrc/eri_deriv.cu skips them."""
        device = coords.device
        t = self.tensors(device)
        lmax = self.lmax
        tmax = 2 * lmax          # max Hermite order per pair per axis
        nz = tmax + 1 + int(derivative)   # z Hermite orders of a pair's row
        vmax4 = 2 * (nz - 1)     # total z Hermite order per quartet
        nmax4 = 4 * lmax + int(derivative)   # Boys order cap per quartet

        hx, hy, hz, p, Pz = self._pair_data(coords)
        sign = torch.tensor([(-1.0) ** k for k in range(nz)], dtype=_F64, device=device)

        def ext(x, fill=0.0):
            return torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype,
                                            device=device)])

        data = {"hx": ext(hx), "hy": ext(hy), "p": ext(p, 1.0),
                "Pz": ext(Pz), "coef": ext(t["coef"]),
                "pid": ext(t["pair_id"].long(), 0)}
        if derivative:
            data["hz"] = ext(torch.nn.functional.pad(hz, (0, 1)))
            data["dz"] = ext(self._pair_dz(coords))
            one_atom = torch.where(t["atom1"] == t["atom2"], t["atom1"], -1).long()
            data["one_atom"] = ext(one_atom, -1)
        else:
            data["hz"] = ext(hz)

        # t + u -> T coupling, and the x/y pairing of even orders T = 2 m1,
        # U = 2 m2 into n = m1 + m2 with the (T-1)!! (U-1)!! weights
        n2t = 2 * tmax
        conv = np.zeros((nz, nz, 2 * nz - 1))
        for k1 in range(nz):
            for k2 in range(nz):
                conv[k1, k2, k1 + k2] = 1.0
        pair_xy = np.zeros((n2t + 1, n2t + 1, nmax4 + 1))
        for T in range(0, n2t + 1, 2):
            for U in range(0, n2t + 1, 2):
                if T // 2 + U // 2 <= nmax4:
                    pair_xy[T, U, T // 2 + U // 2] = (_double_factorial(T - 1)
                                                      * _double_factorial(U - 1))
        vn_mask = np.array([[1.0 if n <= nmax4 - V else 0.0 for n in range(nmax4 + 1)]
                            for V in range(vmax4 + 1)])
        conv = torch.as_tensor(conv, dtype=_F64, device=device)
        pair_xy = torch.as_tensor(pair_xy, dtype=_F64, device=device)
        vn_mask = torch.as_tensor(vn_mask, dtype=_F64, device=device)

        def block_values(rows, cols):
            p12 = data["p"][rows][:, None]
            q34 = data["p"][cols][None, :]
            psum = p12 + q34
            alpha = p12 * q34 / psum
            PQz = data["Pz"][rows][:, None] - data["Pz"][cols][None, :]
            r12_half = _powers(torch.sqrt(q34 / psum), nz - 1)
            r34_half = _powers(torch.sqrt(p12 / psum), nz - 1)
            xy_conv = conv[:tmax + 1, :tmax + 1, :n2t + 1]
            G = []
            for key in ("hx", "hy"):
                g12 = data[key][rows][:, None, :] * r12_half[..., :tmax + 1]
                g34 = (data[key][cols] * sign[:tmax + 1])[None, :, :] * r34_half[..., :tmax + 1]
                G.append(torch.einsum("rct,rcu,tuT->rcT", g12, g34, xy_conv))
            Gx, Gy = G
            r12, r34 = r12_half * r12_half, r34_half * r34_half

            def z_product(key12, key34):
                g12 = data[key12][rows][:, None, :] * r12
                g34 = (data[key34][cols] * sign)[None, :, :] * r34
                return torch.einsum("rct,rcu,tuT->rcT", g12, g34, conv)

            Gz = (z_product("dz", "hz") + z_product("hz", "dz") if derivative
                  else z_product("hz", "hz"))
            axy = torch.einsum("rcT,rcU,TUn->rcn", Gx, Gy, pair_xy)
            Rz = build_scaled_Rz_table(vmax4, nmax4, PQz.reshape(-1), alpha.reshape(-1))
            Rz = Rz.reshape(PQz.shape + (vmax4 + 1, nmax4 + 1)) * vn_mask
            total = torch.einsum("rcv,rcvn,rcn->rc", Gz, Rz, axy)
            pref = TWO_PI_POW_2_5 / (p12 * q34 * torch.sqrt(psum))
            values = data["coef"][rows][:, None] * data["coef"][cols][None, :] * pref * total
            if derivative:
                atom_r, atom_c = data["one_atom"][rows][:, None], data["one_atom"][cols][None, :]
                values = torch.where((atom_r >= 0) & (atom_r == atom_c), 0.0, values)
            return values

        return data, block_values

    def _plain_block_sweep(self, coords, derivative=False):
        """(rows, cols, v, upper, strict) for every block pair of the plain
        sweep: the forward mask c >= r keeps each unordered primitive
        quartet once (the diagonal included), the strict mask c > r marks
        the quartets whose mirror orientation still has to be added."""
        data, block_values = self._plain_sweep(coords, derivative)
        blocks, block_pairs = self._plain_layout(
            _PLAIN_BLOCK_BYTES if coords.device.type == "cpu" else _PLAIN_BLOCK_BYTES_CARD)
        blocks = torch.as_tensor(blocks, device=coords.device)
        for bl, br in block_pairs:
            rows, cols = blocks[bl], blocks[br]
            yield (data["pid"][rows], data["pid"][cols], block_values(rows, cols),
                   cols[None, :] >= rows[:, None], cols[None, :] > rows[:, None])

    def _eri_packed_plain(self, coords, derivative=False):
        """The parity-blocked symmetric quartet sweep in plain torch: each
        unordered primitive quartet once, its value added to both packed
        positions; with `derivative`, the R-tangent of each value (atom 1
        moving)."""
        packed = torch.zeros((self.n_pairs, self.n_pairs), dtype=_F64, device=coords.device)
        for pid_r, pid_c, v, upper, strict in self._plain_block_sweep(coords, derivative):
            packed.index_put_((pid_r[:, None], pid_c[None, :]), torch.where(upper, v, 0.0),
                              accumulate=True)
            packed.index_put_((pid_c[None, :], pid_r[:, None]), torch.where(strict, v, 0.0),
                              accumulate=True)
        return packed

    # ------------------------------------------------------------------
    # Direct Fock build: J/K contracted as the quartets are generated, the
    # N^4 tensor never materialised  [Cartesian basis]
    # ------------------------------------------------------------------

    def fock_direct(self, coords, P):
        """Coulomb and exchange matrices J_ij = sum_kl (ij|kl) P_kl and
        K_ij = sum_kl (il|kj) P_kl of a symmetric (N, N) float64 density:
        the K4 kernel on a CUDA tensor, the plain version on a CPU tensor."""
        if coords.device.type == "cpu":
            return self._fock_direct_plain(coords, P)
        if coords.device.type == "cuda":
            return self._fock_direct_kernel(coords, P)
        raise ValueError(f"no direct Fock build for device {coords.device}")

    def fock_closure(self, spherical_transformation=None):
        """(coords, P) -> (J, K) for the integral-direct SCF, in the
        spherical AO basis when a (n_spherical, n_cartesian) transformation
        U is given: the Cartesian density is U^T P U, and the closure
        returns U J_c U^T and U K_c U^T (tuna_tpu's fock_closure with
        dispatch=False)."""
        if spherical_transformation is None:
            return self.fock_direct
        U_host = np.asarray(spherical_transformation, dtype=np.float64)
        U_on: dict = {}

        def closure(coords, P):
            U = U_on.get(P.device)
            if U is None:
                U = U_on[P.device] = torch.as_tensor(U_host, device=P.device)
            J_c, K_c = self.fock_direct(coords, U.T @ P @ U)
            return U @ J_c @ U.T, U @ K_c @ U.T

        return closure

    def _fock_direct_kernel(self, coords, P):
        self._check_kernel_lmax("fock_direct")
        device = coords.device
        N = self.n_basis
        _kernels.check_tensor("coords", coords, (self.n_atoms, 3), _F64, device)
        _kernels.check_tensor("P", P, (N, N), _F64, device)
        t = self.tensors(device)
        quartets, classes = self._kernel_work_list(device)
        row_size = 3 * (2 * self.lmax + 1) + 3
        rows = torch.empty((self.n_prim_pairs, row_size), dtype=_F64, device=device)
        J_pair = torch.empty(self.n_pairs, dtype=_F64, device=device)
        J = torch.empty((N, N), dtype=_F64, device=device)
        K = torch.empty((N, N), dtype=_F64, device=device)
        _kernels.launch(
            "fock_direct", "tuna_fock_direct", device,
            self.lmax, self.n_pairs, self.n_prim_pairs, N,
            coords.data_ptr(), t["a"].data_ptr(), t["b"].data_ptr(),
            t["coef"].data_ptr(), t["l1"].data_ptr(), t["l2"].data_ptr(),
            t["atom1"].data_ptr(), t["atom2"].data_ptr(), t["pair_start"].data_ptr(),
            t["pid_i"].data_ptr(), t["pid_j"].data_ptr(), quartets.data_ptr(),
            len(classes), classes.ctypes.data, t["boys_quartets"].data_ptr(),
            P.data_ptr(), rows.data_ptr(), J_pair.data_ptr(), J.data_ptr(), K.data_ptr())
        return J, K

    def _fock_direct_plain(self, coords, P):
        """tuna_tpu's _fock_sweep over the plain sweep's blocks: each block
        pair's values added in both orientations (rows as "ij", then the
        strict part transposed), J binned per AO pair, K scattered to its
        dense rows; then _fock_unpack."""
        device = coords.device
        N = self.n_basis
        t = self.tensors(device)
        pi, pj = t["pid_i"].long(), t["pid_j"].long()
        # pair degeneracy for J; off-diagonal mask for the k <-> l swap of K
        Pp_pair = P[pi, pj] * torch.where(pi == pj, 1.0, 2.0)
        m_pair = (pi != pj).to(_F64)
        J_pair = torch.zeros(self.n_pairs, dtype=_F64, device=device)
        K = torch.zeros((N, N), dtype=_F64, device=device)

        def seg(values, segments):   # (Tr, Tc) -> (Tr, N), summed by column segment
            out = torch.zeros((values.shape[0], N), dtype=_F64, device=device)
            return out.index_add_(1, segments, values)

        def accumulate(v, rpid, cpid):
            # v: (Tr, Tc) quartet values with rows acting as "ij", cols "kl"
            irow, jrow = pi[rpid], pj[rpid]       # AO i >= j
            kcol, lcol = pi[cpid], pj[cpid]       # AO k >= l
            m_kl = m_pair[cpid][None, :]
            m_ij = m_pair[rpid][:, None]
            J_pair.index_add_(0, rpid, v @ Pp_pair[cpid])
            # K[m,n] += (ms|tn) P[t,s] over the distinct dense positions of
            # this packed value: (m,s) in {(i,j),(j,i)}, (t,n) in {(k,l),(l,k)}
            P_kj = P[kcol[None, :], jrow[:, None]]
            P_lj = P[lcol[None, :], jrow[:, None]]
            P_ki = P[kcol[None, :], irow[:, None]]
            P_li = P[lcol[None, :], irow[:, None]]
            K.index_add_(0, irow, seg(v * P_kj, lcol) + seg(v * P_lj * m_kl, kcol))
            K.index_add_(0, jrow, (seg(v * P_ki, lcol) + seg(v * P_li * m_kl, kcol)) * m_ij)

        for pid_r, pid_c, v, upper, strict in self._plain_block_sweep(coords):
            accumulate(torch.where(upper, v, 0.0), pid_r, pid_c)
            accumulate(torch.where(strict, v, 0.0).T, pid_c, pid_r)
        return self._fock_unpack(J_pair, K)

    def _fock_unpack(self, J_pair, K):
        """Expand the packed J pair vector symmetrically."""
        t = self.tensors(J_pair.device)
        J = torch.zeros((self.n_basis, self.n_basis), dtype=J_pair.dtype, device=J_pair.device)
        J[t["pid_i"].long(), t["pid_j"].long()] = J_pair
        return J + torch.triu(J.T, diagonal=1), K

    # ------------------------------------------------------------------
    # R-tangent of the two-electron energy at fixed density  [Cartesian]
    # ------------------------------------------------------------------

    def eri_deriv_energy(self, coords, P, hfx):
        """d/dR, at fixed symmetric (N, N) float64 density P, of
        E_2 = 1/2 sum P_ij P_kl (ij|kl) - hfx/4 sum P_ik P_jl (ij|kl) when
        atom 1 moves along +z (tuna_tpu/drivers/gradients.py:266-271,
        restricted), as a 0-d tensor: the K8b kernel on a CUDA tensor, the
        plain version on a CPU tensor."""
        if coords.device.type == "cpu":
            return self._eri_deriv_energy_plain(coords, P, hfx)
        if coords.device.type == "cuda":
            return self._eri_deriv_energy_kernel("eri_deriv_energy", "tuna_eri_deriv_energy",
                                                 coords, [P], hfx)
        raise ValueError(f"no two-electron energy derivative for device {coords.device}")

    def eri_deriv_energy_unrestricted(self, coords, P_a, P_b, hfx):
        """d/dR, at fixed symmetric (N, N) float64 spin densities, of
        E_2 = 1/2 sum P_ij P_kl (ij|kl) - hfx/2 sum_s sum P^s_ik P^s_jl
        (ij|kl), P = P_a + P_b (tuna_tpu/drivers/gradients.py:266-275,
        unrestricted), as a 0-d tensor: the K8bu kernel (one sweep) on a
        CUDA tensor, the plain version on a CPU tensor."""
        if coords.device.type == "cpu":
            return self._eri_deriv_energy_unrestricted_plain(coords, P_a, P_b, hfx)
        if coords.device.type == "cuda":
            return self._eri_deriv_energy_kernel(
                "eri_deriv_energy_unrestricted", "tuna_eri_deriv_energy_unrestricted", coords,
                [P_a + P_b, P_a, P_b], hfx)
        raise ValueError(f"no two-electron energy derivative for device {coords.device}")

    def deriv_partial_count(self) -> int:
        """Partial sums of one K8b or K8bu call: one a task, a block each
        (csrc/eri_deriv.cu)."""
        return len(self.deriv_schedule()[0])

    def _eri_deriv_energy_kernel(self, kernel, entry, coords, densities, hfx):
        """Launch K8b (densities [P]) or K8bu ([P_a + P_b, P_a, P_b])."""
        self._check_kernel_lmax(kernel)
        device = coords.device
        N = self.n_basis
        _kernels.check_tensor("coords", coords, (self.n_atoms, 3), _F64, device)
        for P in densities:
            _kernels.check_tensor("P", P, (N, N), _F64, device)
        t = self.tensors(device)
        (components, component_rows, tasks, shared_runs, shared_owner,
         classes) = self._kernel_deriv_schedule(device)
        rows = torch.empty((4 * (2 * self.lmax + 1) + 4, self.n_prim_pairs), dtype=_F64,
                           device=device)
        weights = torch.empty(max(len(components), 1), dtype=_F64, device=device)
        tables = torch.empty(max(self.deriv_tables()[2], 1), dtype=_F64, device=device)
        n_partials = self.deriv_partial_count()
        partials = torch.empty(max(n_partials, 1), dtype=_F64, device=device)
        out = torch.empty((), dtype=_F64, device=device)
        _kernels.launch(
            kernel, entry, device,
            self.lmax, self.n_prim_pairs, N,
            coords.data_ptr(), t["a"].data_ptr(), t["b"].data_ptr(),
            t["coef"].data_ptr(), t["l1"].data_ptr(), t["l2"].data_ptr(),
            t["atom1"].data_ptr(), t["atom2"].data_ptr(), t["pid_i"].data_ptr(),
            t["pid_j"].data_ptr(), len(components), components.data_ptr(),
            component_rows.data_ptr(), tasks.data_ptr(), len(classes), classes.ctypes.data,
            len(shared_owner), shared_runs.data_ptr(), shared_owner.data_ptr(),
            t["boys_quartets"].data_ptr(), *(P.data_ptr() for P in densities), float(hfx),
            rows.data_ptr(), weights.data_ptr(), tables.data_ptr(), n_partials,
            partials.data_ptr(), out.data_ptr())
        return out

    def _eri_tangent_plain(self, coords):
        """The plain sweep's derivative values expanded to the N^4 tensor
        d(ij|kl)/dR: for small bases only."""
        packed = self._eri_packed_plain(coords, derivative=True)
        pidx = self.tensors(coords.device)["pair_index"]
        return packed[pidx[:, :, None, None], pidx[None, None, :, :]]

    def _eri_deriv_energy_plain(self, coords, P, hfx, tangent=None):
        """The ERI tangent contracted by einsum, as tuna_tpu's total_energy
        contracts the ERI; `tangent`, the tangent of _eri_tangent_plain at
        these coords, spares forming it again."""
        d_eri = self._eri_tangent_plain(coords) if tangent is None else tangent
        J = torch.einsum("ijkl,kl->ij", d_eri, P)
        K = torch.einsum("ilkj,kl->ij", d_eri, P)
        return 0.5 * torch.sum(P * J) - 0.25 * hfx * torch.sum(P * K)

    def _eri_deriv_energy_unrestricted_plain(self, coords, P_a, P_b, hfx, tangent=None):
        """The ERI tangent contracted with both spins, as tuna_tpu's
        total_energy contracts the ERI for an unrestricted reference
        (`tangent` as for _eri_deriv_energy_plain)."""
        d_eri = self._eri_tangent_plain(coords) if tangent is None else tangent
        P = P_a + P_b
        J = torch.einsum("ijkl,kl->ij", d_eri, P)
        K_a = torch.einsum("ilkj,kl->ij", d_eri, P_a)
        K_b = torch.einsum("ilkj,kl->ij", d_eri, P_b)
        return 0.5 * torch.sum(P * J) - 0.5 * hfx * (torch.sum(P_a * K_a)
                                                     + torch.sum(P_b * K_b))


def shell_subset(basis_functions, keep) -> list:
    """The basis functions of the first shell of each (atom, l) in `keep`,
    in basis order.  A shell is a run of the (l + 1)(l + 2) / 2 Cartesian
    components of one total angular momentum l on one atom.  Reduced plans
    of a large basis (a few of its g and h shells) are built this way."""
    keep, chosen, seen, i = set(keep), [], set(), 0
    while i < len(basis_functions):
        function = basis_functions[i]
        l = function.l_total
        shell = basis_functions[i:i + (l + 1) * (l + 2) // 2]
        if (function.atom_index, l) in keep - seen:
            seen.add((function.atom_index, l))
            chosen.extend(shell)
        i += len(shell)
    return chosen


def cross_overlap(basis_functions_1, basis_functions_2) -> np.ndarray:
    """Overlap matrix between two basis sets, on the host (used for guesses).

    Mirrors tuna_integral.pyx:626-768 and tuna_tpu's cross_overlap."""
    lmax1 = max(bf.l_total for bf in basis_functions_1)
    lmax2 = max(bf.l_total for bf in basis_functions_2)

    rows_i, rows_j, a_l, b_l, coef_l, l1_l, l2_l, A_l, B_l = [], [], [], [], [], [], [], [], []
    for i, bi in enumerate(basis_functions_1):
        for j, bj in enumerate(basis_functions_2):
            for k in range(bi.num_exps):
                for l in range(bj.num_exps):
                    rows_i.append(i)
                    rows_j.append(j)
                    a_l.append(bi.exps[k])
                    b_l.append(bj.exps[l])
                    coef_l.append(bi.coefs[k] * bi.norms[k] * bj.coefs[l] * bj.norms[l])
                    l1_l.append(bi.lmn)
                    l2_l.append(bj.lmn)
                    A_l.append(bi.origin)
                    B_l.append(bj.origin)

    a = torch.tensor(a_l, dtype=_F64)
    b = torch.tensor(b_l, dtype=_F64)
    coef = torch.tensor(coef_l, dtype=_F64)
    l1 = torch.tensor(l1_l, dtype=torch.int64)
    l2 = torch.tensor(l2_l, dtype=torch.int64)
    A = torch.tensor(np.array(A_l), dtype=_F64)
    B = torch.tensor(np.array(B_l), dtype=_F64)

    p = a + b
    s = coef * PI_POW_1_5 / (p * torch.sqrt(p))
    for axis in range(3):
        E = build_E_table(lmax1, lmax2, A[:, axis] - B[:, axis], a, b)
        Etab = stack_E_table(E, lmax1, lmax2, lmax1 + lmax2)
        s = s * gather_E_scalar(Etab, l1[:, axis], l2[:, axis], 0)

    S = torch.zeros((len(basis_functions_1), len(basis_functions_2)), dtype=_F64)
    S.index_put_((torch.tensor(rows_i), torch.tensor(rows_j)), s, accumulate=True)
    return S.numpy()
