"""Transform-direct AO -> MO two-electron integrals from the packed pair
matrix, never materialising the dense N^4 AO tensor.

Twin of tuna_tpu/ops/motransform.py without its mesh-sharded variant.  The
integral sweep produces the packed pair matrix G_pair[(ij), (kl)] = (ij|kl)
of shape (n_pairs, n_pairs); two half-transforms take it to the packed MO
pair matrix:

  phase 1:  H[(ij), (pq)] = sum_{kl} W[k,p] W[l,q] (ij|kl)
  phase 2:  G[(pq), (rs)] = sum_{ij} W[i,r] W[j,s] H[(ij), (pq)]

with W the Cartesian AO -> MO coefficients and (pq) packed over p >= q.
Each half-transform is the K5 kernel (csrc/mo_transform.cu) on a CUDA
tensor, which reads phase 2's input transposed in place, and the plain
version (a gather and two einsums over chunks of rows) on a CPU tensor.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels

_F64 = torch.float64
# What K5 runs with (csrc/mo_transform.cu): its warps and the n-tiles of
# one warp job.
_WARPS = 16
_MAX_TILES = 6


def mo_pair_indices(n_mo: int):
    """(rows, cols) of the packed MO pair ordering p >= q."""
    return np.tril_indices(n_mo)


def mo_pair_index_matrix(n_mo: int) -> np.ndarray:
    """Symmetric (n_mo, n_mo) -> packed index lookup."""
    idx = np.zeros((n_mo, n_mo), dtype=np.int64)
    rows, cols = np.tril_indices(n_mo)
    idx[rows, cols] = idx[cols, rows] = np.arange(len(rows))
    return idx


def _half_transform_plain(M_rows, pair_index, W, tri):
    """One half-transform: (rows, n_ao_pairs) -> (rows, n_mo_pairs).

    Expands each packed row to its dense symmetric (N, N) matrix by gather,
    applies the W sandwich, and re-packs the (symmetric) MO pair axis."""
    dense = M_rows[:, pair_index]                      # (rows, N, N)
    t = torch.einsum("rkl,kp->rpl", dense, W)
    t = torch.einsum("rpl,lq->rpq", t, W)
    return t[:, tri[0], tri[1]]


def _chunked_half_transform(M, pair_index, W, tri, row_chunk):
    """Half-transform all rows of M, a chunk of rows at a time, so the dense
    (chunk, N, N) workspace stays bounded."""
    return torch.cat([_half_transform_plain(M[start:start + row_chunk], pair_index, W, tri)
                      for start in range(0, M.shape[0], row_chunk)])


def half_transform(M, pair_index, W, transposed: bool = False, row_chunk: int = 128):
    """out[r, (pq)] = sum_kl W[k,p] W[l,q] A[r, pair_index[k,l]] over p >= q,
    with A = M, or M^T when `transposed`: the K5 kernel on a CUDA tensor,
    the plain version in chunks of `row_chunk` rows on a CPU tensor."""
    if M.device.type == "cpu":
        tri = mo_pair_indices(W.shape[1])
        return _chunked_half_transform(M.T if transposed else M, pair_index, W, tri, row_chunk)
    if M.device.type == "cuda":
        return _half_transform_kernel(M, pair_index, W, transposed)
    raise ValueError(f"no half-transform for device {M.device}")


class HalfTransformLayout(NamedTuple):
    """K5's use of shared memory for N AOs and n_mo MOs: `staged` holds
    W^T, D_r and T^T whole and stages `run` rows at a time; otherwise D_r
    comes in panels of `panel` rows (panel = the padded N when staged)."""
    staged: bool
    run: int
    panel: int
    shared_bytes: int


def half_transform_layout(N: int, n_mo: int) -> HalfTransformLayout:
    """The largest run of rows (4, 2 or 1) whose staging fits beside W^T,
    D_r and T^T; else the widest panel of D_r rows that divides the padded
    N and fits beside T^T's panel (csrc/mo_transform.cu sizes the same
    arrays)."""
    np8, mq = -(-N // 8) * 8, -(-n_mo // 16) * 16
    ld, n_pairs = np8 + 4, N * (N + 1) // 2
    for run in (4, 2, 1):
        shared = 8 * (2 * mq * ld + np8 * ld + run * n_pairs)
        if shared <= _kernels.SHARED_MEMORY_A_BLOCK:
            return HalfTransformLayout(True, run, np8, shared)
    for panel in range(np8, 7, -8):
        shared = 8 * (panel * ld + mq * (panel + 4))
        if np8 % panel == 0 and shared <= _kernels.SHARED_MEMORY_A_BLOCK:
            return HalfTransformLayout(False, 1, panel, shared)
    raise ValueError(f"half-transform: N = {N} and n_mo = {n_mo} leave no panel that fits "
                     f"{_kernels.SHARED_MEMORY_A_BLOCK} bytes of shared memory")


def _warp_jobs(tiles_per_row) -> list[int]:
    """Warp jobs over m-tiles i with tiles_per_row[i] n-tiles each: runs of
    at most _MAX_TILES consecutive n-tiles, as even as the warps allow, the
    longest first; coded i | first n-tile << 10 | n-tiles << 20."""
    size = max(1, min(_MAX_TILES, -(-sum(tiles_per_row) // _WARPS)))
    jobs = []
    for i, count in enumerate(tiles_per_row):
        parts = -(-count // size)
        bounds = [part * count // parts for part in range(parts + 1)]
        jobs += [i | lo << 10 | (hi - lo) << 20 for lo, hi in zip(bounds, bounds[1:])]
    return sorted(jobs, key=lambda code: -(code >> 20))


@functools.lru_cache(maxsize=None)
def tile_table(n_mo: int, panel: int) -> tuple[np.ndarray, int, int]:
    """K5's table for n_mo MOs and a panel of `panel` AO rows: the warp
    jobs of T^T = W^T D (every 16 x 8 tile of (q, k in the panel)), then of
    out = W^T T (the 16 x 8 tiles of (p, q) that touch p >= q), then p (p +
    1) / 2 for each p, the packed offset of row p.  Returns (table int32,
    jobs of the first product, jobs of the second)."""
    m_tiles = -(-n_mo // 16)
    left = _warp_jobs([panel // 8] * m_tiles)
    right = _warp_jobs([min(16 * i + 15, n_mo - 1) // 8 + 1 for i in range(m_tiles)])
    p = np.arange(n_mo)
    table = np.concatenate([np.asarray(left + right, dtype=np.int64), p * (p + 1) // 2])
    return table.astype(np.int32), len(left), len(right)


_device_tables: dict = {}
_pair_kl: dict = {}   # id(pair_index) -> (a weak reference to it, its inverse)


def pair_kl(pair_index) -> torch.Tensor:
    """The inverse of pair_index (symmetric, a bijection from k >= l onto
    the packed pairs): k | l << 16 for each packed AO pair, int32 on
    pair_index's device, computed once per pair_index tensor."""
    entry = _pair_kl.get(id(pair_index))
    if entry is None or entry[0]() is not pair_index:
        N = pair_index.shape[0]
        k, l = torch.tril_indices(N, N, device=pair_index.device)
        kl = torch.empty(N * (N + 1) // 2, dtype=torch.int32, device=pair_index.device)
        kl[pair_index[k, l]] = (k | l << 16).to(torch.int32)
        entry = _pair_kl[id(pair_index)] = (weakref.ref(pair_index), kl)
        weakref.finalize(pair_index, _pair_kl.pop, id(pair_index), None)
    return entry[1]


def _half_transform_kernel(M, pair_index, W, transposed):
    device = M.device
    N, n_mo = W.shape
    n_ao_pairs = N * (N + 1) // 2
    n_rows = M.shape[1] if transposed else M.shape[0]
    stored = (n_ao_pairs, n_rows) if transposed else (n_rows, n_ao_pairs)
    _kernels.check_tensor("M", M, stored, _F64, device)
    _kernels.check_tensor("W", W, (N, n_mo), _F64, device)
    _kernels.check_tensor("pair_index", pair_index, (N, N), pair_index.dtype, device)
    layout = half_transform_layout(N, n_mo)
    key = (n_mo, layout.panel, device)
    if key not in _device_tables:
        table, n_left, n_right = tile_table(n_mo, layout.panel)
        _device_tables[key] = (torch.as_tensor(table, device=device), n_left, n_right)
    table, n_left, n_right = _device_tables[key]
    kl = pair_kl(pair_index)
    out = torch.empty((n_rows, n_mo * (n_mo + 1) // 2), dtype=_F64, device=device)
    row_stride, col_stride = (1, n_rows) if transposed else (n_ao_pairs, 1)
    _kernels.launch("mo_half_transform", "tuna_mo_half_transform", device,
                    n_rows, N, n_mo, int(layout.staged), layout.run, layout.panel, n_left,
                    n_right, row_stride, col_stride, M.data_ptr(), kl.data_ptr(),
                    W.data_ptr(), table.data_ptr(), out.data_ptr())
    return out


def pair_packed_to_mo(G_pair, pair_index, W, n_mo: int, row_chunk: int = 128):
    """Packed AO pair matrix -> packed MO pair matrix (chemists' notation).

    G_pair: (n_ao_pairs, n_ao_pairs) packed (ij|kl); pair_index: (N, N)
    integer tensor mapping dense (i, j) to the packed index; W: (N, n_mo)
    Cartesian AO -> MO coefficients.  Returns the (n_mo_pairs, n_mo_pairs)
    packed (pq|rs), both axes in the order of mo_pair_indices(n_mo)."""
    if W.shape[1] != n_mo:
        raise ValueError(f"W has {W.shape[1]} columns, expected n_mo = {n_mo}")
    H = half_transform(G_pair, pair_index, W, row_chunk=row_chunk)
    # phase 2 transforms the remaining AO pair axis: the rows of H^T
    return half_transform(H, pair_index, W, transposed=True, row_chunk=row_chunk)


def pair_packed_to_mo_mixed(G_pair, pair_index, W_left, W_right, n_mo: int,
                            row_chunk: int = 128):
    """Mixed-coefficient transform: the left pair gets W_left, the right
    W_right; element ((rs), (pq)) of the result is (r_left s_left |
    p_right q_right).  Serves the UHF-reference integral-direct path."""
    if W_left.shape[1] != n_mo or W_right.shape[1] != n_mo:
        raise ValueError(f"W_left and W_right need n_mo = {n_mo} columns")
    H = half_transform(G_pair, pair_index, W_right, row_chunk=row_chunk)
    # The second half-transform, over H's untouched AO pair axis, leaves
    # the right pairs on its row axis; transpose so the left pairs lead.
    return half_transform(H, pair_index, W_left, transposed=True, row_chunk=row_chunk).T


def expand_mo_chemists(G_mo, n_mo: int):
    """Packed MO pair matrix -> dense chemists' (pq|rs) tensor."""
    midx = torch.as_tensor(mo_pair_index_matrix(n_mo), device=G_mo.device)
    return G_mo[midx[:, :, None, None], midx[None, None, :, :]]
