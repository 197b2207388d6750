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

import numpy as np
import torch

from .. import _kernels

_F64 = torch.float64
# Dynamic shared memory one block of K5 takes: two blocks fit on an SM.
_PANEL_BYTES = 110 * 1024


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


def _half_transform_kernel(M, pair_index, W, transposed):
    device = M.device
    N, n_mo = W.shape
    n_ao_pairs = N * (N + 1) // 2
    n_rows = M.shape[1] if transposed else M.shape[0]
    stored = (n_ao_pairs, n_rows) if transposed else (n_rows, n_ao_pairs)
    _kernels.check_tensor("M", M, stored, _F64, device)
    _kernels.check_tensor("W", W, (N, n_mo), _F64, device)
    _kernels.check_tensor("pair_index", pair_index, (N, N), pair_index.dtype, device)
    panel = min(N, _PANEL_BYTES // (8 * (N + n_mo)))
    if panel < 1:
        raise ValueError(f"half-transform: N = {N} and n_mo = {n_mo} leave no panel of "
                         f"{_PANEL_BYTES} bytes")
    index32 = pair_index.to(torch.int32).contiguous()
    out = torch.empty((n_rows, n_mo * (n_mo + 1) // 2), dtype=_F64, device=device)
    row_stride, col_stride = (1, n_rows) if transposed else (n_ao_pairs, 1)
    _kernels.launch("mo_half_transform", "tuna_mo_half_transform", device,
                    n_rows, N, n_mo, panel, row_stride, col_stride, M.data_ptr(),
                    index32.data_ptr(), W.data_ptr(), out.data_ptr())
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
