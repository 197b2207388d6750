"""Orbital-rotation response: the (A+B) matrices and the Z-vector solve.

Twin of the part of tuna_tpu/post/rpa.py that relaxed MP2 densities need:
the Z-vector equations solve (A+B) z = -L with the orbital Hessian's (A+B)
block, built from the chemists' MO tensor (restricted, singlet channel)
or the response-scaled physicists' spin-orbital tensor (unrestricted).
The XC kernel of a Kohn-Sham reference, the triplet channel and the
excitation and stability solvers are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import linalg


def _as_ov_matrix(M4):
    """(i, a, j, b) tensor -> symmetric (ia, jb) matrix."""
    n_ov = M4.shape[0] * M4.shape[1]
    M = M4.reshape(n_ov, n_ov)
    return 0.5 * (M + M.T)


def orbital_gap_diagonal(epsilons, o, v):
    """Flattened diagonal of the zeroth-order excitation operator."""
    return (epsilons[v][None, :] - epsilons[o][:, None]).reshape(-1)


def restricted_apb(g, epsilons, o, v, hfx):
    """(A+B) for the singlet channel of a closed-shell Hartree-Fock
    reference (tuna_tpu's `restricted_apb` without an XC kernel):

    (A+B)_{ia,jb} = delta (e_a - e_i) + 4 (ia|jb) - c_x [(ij|ab) + (ib|ja)]
    """
    M4 = 4.0 * g[o, v, o, v] - hfx * (g[o, o, v, v].permute(0, 2, 1, 3)
                                      + g[o, v, o, v].permute(0, 3, 2, 1))
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


def spin_orbital_apb(g_scaled, epsilons, o, v):
    """(A+B) on a spin-orbital reference from g~ = <pq|rs> - c_x <pq|sr>:
    A_{ia,jb} = <aj|ib>~, B_{ia,jb} = <ab|ij>~."""
    g = g_scaled
    M4 = g[v, o, o, v].permute(2, 0, 1, 3) + g[v, v, o, o].permute(2, 0, 3, 1)
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


def zvector_solve(apb, lagrangian_ov):
    """Orbital response z from (A+B) z = -L."""
    z, _ = linalg.solve_symmetric(apb, -lagrangian_ov.reshape(-1))
    return z.reshape(lagrangian_ov.shape)
