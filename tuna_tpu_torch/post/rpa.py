"""Orbital-rotation linear response: the (A+B), (A-B) and A matrices, the
excitation and stability eigensolves, and the Z-vector solve.

Twin of tuna_tpu/post/rpa.py.  Excited states (TDHF/TDA/TD-DFT), SCF
stability and the Z-vector equations of relaxed MP2 densities all read the
combinations (A+B) and (A-B) of the orbital-rotation blocks:

  * excitations: the Casida problem [[A,B],[-B,-A]] of a real reference
    folds into the symmetric product eigenproblem
        (A-B)^1/2 (A+B) (A-B)^1/2  T = w^2 T,
    two symmetric eigensolves (ops.linalg.eigh, the polished eigh);
  * stability: the orbital Hessian [[A,B],[B,A]] is orthogonally
    equivalent to diag(A+B, A-B), so its spectrum is eig(A+B) u eig(A-B);
  * Z-vector: solves (A+B) z = -L.

Every block is built from the chemists' MO tensor (pq|rs) (restricted) or
the response-scaled physicists' spin-orbital tensor (unrestricted).  For
the HF and local TD-DFT kernels served here (A-B) is the same matrix for
the singlet and triplet channels (the Coulomb and f_xc parts couple only
X+Y), so one build serves both.
"""

from __future__ import annotations

import torch

from ..ops import linalg

# (A-B) eigenvalues below this are treated as an unstable reference
INSTABILITY_FLOOR = 1e-12


def _as_ov_matrix(M4):
    """(i, a, j, b) tensor -> symmetric (ia, jb) matrix."""
    n_ov = M4.shape[0] * M4.shape[1]
    M = M4.reshape(n_ov, n_ov)
    return 0.5 * (M + M.T)


def orbital_gap_diagonal(epsilons, o, v):
    """Flattened diagonal of the zeroth-order excitation operator."""
    return (epsilons[v][None, :] - epsilons[o][:, None]).reshape(-1)


# ---------------------------------------------------------------------------
# Closed-shell (spin-adapted) blocks, chemists' notation
# ---------------------------------------------------------------------------

def restricted_apb(g, epsilons, o, v, hfx, channel="singlet", K_XC=None):
    """(A+B) for one spin channel of a closed-shell reference.

    (A+B)_{ia,jb} = delta (e_a - e_i)
                    + 4 (ia|jb) [singlet only]
                    - c_x [ (ij|ab) + (ib|ja) ]
                    + 2 K_XC
    """
    x_pair = g[o, o, v, v].permute(0, 2, 1, 3) + g[o, v, o, v].permute(0, 3, 2, 1)
    M4 = -hfx * x_pair
    if channel == "singlet":
        M4 = M4 + 4.0 * g[o, v, o, v]
    if K_XC is not None:
        M4 = M4 + 2.0 * K_XC
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


def restricted_amb(g, epsilons, o, v, hfx):
    """(A-B), identical for singlet and triplet channels:

    (A-B)_{ia,jb} = delta (e_a - e_i) - c_x [ (ij|ab) - (ib|ja) ]
    """
    M4 = -hfx * (g[o, o, v, v].permute(0, 2, 1, 3) - g[o, v, o, v].permute(0, 3, 2, 1))
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


def restricted_tda_matrix(g, epsilons, o, v, hfx, channel="singlet", K_XC=None):
    """The bare excitation block A = ((A+B) + (A-B)) / 2, built directly."""
    M4 = -hfx * g[o, o, v, v].permute(0, 2, 1, 3)
    if channel == "singlet":
        M4 = M4 + 2.0 * g[o, v, o, v]
    if K_XC is not None:
        M4 = M4 + K_XC
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


# ---------------------------------------------------------------------------
# Spin-orbital blocks (unrestricted references)
# ---------------------------------------------------------------------------
# Take the response-scaled physicists' tensor  g~ = <pq|rs> - c_x <pq|sr>
# (antisymmetrised at c_x = 1), as produced by the spin-orbital transform.

def spin_orbital_apb(g_scaled, epsilons, o, v, K_XC=None):
    """A_{ia,jb} = <aj|ib>~, B_{ia,jb} = <ab|ij>~ (+ 2 K_XC)."""
    g = g_scaled
    M4 = g[v, o, o, v].permute(2, 0, 1, 3) + g[v, v, o, o].permute(2, 0, 3, 1)
    if K_XC is not None:
        M4 = M4 + 2.0 * K_XC
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


def spin_orbital_amb(g_scaled, epsilons, o, v):
    g = g_scaled
    M4 = g[v, o, o, v].permute(2, 0, 1, 3) - g[v, v, o, o].permute(2, 0, 3, 1)
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


def spin_orbital_tda_matrix(g_scaled, epsilons, o, v, K_XC=None):
    M4 = g_scaled[v, o, o, v].permute(2, 0, 1, 3)
    if K_XC is not None:
        M4 = M4 + K_XC
    return _as_ov_matrix(M4) + torch.diag(orbital_gap_diagonal(epsilons, o, v))


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

def tda_excitations(A):
    """Symmetric (CIS / TDA) eigenproblem; ascending energies."""
    return linalg.eigh(A)


def rpa_excitations(apb, amb):
    """Full-response (TDHF/TD-DFT) excitations by the symmetric product form.

    Returns (energies, vectors, amb_min, w2_min) where vectors stacks
    [X; Y] column-wise with the X^2 - Y^2 = 1 metric built in:
        X+Y = (A-B)^{1/2} T / sqrt(w),   X-Y = (A-B)^{-1/2} T sqrt(w).
    amb_min < 0 or w2_min < 0 signals an unstable reference (where the
    non-Hermitian problem has imaginary roots); the affected states carry
    clamped (meaningless) energies and should be dropped by the caller.
    """
    s, U = linalg.eigh(amb)
    root = torch.sqrt(torch.clamp(s, min=INSTABILITY_FLOOR))
    half = (U * root) @ U.T
    half_inv = (U * (1.0 / root)) @ U.T

    M = half @ apb @ half
    w2, T = linalg.eigh(0.5 * (M + M.T))
    w = torch.sqrt(torch.clamp(w2, min=INSTABILITY_FLOOR))

    XpY = (half @ T) / torch.sqrt(w)[None, :]
    XmY = (half_inv @ T) * torch.sqrt(w)[None, :]
    vectors = torch.cat([0.5 * (XpY + XmY), 0.5 * (XpY - XmY)], dim=0)
    return w, vectors, torch.min(s), torch.min(w2)


def orbital_hessian_lowest(apb, amb):
    """Lowest eigenvalue of the stability Hessian [[A,B],[B,A]].

    The orthogonal rotation (u, v) -> ((u+v)/sqrt2, (u-v)/sqrt2) block-
    diagonalises the Hessian into (A+B) direct-sum (A-B), so the full 2n x 2n
    eigenproblem never needs to be formed.
    """
    return torch.minimum(torch.min(torch.linalg.eigvalsh(apb)),
                         torch.min(torch.linalg.eigvalsh(amb)))


def zvector_solve(apb, lagrangian_ov):
    """Orbital response z from (A+B) z = -L."""
    z, _ = linalg.solve_symmetric(apb, -lagrangian_ov.reshape(-1))
    return z.reshape(lagrangian_ov.shape)
