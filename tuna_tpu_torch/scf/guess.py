"""Initial SCF guesses: core Hamiltonian, superposition of atomic densities
(SAD), minimal-basis self-consistent projection, MO rotation for symmetry
breaking, and cross-basis density projection.

Twin of tuna_tpu/scf/guess.py.  The minimal-basis SCF guess is orchestrated
by the energy driver (it recurses into the energy pipeline); this module
provides the building blocks.  Tensors follow the device of the target
basis's matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import linalg
from ..ops.integrals import cross_overlap
from ..output import error, log
from . import density_matrix, diagonalise_fock

_F64 = torch.float64


def rotate_molecular_orbitals(mos, n_occ: int, theta_degrees: float):
    """Mix HOMO and LUMO by a rotation of theta degrees."""
    n = mos.shape[0]
    if n_occ < 1 or n_occ >= n:
        error("Basis set too small to rotate initial guess orbitals! "
              "Use a larger basis or the NOROTATE keyword.")
    theta = np.deg2rad(theta_degrees)
    R = torch.eye(n, dtype=_F64, device=mos.device)
    R[n_occ - 1:n_occ + 1, n_occ - 1:n_occ + 1] = torch.tensor(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], dtype=_F64)
    return mos @ R


def minimal_basis_superposition_density(atoms):
    """Block-diagonal spherically-averaged atomic densities (per spin)."""
    if len(atoms) == 1:
        return np.asarray(atoms[0].sad_density, dtype=float)
    d0 = np.asarray(atoms[0].sad_density, dtype=float)
    d1 = np.asarray(atoms[1].sad_density, dtype=float)
    n0, n1 = d0.shape[0], d1.shape[0]
    P = np.zeros((n0 + n1, n0 + n1))
    P[:n0, :n0] = d0
    P[n0:, n0:] = d1
    return P / 2.0


def project_density_matrix(P_source, S_cross, S_target_inverse, spherical_transform):
    """Project a density matrix onto a larger basis: P' = W P W^T with
    W = S_target^-1 (U S_cross), on the device of S_target_inverse."""
    device = S_target_inverse.device
    S_cross = (torch.as_tensor(spherical_transform, dtype=_F64, device=device)
               @ torch.as_tensor(S_cross, dtype=_F64, device=device))
    W = S_target_inverse @ S_cross
    return W @ torch.as_tensor(P_source, dtype=_F64, device=device) @ W.T


def natural_orbitals_of_density(P, X, S):
    """Natural orbitals (AO basis, descending occupancy) of a density matrix.

    Uses inv(X) = S @ X for X = S^-1/2."""
    X_inv = S @ X
    P_ortho = X_inv @ P @ X_inv.T
    occupancies, orbitals = linalg.eigh(P_ortho)
    return occupancies.flip(0), X @ orbitals.flip(1)


def break_density_spin_symmetry(P, X, S, n_occ: int, theta: float):
    """Mix the HONO and LUNO of a density matrix to break spin symmetry."""
    _, naturals = natural_orbitals_of_density(P, X, S)
    rotated = rotate_molecular_orbitals(naturals, n_occ, theta)
    return density_matrix(rotated, n_occ, 1)


def core_guess(H_core, X, n_alpha, n_beta, rotate: bool, theta: float):
    _, mos = diagonalise_fock(H_core, X)
    mos_alpha = rotate_molecular_orbitals(mos, n_alpha, theta) if rotate else mos
    P_a = density_matrix(mos_alpha, n_alpha, 1)
    P_b = density_matrix(mos, n_beta, 1)
    return P_a + P_b, P_a, P_b


def superposition_guess(molecule, molecule_minimal, S_inverse, S, X, rotate: bool,
                        theta: float):
    P_minimal = minimal_basis_superposition_density(molecule.atoms)
    S_cross = cross_overlap(molecule.cartesian_basis_functions,
                            molecule_minimal.cartesian_basis_functions)
    P_a = project_density_matrix(P_minimal, S_cross, S_inverse,
                                 molecule.spherical_transformation)
    P_b = P_a
    if rotate:
        P_a = break_density_spin_symmetry(P_a, X, S, molecule.n_alpha, theta)
    return P_a + P_b, P_a, P_b


def setup_initial_guess(P_guess, P_guess_alpha, P_guess_beta, E_guess, integrals,
                        X, calculation, molecule, S_inverse, silent=False):
    """Choose the guess strategy and return (E, P, P_alpha, P_beta).

    Mirrors tuna_guess.py:398-467 including the MO-read reuse policy."""
    device = integrals.S.device
    decontract_requested = calculation.decontract
    calculation.decontract = False
    try:
        rotate = (molecule.multiplicity == 1 and not calculation.no_rotate_guess
                  and calculation.reference == "UHF")

        if (calculation.reference == "RHF" and P_guess is not None
                and calculation.calculation_type != "SPE"):
            log("\n Using density matrix from previous step for guess. \n",
                calculation, 1, silent=silent)
            P_guess_alpha = P_guess_beta = torch.as_tensor(
                P_guess, dtype=_F64, device=device) / 2.0
        elif (calculation.reference == "UHF" and P_guess_alpha is not None
                and P_guess_beta is not None and calculation.calculation_type != "SPE"):
            log("\n Using density matrices from previous step for guess. \n",
                calculation, silent=silent)
            P_guess = (torch.as_tensor(P_guess_alpha, dtype=_F64, device=device)
                       + torch.as_tensor(P_guess_beta, dtype=_F64, device=device))
        elif calculation.core_guess:
            log("\n Diagonalising core Hamiltonian for guess...  ", calculation,
                end="", silent=silent)
            P_guess, P_guess_alpha, P_guess_beta = core_guess(
                integrals.H_core, X, molecule.n_alpha, molecule.n_beta,
                rotate, calculation.theta)
            log("[Done]\n", calculation, silent=silent)
        else:
            log("\n Calculating superposition of atomic densities for guess...  ",
                calculation, end="", silent=silent)
            from ..system import Molecule
            old_basis = calculation.basis
            try:
                calculation.basis = "STO-3G"
                molecule_minimal = Molecule(molecule.atomic_symbols,
                                            molecule.coordinates, calculation,
                                            do_correlation=False)
            finally:
                calculation.basis = old_basis
            P_guess, P_guess_alpha, P_guess_beta = superposition_guess(
                molecule, molecule_minimal, S_inverse, integrals.S, X, rotate,
                calculation.theta)
            log("[Done]\n", calculation, silent=silent)

        if rotate:
            log(f" Initial guess density uses molecular orbitals rotated by "
                f"{calculation.theta:.1f} degrees.\n", calculation, silent=silent)

        P_guess = torch.as_tensor(P_guess, dtype=_F64, device=device)
        E_guess = float(torch.sum(integrals.H_core * P_guess))
    finally:
        calculation.decontract = decontract_requested
    return E_guess, P_guess, P_guess_alpha, P_guess_beta
