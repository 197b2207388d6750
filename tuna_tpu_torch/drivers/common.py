"""Shared driver-level machinery: coordinate hygiene, nuclear repulsion,
orthogonalisation, dispersion corrections, electric fields and the
spherical-harmonic integral transformation.

Twin of the pieces of tuna_tpu/drivers/common.py on the single-point path.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..containers import Integrals
from ..ops import linalg
from ..ops.integrals import IntegralPlan
from ..output import error, log, timer, warning

_F64 = torch.float64


def clean_coordinates(coordinates: np.ndarray) -> np.ndarray:
    """Align the molecule exactly on the z axis (tuna_util.py:845-880)."""
    coordinates = np.asarray(coordinates, dtype=np.float64)
    if coordinates.shape == (2, 3):
        bond = float(np.linalg.norm(coordinates[1] - coordinates[0]))
        return np.array([[0.0, 0.0, 0.0], [0.0, 0.0, bond]])
    if coordinates.shape == (1, 3):
        return np.array([[0.0, 0.0, 0.0]])
    return coordinates


def calculate_nuclear_repulsion_energy(charges, coordinates, calculation, silent=False):
    log(" Calculating nuclear repulsion energy...  ", calculation, 1, end="", silent=silent)
    V_NN = float(np.prod(charges) / np.linalg.norm(coordinates[1] - coordinates[0]))
    log(f"[Done]\n\n Nuclear repulsion energy: {V_NN:.10f}\n", calculation, 1, silent=silent)
    return V_NN


def calculate_orthogonalisation_matrix(S, calculation, silent=False):
    """X = S^-1/2, smallest eigenvalue, S^-1."""
    timer("Fock orthogonalisation matrix", 0)
    log(" Constructing Fock orthogonalisation matrix... ", calculation, 1,
        end="", silent=silent)
    X, smallest, S_inverse = linalg.inverse_sqrt(S)
    smallest = float(smallest)
    if smallest < 0:
        error("A negative overlap matrix eigenvalue was found!")
    log("[Done]", calculation, 1, silent=silent)
    timer("Fock orthogonalisation matrix", 1)
    return X, smallest, S_inverse


def check_overlap_eigenvalues(smallest_S_eigenvalue, calculation, silent=False):
    log(f"\n Smallest overlap matrix eigenvalue is {smallest_S_eigenvalue:.8f}, "
        f"threshold is {calculation.S_eigenvalue_threshold:.8f}.",
        calculation, 2, silent=silent)
    if smallest_S_eigenvalue < calculation.S_eigenvalue_threshold:
        error("An overlap matrix eigenvalue is too small! Change the basis set "
              "or decrease the threshold with STHRESH.")
    elif smallest_S_eigenvalue < 10 * calculation.S_eigenvalue_threshold:
        warning(f"Smallest overlap matrix eigenvalue is close to the threshold, "
                f"at {smallest_S_eigenvalue:.8f}! \n", space=1)


def calculate_D2_dispersion_energy(molecule, calculation, silent):
    """Grimme D2 pairwise dispersion (tuna_kernel.py:984-1023)."""
    atoms = molecule.atoms
    S6 = calculation.functional.D2_S6 if calculation.DFT_calculation else 1.2
    log(f" Calculating semi-empirical dispersion energy with S6 value of "
        f"{S6:.3f}...  ", calculation, 1, end="", silent=silent)
    damping_factor = 20  # matches the ORCA HF-D2 implementation
    C6 = np.sqrt(atoms[0].C6 * atoms[1].C6)
    vdw_sum = atoms[0].vdw_radius + atoms[1].vdw_radius
    f_damp = 1 / (1 + np.exp(-damping_factor * (molecule.bond_length / vdw_sum - 1)))
    E_D2 = -S6 * C6 / molecule.bond_length**6 * f_damp
    log(f"[Done]\n\n Dispersion energy (D2): {E_D2:.10f}\n", calculation, 1, silent=silent)
    return E_D2


def calculate_additive_dispersion_energy(molecule, calculation, silent):
    if calculation.monatomic or not calculation.D2:
        return 0.0
    return calculate_D2_dispersion_energy(molecule, calculation, silent)


def apply_electric_field(D, electric_field):
    field = torch.as_tensor(electric_field, dtype=_F64, device=D.device)
    return torch.einsum("i,ijk->jk", field, D)


def apply_electric_field_gradient(Q, electric_field_gradient):
    # Reference uses components (xx, xx, yy) here (tuna_kernel.py:705);
    # replicated for output parity.
    Q_stack = torch.stack([Q[0], Q[0], Q[1]])
    gradient = torch.as_tensor(electric_field_gradient, dtype=_F64, device=Q.device)
    return torch.einsum("i,ijk->jk", gradient, Q_stack)


def _spherical_one_electron(U, S, T, V_NE, D, Q):
    return (U @ S @ U.T, U @ T @ U.T, U @ V_NE @ U.T,
            torch.einsum("mw,awx,nx->amn", U, D, U),
            torch.einsum("mw,awx,nx->amn", U, Q, U))


def _spherical_eri(U, ERI):
    for _ in range(4):
        ERI = torch.movedim(torch.tensordot(U, ERI, dims=([1], [0])), 0, 3)
    return ERI


def transform_to_spherical_harmonics(S, T, V_NE, D, Q, ERI, molecule, calculation,
                                     silent):
    """U M U^T for one-electron matrices, four tensordots for the ERI."""
    if calculation.cartesian_harmonics:
        return S, T, V_NE, D, Q, ERI
    timer("Spherical harmonic transformation", 0)
    log("\n Transforming to spherical harmonics...    ", calculation, 1, end="",
        silent=silent)
    U = torch.as_tensor(molecule.spherical_transformation, dtype=_F64, device=S.device)
    S, T, V_NE, D, Q = _spherical_one_electron(U, S, T, V_NE, D, Q)
    if ERI is not None:
        ERI = _spherical_eri(U, ERI)
    log("[Done]\n", calculation, 1, silent=silent)
    timer("Spherical harmonic transformation", 1)
    return S, T, V_NE, D, Q, ERI


# --- Integral plan cache (one plan per chemical system/basis) ---

_PLAN_CACHE: dict = {}


def get_integral_plan(molecule) -> IntegralPlan:
    key = tuple(
        (bf.lmn, bf.atom_index, tuple(bf.exps.tolist()), tuple(bf.coefs.tolist()))
        for bf in molecule.cartesian_basis_functions
    ) + (molecule.n_atoms,)
    if key not in _PLAN_CACHE:
        _PLAN_CACHE[key] = IntegralPlan(molecule.cartesian_basis_functions,
                                        molecule.n_atoms)
    return _PLAN_CACHE[key]


def calculate_analytical_integrals(molecule, calculation, silent, device) -> Integrals:
    """One- and two-electron integrals in the (spherical) AO basis, on
    `device`."""
    coords = molecule.coordinates
    if molecule.n_atoms == 2 and (np.abs(coords[:, :2]) > 1e-10).any():
        error("Molecule is incorrectly aligned! Unable to calculate molecular integrals.")

    direct = bool(getattr(calculation, "direct_scf", False))
    memory_bytes = 8 * molecule.n_cartesian_basis**4
    log(f" Memory required for two-electron integrals is "
        f"{memory_bytes / 1e9:.2f} GB\n", calculation, 3, silent=silent)
    if memory_bytes > 12e9 and not direct:
        error("Not enough memory to store two-electron integrals! "
              'Use the "DIRECT" keyword (integral-direct SCF) or a smaller '
              "basis set.")

    plan = get_integral_plan(molecule)
    coords_t = torch.as_tensor(coords, dtype=_F64, device=device).contiguous()

    log(" Calculating one-electron integrals...     ", calculation, 1, end="", silent=silent)
    timer("One-electron integrals", 0)
    S, T, V_NE, D, Q = plan.one_electron(
        coords_t, torch.as_tensor(molecule.charges, dtype=_F64, device=device),
        molecule.centre_of_mass)
    timer("One-electron integrals", 1)
    log("[Done]", calculation, 1, silent=silent)

    if direct:
        # Integral-direct SCF: J/K are contracted against the quartet values
        # as they are generated (IntegralPlan.fock_direct), so the N^4
        # tensor is never formed.
        log(" Two-electron integrals deferred (integral-direct SCF).",
            calculation, 1, silent=silent)
        ERI = None
    else:
        log(" Calculating two-electron integrals...     ", calculation, 1, end="",
            silent=silent)
        timer("Two-electron integrals", 0)
        ERI = plan.eri(coords_t)
        timer("Two-electron integrals", 1)
        log("[Done]", calculation, 1, silent=silent)

    S, T, V_NE, D, Q, ERI = transform_to_spherical_harmonics(
        S, T, V_NE, D, Q, ERI, molecule, calculation, silent)
    return Integrals(S, T, V_NE, D, Q, ERI)


def print_molecule_information(molecule, calculation, silent=False):
    n_occ, n_virt = ((molecule.n_occ, molecule.n_virt)
                     if calculation.reference == "UHF"
                     else (molecule.n_occ // 2, molecule.n_virt // 2))
    log(" ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~", calculation, 1, silent=silent)
    log("    Molecule and Basis Information", calculation, 1, silent=silent)
    log(" ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~", calculation, 1, silent=silent)
    log("  Molecular structure: " + molecule.molecular_structure, calculation, 1, silent=silent)
    log("\n  Number of basis functions: " + str(molecule.n_basis), calculation, 1, silent=silent)
    log("  Number of primitive Gaussians: " + str(int(np.sum(molecule.primitive_Gaussians))),
        calculation, 1, silent=silent)
    log("\n  Charge: " + str(molecule.charge), calculation, 1, silent=silent)
    log("  Multiplicity: " + str(molecule.multiplicity), calculation, 1, silent=silent)
    log("  Number of electrons: " + str(molecule.n_electrons), calculation, 1, silent=silent)
    log("  Number of alpha electrons: " + str(molecule.n_alpha), calculation, 1, silent=silent)
    log("  Number of beta electrons: " + str(molecule.n_beta), calculation, 1, silent=silent)
    log("  Number of occupied orbitals: " + str(n_occ), calculation, 1, silent=silent)
    log("  Number of virtual orbitals: " + str(n_virt), calculation, 1, silent=silent)
    log(f"\n  Point group: {molecule.point_group}", calculation, 1, silent=silent)
    if calculation.diatomic:
        log(f"  Bond length: {constants.bohr_to_angstrom(molecule.bond_length):.5f} ",
            calculation, 1, silent=silent)
    log(" ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~\n", calculation, 1, silent=silent)


def print_reference_type(method, calculation, silent):
    ref_type = "Kohn-Sham" if method.density_functional_method else "Hartree-Fock"
    prefix = "restricted" if calculation.reference == "RHF" else "unrestricted"
    log(f" Beginning {prefix} {ref_type} calculation...  \n", calculation, 1, silent=silent)
