"""Single-point energy pipeline: molecule + integrals + guess -> SCF ->
post-SCF correlation.

Twin of the single-point path of tuna_tpu/drivers/energy.py.  Every tensor
lives on the `device` the caller names; the minimal-basis guess SCF runs on
the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..output import error, log, timer
from ..scf import clean_density_matrix, run_self_consistent_field
from ..scf import guess as guess_mod
from ..system import Molecule
from . import common
from .post_scf import run_post_SCF_energy_calculation

_F64 = torch.float64


def _refuse_unported(calculation, do_correlation):
    """Raise for the options of this pipeline that the port lacks so far."""
    unported = [
        (calculation.DFT_calculation or calculation.VV10, "density functional theory"),
        (getattr(calculation, "direct_scf", False), 'the "DIRECT" keyword'),
        (getattr(calculation, "read_checkpoint", False)
         or getattr(calculation, "checkpoint", False), "checkpoints"),
        (calculation.extrapolate, "basis-set extrapolation"),
    ]
    if do_correlation:
        unported.append((calculation.dipole or calculation.quadrupole
                         or calculation.polarisability or calculation.hyperpolarisability,
                         "numerical electric properties"))
    for requested, what in unported:
        if requested:
            error(f"{what[0].upper() + what[1:]} is not yet ported to tuna_tpu_torch!")


def enforce_density_matrix_trace(P_alpha, P_beta, S, n_alpha, n_beta):
    P_alpha = clean_density_matrix(torch.as_tensor(P_alpha, dtype=_F64, device=S.device),
                                   S, n_alpha)
    P_beta = clean_density_matrix(torch.as_tensor(P_beta, dtype=_F64, device=S.device),
                                  S, n_beta)
    return P_alpha + P_beta, P_alpha, P_beta


def calculate_self_consistent_guess(calculation, atomic_symbols, coordinates,
                                    molecule, S_inverse, device, silent=False):
    """Minimal-basis SCF, projected onto the target basis (the default guess)."""
    timer("Initial guess", 0)
    log("\n Calculating self-consistent density for guess...  ", calculation,
        end="", silent=silent)

    old_basis = calculation.basis
    calculation.basis = "STO-3G"
    try:
        SCF_output, molecule_minimal, guess_energy, _ = calculate_energy(
            calculation, atomic_symbols, coordinates, terse=True,
            silent=True, do_correlation=False, device=device)
    finally:
        calculation.basis = old_basis

    from ..ops.integrals import cross_overlap
    S_cross = cross_overlap(molecule.cartesian_basis_functions,
                            molecule_minimal.cartesian_basis_functions)

    P_a = guess_mod.project_density_matrix(
        SCF_output.P_alpha, S_cross, S_inverse, molecule.spherical_transformation)
    P_b = guess_mod.project_density_matrix(
        SCF_output.P_beta, S_cross, S_inverse, molecule.spherical_transformation)

    log("[Done]", calculation, silent=silent)
    timer("Initial guess", 1)
    return P_a + P_b, P_a, P_b, guess_energy


def build_molecule_and_integrals(calculation, atomic_symbols, coordinates, silent,
                                 guess_container, do_correlation, device, integrals=None):
    log("\n Setting up molecule...     ", calculation, 1, silent=silent, end="")
    molecule = Molecule(atomic_symbols, coordinates, calculation,
                        do_correlation=do_correlation)
    log("[Done]\n", calculation, 1, silent=silent)

    if integrals is None:
        integrals = common.calculate_analytical_integrals(molecule, calculation, silent,
                                                          device)

    molecule.process_basis_functions(calculation, int(integrals.n_basis))
    common.print_molecule_information(molecule, calculation, silent)
    common.print_reference_type(calculation.method, calculation, silent)

    V_NN = (common.calculate_nuclear_repulsion_energy(
        molecule.charges, coordinates, calculation, silent)
        if calculation.diatomic else 0.0)
    E_dispersion = common.calculate_additive_dispersion_energy(molecule, calculation, silent)

    X, smallest_S_eigenvalue, S_inverse = common.calculate_orthogonalisation_matrix(
        integrals.S, calculation, silent)
    common.check_overlap_eigenvalues(smallest_S_eigenvalue, calculation, silent=silent)

    P_guess, P_guess_alpha, P_guess_beta, E_guess = guess_container
    if (calculation.self_consistent_guess and do_correlation and P_guess is None
            and P_guess_alpha is None and P_guess_beta is None):
        P_guess, P_guess_alpha, P_guess_beta, E_guess = calculate_self_consistent_guess(
            calculation, atomic_symbols, coordinates, molecule, S_inverse, device,
            silent=silent)

    E_guess, P_guess, P_guess_alpha, P_guess_beta = guess_mod.setup_initial_guess(
        P_guess, P_guess_alpha, P_guess_beta, E_guess, integrals, X, calculation,
        molecule, S_inverse, silent=silent)

    P_guess, P_guess_alpha, P_guess_beta = enforce_density_matrix_trace(
        P_guess_alpha, P_guess_beta, integrals.S, molecule.n_alpha, molecule.n_beta)
    guess_container = (P_guess, P_guess_alpha, P_guess_beta, E_guess)
    return molecule, integrals, guess_container, X, V_NN, E_dispersion


def calculate_energy(calculation, atomic_symbols, coordinates, P_guess=None,
                     P_guess_alpha=None, P_guess_beta=None, E_guess=None,
                     terse=False, silent=False, do_correlation=True, integrals=None,
                     device="cuda"):
    """The single-point pipeline (reference: tuna_energy.py:875-964)."""
    _refuse_unported(calculation, do_correlation)
    device = torch.device(device)
    guess_container = (P_guess, P_guess_alpha, P_guess_beta, E_guess)
    coordinates = common.clean_coordinates(coordinates)

    (molecule, integrals, guess_container, X, V_NN,
     E_dispersion) = build_molecule_and_integrals(
        calculation, atomic_symbols, coordinates, silent, guess_container,
        do_correlation, device, integrals=integrals)

    integrals.F = (common.apply_electric_field(integrals.D, calculation.electric_field)
                   if np.linalg.norm(calculation.electric_field) > 0
                   else torch.zeros_like(integrals.S))
    integrals.G = (common.apply_electric_field_gradient(integrals.Q,
                                                        calculation.electric_field_gradient)
                   if np.linalg.norm(calculation.electric_field_gradient) > 0
                   else torch.zeros_like(integrals.S))

    SCF_output = run_self_consistent_field(
        molecule, calculation, integrals, V_NN, X, guess_container, silent)

    if not do_correlation:
        return SCF_output, molecule, SCF_output.energy, SCF_output.P

    SCF_output.set_dispersion_energy(E_dispersion)

    final_energy, P = run_post_SCF_energy_calculation(
        molecule, integrals, SCF_output, calculation, X, V_NN, silent, terse)
    return SCF_output, molecule, final_energy, P


def evaluate_molecular_energy(calculation, atomic_symbols, coordinates,
                              P_guess=None, P_guess_alpha=None, P_guess_beta=None,
                              E_guess=None, terse=False, silent=False,
                              do_correlation=True, integrals=None, device="cuda"):
    """Single-point energy (basis-set extrapolation is not ported yet)."""
    return calculate_energy(calculation, atomic_symbols, coordinates, P_guess,
                            P_guess_alpha, P_guess_beta, E_guess, terse, silent,
                            do_correlation, integrals, device)
