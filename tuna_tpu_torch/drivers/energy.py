"""Single-point energy pipeline: molecule + integrals + guess (+ DFT grid)
-> SCF -> VV10 -> post-SCF correlation.

Twin of the single-point path of tuna_tpu/drivers/energy.py.  Every tensor
lives on the `device` the caller names; the minimal-basis guess SCF runs on
the same device, with its own grid when the calculation is DFT or VV10.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dft import make_xc_closure, unported_functional
from ..dft import grid as dft_grid
from ..dft import vv10
from ..output import error, log, timer
from ..scf import clean_density_matrix, run_self_consistent_field
from ..scf import guess as guess_mod
from ..system import Molecule
from . import common
from .post_scf import run_post_SCF_energy_calculation

_F64 = torch.float64

# Methods the DIRECT keyword serves (tuna_tpu/drivers/energy.py:184-205):
# mean-field SCF contracts J/K during the sweep, correlated methods get
# their MO integrals transform-direct from the packed pair matrix
# (spatial-orbital for RHF, spin-orbital for UHF references).  Methods that
# consume the AO tensor every iteration, and the spin-orbital MPn
# densities, need the stored tensor.
_DIRECT_OK = {
    "HF", "UHF", "RHF", "MP2", "SCS-MP2", "MP3", "SCS-MP3", "MP4",
    "CID", "CISD", "CCD", "CEPA", "CEPA0", "CEPA[0]", "CEPA(0)",
    "LCCD", "LCCSD", "QCISD", "QCISD[T]", "QCISD(T)",
    "CCSD", "CCSD[T]", "CCSD(T)",
}
_MPN_NAMES = {"MP2", "SCS-MP2", "MP3", "SCS-MP3", "MP4"}
_DIRECT_OK_UHF = _DIRECT_OK - _MPN_NAMES - {"RHF"}


def _direct_fock_closure(calculation, molecule, device):
    """The integral-direct P -> (J, K) closure under the DIRECT keyword,
    else None; raises for what DIRECT does not serve, with tuna_tpu's
    texts."""
    if not getattr(calculation, "direct_scf", False):
        return None
    name = calculation.method.name
    if (calculation.DFT_calculation or name not in _DIRECT_OK
            or (calculation.reference != "RHF" and name not in _DIRECT_OK_UHF)):
        error('The "DIRECT" (integral-direct) keyword supports mean-field '
              "HF/UHF and correlated MPn/CI/CC families (restricted, plus "
              "the UHF-reference CC/CI set); DFT, spin-orbital MPn "
              "densities and AO-tensor-iterating methods (CC2/CC3/"
              "CCSDT+/OMP2/LMP2) need the stored two-electron tensor.")
    if calculation.stability_analysis or calculation.time_dependent:
        error("Stability analysis and excited states need the stored "
              'two-electron tensor; remove the "DIRECT" keyword.')
    closure = common.get_integral_plan(molecule).fock_closure(
        None if calculation.cartesian_harmonics else molecule.spherical_transformation)
    coords = torch.as_tensor(molecule.coordinates, dtype=_F64, device=device)
    return lambda P: closure(coords, P)


def _refuse_unported(calculation, do_correlation):
    """Raise for the options of this pipeline that the port lacks so far."""
    dft = calculation.DFT_calculation
    missing_functional = unported_functional(calculation) if dft else None
    unported = [
        (dft and calculation.method.unrestricted, "unrestricted Kohn-Sham"),
        (dft and calculation.MPC_prop != 0, "double-hybrid functionals (they need MP2)"),
        (missing_functional is not None, missing_functional or ""),
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

    # DFT integration grid
    if calculation.DFT_calculation or calculation.VV10:
        grid_container = dft_grid.set_up_integration_grid(
            molecule, P_guess_alpha, P_guess_beta, calculation, silent, device)
    else:
        grid_container = (None, None, None, None)

    return molecule, integrals, guess_container, grid_container, X, V_NN, E_dispersion


def calculate_energy(calculation, atomic_symbols, coordinates, P_guess=None,
                     P_guess_alpha=None, P_guess_beta=None, E_guess=None,
                     terse=False, silent=False, do_correlation=True, integrals=None,
                     device="cuda"):
    """The single-point pipeline (reference: tuna_energy.py:875-964)."""
    _refuse_unported(calculation, do_correlation)
    device = torch.device(device)
    guess_container = (P_guess, P_guess_alpha, P_guess_beta, E_guess)
    coordinates = common.clean_coordinates(coordinates)

    (molecule, integrals, guess_container, grid_container, X, V_NN,
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

    xc_closure = (make_xc_closure(calculation, grid_container)
                  if calculation.DFT_calculation else None)
    fock_closure = _direct_fock_closure(calculation, molecule, device)

    SCF_output = run_self_consistent_field(
        molecule, calculation, integrals, V_NN, X, guess_container, silent,
        xc_closure=xc_closure, fock_closure=fock_closure)

    if not do_correlation:
        return SCF_output, molecule, SCF_output.energy, SCF_output.P

    if calculation.VV10 or calculation.method.name == "B97M-V":
        E_dispersion = vv10.calculate_VV10_energy(SCF_output.P, grid_container,
                                                  calculation, silent)
    SCF_output.set_dispersion_energy(E_dispersion)

    final_energy, P = run_post_SCF_energy_calculation(
        molecule, integrals, SCF_output, grid_container, calculation, X, V_NN, silent,
        terse)
    return SCF_output, molecule, final_energy, P


def evaluate_molecular_energy(calculation, atomic_symbols, coordinates,
                              P_guess=None, P_guess_alpha=None, P_guess_beta=None,
                              E_guess=None, terse=False, silent=False,
                              do_correlation=True, integrals=None, device="cuda"):
    """Single-point energy (basis-set extrapolation is not ported yet)."""
    return calculate_energy(calculation, atomic_symbols, coordinates, P_guess,
                            P_guess_alpha, P_guess_beta, E_guess, terse, silent,
                            do_correlation, integrals, device)
