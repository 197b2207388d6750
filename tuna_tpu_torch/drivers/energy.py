"""Single-point energy pipeline: molecule + integrals + guess (+ DFT grid)
-> SCF -> VV10 -> post-SCF correlation -> finite-field properties; plus
CBS extrapolation and the coordinate scan (forward, or reverse as ANHARM
walks it).

Twin of tuna_tpu/drivers/energy.py.  Every tensor lives on the `device`
the caller names; the minimal-basis guess SCF runs on the same device, with
its own grid when the calculation is DFT or VV10.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants, parallel
from ..containers import to_numpy
from ..dft import grid as dft_grid
from ..dft import make_xc_closure, unported_functional
from ..dft import vv10
from ..output import error, log, log_big_spacer, log_spacer, timer
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


def _refuse_unported(calculation):
    """Raise for a functional that the port lacks."""
    missing = unported_functional(calculation) if calculation.DFT_calculation else None
    if missing is not None:
        error(f"{missing[0].upper() + missing[1:]} is not yet ported to tuna_tpu_torch!")


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
    if (P_guess is None and getattr(calculation, "read_checkpoint", False)):
        from .. import checkpoint
        stage = checkpoint.load_stage(calculation, "scf")
        if stage is not None and stage["P"].shape[0] == int(integrals.n_basis):
            P_guess, P_guess_alpha, P_guess_beta = (
                torch.as_tensor(stage[key], dtype=_F64, device=device)
                for key in ("P", "P_alpha", "P_beta"))
            E_guess = float(stage["energy"])
            log(" Restarting SCF from checkpoint density.", calculation, 1,
                silent=silent)
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
    _refuse_unported(calculation)
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

    if getattr(calculation, "checkpoint", False):
        from .. import checkpoint
        checkpoint.save_stage(calculation, "scf", {
            "P": to_numpy(SCF_output.P), "P_alpha": to_numpy(SCF_output.P_alpha),
            "P_beta": to_numpy(SCF_output.P_beta), "energy": SCF_output.energy})

    if not do_correlation:
        return SCF_output, molecule, SCF_output.energy, SCF_output.P

    if calculation.VV10 or calculation.method.name == "B97M-V":
        E_dispersion = vv10.calculate_VV10_energy(SCF_output.P, grid_container,
                                                  calculation, silent)
    SCF_output.set_dispersion_energy(E_dispersion)

    final_energy, P = run_post_SCF_energy_calculation(
        molecule, integrals, SCF_output, grid_container, calculation, X, V_NN, silent,
        terse)

    if not calculation.extrapolate and not silent:
        from . import electric
        if calculation.dipole:
            electric.calculate_numerical_dipole_moment(
                molecule, calculation, False, atomic_symbols, coordinates, integrals,
                device=device)
        if calculation.quadrupole:
            electric.calculate_numerical_quadrupole_moment(
                molecule, calculation, False, atomic_symbols, coordinates, integrals,
                device=device)
        if calculation.polarisability:
            electric.calculate_polarisability(
                molecule, calculation, final_energy, False, atomic_symbols,
                coordinates, integrals, device=device)
        if calculation.hyperpolarisability:
            electric.calculate_hyperpolarisability(
                molecule, calculation, False, atomic_symbols, coordinates, integrals,
                device=device)

    return SCF_output, molecule, final_energy, P


def evaluate_molecular_energy(calculation, atomic_symbols, coordinates,
                              P_guess=None, P_guess_alpha=None, P_guess_beta=None,
                              E_guess=None, terse=False, silent=False,
                              do_correlation=True, integrals=None, device="cuda"):
    """Wrapper choosing plain vs basis-set-extrapolated energy."""
    if calculation.extrapolate:
        return calculate_extrapolated_energy(
            calculation, atomic_symbols, coordinates, P_guess, P_guess_alpha,
            P_guess_beta, E_guess, terse, silent, device=device)
    return calculate_energy(calculation, atomic_symbols, coordinates, P_guess,
                            P_guess_alpha, P_guess_beta, E_guess, terse, silent,
                            do_correlation, integrals, device)


def _detect_zeta(basis: str) -> str:
    b = basis.upper()
    for tag, zeta in (("DZ", "double"), ("TZ", "triple"), ("QZ", "quadruple"),
                      ("5Z", "quintuple")):
        if b.endswith(tag):
            return zeta
    if "SVP" in b:
        return "double"
    if "TZV" in b:
        return "triple"
    if b == "PC-1":
        return "double"
    if b == "PC-2":
        return "triple"
    if b == "PC-3":
        return "quadruple"
    error("Your chosen basis set is not parameterised for extrapolation!")


_NEXT_BASIS = {
    # cc family
    "CC-PVDZ": "CC-PVTZ", "CC-PVTZ": "CC-PVQZ", "CC-PVQZ": "CC-PV5Z", "CC-PV5Z": "CC-PV6Z",
    "AUG-CC-PVDZ": "AUG-CC-PVTZ", "AUG-CC-PVTZ": "AUG-CC-PVQZ",
    "AUG-CC-PVQZ": "AUG-CC-PV5Z", "AUG-CC-PV5Z": "AUG-CC-PV6Z",
    "D-AUG-CC-PVDZ": "D-AUG-CC-PVTZ", "D-AUG-CC-PVTZ": "D-AUG-CC-PVQZ",
    "D-AUG-CC-PVQZ": "D-AUG-CC-PV5Z", "D-AUG-CC-PV5Z": "D-AUG-CC-PV6Z",
    "T-AUG-CC-PVDZ": "T-AUG-CC-PVTZ", "T-AUG-CC-PVTZ": "T-AUG-CC-PVQZ",
    "T-AUG-CC-PVQZ": "T-AUG-CC-PV5Z", "T-AUG-CC-PV5Z": "T-AUG-CC-PV6Z",
    "PC-1": "PC-2", "PC-2": "PC-3", "PC-3": "PC-4",
    "DEF2-SVP": "DEF2-TZVPP", "DEF2-SVPD": "DEF2-TZVPPD",
    "DEF2-TZVP": "DEF2-QZVP", "DEF2-TZVPP": "DEF2-QZVPP",
    "DEF2-TZVPD": "DEF2-QZVPD", "DEF2-TZVPPD": "DEF2-QZVPPD",
    "ANO-PVDZ": "ANO-PVTZ", "ANO-PVTZ": "ANO-PVQZ", "ANO-PVQZ": "ANO-PV5Z",
    "AUG-ANO-PVDZ": "AUG-ANO-PVTZ", "AUG-ANO-PVTZ": "AUG-ANO-PVQZ",
    "AUG-ANO-PVQZ": "AUG-ANO-PV5Z",
}


def calculate_extrapolated_energy(calculation, atomic_symbols, coordinates,
                                  P_guess=None, P_guess_alpha=None,
                                  P_guess_beta=None, E_guess=None, terse=False,
                                  silent=False, device="cuda"):
    """Run small + large basis back-to-back and extrapolate to the CBS limit."""
    small_basis = calculation.basis.upper()
    large_basis = _NEXT_BASIS.get(small_basis)
    if large_basis is None:
        error("Your chosen basis set is not parameterised for extrapolation!")
    zeta = _detect_zeta(small_basis)

    log(f"\n Using two-point extrapolation from {small_basis} with "
        f"{large_basis}.", calculation, 1, silent=silent)

    SCF_small, molecule, E_small, _ = calculate_energy(
        calculation, atomic_symbols, coordinates, P_guess, P_guess_alpha,
        P_guess_beta, E_guess, terse=True, silent=silent, device=device)
    E_SCF_small = SCF_small.energy
    E_corr_small = E_small - E_SCF_small - SCF_small.dispersion_energy

    old_basis = calculation.basis
    calculation.basis = large_basis
    try:
        SCF_large, molecule, E_large, P = calculate_energy(
            calculation, atomic_symbols, coordinates, terse=True, silent=silent,
            device=device)
    finally:
        calculation.basis = old_basis
    E_SCF_large = SCF_large.energy
    E_corr_large = E_large - E_SCF_large - SCF_large.dispersion_energy

    E_SCF_cbs, E_corr_cbs = common.extrapolate_energies(
        small_basis, E_SCF_small, E_SCF_large, E_corr_small, E_corr_large, zeta)
    E_extrapolated = E_SCF_cbs + E_corr_cbs
    dispersion = SCF_large.dispersion_energy

    log_spacer(calculation, silent=silent, start="\n")
    log("                Basis Set Extrapolation", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log(f"  SCF energy ({small_basis}):".ljust(35) + f"{E_SCF_small:16.10f}", calculation, 1, silent=silent)
    log(f"  SCF energy ({large_basis}):".ljust(35) + f"{E_SCF_large:16.10f}", calculation, 1, silent=silent)
    if calculation.method.correlated_method:
        log("\n" + f"  Correlation energy ({small_basis}):".ljust(36) + f"{E_corr_small:15.10f}", calculation, 1, silent=silent)
        log(f"  Correlation energy ({large_basis}):".ljust(36) + f"{E_corr_large:15.10f}", calculation, 1, silent=silent)
    log(f"\n  Extrapolated SCF energy:         {E_SCF_cbs:16.10f}", calculation, 1, silent=silent)
    if calculation.method.correlated_method:
        log(f"  Extrapolated correlation energy: {E_corr_cbs:16.10f}", calculation, 1, silent=silent)
    log(f"  Extrapolated total energy:       {E_extrapolated:16.10f}", calculation, 1, silent=silent)
    if dispersion != 0:
        log(f"\n  Dispersion-corrected total energy:{E_extrapolated + dispersion:15.10f}", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    return SCF_large, molecule, E_extrapolated + dispersion, P


def _print_scan_table(calculation, silent, energies, bond_lengths):
    log_big_spacer(calculation, start="\n", space="", silent=silent)
    log("\nCoordinate scan calculation finished!\n\n Printing energy as a "
        "function of bond length...\n", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("                   Coordinate Scan", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Step         Bond Length               Energy", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    for i, (energy, bond) in enumerate(zip(energies, bond_lengths)):
        log(f" {i + 1:4.0f}            {constants.bohr_to_angstrom(bond):.5f}"
            f"             {energy:13.10f}", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)


def _plot_scan(calculation, bond_lengths, energies):
    if calculation.scan_plot:
        from .. import plotting
        plotting.generate_one_dimensional_plot(
            calculation, constants.bohr_to_angstrom(np.array(bond_lengths)),
            energies, "coordinate scan")


def scan_coordinate(calculation, atomic_symbols, starting_coordinates,
                    silent=False, reverse=False, device="cuda"):
    """Bond-length scan with MOREAD density chaining (tuna_energy.py:975-1085).
    Returns (bond lengths, energies, dipole moments: analytic, or numerical
    under DIPOLE).  `reverse` walks to shorter bonds and stops at 0.2
    angstrom, as ANHARM's left scans do."""
    from .. import props as props_mod

    timer("Coordinate scan", 0)
    coordinates = common.clean_coordinates(starting_coordinates)
    step_size = constants.angstrom_to_bohr(calculation.step)
    if reverse:
        step_size = -step_size

    bond_length = float(np.linalg.norm(coordinates[1] - coordinates[0]))
    log(f"Initialising a {calculation.number_of_steps} step coordinate scan in "
        f"{step_size:.4f} angstrom increments.", calculation, 1, silent=silent)
    log(f"Starting at a bond length of "
        f"{constants.bohr_to_angstrom(bond_length):.4f} angstroms.\n",
        calculation, 1, silent=silent)

    bond_lengths, energies, dipole_moments = [], [], []
    P_guess = P_guess_alpha = P_guess_beta = E_guess = None

    # More than one device: the scan points are independent, so the whole
    # scan runs as one batched SCF (parallel.py) instead of the serial
    # MOREAD-chained walk, which stays the fallback for an unconverged batch.
    if (parallel.device_count() > 1 and not calculation.dipole
            and parallel.mean_field_batchable(calculation, atomic_symbols)):
        bonds, bond = [], bond_length
        for _ in range(calculation.number_of_steps):
            bonds.append(bond)
            next_bond = bond + step_size
            if reverse and next_bond <= constants.angstrom_to_bohr(0.2):
                break
            bond = next_bond
        devices = parallel.devices_like(device)
        log(f"Distributing {len(bonds)} scan points over "
            f"{len(devices)} devices...", calculation, 1, silent=silent)
        batch_E, batch_conv, batch_dip = parallel.scan_points_parallel(
            calculation, atomic_symbols, bonds, devices)
        if batch_conv.all():
            bond_lengths = [float(bv) for bv in bonds]
            energies = [float(E) for E in batch_E]
            dipole_moments = [float(d) for d in batch_dip]
            _print_scan_table(calculation, silent, energies, bond_lengths)
            timer("Coordinate scan", 1)
            _plot_scan(calculation, bond_lengths, energies)
            return bond_lengths, energies, dipole_moments
        log("Sharded scan did not fully converge; falling back to the serial "
            "density-chained walk.", calculation, 1, silent=silent)

    for step in range(1, calculation.number_of_steps + 1):
        bond_length = float(np.linalg.norm(coordinates[1] - coordinates[0]))
        log_big_spacer(calculation, start="\n", space="", silent=silent)
        log(f"Starting scan step {step} of {calculation.number_of_steps} with "
            f"bond length of {constants.bohr_to_angstrom(bond_length):.5f} "
            "angstroms...", calculation, 1, silent=silent)
        log_big_spacer(calculation, space="", silent=silent)

        SCF_output, molecule, energy, _ = evaluate_molecular_energy(
            calculation, atomic_symbols, coordinates, P_guess, P_guess_alpha,
            P_guess_beta, E_guess, terse=True, silent=silent, device=device)

        if calculation.dipole:
            from . import electric
            dipole_moment = electric.calculate_numerical_dipole_moment(
                molecule, calculation, True, atomic_symbols, coordinates,
                SCF_output.integrals, device=device)
        else:
            dipole_moment, _, _ = props_mod.calculate_analytical_dipole_moment(
                molecule.centre_of_mass, molecule.charges, coordinates,
                to_numpy(SCF_output.P), to_numpy(SCF_output.integrals.D))
        dipole_moments.append(dipole_moment)

        if calculation.MO_read:
            P_guess, E_guess = SCF_output.P, energy
            P_guess_alpha, P_guess_beta = SCF_output.P_alpha, SCF_output.P_beta

        energies.append(energy)
        bond_lengths.append(bond_length)
        coordinates = np.array([coordinates[0], [0, 0, bond_length + step_size]])
        if bond_length + step_size <= constants.angstrom_to_bohr(0.2) and reverse:
            break

    _print_scan_table(calculation, silent, energies, bond_lengths)
    timer("Coordinate scan", 1)
    _plot_scan(calculation, bond_lengths, energies)
    return bond_lengths, energies, dipole_moments
