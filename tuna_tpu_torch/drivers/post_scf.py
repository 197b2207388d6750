"""Post-SCF dispatcher: spin contamination of an unrestricted reference,
energy components, the integrated density of a Kohn-Sham run, coupled
cluster, energy summation and property printing.

Twin of the Hartree-Fock, restricted Kohn-Sham and coupled-cluster branches
of tuna_tpu/drivers/post_scf.py (reference: tuna_kernel.py:1076-1323).  The host-side printing code (`props.py`, numpy)
receives host copies of the device tensors.
"""

from __future__ import annotations

from .. import props
from ..containers import to_numpy
from ..dft import grid as dft_grid
from ..output import error, log


def _print_scf_energy(final_energy, reference, method, calculation, silent):
    space = " " * max(0, 8 - len(method.name))
    if reference == "RHF" and not calculation.DFT_calculation:
        log("\n Restricted Hartree-Fock energy:   " + f"{final_energy:16.10f}",
            calculation, 1, silent=silent)
    elif reference == "UHF" and not calculation.DFT_calculation:
        log("\n Unrestricted Hartree-Fock energy: " + f"{final_energy:16.10f}",
            calculation, 1, silent=silent)
    elif reference == "RHF":
        log(f"\n Restricted {method.name} energy: {space}      " + f"{final_energy:16.10f}",
            calculation, 1, silent=silent)
    else:
        log(f"\n Unrestricted {method.name} energy: {space}    " + f"{final_energy:16.10f}",
            calculation, 1, silent=silent)


def run_post_SCF_energy_calculation(molecule, integrals, SCF_output, grid_container,
                                    calculation, X, V_NN, silent, terse):
    reference = calculation.reference
    method = calculation.method
    _, weights, _, _ = grid_container

    if (calculation.stability_analysis or method.perturbative_method
            or calculation.MPC_prop != 0 or method.excited_state_method
            or calculation.time_dependent or calculation.plot_something):
        error(f"The {method.name} method and these keywords are not yet ported to "
              "tuna_tpu_torch!")
    if method.method_base not in ("HF", "DFT", "CC"):
        error(f"The {method.name} method is not yet ported to tuna_tpu_torch!")

    P = SCF_output.P
    P_alpha = SCF_output.P_alpha
    P_beta = SCF_output.P_beta
    final_energy = SCF_output.energy

    E_CC = E_CC_perturbative = 0.0
    natural_orbitals = natural_occupancies = None

    SCF_output.D = integrals.D
    SCF_output.Q = integrals.Q

    if reference == "UHF":
        if calculation.natural_orbitals:
            error("Natural orbitals of unrestricted references are not yet ported to "
                  "tuna_tpu_torch!")
        props.calculate_spin_contamination(
            to_numpy(P_alpha), to_numpy(P_beta), molecule.n_alpha, molecule.n_beta,
            to_numpy(integrals.S), calculation, "UHF", silent=silent)

    props.print_energy_components(SCF_output, V_NN, calculation, silent=silent)

    if calculation.DFT_calculation:
        dft_grid.integrate_final_density(
            SCF_output.alpha_density, SCF_output.beta_density, SCF_output.density,
            weights, calculation, silent)

    if method.method_base == "CC":
        from ..post import cc
        (E_CC, E_CC_perturbative, (P, P_alpha, P_beta), natural_occupancies,
         natural_orbitals) = cc.begin_coupled_cluster_calculation(
            method, molecule, SCF_output, integrals, X, calculation, silent)
        props.calculate_spin_contamination(
            to_numpy(P_alpha), to_numpy(P_beta), molecule.n_alpha, molecule.n_beta,
            to_numpy(integrals.S), calculation, "Coupled cluster", silent=silent)

    if not terse and not silent:
        props.calculate_molecular_properties(
            molecule, calculation, to_numpy(P), to_numpy(integrals.S),
            SCF_output.host_view(), to_numpy(P_alpha), to_numpy(P_beta),
            natural_orbitals=natural_orbitals,
            natural_occupancies=natural_occupancies)

    _print_scf_energy(final_energy, reference, method, calculation, silent)

    # --- energy summation and printing ---------------------------------------
    if method.method_base == "CC":
        method.name = method.name.replace("[", "(").replace("]", ")")
        final_energy += E_CC + E_CC_perturbative
        space = " " * max(0, 8 - len(method.name))
        if "(" in method.name:
            log(f" Correlation energy from {method.name.split('(')[0]}:{space}    {E_CC:16.10f}",
                calculation, 1, silent=silent)
            log(f" Correlation energy from {method.name}: {space}{E_CC_perturbative:16.10f}\n",
                calculation, 1, silent=silent)
            log(f" Total correlation energy: {space}       {E_CC + E_CC_perturbative:16.10f}\n",
                calculation, 3, silent=silent)
        else:
            log(f" Correlation energy from {method.name}:{space} " + f"{E_CC:16.10f}\n",
                calculation, 1, silent=silent)
        method.name = method.name.replace("(", "[").replace(")", "]")

    log(" Final single point energy:        " + f"{final_energy:16.10f}",
        calculation, 1, silent=silent)

    if SCF_output.dispersion_energy != 0:
        final_energy += SCF_output.dispersion_energy
        log("\n Semi-empirical dispersion energy: " + f"{SCF_output.dispersion_energy:16.10f}",
            calculation, 1, silent=silent)
        log(" Dispersion-corrected final energy:" + f"{final_energy:16.10f}",
            calculation, 1, silent=silent)

    return final_energy, P
