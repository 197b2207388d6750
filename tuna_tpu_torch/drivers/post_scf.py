"""Post-SCF dispatcher: spin contamination and natural orbitals of an
unrestricted reference, energy components, the integrated density of a
Kohn-Sham run, stability analysis, perturbation theory (MPn and double
hybrids), coupled cluster, excited states, energy summation, property
printing and the two-dimensional plots.

Twin of tuna_tpu/drivers/post_scf.py (reference: tuna_kernel.py:1076-1323).
The host-side printing and plotting code (`props.py`, `plotting.py`,
numpy) receives host copies of the device tensors.
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
    do_DFT = calculation.DFT_calculation
    bfs_on_grid, weights, _, _ = grid_container

    P = SCF_output.P
    P_alpha = SCF_output.P_alpha
    P_beta = SCF_output.P_beta
    final_energy = SCF_output.energy

    E_MP2 = E_MP3 = E_MP4 = 0.0
    E_CC = E_CC_perturbative = 0.0
    E_excited_state = E_transition = 0.0
    natural_orbitals = natural_occupancies = None

    SCF_output.D = integrals.D
    SCF_output.Q = integrals.Q

    if reference == "UHF":
        props.calculate_spin_contamination(
            to_numpy(P_alpha), to_numpy(P_beta), molecule.n_alpha, molecule.n_beta,
            to_numpy(integrals.S), calculation, "UKS" if do_DFT else "UHF", silent=silent)
        if calculation.natural_orbitals:
            from ..scf.guess import natural_orbitals_of_density
            natural_occupancies, natural_orbitals = natural_orbitals_of_density(
                P, X, integrals.S)
            log(" ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~\n",
                calculation, 1, silent=silent)

    props.print_energy_components(SCF_output, V_NN, calculation, silent=silent)

    if do_DFT:
        dft_grid.integrate_final_density(
            SCF_output.alpha_density, SCF_output.beta_density, SCF_output.density,
            weights, calculation, silent)

    if calculation.stability_analysis:
        from ..post import excited as stability
        stability.determine_self_consistent_field_stability(
            molecule, calculation, integrals.ERI_AO, SCF_output, bfs_on_grid,
            weights, silent)

    if method.perturbative_method or calculation.MPC_prop != 0:
        from ..post import mp
        (E_MP2, E_MP3, E_MP4, P, P_alpha, P_beta, natural_occupancies,
         natural_orbitals) = mp.run_perturbation_theory_calculation(
            method, molecule, SCF_output, integrals, calculation, V_NN,
            grid_container, silent=silent)
        props.calculate_spin_contamination(
            to_numpy(P_alpha), to_numpy(P_beta), molecule.n_alpha, molecule.n_beta,
            to_numpy(integrals.S), calculation, "MP2", silent)
    elif method.method_base == "CC":
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
            natural_orbitals=to_numpy(natural_orbitals),
            natural_occupancies=to_numpy(natural_occupancies))

    P_diff = P_diff_alpha = P_diff_beta = None
    if method.excited_state_method or calculation.time_dependent:
        log("\n Beginning excited state calculation...", calculation, 1, silent=silent)
        if molecule.n_virt <= 0:
            error("Excited state calculation requested on system with no virtual orbitals!")
        from ..post import excited as ci
        (E_excited_state, E_transition, P, P_alpha, P_beta, P_diff,
         P_diff_alpha, P_diff_beta) = ci.run_excited_state_calculation(
            molecule, calculation, SCF_output, bfs_on_grid, weights, silent)
        if calculation.additional_print:
            props.calculate_molecular_properties(
                molecule, calculation, to_numpy(P), to_numpy(integrals.S),
                SCF_output.host_view(), to_numpy(P_alpha), to_numpy(P_beta),
                print_orbitals=False)

    _print_scf_energy(final_energy, reference, method, calculation, silent)

    # --- energy summation and printing per method family -------------------
    if method.method_base == "MP2" or (calculation.MPC_prop != 0
                                       and not method.excited_state_method
                                       and not calculation.time_dependent):
        space = " " * max(0, 8 - len(method.name))
        E_MP2 = E_MP2 * calculation.MPC_prop if do_DFT else E_MP2
        final_energy += E_MP2
        if do_DFT:
            log(" Double-hybrid correlation energy: " + f"{E_MP2:16.10f}\n",
                calculation, 1, silent=silent)
        else:
            log(f" Correlation energy from {method.name}: {space}" + f"{E_MP2:16.10f}\n",
                calculation, 1, silent=silent)
    elif method.method_base == "MP3":
        final_energy += E_MP2 + E_MP3
        label = "SCS-MP2" if method.name == "SCS-MP3" else "MP2"
        label3 = "SCS-MP3" if method.name == "SCS-MP3" else "MP3"
        log(f" Correlation energy from {label}:  ".ljust(35) + f"{E_MP2:16.10f}",
            calculation, 1, silent=silent)
        log(f" Correlation energy from {label3}:  ".ljust(35) + f"{E_MP3:16.10f}\n",
            calculation, 1, silent=silent)
        log(" Total correlation energy:         " + f"{E_MP2 + E_MP3:16.10f}\n",
            calculation, 3, silent=silent)
    elif method.method_base == "MP4":
        final_energy += E_MP2 + E_MP3 + E_MP4
        log(" Correlation energy from MP2:      " + f"{E_MP2:16.10f}", calculation, 1, silent=silent)
        log(" Correlation energy from MP3:      " + f"{E_MP3:16.10f}", calculation, 1, silent=silent)
        if method.name in ("MP4", "MP4[SDTQ]", "MP4(SDTQ)"):
            log(" Correlation energy from MP4:      " + f"{E_MP4:16.10f}\n", calculation, 1,
                silent=silent)
        elif method.name in ("MP4[SDQ]", "MP4(SDQ)"):
            log(" Correlation energy from MP4(SDQ): " + f"{E_MP4:16.10f}\n", calculation, 1,
                silent=silent)
        elif method.name in ("MP4[DQ]", "MP4(DQ)"):
            log(" Correlation energy from MP4(DQ):  " + f"{E_MP4:16.10f}\n", calculation, 1,
                silent=silent)
        log(" Total correlation energy:         " + f"{E_MP2 + E_MP3 + E_MP4:16.10f}\n",
            calculation, 3, silent=silent)
    elif method.method_base == "CC":
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
    elif method.excited_state_method or calculation.time_dependent:
        final_energy = E_excited_state
        method.name = method.name.replace("[", "(").replace("]", ")")
        log(f"\n Excitation energy is the energy difference to excited state "
            f"{calculation.root}.", calculation, 1, silent=silent)
        excited_name = method.name if method.excited_state_method else "TD-" + method.name
        log(f"\n Excitation energy from {f'{excited_name}:':<11} {E_transition:15.10f}",
            calculation, 1, silent=silent)

    log(" Final single point energy:        " + f"{final_energy:16.10f}",
        calculation, 1, silent=silent)

    if SCF_output.dispersion_energy != 0:
        final_energy += SCF_output.dispersion_energy
        log("\n Semi-empirical dispersion energy: " + f"{SCF_output.dispersion_energy:16.10f}",
            calculation, 1, silent=silent)
        log(" Dispersion-corrected final energy:" + f"{final_energy:16.10f}",
            calculation, 1, silent=silent)

    if not silent and calculation.plot_something:
        from .. import plotting
        plotting.show_two_dimensional_plot(
            calculation, molecule, P, P_alpha, P_beta, P_diff_alpha, P_diff_beta,
            P_diff, SCF_output.molecular_orbitals, natural_orbitals)

    return final_energy, P
