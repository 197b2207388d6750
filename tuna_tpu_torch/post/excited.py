"""Excited states and SCF stability, driven through the linear-response
module (post.rpa).

Twin of tuna_tpu/post/excited.py: CIS / TDHF / TDA / TD-DFT excitation
spectra, transition dipoles and oscillator strengths, excited-state
difference densities, and the CIS(D) perturbative doubles correction.
The response matrices, eigensolves (the polished ops.linalg.eigh), XC
kernels and (D) pieces are tensors on the device of the SCF; printing and
the sort of the state labels read host copies.  CIS(D) is factorised
through o^2/v^2 intermediates, each term a tensordot or matmul, so no
three-operand contraction is formed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..containers import to_numpy
from ..output import error, log, log_big_spacer, log_spacer, timer, warning
from . import rpa, transforms


# ---------------------------------------------------------------------------
# State-vector utilities
# ---------------------------------------------------------------------------

def split_state_vector(column, n_occ, n_virt):
    """X (excitation) and Y (de-excitation) blocks of one state vector."""
    n_ia = n_occ * n_virt
    if column.shape[0] == 2 * n_ia:
        return (column[:n_ia].reshape(n_occ, n_virt),
                column[n_ia:].reshape(n_occ, n_virt))
    X = column.reshape(n_occ, n_virt)
    return X, torch.zeros_like(X)


def _solve_channel(tda, apb, amb, A):
    """One spin channel; returns (energies ascending, vectors column-wise),
    dropping any root the instability clamp touched."""
    if tda:
        return rpa.tda_excitations(A)
    w, V, amb_min, w2_min = rpa.rpa_excitations(apb, amb)
    if float(amb_min) < 0 or float(w2_min) < 0:
        warning("The response matrix A-B (or the folded Casida product) has "
                "negative eigenvalues: the SCF reference is unstable and the "
                "affected imaginary roots were discarded.", space=2)
        keep = w > 10 * np.sqrt(rpa.INSTABILITY_FLOOR)
        w, V = w[keep], V[:, keep]
    return w, V


# ---------------------------------------------------------------------------
# Stability analysis
# ---------------------------------------------------------------------------

def determine_self_consistent_field_stability(molecule, calculation, ERI_AO,
                                              SCF_output, bfs_on_grid=None,
                                              weights=None, silent=False):
    """Internal stability of the converged SCF.

    The orbital Hessian [[A,B],[B,A]] is never formed: its spectrum is
    eig(A+B) u eig(A-B) (rpa.orbital_hessian_lowest).  Returns the lowest
    eigenvalues: (singlet, triplet) for a restricted reference, (lowest,)
    for an unrestricted one.
    """
    K_XC_singlet = K_XC_triplet = K_XC = None
    if (calculation.method.density_functional_method
            and not calculation.functional.time_dependent_available):
        error("Stability analysis is not yet available for this "
              "exchange-correlation functional!")

    restricted = calculation.reference == "RHF"
    hfx = calculation.HFX_prop

    log_spacer(calculation, silent=silent, start="\n")
    log("                  Stability Analysis", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    threshold = constants.ORB_HESS_EIG_THRESH
    if restricted:
        g, mos, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
            molecule, ERI_AO, SCF_output, calculation, silent)
        if calculation.method.density_functional_method:
            from ..dft import kernels as dft_kernels
            K_XC_singlet, K_XC_triplet, _ = dft_kernels.restricted_xc_kernel_matrices(
                o, v, SCF_output.density, bfs_on_grid, mos, calculation,
                weights, silent)

        log("  Building response blocks...                ", calculation, 1, end="", silent=silent)
        amb = rpa.restricted_amb(g, epsilons, o, v, hfx)
        apb_s = rpa.restricted_apb(g, epsilons, o, v, hfx, "singlet", K_XC_singlet)
        apb_t = rpa.restricted_apb(g, epsilons, o, v, hfx, "triplet", K_XC_triplet)
        log("[Done]", calculation, 1, silent=silent)

        log("\n  Diagonalising orbital Hessians...          ", calculation, 1, end="", silent=silent)
        lowest_singlet = float(rpa.orbital_hessian_lowest(apb_s, amb))
        lowest_triplet = float(rpa.orbital_hessian_lowest(apb_t, amb))
        log("[Done]", calculation, 1, silent=silent)

        log(f"\n  Lowest singlet eigenvalue:             {lowest_singlet:10.5f}", calculation, 1, silent=silent)
        log(f"  Lowest triplet eigenvalue:             {lowest_triplet:10.5f}", calculation, 1, silent=silent)

        if lowest_singlet <= threshold:
            log("\n  The SCF is unstable wrt. restricted rotations.", calculation, 1, silent=silent)
        if lowest_triplet <= threshold:
            log("\n  The SCF is unstable wrt. unrestricted rotations.", calculation, 1, silent=silent)
        if lowest_singlet > threshold and lowest_triplet > threshold:
            log("\n  The self-consistent field solution is stable!", calculation, 1, silent=silent)
        lowest = (lowest_singlet, lowest_triplet)
    else:
        (g, C_spin_block, epsilons, o, v, spin_labels, _, ERI_spin_block,
         ERI_SO) = transforms.begin_spin_orbital_calculation(
            molecule, ERI_AO, SCF_output, calculation, silent, keep_tensors=True)
        del g, ERI_spin_block
        g_scaled = ERI_SO - hfx * ERI_SO.transpose(2, 3)
        del ERI_SO
        if calculation.method.density_functional_method:
            from ..dft import kernels as dft_kernels
            K_XC = dft_kernels.unrestricted_xc_kernel_matrices(
                o, v, SCF_output.P_alpha, SCF_output.P_beta, bfs_on_grid,
                C_spin_block, spin_labels, calculation, weights, silent)

        log("  Building response blocks...                ", calculation, 1, end="", silent=silent)
        keep = _spin_conserving_indices(spin_labels, o, v, epsilons.device)
        apb = rpa.spin_orbital_apb(g_scaled, epsilons, o, v, K_XC)[keep[:, None], keep[None, :]]
        amb = rpa.spin_orbital_amb(g_scaled, epsilons, o, v)[keep[:, None], keep[None, :]]
        log("[Done]", calculation, 1, silent=silent)

        log("\n  Diagonalising orbital Hessian...           ", calculation, 1, end="", silent=silent)
        lowest_value = float(rpa.orbital_hessian_lowest(apb, amb))
        log("[Done]", calculation, 1, silent=silent)
        log(f"\n  Lowest Hessian eigenvalue:             {lowest_value:10.5f}", calculation, 1, silent=silent)
        if lowest_value <= threshold:
            log("\n  The SCF is unstable wrt. unrestricted rotations.", calculation, 1, silent=silent)
        else:
            log("\n  The self-consistent field solution is stable!", calculation, 1, silent=silent)
        lowest = (lowest_value,)

    log_spacer(calculation, silent=silent)
    return lowest


def _spin_conserving_indices(spin_labels, o, v, device):
    """Indices (ia flattened) of the excitations that keep the spin, as a
    tensor on `device`."""
    spin_occ = np.array(spin_labels)[o]
    spin_virt = np.array(spin_labels)[v]
    keep = np.where((spin_occ[:, None] == spin_virt[None, :]).ravel())[0]
    return torch.as_tensor(keep, device=device)


# ---------------------------------------------------------------------------
# State solvers
# ---------------------------------------------------------------------------

def _print_excited_state_header(calculation, silent):
    log_spacer(calculation, silent=silent, start="\n")
    if calculation.method.density_functional_method:
        log("      Time-dependent Density Functional Theory", calculation, 1, silent=silent)
    elif calculation.tamm_dancoff_approximation:
        log("          Configuration Interaction Singles", calculation, 1, silent=silent)
    else:
        log("            Time-dependent Hartree-Fock", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    if calculation.tamm_dancoff_approximation:
        log("  Using the Tamm-Dancoff approximation...\n", calculation, 1, silent=silent)
    else:
        log("  Not using the Tamm-Dancoff approximation...\n", calculation, 1, silent=silent)

    if calculation.reference == "RHF":
        if not calculation.calculate_no_triplets and not calculation.calculate_no_singlets:
            log("  Singlet and triplet states will be calculated.", calculation, 1, silent=silent)
        elif not calculation.calculate_no_triplets:
            log("  Only triplet states will be calculated.", calculation, 1, silent=silent)
        else:
            log("  Only singlet states will be calculated.", calculation, 1, silent=silent)


def restricted_excited_states(g, epsilons, o, v, calculation, silent=False,
                              K_XC_singlet=None, K_XC_triplet=None):
    """Singlet / triplet CIS or TDHF states for a closed-shell reference.
    g is the chemists' MO tensor, used directly by the rpa builders."""
    if "CIS" in calculation.method.name:
        calculation.tamm_dancoff_approximation = True
    _print_excited_state_header(calculation, silent)
    timer("Excited state calculation", 0)

    tda = calculation.tamm_dancoff_approximation
    hfx = calculation.HFX_prop

    log("\n  Building excited state Hamiltonian...      ", calculation, 1, end="", silent=silent)
    amb = None if tda else rpa.restricted_amb(g, epsilons, o, v, hfx)
    channels = {}
    if not calculation.calculate_no_singlets:
        channels["singlet"] = (
            rpa.restricted_tda_matrix(g, epsilons, o, v, hfx, "singlet", K_XC_singlet)
            if tda else
            rpa.restricted_apb(g, epsilons, o, v, hfx, "singlet", K_XC_singlet))
    if not calculation.calculate_no_triplets:
        channels["triplet"] = (
            rpa.restricted_tda_matrix(g, epsilons, o, v, hfx, "triplet", K_XC_triplet)
            if tda else
            rpa.restricted_apb(g, epsilons, o, v, hfx, "triplet", K_XC_triplet))
    log("[Done]", calculation, 1, silent=silent)

    log("  Diagonalising Hamiltonian...               ", calculation, 1, end="", silent=silent)
    results = {}
    for channel, M in channels.items():
        if tda:
            results[channel] = _solve_channel(True, None, None, M)
        else:
            results[channel] = _solve_channel(False, M, amb, None)
    log("[Done]", calculation, 1, silent=silent)

    timer("Excited state calculation", 1)
    singlet = results.get("singlet", (None, None))
    triplet = results.get("triplet", (None, None))
    return singlet[0], triplet[0], singlet[1], triplet[1]


def unrestricted_excited_states(g_scaled, epsilons, o, v, n_occ, n_virt,
                                spin_labels, calculation, silent=False, K_XC=None):
    """Spin-conserving CIS or TDHF states for an unrestricted reference."""
    if "CIS" in calculation.method.name:
        calculation.tamm_dancoff_approximation = True
    _print_excited_state_header(calculation, silent)
    timer("Excited state calculation", 0)

    keep = _spin_conserving_indices(spin_labels, o, v, epsilons.device)
    n_keep = len(keep)
    rows, columns = keep[:, None], keep[None, :]
    n_ia = n_occ * n_virt

    log("  Building excited state Hamiltonian...      ", calculation, 1, end="", silent=silent)
    if calculation.tamm_dancoff_approximation:
        A = rpa.spin_orbital_tda_matrix(g_scaled, epsilons, o, v, K_XC)[rows, columns]
        log("[Done]", calculation, 1, silent=silent)
        log("  Diagonalising Hamiltonian...               ", calculation, 1, end="", silent=silent)
        energies, vectors = _solve_channel(True, None, None, A)
        full_vectors = vectors.new_zeros((n_ia, len(energies)))
        full_vectors[keep] = vectors
    else:
        apb = rpa.spin_orbital_apb(g_scaled, epsilons, o, v, K_XC)[rows, columns]
        amb = rpa.spin_orbital_amb(g_scaled, epsilons, o, v)[rows, columns]
        log("[Done]", calculation, 1, silent=silent)
        log("  Diagonalising Hamiltonian...               ", calculation, 1, end="", silent=silent)
        energies, vectors = _solve_channel(False, apb, amb, None)
        full_vectors = vectors.new_zeros((2 * n_ia, len(energies)))
        full_vectors[keep] = vectors[:n_keep]
        full_vectors[n_ia + keep] = vectors[n_keep:]
    log("[Done]", calculation, 1, silent=silent)

    timer("Excited state calculation", 1)
    return energies, full_vectors


# ---------------------------------------------------------------------------
# Transition properties (batched over states)
# ---------------------------------------------------------------------------

def calculate_oscillator_strengths(transition_dipoles, excitation_energies):
    return (2.0 / 3.0) * excitation_energies * transition_dipoles**2


def _dipole_norms_batched(D_ov, F_states):
    """D_ov: (3, no, nv) MO dipole blocks; F_states: (n_states, no, nv) X+Y
    amplitudes.  One contraction for all states and components."""
    amplitudes = torch.tensordot(F_states, D_ov, dims=([1, 2], [1, 2]))
    return torch.linalg.norm(amplitudes, dim=1)


def _transition_amplitudes(vectors, n_occ, n_virt):
    """X+Y per state, stacked (n_states, no, nv)."""
    n_ia = n_occ * n_virt
    F = vectors[:n_ia] + vectors[n_ia:] if vectors.shape[0] == 2 * n_ia else vectors
    return F.T.reshape(-1, n_occ, n_virt)


def restricted_transition_dipoles(SCF_output, singlet_vectors, triplet_vectors,
                                  n_occ, n_virt, o, v):
    C = SCF_output.molecular_orbitals
    D_ov = torch.stack([transforms.transform_matrix_ao_to_so(M, C)[o, v]
                        for M in SCF_output.D])
    dipoles = [D_ov.new_zeros(0)]
    if singlet_vectors is not None and singlet_vectors.shape[1]:
        F = _transition_amplitudes(singlet_vectors, n_occ, n_virt)
        dipoles.append(_dipole_norms_batched(D_ov, F))
    if triplet_vectors is not None:
        dipoles.append(D_ov.new_zeros(triplet_vectors.shape[1]))   # spin-forbidden
    return torch.cat(dipoles) * np.sqrt(2.0)


def unrestricted_transition_dipoles(SCF_output, vectors, n_occ, n_virt, o, v,
                                    C_spin_block):
    D_ov = torch.stack([transforms.transform_matrix_ao_to_so(
        transforms.spin_block_matrix(M.contiguous()), C_spin_block)[o, v]
        for M in SCF_output.D])
    F = _transition_amplitudes(vectors, n_occ, n_virt)
    return _dipole_norms_batched(D_ov, F)


# ---------------------------------------------------------------------------
# State density and energy
# ---------------------------------------------------------------------------

def _difference_density_MO(X, Y, n_orbitals, o, v):
    P = X.new_zeros((n_orbitals, n_orbitals))
    P[v, v] = X.T @ X + Y.T @ Y
    P[o, o] = -(X @ X.T + Y @ Y.T)
    return P


def excited_state_energy_and_density(excitation_energies, excitation_vectors,
                                     state, n_occ, n_virt, SCF_output, o, v,
                                     orbitals, restricted):
    if state >= len(excitation_energies):
        error(f"Specified root ({state + 1}) does not exist!")
    E_transition = float(excitation_energies[state])
    X, Y = split_state_vector(excitation_vectors[:, state], n_occ, n_virt)

    if restricted:
        P_diff_MO = _difference_density_MO(X, Y, SCF_output.P.shape[0], o, v)
        P_diff = orbitals @ P_diff_MO @ orbitals.T
        P_diff_alpha = P_diff_beta = P_diff / 2.0
    else:
        n_SO = orbitals.shape[1]
        P_diff_MO = _difference_density_MO(X, Y, n_SO, o, v)
        P_diff, P_diff_alpha, P_diff_beta = transforms.density_so_to_ao(
            P_diff_MO, orbitals, n_SO)

    E_state = SCF_output.energy + E_transition
    P_state = SCF_output.P + P_diff
    P_state_alpha = SCF_output.P_alpha + P_diff_alpha
    P_state_beta = SCF_output.P_beta + P_diff_beta
    return (E_state, E_transition, P_state, P_state_alpha, P_state_beta,
            P_diff, P_diff_alpha, P_diff_beta)


# ---------------------------------------------------------------------------
# Printing (host copies)
# ---------------------------------------------------------------------------

def print_absorption_spectrum(molecule, excitation_energies, calculation,
                              transition_dipoles, oscillator_strengths,
                              state_types, silent=False):
    excitation_energies = np.asarray(to_numpy(excitation_energies))
    transition_dipoles = np.asarray(to_numpy(transition_dipoles))
    oscillator_strengths = np.asarray(to_numpy(oscillator_strengths))
    wavelengths_nm = 1e7 / (excitation_energies * constants.PER_CM_IN_HARTREE)
    energies_eV = constants.EV_IN_HARTREE * excitation_energies

    log_spacer(calculation, silent=silent, start="\n")
    log(f"\n Transition dipole moment origin is the centre of mass, "
        f"{constants.bohr_to_angstrom(molecule.centre_of_mass):.4f} angstroms "
        "from the first atom.", calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent, start="\n")
    log("                                     Excited State Absorption Spectrum",
        calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent)
    log("   State         Energy          Energy (eV)     Wavelength (nm)    "
        "Osc. Strength     Transition Dipole", calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent)

    for state in range(len(excitation_energies)):
        if state < calculation.n_states:
            state_type = (" - " + state_types[state][0]
                          if calculation.reference == "RHF" else "  ")
            gap = "" if calculation.reference == "RHF" else "  "
            log(f"  {gap}{(state + 1):2}{state_type.upper()}  "
                f"{excitation_energies[state]:16.10f}  {energies_eV[state]:14.5f}   "
                f"{wavelengths_nm[state]:16.5f}       "
                f"{oscillator_strengths[state]:10.5f}          "
                f"{transition_dipoles[state]:10.5f}", calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent)


def print_state_contributions(calculation, silent, excitation_energies,
                              excitation_vectors, state_types, n_occ, n_virt,
                              o, orbital_labels=None):
    log("\n  Printing excited state information...", calculation, 2, silent=silent)
    log(f"  Only printing contributions larger than "
        f"{calculation.excited_state_contribution_threshold:.1f} %.",
        calculation, 2, silent=silent)
    excitation_energies = np.asarray(to_numpy(excitation_energies))
    n_printed = min(len(excitation_energies), calculation.n_states)
    vectors = excitation_vectors[:, :n_printed].cpu()

    for state in range(n_printed):
        log(f"\n  ~~~~~ State {state + 1} ~~~~~  {state_types[state].capitalize()}",
            calculation, 2, silent=silent)
        log(f"\n  Excitation energy: {excitation_energies[state]:16.10f}\n",
            calculation, 2, silent=silent)

        X, Y = split_state_vector(vectors[:, state], n_occ, n_virt)
        contributions = (100.0 * (X**2 - Y**2)).numpy()

        for index in np.argsort(contributions, axis=None)[::-1]:
            i, a = divmod(index, n_virt)
            if contributions[i, a] <= calculation.excited_state_contribution_threshold:
                break
            if orbital_labels is not None:
                occ_label = orbital_labels[o.start + i]
                virt_label = orbital_labels[o.stop + a]
            else:
                occ_label, virt_label = f"{o.start + i + 1}", f"{o.stop + a + 1}"
            log(f"    {occ_label:>4}  ->  {virt_label:<4}  "
                f"{contributions[i, a]:7.2f} %", calculation, 2, silent=silent)


# ---------------------------------------------------------------------------
# CIS(D) perturbative doubles correction
# ---------------------------------------------------------------------------
# Head-Gordon, Rico, Oumi, Lee, CPL 219, 21 (1994).  Factorised through
# one-index-contracted intermediates: the "indirect" triple contractions of
# the paper reduce to two oo/vv matrices and one ov seed, so each term is a
# single matmul against the CIS amplitude.

def _print_doubles_result(E_D, E_D_scaled, excitation_energy, calculation, silent):
    log(f"\n  Original excitation energy:       {excitation_energy:15.10f}", calculation, 1, silent=silent)
    log(f"  Correction energy from (D):       {E_D:15.10f}", calculation, 1, silent=silent)
    log(f"  Correction energy (eV):           {(E_D * constants.EV_IN_HARTREE):15.10f}", calculation, 3, silent=silent)
    if calculation.MPC_requested or calculation.DFT_calculation:
        log(f"  Scaled correction energy:         {E_D_scaled:15.10f}", calculation, 1, silent=silent)
    log(f"\n  Corrected excitation energy:      {(E_D_scaled + excitation_energy):15.10f}", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)


def _restricted_doubles_pieces(gc, b_ia, e_ijab):
    """Core of spin-adapted CIS(D).  gc is the chemists' MO tensor sliced by
    the caller into the four blocks used here."""
    g_vvvo, g_vovv, g_oovo, g_ovov = gc
    # Doubles excitation amplitudes driven by the CIS vector: two particle
    # attachments and two hole attachments of b
    p1 = torch.tensordot(b_ia, g_vvvo, dims=([1], [1])).permute(0, 3, 1, 2)
    p2 = torch.tensordot(g_vovv, b_ia, dims=([3], [1])).permute(1, 3, 0, 2)
    h1 = torch.tensordot(g_oovo, b_ia, dims=([0], [0])).permute(2, 0, 1, 3)
    h2 = torch.tensordot(g_oovo, b_ia, dims=([0], [0])).permute(0, 2, 3, 1)

    u_S = p1 + p2 - h1 - h2
    u_T = p1 - p2 + h1 - h2

    # MP2 ground-state amplitudes and the J/K orderings of (ov|ov)
    J = g_ovov.permute(0, 2, 1, 3)
    K = g_ovov.permute(0, 2, 3, 1)
    t = J * e_ijab
    u2 = 2.0 * t - t.transpose(2, 3)

    # Indirect intermediates: everything except the final contraction with b
    half_JmK = 0.5 * J - K
    half_KmJ = 0.5 * K - J
    Woo = (torch.tensordot(half_JmK, t, dims=([1, 2, 3], [1, 3, 2]))
           + torch.tensordot(half_KmJ, t, dims=([1, 2, 3], [1, 2, 3])))
    Wvv = (torch.tensordot(half_JmK, t, dims=([0, 1, 3], [0, 1, 2]))
           + torch.tensordot(half_KmJ, t, dims=([0, 1, 3], [0, 1, 3])))
    seed_S = torch.tensordot(2.0 * J - K, b_ia, dims=([0, 2], [0, 1]))
    seed_T = torch.tensordot(K, b_ia, dims=([0, 2], [0, 1]))

    v_common = Woo.T @ b_ia + b_ia @ Wvv
    v_S = v_common + torch.tensordot(u2, seed_S, dims=([1, 3], [0, 1]))
    v_T = v_common + torch.tensordot(t.transpose(2, 3), seed_T, dims=([1, 3], [0, 1]))
    return u_S, u_T, v_S, v_T


def restricted_doubles_correction(excitation_energy, epsilons, root, g, o, v,
                                  b_ia, state_type, calculation, silent=False):
    """Spin-adapted CIS(D); g is the chemists' MO tensor."""
    log_spacer(calculation, silent=silent, start="\n")
    log("          Perturbative Doubles Correction", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log(f"  Applying doubles correction to state {root + 1} only.", calculation, 1, silent=silent)
    log("\n  Building doubles amplitudes...           ", calculation, 1, end="", silent=silent)

    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    shifted = 1.0 / (1.0 / e_ijab + excitation_energy)

    blocks = (g[v, v, v, o], g[v, o, v, v], g[o, o, v, o], g[o, v, o, v])
    u_S, u_T, v_S, v_T = _restricted_doubles_pieces(blocks, b_ia, e_ijab)
    log("  [Done]", calculation, 1, silent=silent)

    log("\n  Calculating direct contribution...  ", calculation, 1, end="", silent=silent)
    def weighted(x, y):
        return float(torch.sum(shifted * x * y))

    u_S_x = u_S.transpose(0, 1)
    if state_type == "singlet":
        E_direct = weighted(u_S, u_S) - 0.5 * weighted(u_S, u_S_x)
        v_ia = v_S
    else:
        E_direct = (0.5 * weighted(u_S, u_S) - 0.5 * weighted(u_S, u_S_x)
                    + 0.5 * weighted(u_T, u_T))
        v_ia = v_T
    log("       [Done]", calculation, 1, silent=silent)

    log("  Calculating indirect contribution...  ", calculation, 1, end="", silent=silent)
    E_indirect = float(torch.sum(b_ia * v_ia))
    log("     [Done]", calculation, 1, silent=silent)

    log("\n  Calculating doubles correction...         ", calculation, 1, end="", silent=silent)
    E_D = E_direct + E_indirect
    E_D_scaled = (E_D * calculation.MPC_prop
                  if calculation.MPC_requested or calculation.DFT_calculation else E_D)
    _print_doubles_result(E_D, E_D_scaled, excitation_energy, calculation, silent)
    return E_D_scaled


def _unrestricted_doubles_pieces(g_vvvo, g_ovoo, g_oovv, b_ia, e_ijab):
    """Spin-orbital CIS(D) core; g blocks are the antisymmetrised
    physicists' tensor."""
    def antisym(M, ax1, ax2):
        return M - M.transpose(ax1, ax2)

    p = torch.tensordot(b_ia, g_vvvo, dims=([1], [2])).permute(0, 3, 1, 2)
    h = torch.tensordot(g_ovoo, b_ia, dims=([0], [0])).permute(1, 2, 0, 3)
    u = antisym(p, 0, 1) + antisym(h, 2, 3)

    t = g_oovv * e_ijab
    Wvv = torch.tensordot(g_oovv, t, dims=([0, 1, 3], [0, 1, 2]))
    Woo = torch.tensordot(g_oovv, t, dims=([1, 2, 3], [1, 3, 2]))
    seed = torch.tensordot(g_oovv, b_ia, dims=([0, 2], [0, 1]))
    v_ia = (0.5 * b_ia @ Wvv + 0.5 * Woo.T @ b_ia
            + torch.tensordot(t, seed, dims=([1, 3], [0, 1])))
    return u, v_ia


def unrestricted_doubles_correction(excitation_energy, epsilons, root, g, o, v,
                                    b_ia, calculation, silent=False):
    """Spin-orbital CIS(D)."""
    log_spacer(calculation, silent=silent, start="\n")
    log("          Perturbative Doubles Correction", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log(f"  Applying doubles correction to state {root + 1} only.", calculation, 1, silent=silent)
    log("\n  Building doubles amplitudes...             ", calculation, 1, end="", silent=silent)

    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    shifted = 1.0 / (1.0 / e_ijab + excitation_energy)

    u, v_ia = _unrestricted_doubles_pieces(
        g[v, v, v, o], g[o, v, o, o], g[o, o, v, v], b_ia, e_ijab)
    log("[Done]", calculation, 1, silent=silent)

    log("\n  Calculating direct contribution...         ", calculation, 1, end="", silent=silent)
    E_direct = 0.25 * float(torch.sum(u * u * shifted))
    log("[Done]", calculation, 1, silent=silent)
    log("  Calculating indirect contribution...       ", calculation, 1, end="", silent=silent)
    E_indirect = float(torch.sum(b_ia * v_ia))
    log("[Done]", calculation, 1, silent=silent)

    log("\n  Calculating doubles correction...          ", calculation, 1, end="", silent=silent)
    E_D = E_direct + E_indirect
    log("[Done]", calculation, 1, silent=silent)

    E_D_scaled = (E_D * calculation.MPC_prop
                  if calculation.MPC_requested or calculation.DFT_calculation else E_D)
    _print_doubles_result(E_D, E_D_scaled, excitation_energy, calculation, silent)
    return E_D_scaled


def run_perturbative_doubles(state, n_occ, n_virt, excitation_vectors, g,
                             epsilons, o, v, state_types, state_result,
                             calculation, silent):
    timer("Perturbative doubles", 0)
    X, Y = split_state_vector(excitation_vectors[:, state], n_occ, n_virt)
    b_ia = X + Y

    if calculation.reference == "RHF":
        E_CIS_D = restricted_doubles_correction(
            state_result[1], epsilons, state, g, o, v, b_ia,
            state_types[state], calculation, silent)
    else:
        E_CIS_D = unrestricted_doubles_correction(
            state_result[1], epsilons, state, g, o, v, b_ia, calculation, silent)

    state_result = (state_result[0] + E_CIS_D, state_result[1] + E_CIS_D) + state_result[2:]
    timer("Perturbative doubles", 1)
    return state_result


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_excited_state_calculation(molecule, calculation, SCF_output,
                                  bfs_on_grid=None, weights=None, silent=False):
    """TD-HF / TD-DFT / CIS(-D) excited states."""
    if calculation.calculate_no_singlets and calculation.calculate_no_triplets:
        error("There are no excited states to calculate!")
    if (calculation.method.density_functional_method
            and not calculation.functional.time_dependent_available):
        error("Time-dependent DFT is not yet available for this "
              "exchange-correlation functional!")
    if (not calculation.method.excited_state_method
            and not calculation.method.density_functional_method
            and not calculation.method.name == "HF"):
        error(f"Excited states are not available with {calculation.method.name}!")

    K_XC_singlet = K_XC_triplet = K_XC = None
    spin_orbital_labels = None
    state = calculation.root - 1
    restricted = calculation.reference == "RHF"

    if restricted:
        g, orbitals, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
            molecule, SCF_output.integrals.ERI_AO, SCF_output, calculation, silent)
        n_occ, n_virt = o.stop - (o.start or 0), molecule.n_doubly_virt

        if calculation.method.density_functional_method:
            from ..dft import kernels as dft_kernels
            K_XC_singlet, K_XC_triplet, _ = dft_kernels.restricted_xc_kernel_matrices(
                o, v, SCF_output.density, bfs_on_grid, orbitals, calculation,
                weights, silent)

        (singlet_energies, triplet_energies, singlet_vectors,
         triplet_vectors) = restricted_excited_states(
            g, epsilons, o, v, calculation, silent, K_XC_singlet, K_XC_triplet)

        excitation_energies = torch.cat(
            [e for e in (singlet_energies, triplet_energies) if e is not None])
        excitation_vectors = torch.cat(
            [vec for vec in (singlet_vectors, triplet_vectors) if vec is not None], dim=1)
        state_types = np.concatenate(
            [np.full(len(e), label) for e, label in
             ((singlet_energies, "singlet"), (triplet_energies, "triplet"))
             if e is not None])
    else:
        (g, C_spin_block, epsilons, o, v, spin_labels, spin_orbital_labels,
         ERI_spin_block, ERI_SO) = transforms.begin_spin_orbital_calculation(
            molecule, SCF_output.integrals.ERI_AO, SCF_output, calculation, silent,
            keep_tensors=True)
        del ERI_spin_block
        orbitals = C_spin_block
        n_occ, n_virt = o.stop - (o.start or 0), molecule.n_virt

        if calculation.method.density_functional_method:
            from ..dft import kernels as dft_kernels
            K_XC = dft_kernels.unrestricted_xc_kernel_matrices(
                o, v, SCF_output.P_alpha, SCF_output.P_beta, bfs_on_grid,
                C_spin_block, spin_labels, calculation, weights, silent)

        g_scaled = ERI_SO - calculation.HFX_prop * ERI_SO.transpose(2, 3)
        del ERI_SO
        excitation_energies, excitation_vectors = unrestricted_excited_states(
            g_scaled, epsilons, o, v, n_occ, n_virt, spin_labels, calculation,
            silent, K_XC)
        del g_scaled
        state_types = np.array([""] * len(excitation_energies))

    log("\n  Calculating oscillator strengths...        ", calculation, 1, end="", silent=silent)
    if restricted:
        transition_dipoles = restricted_transition_dipoles(
            SCF_output, singlet_vectors, triplet_vectors, n_occ, n_virt, o, v)
    else:
        transition_dipoles = unrestricted_transition_dipoles(
            SCF_output, excitation_vectors, n_occ, n_virt, o, v, C_spin_block)
    oscillator_strengths = calculate_oscillator_strengths(
        transition_dipoles, excitation_energies)
    log("[Done]", calculation, 1, silent=silent)

    order = torch.argsort(excitation_energies, stable=True)
    excitation_vectors = excitation_vectors[:, order]
    excitation_energies, transition_dipoles, oscillator_strengths = (
        x[order] for x in (excitation_energies, transition_dipoles, oscillator_strengths))
    state_types = state_types[to_numpy(order)]

    log("  Constructing density matrix...             ", calculation, 1, end="", silent=silent)
    state_result = excited_state_energy_and_density(
        excitation_energies, excitation_vectors, state, n_occ, n_virt,
        SCF_output, o, v, orbitals, restricted)
    log("[Done]", calculation, 1, silent=silent)

    print_state_contributions(calculation, silent, excitation_energies,
                              excitation_vectors, state_types, n_occ, n_virt,
                              o, spin_orbital_labels)
    print_absorption_spectrum(molecule, excitation_energies, calculation,
                              transition_dipoles, oscillator_strengths,
                              state_types, silent)

    if (calculation.do_perturbative_doubles or "[D]" in calculation.method.name
            or "(D)" in calculation.method.name):
        state_result = run_perturbative_doubles(
            state, n_occ, n_virt, excitation_vectors, g, epsilons, o, v,
            state_types, state_result, calculation, silent)

    if calculation.plot_absorbance_spectrum:
        from .. import plotting
        plotting.generate_absorbance_spectrum(calculation, to_numpy(excitation_energies),
                                              to_numpy(oscillator_strengths))

    return state_result
