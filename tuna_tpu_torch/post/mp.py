"""Moller-Plesset perturbation theory: MP2 (with SCS, iterative, Laplace AO
and orbital-optimised variants), MP3 and MP4, with unrelaxed and relaxed
densities, on restricted and unrestricted references.

Twin of tuna_tpu/post/mp.py.  Its jitted cores are einsums and tensordots,
here plain functions on tensors (cuBLAS on the card).  Every contraction of
three or more operands is written as pairwise steps with o^2 v^2
intermediates: torch.einsum contracts left to right when opt_einsum is
absent, as on the card's machine, which for UMP3's terms would form o^2
v^4 and o^4 v^2 intermediates.  The IMP2 and OMP2 iterations are host loops over device
steps with tuna_tpu's stop rule (the energy change below ECONV, at most
CORRMAXITER steps); each step's wall seconds go to
SCF_output.correlation_iteration_seconds, as the coupled-cluster loop's do.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..containers import to_numpy
from ..ops import linalg
from ..output import error, log, log_spacer, timer
from ..scf.guess import natural_orbitals_of_density
from . import rpa, transforms


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def print_natural_orbitals(P, X, S, calculation, silent=False):
    occupancies, orbitals = natural_orbitals_of_density(P, X, S)
    occupancies = to_numpy(occupancies)
    if calculation.method.name != "UHF":
        log("", calculation, 2, silent=silent)
    log("  Natural orbital occupancies: \n", calculation, 2, silent=silent)
    for i, occ in enumerate(occupancies):
        log(f"    {i + 1:2.0f}. {occ:12.8f}", calculation, 2, silent=silent)
    log(f"\n  Sum of natural orbital occupancies: {np.sum(occupancies):.6f}",
        calculation, 2, silent=silent)
    return occupancies, orbitals


def _zeros_like_square(n, like):
    return torch.zeros((n, n), dtype=like.dtype, device=like.device)


def _t_amplitude_density_contribution(n, t_ijab, o, v):
    P = _zeros_like_square(n, t_ijab)
    P[v, v] += 0.5 * torch.einsum("ijac,ijbc->ab", t_ijab, t_ijab)
    P[o, o] += -0.5 * torch.einsum("jkab,ikab->ij", t_ijab, t_ijab)
    return P


def _spin_component_scaling_active(calculation):
    return ("SCS" in calculation.method.name
            or (calculation.DFT_calculation
                and calculation.functional.functional_type == "spin-scaled double-hybrid")
            or (calculation.DFT_calculation
                and (calculation.SSS_requested or calculation.OSS_requested)))


def _log_scs(calculation, silent):
    log(f"  Same-spin scaling: {calculation.same_spin_scaling:.3f}", calculation, 1, silent=silent)
    log(f"  Opposite-spin scaling: {calculation.opposite_spin_scaling:.3f}\n", calculation, 1, silent=silent)


def _double_hybrid_scale(calculation):
    return (calculation.MPC_prop
            if calculation.MPC_requested or calculation.DFT_calculation else 1.0)


# ---------------------------------------------------------------------------
# Relaxed (response) densities via Z-vector equations
# ---------------------------------------------------------------------------
# The orbital relaxation z solves one (A+B) system built by post.rpa; the
# occupied-virtual Lagrangian is a sum of tensordots over the chemists' MO
# tensor (restricted) or the antisymmetrised spin-orbital tensor
# (unrestricted).  Kohn-Sham references need the XC kernel (dft/kernels.py
# in tuna_tpu), which is not ported: drivers/energy.py refuses them.

def _frozen_core_rotation(P0, w, gc, epsilons, o, v, spin_adapted):
    """Frozen-active occupied rotation block: the Lagrangian coupling between
    frozen and active occupied orbitals over the orbital-energy gap.  gc is
    chemists' for the spin-adapted path, spin-orbital physicists' otherwise.
    Adds into P0 in place."""
    n_frozen = 0 if o.start is None else o.start
    if n_frozen == 0:
        return P0
    f = slice(0, n_frozen)
    if spin_adapted:
        # sum_jab w[i,j,a,b] (Fa|jb)  +  sum_jbc w[j,i,b,c] (jb|Fc)
        L_fo = (torch.tensordot(gc[f, v, o, v], w, dims=([1, 2, 3], [2, 1, 3]))
                + torch.tensordot(gc[o, v, f, v], w, dims=([0, 1, 3], [0, 2, 3])))
    else:
        # sum_jab w[i,j,a,b] <Fj|ab>
        L_fo = torch.tensordot(gc[f, o, v, v], w, dims=([1, 2, 3], [1, 2, 3]))
    z_fo = L_fo / (epsilons[o][None, :] - epsilons[f][:, None])
    P0[f, o] += 0.5 * z_fo
    P0[o, f] += 0.5 * z_fo.T
    return P0


def _restricted_relaxed_density(P_unrelaxed, amp_weights, gc, epsilons, o, v,
                                n_occ, n_virt, calculation):
    """Spin-adapted Z-vector (response) MP2 density; gc is the full chemists'
    MO tensor, amp_weights the pre-scaled amplitude combinations."""
    w = amp_weights
    oa = slice(0, n_occ)  # all occupied, frozen included

    # Amplitude part of the ov Lagrangian: two particle and two hole terms
    L_active = (torch.tensordot(w, gc[v, v, o, v], dims=([1, 2, 3], [2, 1, 3]))
                + torch.tensordot(w, gc[o, v, v, v], dims=([0, 2, 3], [0, 1, 3])))
    L_hole = (torch.tensordot(w, gc[o, oa, o, v], dims=([0, 1, 3], [0, 2, 3]))
              + torch.tensordot(w, gc[o, v, o, oa], dims=([0, 1, 2], [0, 2, 1])))
    L = torch.zeros((n_occ, n_virt), dtype=w.dtype, device=w.device)
    L[o, :] += L_active
    L = L - L_hole.T

    P_relaxed = _frozen_core_rotation(P_unrelaxed.clone(), w, gc, epsilons, o, v,
                                      spin_adapted=True)

    # Generalised-Fock part, driven by the (frozen-corrected) density:
    # 4 J[P] - c_x (K[P] + K[P^T]) in the (i,a) block
    hfx = calculation.HFX_prop
    L_fock = 4.0 * torch.tensordot(gc[v, oa, :, :], P_relaxed, dims=2).T
    L_fock = L_fock - hfx * (
        torch.tensordot(gc[v, :, oa, :], P_relaxed, dims=([1, 3], [0, 1]))
        + torch.tensordot(gc[v, :, oa, :], P_relaxed, dims=([1, 3], [1, 0]))).T

    apb = rpa.restricted_apb(gc, epsilons, oa, v, hfx)
    z = rpa.zvector_solve(apb, L + L_fock)
    P_relaxed[oa, v] += 0.5 * z
    P_relaxed[v, oa] += 0.5 * z.T
    return P_relaxed


def _unrestricted_relaxed_density(P_unrelaxed, amp_weights, g, ERI_SO, epsilons,
                                  o, v, n_occ, n_virt, calculation):
    """Spin-orbital Z-vector MP2 density; g is the antisymmetrised
    physicists' tensor."""
    w = amp_weights
    oa = slice(0, n_occ)

    L_active = torch.tensordot(w, g[v, o, v, v], dims=([1, 2, 3], [1, 2, 3]))
    L_hole = torch.tensordot(w, g[o, o, oa, v], dims=([0, 1, 3], [0, 1, 3]))
    L = torch.zeros((n_occ, n_virt), dtype=w.dtype, device=w.device)
    L[o, :] += L_active
    L = L - L_hole.T

    P_relaxed = _frozen_core_rotation(P_unrelaxed.clone(), w, g, epsilons, o, v,
                                      spin_adapted=False)

    g_response = ERI_SO - calculation.HFX_prop * ERI_SO.transpose(2, 3)
    L_fock = 2.0 * torch.tensordot(g_response[v, :, oa, :], P_relaxed,
                                   dims=([1, 3], [0, 1])).T

    apb = rpa.spin_orbital_apb(g_response, epsilons, oa, v)
    del g_response
    z = rpa.zvector_solve(apb, L + L_fock)
    P_relaxed[oa, v] += 0.5 * z
    P_relaxed[v, oa] += 0.5 * z.T
    return P_relaxed


# ---------------------------------------------------------------------------
# Restricted MP2
# ---------------------------------------------------------------------------

def _restricted_mp2_core(g_ijab, e_ijab):
    """MP2 energies and unrelaxed density blocks."""
    g_asym = g_ijab - g_ijab.transpose(2, 3)
    E_OS = torch.sum(g_ijab * g_ijab * e_ijab)
    E_SS = torch.sum(g_ijab * g_asym * e_ijab)
    t_OS = -2.0 * g_ijab * e_ijab
    t_SS = g_asym * e_ijab
    oo_OS = -0.5 * torch.einsum("kiab,kjab->ij", t_OS, t_OS)
    vv_OS = 0.5 * torch.einsum("ijbc,ijac->ab", t_OS, t_OS)
    oo_SS = -torch.einsum("kiab,kjab->ij", t_SS, t_SS)
    vv_SS = torch.einsum("ijbc,ijac->ab", t_SS, t_SS)
    return E_OS, E_SS, oo_OS, vv_OS, oo_SS, vv_SS


def run_restricted_MP2(ERI_MO, epsilons, molecular_orbitals, o, v, X, calculation,
                       molecule, S=None, silent=False):
    natural_occ, naturals = None, None
    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)

    same_spin_scale = opposite_spin_scale = 1.0
    do_scs = _spin_component_scaling_active(calculation)

    log_spacer(calculation, silent=silent, start="\n")
    log("                MP2 Energy and Density ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Calculating MP2 correlation energy... ", calculation, 1, end="", silent=silent)

    ERI_phys = transforms.chemists_to_physicists(ERI_MO)
    g_ijab = ERI_phys[o, o, v, v]
    E_OS_t, E_SS_t, oo_OS, vv_OS, oo_SS, vv_SS = _restricted_mp2_core(g_ijab, e_ijab)
    E_MP2_OS, E_MP2_SS = float(E_OS_t), float(E_SS_t)
    log("     [Done]\n", calculation, 1, silent=silent)

    if do_scs:
        _log_scs(calculation, silent)
        E_MP2_SS *= calculation.same_spin_scaling
        E_MP2_OS *= calculation.opposite_spin_scaling
        same_spin_scale = calculation.same_spin_scaling
        opposite_spin_scale = calculation.opposite_spin_scaling

    E_MP2 = E_MP2_SS + E_MP2_OS
    log(f"  Same spin contribution:             {E_MP2_SS:13.10f}", calculation, 1, silent=silent)
    log(f"  Opposite spin contribution:         {E_MP2_OS:13.10f}", calculation, 1, silent=silent)
    log(f"\n  MP2 correlation energy:             {E_MP2:13.10f}", calculation, 1, silent=silent)

    label = "relaxed" if calculation.relaxed_density else "unrelaxed"
    log(f"\n  Constructing MP2 {label} density... ".ljust(41), calculation, 1, end="", silent=silent)

    n_basis = molecule.n_basis
    P_OS = _zeros_like_square(n_basis, g_ijab)
    P_OS[o, o] += oo_OS
    P_OS[v, v] += vv_OS
    P_SS = _zeros_like_square(n_basis, g_ijab)
    P_SS[o, o] += oo_SS
    P_SS[v, v] += vv_SS

    if calculation.relaxed_density:
        w_OS = 2.0 * g_ijab * e_ijab
        w_SS = 2.0 * (g_ijab - g_ijab.transpose(2, 3)) * e_ijab
        n_virt = n_basis - molecule.n_doubly_occ
        P_OS = _restricted_relaxed_density(P_OS, w_OS, ERI_MO, epsilons, o, v,
                                           molecule.n_doubly_occ, n_virt, calculation)
        P_SS = _restricted_relaxed_density(P_SS, w_SS, ERI_MO, epsilons, o, v,
                                           molecule.n_doubly_occ, n_virt, calculation)

    n_doubly_occ = molecule.n_doubly_occ
    P_MO = _zeros_like_square(n_basis, g_ijab)
    P_MO[:n_doubly_occ, :n_doubly_occ] = 2.0 * torch.eye(n_doubly_occ, dtype=P_MO.dtype,
                                                         device=P_MO.device)
    P_MO = P_MO + (opposite_spin_scale * P_OS
                   + same_spin_scale * P_SS) * _double_hybrid_scale(calculation)

    C = molecular_orbitals
    P = C @ P_MO @ C.T
    P_alpha = P_beta = P / 2.0
    log("     [Done]", calculation, 1, silent=silent)

    if calculation.natural_orbitals:
        natural_occ, naturals = print_natural_orbitals(P, X, S, calculation, silent)

    return E_MP2, P, P_alpha, P_beta, natural_occ, naturals


# ---------------------------------------------------------------------------
# Unrestricted MP2
# ---------------------------------------------------------------------------

def run_unrestricted_MP2(molecule, calculation, SCF_output, n_SO, o,
                         ERI_spin_block, X, silent=False, g=None, ERI_SO=None,
                         epsilons_sorted=None, C_spin_block=None, spin_labels=None):
    natural_occ, naturals = None, None

    C_a = SCF_output.molecular_orbitals_alpha
    C_b = SCF_output.molecular_orbitals_beta
    eps_a = torch.sort(SCF_output.epsilons_alpha).values
    eps_b = torch.sort(SCF_output.epsilons_beta).values
    n_occ_a, n_occ_b = molecule.n_alpha, molecule.n_beta

    o_a = slice((o.start + 1) // 2, n_occ_a)
    o_b = slice(o.start // 2, n_occ_b)
    v_a = slice(n_occ_a, n_SO // 2)
    v_b = slice(n_occ_b, n_SO // 2)

    do_scs = _spin_component_scaling_active(calculation)
    same_spin_scale = opposite_spin_scale = 1.0

    log_spacer(calculation, silent=silent, start="\n")
    log("                MP2 Energy and Density ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    # Separate alpha and beta spatial transforms: tuna_tpu's spin-blocked
    # transform with each spin's orbitals alone (its (2N, N) coefficients
    # from spin_block_orbitals over one spin's N orbital energies)
    C_sb_a = transforms.spin_block_orbitals(C_a, C_a, to_numpy(SCF_output.epsilons_alpha))
    C_sb_b = transforms.spin_block_orbitals(C_b, C_b, to_numpy(SCF_output.epsilons_beta))

    ERI_SO_a = transforms.ao_to_so_physicists(ERI_spin_block, C_sb_a, C_sb_a)
    ERI_SO_b = transforms.ao_to_so_physicists(ERI_spin_block, C_sb_b, C_sb_b)
    ERI_SO_ab = transforms.ao_to_so_physicists(ERI_spin_block, C_sb_b, C_sb_a)

    log("  Calculating MP2 correlation energy... ", calculation, 1, end="", silent=silent)

    g_aa = transforms.antisymmetrise(ERI_SO_a[o_a, o_a, v_a, v_a])
    g_bb = transforms.antisymmetrise(ERI_SO_b[o_b, o_b, v_b, v_b])
    g_ab = ERI_SO_ab[o_a, o_b, v_a, v_b]
    del ERI_SO_a, ERI_SO_b, ERI_SO_ab

    e_aa = transforms.doubles_epsilons(eps_a, eps_a, o_a, o_a, v_a, v_a)
    e_bb = transforms.doubles_epsilons(eps_b, eps_b, o_b, o_b, v_b, v_b)
    e_ab = transforms.doubles_epsilons(eps_a, eps_b, o_a, o_b, v_a, v_b)

    t_aa = g_aa * e_aa
    t_bb = g_bb * e_bb
    t_ab = g_ab * e_ab
    t_ba = t_ab.permute(1, 0, 3, 2)

    E_aa = 0.25 * float(torch.sum(t_aa * g_aa))
    E_bb = 0.25 * float(torch.sum(t_bb * g_bb))
    E_ab = float(torch.sum(t_ab * g_ab))

    E_MP2_SS = E_aa + E_bb
    E_MP2_OS = E_ab
    log("     [Done]\n", calculation, 1, silent=silent)

    if do_scs:
        _log_scs(calculation, silent)
        E_MP2_SS *= calculation.same_spin_scaling
        E_MP2_OS *= calculation.opposite_spin_scaling
        same_spin_scale = calculation.same_spin_scaling
        opposite_spin_scale = calculation.opposite_spin_scaling

    E_MP2 = E_MP2_SS + E_MP2_OS
    log(f"  Energy from alpha-alpha pairs:      {E_aa:13.10f}", calculation, 1, silent=silent)
    log(f"  Energy from beta-beta pairs:        {E_bb:13.10f}", calculation, 1, silent=silent)
    log(f"  Energy from alpha-beta pairs:       {E_ab:13.10f}", calculation, 1, silent=silent)
    log(f"\n  Same spin contribution:             {E_MP2_SS:13.10f}", calculation, 1, silent=silent)
    log(f"  Opposite spin contribution:         {E_MP2_OS:13.10f}", calculation, 1, silent=silent)
    log(f"\n  MP2 correlation energy:             {E_MP2:13.10f}", calculation, 1, silent=silent)

    label = "relaxed" if calculation.relaxed_density else "unrelaxed"
    log(f"\n  Constructing MP2 {label} density... ".ljust(41), calculation, 1, end="", silent=silent)

    n = n_SO // 2
    eye = torch.eye(n, dtype=C_a.dtype, device=C_a.device)
    P_a_MO = _zeros_like_square(n, C_a)
    P_a_MO[:n_occ_a, :n_occ_a] = eye[:n_occ_a, :n_occ_a]
    P_b_MO = _zeros_like_square(n, C_a)
    P_b_MO[:n_occ_b, :n_occ_b] = eye[:n_occ_b, :n_occ_b]

    P_aa = _t_amplitude_density_contribution(n, t_aa, o_a, v_a)
    P_ab = _t_amplitude_density_contribution(n, t_ab, o_a, v_a)
    P_bb = _t_amplitude_density_contribution(n, t_bb, o_b, v_b)
    P_ba = _t_amplitude_density_contribution(n, t_ba, o_b, v_b)

    double_hybrid_scale = _double_hybrid_scale(calculation)
    P_a_MO = P_a_MO + (same_spin_scale * P_aa + opposite_spin_scale * 2 * P_ab) * double_hybrid_scale
    P_b_MO = P_b_MO + (same_spin_scale * P_bb + opposite_spin_scale * 2 * P_ba) * double_hybrid_scale

    P_alpha = C_a @ P_a_MO @ C_a.T
    P_beta = C_b @ P_b_MO @ C_b.T
    P = P_alpha + P_beta

    if calculation.relaxed_density:
        v_full = slice(molecule.n_occ, None)
        n_occ, n_virt = molecule.n_occ, n_SO - molecule.n_occ
        e_ijab = transforms.doubles_epsilons(epsilons_sorted, epsilons_sorted, o, o,
                                             v_full, v_full)
        t_ijab = g[o, o, v_full, v_full] * e_ijab
        spins_occupied = np.array(spin_labels)[o]
        pair_scaling = np.where(spins_occupied[:, None] == spins_occupied[None, :],
                                same_spin_scale, opposite_spin_scale)
        w_ijab = (t_ijab * torch.as_tensor(pair_scaling, dtype=t_ijab.dtype,
                                           device=t_ijab.device)[:, :, None, None]
                  * double_hybrid_scale)

        P_SO = _zeros_like_square(n_SO, t_ijab)
        P_SO[o, o] -= 0.5 * torch.einsum("jkab,ikab->ij", w_ijab, t_ijab)
        P_SO[v_full, v_full] += 0.5 * torch.einsum("ijac,ijbc->ab", w_ijab, t_ijab)
        P_SO = _unrestricted_relaxed_density(P_SO, w_ijab, g, ERI_SO, epsilons_sorted,
                                             o, v_full, n_occ, n_virt, calculation)
        P_SO[:n_occ, :n_occ] += torch.eye(n_occ, dtype=P_SO.dtype, device=P_SO.device)
        P, P_alpha, P_beta = transforms.density_so_to_ao(P_SO, C_spin_block, n_SO)

    log("     [Done]", calculation, 1, silent=silent)

    if calculation.natural_orbitals:
        natural_occ, naturals = print_natural_orbitals(P, X, SCF_output.S, calculation, silent)

    return E_MP2, P, P_alpha, P_beta, natural_occ, naturals


# ---------------------------------------------------------------------------
# MP3
# ---------------------------------------------------------------------------

def _mp3_doubles_terms(t_ijab, g, L, o, v):
    """The doubles contractions MP3's X and MP4's D channel share."""
    X = (0.5 * torch.einsum("ijcd,acbd->ijab", t_ijab, g[v, v, v, v])
         + 0.5 * torch.einsum("klab,kilj->ijab", t_ijab, g[o, o, o, o]))
    X += (torch.einsum("ikac,bjkc->ijab", t_ijab, L[v, o, o, v])
          - torch.einsum("kjac,bcki->ijab", t_ijab, g[v, v, o, o])
          - torch.einsum("kiac,bjkc->ijab", t_ijab, g[v, o, o, v]))
    return X


def _restricted_mp3_core(g, e_ijab, o, v):
    """MP3: amplitudes, multipliers and the third-order energy over the
    correlated occupied orbitals o and the virtual orbitals v of g.
    tuna_tpu takes o as the first n_occ orbitals of g, which under
    FREEZECORE are not the correlated ones (its MP3 and MP4 then fail on
    mismatched shapes)."""
    L = 2 * g - g.permute(0, 3, 2, 1)
    t_ijab = e_ijab * g[v, o, v, o].permute(1, 3, 0, 2)
    t_dash_ijab = 2 * e_ijab * L[o, v, o, v].permute(0, 2, 1, 3)
    X_ijab = _mp3_doubles_terms(t_ijab, g, L, o, v)
    E_MP3 = torch.sum(t_dash_ijab * X_ijab)
    return E_MP3, e_ijab, t_ijab, t_dash_ijab, L


def _log_scs_mp3(calculation, E_MP3, E_MP2, silent):
    log(f"\n  Scaling for MP3: {calculation.MP3_scaling:.3f}\n", calculation, 1, silent=silent)
    log(f"  Scaled MP3 correlation energy:    {E_MP3:15.10f}", calculation, 1, silent=silent)
    log(f"  SCS-MP3 correlation energy:       {(E_MP3 + E_MP2):15.10f}", calculation, 1, silent=silent)


def run_restricted_MP3(calculation, ERI_MO, epsilons, E_MP2, o, v, silent=False):
    log_spacer(calculation, silent=silent, start="\n")
    log("                      MP3 Energy  ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Calculating amplitudes and multipliers...  ", calculation, 1, end="", silent=silent)

    g = ERI_MO  # chemists' notation throughout (Helgaker convention)
    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    E_MP3_t, e_ijab, t_ijab, t_dash_ijab, L = _restricted_mp3_core(g, e_ijab, o, v)
    log("[Done]", calculation, 1, silent=silent)
    log("  Calculating MP3 correlation energy...      ", calculation, 1, end="", silent=silent)
    E_MP3 = float(E_MP3_t)
    log(f"[Done]\n\n  MP3 correlation energy:             {E_MP3:13.10f}",
        calculation, 1, silent=silent)

    if calculation.method.name == "SCS-MP3":
        E_MP3 *= calculation.MP3_scaling
        _log_scs_mp3(calculation, E_MP3, E_MP2, silent)

    return E_MP3, e_ijab, t_ijab, t_dash_ijab, L


def _unrestricted_mp3_energy(g, e_ijab, o, v):
    """The three terms of tuna_tpu's five-operand UMP3 einsums, pairwise:
    each contracts the first amplitude t = <ij||ab> e_ijab with one block,
    then takes the dot product with the second amplitude."""
    t = g[o, o, v, v] * e_ijab
    # "ijab,klij,abkl,ijab,klab->": sum_ijab t_ijab <kl||ij>, then . t_klab
    X = torch.einsum("ijab,klij->klab", t, g[o, o, o, o])
    E = 0.125 * torch.sum(X * (g[v, v, o, o] * e_ijab.permute(2, 3, 0, 1)).permute(2, 3, 0, 1))
    # "ijab,abcd,cdij,ijab,ijcd->": sum_ab t_ijab <ab||cd>, then . t_ijcd
    X = torch.einsum("ijab,abcd->ijcd", t, g[v, v, v, v])
    E = E + 0.125 * torch.sum(X * g[v, v, o, o].permute(2, 3, 0, 1) * e_ijab)
    # "ijab,kbcj,acik,ijab,ikac->": sum_jb t_ijab <kb||cj>, then . t_ikac
    X = torch.einsum("ijab,kbcj->iakc", t, g[o, v, v, o])
    E = E + torch.sum(X * (g[v, v, o, o].permute(2, 3, 0, 1) * e_ijab).permute(0, 2, 1, 3))
    return E


def run_unrestricted_MP3(calculation, g, epsilons_sorted, E_MP2, o, v, silent=False):
    log_spacer(calculation, silent=silent, start="\n")
    log("                      MP3 Energy  ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    e_ijab = transforms.doubles_epsilons(epsilons_sorted, epsilons_sorted, o, o, v, v)
    log("  Calculating MP3 correlation energy...      ", calculation, 1, end="", silent=silent)
    E_MP3 = float(_unrestricted_mp3_energy(g, e_ijab, o, v))
    log(f"[Done]\n\n  MP3 correlation energy:             {E_MP3:13.10f}",
        calculation, 1, silent=silent)

    if calculation.method.name == "SCS-MP3":
        E_MP3 *= calculation.MP3_scaling
        _log_scs_mp3(calculation, E_MP3, E_MP2, silent)

    return E_MP3


# ---------------------------------------------------------------------------
# MP4
# ---------------------------------------------------------------------------

# tuna_tpu's _permute_three_columns: the six simultaneous permutations of
# (i, j, k) and (a, b, c), in its order of summation
_THREE_COLUMN_PERMUTATIONS = ((0, 2, 1, 3, 5, 4), (1, 0, 2, 4, 3, 5), (1, 2, 0, 4, 5, 3),
                              (2, 0, 1, 5, 3, 4), (2, 1, 0, 5, 4, 3))


def second_order_triples_amplitudes(e_ijkabc, t_ijab, g, o, v):
    """Second-order restricted triples amplitudes, used by MP4 (and CC3 in
    tuna_tpu).  The six permutations are summed into one o^3 v^3 array, in
    place, in tuna_tpu's order."""
    t = torch.einsum("ijad,ckbd->ijkabc", t_ijab, g[v, o, v, v])
    t -= torch.einsum("ilab,cklj->ijkabc", t_ijab, g[v, o, o, o])
    out = t.clone()
    for permutation in _THREE_COLUMN_PERMUTATIONS:
        out += t.permute(permutation)
    del t
    out *= e_ijkabc
    return out


def _restricted_mp4_core(g, e_ijab, t_ijab, t_dash_ijab, L, epsilons, o, v,
                         with_singles, with_triples):
    """Fourth-order energy components (S, D, T, Q channels), over the
    orbitals o and v as _restricted_mp3_core."""
    zero = torch.zeros((), dtype=t_ijab.dtype, device=t_ijab.device)

    second_t2 = (-torch.einsum("ijcd,acbd->ijab", t_ijab, g[v, v, v, v])
                 - torch.einsum("klab,kilj->ijab", t_ijab, g[o, o, o, o]))
    # tuna_tpu forms the o^3 v^3 "inner" and sums it over k and c; the sum
    # is the same three contractions over k and c, without the array
    inner = (torch.einsum("ikac,bjkc->ijab", t_ijab, L[v, o, o, v])
             - torch.einsum("kjac,bcki->ijab", t_ijab, g[v, v, o, o])
             - torch.einsum("kiac,bjkc->ijab", t_ijab, g[v, o, o, v]))
    second_t2 += -(inner + inner.permute(1, 0, 3, 2))
    second_t2 = -second_t2 * e_ijab

    E_S = zero
    if with_singles:
        e_ia = transforms.singles_epsilons(epsilons, o, v)
        second_t1 = (torch.einsum("klad,kild->ia", t_ijab, L[o, o, o, v])
                     - torch.einsum("kicd,adkc->ia", t_ijab, L[v, v, o, v]))
        second_t1 = -second_t1 * e_ia
        S_channel = (torch.einsum("jc,aibc->ijab", second_t1, g[v, o, v, v])
                     - torch.einsum("kb,aikj->ijab", second_t1, g[v, o, o, o]))
        E_S = torch.sum(t_dash_ijab * S_channel)

    D_channel = _mp3_doubles_terms(second_t2, g, L, o, v)
    E_D = torch.sum(t_dash_ijab * D_channel)

    E_T = zero
    if with_triples:
        e_ijkabc = transforms.triples_epsilons(epsilons, o, v)
        second_t3 = second_order_triples_amplitudes(e_ijkabc, t_ijab, g, o, v)
        del e_ijkabc
        T_channel = (torch.einsum("ijkacd,bckd->ijab", second_t3, L[v, v, o, v])
                     - torch.einsum("kjiacd,kdbc->ijab", second_t3, g[o, v, v, v]))
        T_channel += (-torch.einsum("iklabc,kjlc->ijab", second_t3, L[o, o, o, v])
                      + torch.einsum("lkiabc,kjlc->ijab", second_t3, g[o, o, o, v]))
        del second_t3
        E_T = torch.sum(t_dash_ijab * T_channel)

    g_ovov, L_ovov = g[o, v, o, v], L[o, v, o, v]
    Q_channel = 0.5 * torch.einsum("klab,ijkl->ijab", t_ijab,
                                   torch.einsum("ijcd,kcld->ijkl", t_ijab, g_ovov))
    Q_channel += torch.einsum("ikac,jkbc->ijab", t_ijab,
                              torch.einsum("jlbd,kcld->jkbc", t_ijab - t_ijab.transpose(0, 1),
                                           L_ovov))
    Q_channel += 0.5 * torch.einsum("kiac,jkbc->ijab", t_ijab,
                                    torch.einsum("ljbd,kcld->jkbc", t_ijab, g_ovov))
    Q_channel += 0.5 * torch.einsum("kjad,ikbd->ijab", t_ijab,
                                    torch.einsum("libc,kcld->ikbd", t_ijab, g_ovov))
    Q_channel += -torch.einsum("ikab,jk->ijab", t_ijab,
                               torch.einsum("ljcd,lckd->jk", t_ijab, L_ovov))
    Q_channel += -torch.einsum("ijac,bc->ijab", t_ijab,
                               torch.einsum("klbd,kcld->bc", t_ijab, L_ovov))
    E_Q = torch.sum(t_dash_ijab * Q_channel)
    return E_S, E_D, E_T, E_Q


def run_restricted_MP4(e_ijab, t_ijab, t_dash_ijab, L, ERI_MO, epsilons, o, v,
                       calculation, silent=False):
    name = calculation.method.name

    log_spacer(calculation, silent=silent, start="\n")
    log("                      MP4 Energy  ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Calculating amplitudes and multipliers...  ", calculation, 1, end="", silent=silent)
    log("[Done]", calculation, 1, silent=silent)
    log("  Calculating MP4 correlation energy...      ", calculation, 1, end="", silent=silent)

    with_singles = name not in ("MP4[DQ]", "MP4(DQ)")
    with_triples = name in ("MP4", "MP4[SDTQ]", "MP4(SDTQ)")
    E_S, E_D, E_T, E_Q = _restricted_mp4_core(
        ERI_MO, e_ijab, t_ijab, t_dash_ijab, L, epsilons, o, v, with_singles, with_triples)
    E_MP4_S, E_MP4_D, E_MP4_T, E_MP4_Q = (float(E_S), float(E_D), float(E_T), float(E_Q))
    E_MP4 = E_MP4_S + E_MP4_D + E_MP4_T + E_MP4_Q
    log("[Done]\n", calculation, 1, silent=silent)

    if name in ("MP4[SDQ]", "MP4(SDQ)"):
        log("  Triples are not included in MP4(SDQ).\n", calculation, 1, silent=silent)
    elif name in ("MP4[DQ]", "MP4(DQ)"):
        log("  Singles and triples are not included in MP4(DQ).\n", calculation, 1, silent=silent)
    else:
        log("  Triples are included in full MP4.\n", calculation, 1, silent=silent)

    log(f"  Singles correlation energy:         {E_MP4_S:13.10f}", calculation, 2, silent=silent)
    log(f"  Doubles correlation energy:         {E_MP4_D:13.10f}", calculation, 2, silent=silent)
    log(f"  Triples correlation energy:         {E_MP4_T:13.10f}", calculation, 2, silent=silent)
    log(f"  Quadruples correlation energy:      {E_MP4_Q:13.10f}", calculation, 2, silent=silent)
    log(f"\n  MP4 correlation energy:             {E_MP4:13.10f}", calculation, 1, silent=silent)
    return E_MP4


# ---------------------------------------------------------------------------
# Laplace-transform AO-MP2
# ---------------------------------------------------------------------------

def run_restricted_laplace_MP2(integrals, F, calculation, P, silent=False):
    """Euler-Maclaurin-B Laplace AO-MP2.  tuna_tpu takes its matrix
    exponentials on the host (the TPU lacks float64 LU); here
    torch.linalg.matrix_exp runs on the tensors' device."""
    P = P / 2.0
    log_spacer(calculation, silent=silent, start="\n")
    log("          Laplace Transform AO-MP2 Energy", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    log("  Constructing hole density matrix...        ", calculation, 1, end="", silent=silent)
    _, _, S_inverse = linalg.inverse_sqrt(integrals.S)
    Q = S_inverse - P
    log("[Done]", calculation, 1, silent=silent)

    tau = calculation.num_laplace_points
    pad = "" if tau > 9 else " "
    log(f"\n  Building {tau} point integration grid...      {pad}", calculation, 1,
        end="", silent=silent)

    k = np.arange(1, tau + 1)
    r = k / (tau + 1)
    s = (r**3 - 0.9 * r**4) / (1 - r) ** 2 + r**2 * np.tan(np.pi * r / 2)
    ds_dr = -r / (1 - r) ** 3 * (
        r * (-1.8 * r**2 + 4.6 * r - 3)
        + 2 * (r - 1) ** 3 * np.tan(np.pi * r / 2)
        + np.pi / 2 * r * (r - 1) ** 3 * (1 / np.cos(np.pi * r / 2) ** 2))

    ERI = integrals.ERI_AO
    L_AO = 2 * ERI - ERI.transpose(1, 3)
    log("[Done]", calculation, 1, silent=silent)

    total = 0.0
    for i in range(len(s)):
        log(f"\n   ~~~~~ Grid Point {i + 1} of {len(s)}  ~~~~~ ", calculation, 1, silent=silent)
        log("\n   Building energy-weighted densities...     ", calculation, 1, end="", silent=silent)
        Xm = torch.linalg.matrix_exp(float(s[i]) * P @ F) @ P
        Ym = torch.linalg.matrix_exp(-float(s[i]) * Q @ F) @ Q
        log("[Done]", calculation, 1, silent=silent)
        log("   Calculating energy components...          ", calculation, 1, end="", silent=silent)
        L1 = torch.tensordot(Xm, L_AO, dims=([0], [0]))
        L2 = torch.tensordot(Ym, L1, dims=([0], [1]))
        L3 = torch.tensordot(Xm, L2, dims=([1], [2]))
        L4 = torch.tensordot(Ym, L3, dims=([1], [3]))
        e = float(torch.tensordot(L4, ERI, dims=([0, 1, 2, 3], [3, 2, 1, 0])))
        log("[Done]", calculation, 1, silent=silent)
        total += e * ds_dr[i]

    log("\n  Integrating MP2 energy...                  ", calculation, 1, end="", silent=silent)
    E_MP2 = float(-total / (tau + 1))
    log("[Done]", calculation, 1, silent=silent)
    log(f"\n  MP2 correlation energy:           {E_MP2:15.10f}", calculation, 1, silent=silent)
    return E_MP2


# ---------------------------------------------------------------------------
# Iterative (Hylleraas) MP2
# ---------------------------------------------------------------------------

def _log_step_table_head(calculation, silent):
    log_spacer(calculation, silent=silent, start="\n")
    log("  Step          Correlation E               DE", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)


def _log_step(step, E, dE, calculation, silent):
    log(f"  {step:3.0f}           {E:13.10f}         {dE:13.10f}", calculation, 1, silent=silent)


def _sandwich(A, t, B):
    """einsum("ap,ijpq,qb->ijab", A, t, B), pairwise."""
    return torch.einsum("ap,ijpb->ijab", A, torch.einsum("ijpq,qb->ijpb", t, B))


def _imp2_residual(g_oovv, Fvv, Foo, Svv, t_ijab):
    R = g_oovv + _sandwich(Fvv, t_ijab, Svv)
    R += _sandwich(Svv, t_ijab, Fvv)
    # "ap,ik,kjpq,qb->ijab" and "ap,kj,ikpq,qb->ijab"
    sandwiched = _sandwich(Svv, t_ijab, Svv)
    R += -torch.einsum("ik,kjab->ijab", Foo, sandwiched)
    R += -torch.einsum("kj,ikab->ijab", Foo, sandwiched)
    return R


def run_iterative_restricted_MP2(ERI_MO, epsilons, molecular_orbitals, o, v,
                                 n_doubly_occ, X, integrals, calculation,
                                 SCF_output, silent=False):
    from ..scf import (coulomb_matrix, density_matrix, diagonalise_fock, exchange_matrix,
                       symmetrise)

    g = transforms.chemists_to_physicists(ERI_MO)

    C = molecular_orbitals
    P_AO = density_matrix(C, n_doubly_occ, 2)
    F_AO = symmetrise(integrals.H_core + integrals.G + coulomb_matrix(P_AO, integrals.ERI_AO)
                      - 0.5 * exchange_matrix(P_AO, integrals.ERI_AO))

    S_MO = C.T @ SCF_output.S @ C
    F_MO = C.T @ F_AO @ C
    epsilons, _ = diagonalise_fock(F_AO, X)
    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)

    E_conv = calculation.energy_convergence
    max_iter = int(calculation.correlated_max_iter)

    log_spacer(calculation, silent=silent, start="\n")
    log("           Iterative MP2 Energy and Density ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log(f"\n  Tolerance for energy convergence:    {E_conv:.10f}", calculation, 1, silent=silent)
    log("\n  Starting MP2 iterations...\n", calculation, 1, end="", silent=silent)
    _log_step_table_head(calculation, silent)

    g_oovv = g[o, o, v, v]
    Fvv, Foo, Svv = F_MO[v, v], F_MO[o, o], S_MO[v, v]

    E = 0.0
    t_ijab = torch.zeros_like(g_oovv)
    converged = False
    step_seconds = []
    for step in range(1, max_iter + 1):
        start = time.perf_counter()
        R = _imp2_residual(g_oovv, Fvv, Foo, Svv, t_ijab)
        t_ijab = t_ijab + R * e_ijab
        E_new = float(0.5 * torch.sum(torch.einsum(
            "ijab,ijab->ij", g_oovv + R, 4 * t_ijab - 2 * t_ijab.transpose(0, 1))))
        dE = abs(E_new - E)
        E = E_new
        step_seconds.append(time.perf_counter() - start)
        _log_step(step, E, dE, calculation, silent)
        if dE < E_conv:
            converged = True
            break
    SCF_output.correlation_iteration_seconds = step_seconds
    if not converged:
        error("Iterative MP2 failed to converge! Try increasing the maximum iterations?")
    E_MP2 = E

    log_spacer(calculation, silent=silent)
    log(f"\n  MP2 correlation energy:             {E_MP2:.10f}", calculation, 1, silent=silent)
    log("\n  Constructing MP2 unrelaxed density...", calculation, 1, end="", silent=silent)

    n = F_MO.shape[0]
    P_MO = _zeros_like_square(n, F_MO)
    P_MO[:n_doubly_occ, :n_doubly_occ] = 2 * torch.eye(n_doubly_occ, dtype=F_MO.dtype,
                                                       device=F_MO.device)
    P_MO[o, o] += -2 * torch.einsum("ikab,kjab->ij", t_ijab, t_ijab)
    P_MO[v, v] += 2 * torch.einsum("ijac,ijcb->ab", t_ijab, t_ijab)
    P = C @ P_MO @ C.T
    P_alpha = P_beta = P / 2
    log("      [Done]", calculation, 1, silent=silent)

    natural_occ, naturals = (print_natural_orbitals(P, X, SCF_output.S, calculation, silent)
                             if calculation.natural_orbitals else (None, None))
    return E_MP2, P, P_alpha, P_beta, natural_occ, naturals


# ---------------------------------------------------------------------------
# Orbital-optimised MP2
# ---------------------------------------------------------------------------

def _omp2_step(C, t_abij, ERI_sb, H_sb, P_ref, o, v, o_full, n_SO):
    """One orbital-optimised MP2 step: the amplitudes, densities and energy
    at orbitals C, and the rotated orbitals.  Returns (C_new, t_new, P_corr,
    the one- and two-electron energies)."""
    H_core_SO = transforms.transform_matrix_ao_to_so(H_sb, C)
    g = transforms.antisymmetrise(transforms.ao_to_so_physicists(ERI_sb, C, C))
    F = transforms.spin_orbital_fock(H_core_SO, g, o_full)
    F_prime = F - torch.diag(torch.diagonal(F))
    epsilons = torch.diagonal(F)

    t_1 = g[v, v, o, o]
    t_2 = torch.einsum("ac,cbij->abij", F_prime[v, v], t_abij)
    t_3 = torch.einsum("ki,abkj->abij", F_prime[o, o], t_abij)
    t_new = t_1 + t_2 - t_2.permute(1, 0, 2, 3) - t_3 + t_3.permute(0, 1, 3, 2)
    e_abij = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v).permute(2, 3, 0, 1)
    t_new = t_new * e_abij

    P_corr = _t_amplitude_density_contribution(n_SO, t_new.permute(2, 3, 0, 1), o, v)
    P_OMP2 = P_corr + P_ref

    D_corr = torch.zeros((n_SO,) * 4, dtype=C.dtype, device=C.device)
    D_corr[v, v, o, o] = t_new
    D_corr[o, o, v, v] = t_new.permute(2, 3, 0, 1)
    D_2 = torch.einsum("rp,sq->rspq", P_corr, P_ref)
    D_3 = torch.einsum("rp,sq->rspq", P_ref, P_ref)
    D = (D_corr + D_2 - D_2.permute(1, 0, 2, 3) - D_2.permute(0, 1, 3, 2)
         + D_2.permute(1, 0, 3, 2) + D_3 - D_3.permute(1, 0, 2, 3))

    F_gen = H_core_SO @ P_OMP2 + 0.5 * torch.einsum("prst,stqr->pq", g, D)

    R = torch.zeros((n_SO, n_SO), dtype=C.dtype, device=C.device)
    R[v, o] = (F_gen - F_gen.T)[v, o] / (epsilons[None, o] - epsilons[v, None])
    C_new = C @ linalg.expm_skew(R - R.T)

    return C_new, t_new, P_corr, (torch.sum(P_OMP2 * H_core_SO), 0.25 * torch.sum(D * g))


def run_orbital_optimised_MP2(molecule, calculation, C_spin_block, H_core, V_NN,
                              n_SO, X, S, E_HF, ERI_spin_block, o, v, SCF_output,
                              silent=False):
    n_occ = molecule.n_occ

    log_spacer(calculation, silent=silent, start="\n")
    log("      Orbital-optimised MP2 Energy and Density ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log(f"\n  Tolerance for energy convergence:    {calculation.energy_convergence:.10f}",
        calculation, 1, silent=silent)
    log("\n  Starting orbital-optimised MP2 iterations...\n", calculation, 1, end="", silent=silent)
    _log_step_table_head(calculation, silent)

    H_core_sb = transforms.spin_block_matrix(H_core)
    P_ref = _zeros_like_square(n_SO, H_core)
    P_ref[:n_occ, :n_occ] = torch.eye(n_occ, dtype=H_core.dtype, device=H_core.device)
    n_occ_corr = n_occ - molecule.n_core_spin_orbitals if calculation.freeze_core else n_occ
    o_full = slice(0, n_occ)
    max_iter = int(calculation.correlated_max_iter)
    E_conv = calculation.energy_convergence

    C = C_spin_block
    t_abij = torch.zeros((molecule.n_virt, molecule.n_virt, n_occ_corr, n_occ_corr),
                         dtype=C.dtype, device=C.device)
    E_old = 0.0
    converged = False
    step_seconds = []
    for step in range(1, max_iter + 1):
        start = time.perf_counter()
        C, t_abij, P_corr, (E_one, E_two) = _omp2_step(C, t_abij, ERI_spin_block, H_core_sb,
                                                       P_ref, o, v, o_full, n_SO)
        # tuna_tpu's order of summation: (V_NN + E_one + E_two) - E_HF
        E_OMP2 = float(V_NN) + float(E_one) + float(E_two) - float(E_HF)
        dE = E_OMP2 - E_old
        E_old = E_OMP2
        step_seconds.append(time.perf_counter() - start)
        _log_step(step, E_OMP2, dE, calculation, silent)
        if abs(dE) < E_conv:
            converged = True
            break
    SCF_output.correlation_iteration_seconds = step_seconds
    if not converged:
        error("Orbital-optimised MP2 failed to converge! Try increasing the maximum iterations?")

    log_spacer(calculation, silent=silent)
    log(f"\n  OMP2 correlation energy:            {E_OMP2:.10f}", calculation, 1, silent=silent)

    natural_occ, naturals = None, None
    P_OMP2_final = P_corr + P_ref
    P, P_alpha, P_beta = transforms.density_so_to_ao(P_OMP2_final, C, n_SO)
    if calculation.natural_orbitals:
        # tuna_tpu hands None for S here, which its natural-orbital routine
        # cannot multiply; the overlap matrix is what it means
        natural_occ, naturals = print_natural_orbitals(P, X, S, calculation, silent)
    return E_OMP2, P, P_alpha, P_beta, natural_occ, naturals


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_perturbation_theory_calculation(method, molecule, SCF_output, integrals,
                                        calculation, V_NN, silent=False):
    E_MP2 = E_MP3 = E_MP4 = 0.0
    P, P_alpha, P_beta = SCF_output.P, SCF_output.P_alpha, SCF_output.P_beta
    n_SO = molecule.n_SO
    X = SCF_output.X
    natural_occ, naturals = None, None

    if calculation.reference == "UHF" or method.name == "OMP2":
        if not calculation.method.unrestricted_available:
            error("This electronic structure method is unavailable for unrestricted calculations!")
        (g, C_spin_block, epsilons_sorted, o, v, spin_labels, _, ERI_spin_block,
         ERI_SO) = transforms.begin_spin_orbital_calculation(
            molecule, integrals.ERI_AO, SCF_output, calculation, silent=silent,
            keep_tensors=True)
    else:
        ERI_MO, molecular_orbitals, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
            molecule, integrals.ERI_AO, SCF_output, calculation, silent=silent)

    timer("MP2", 0)
    if method.name == "OMP2":
        del g, ERI_SO
        E_MP2, P, P_alpha, P_beta, natural_occ, naturals = run_orbital_optimised_MP2(
            molecule, calculation, C_spin_block, integrals.H_core, V_NN, n_SO,
            X, SCF_output.S, SCF_output.energy, ERI_spin_block, o, v, SCF_output,
            silent=silent)
        timer("MP2", 1)
    elif method.name == "IMP2":
        E_MP2, P, P_alpha, P_beta, natural_occ, naturals = run_iterative_restricted_MP2(
            ERI_MO, epsilons, molecular_orbitals, o, v, molecule.n_doubly_occ, X,
            integrals, calculation, SCF_output, silent=silent)
        timer("MP2", 1)
    elif method.name in ("LMP2", "AO-MP2"):
        E_MP2 = run_restricted_laplace_MP2(integrals, SCF_output.F, calculation,
                                           SCF_output.P, silent=silent)
        timer("MP2", 1)
    else:
        if calculation.reference == "UHF":
            E_MP2, P, P_alpha, P_beta, natural_occ, naturals = run_unrestricted_MP2(
                molecule, calculation, SCF_output, n_SO, o, ERI_spin_block, X,
                silent=silent, g=g, ERI_SO=ERI_SO, epsilons_sorted=epsilons_sorted,
                C_spin_block=C_spin_block, spin_labels=spin_labels)
            del ERI_spin_block, ERI_SO
        else:
            E_MP2, P, P_alpha, P_beta, natural_occ, naturals = run_restricted_MP2(
                ERI_MO, epsilons, molecular_orbitals, o, v, X, calculation,
                molecule, S=SCF_output.S, silent=silent)
        timer("MP2", 1)

        if method.method_base in ("MP3", "MP4"):
            timer("MP3", 0)
            if calculation.reference == "UHF":
                E_MP3 = run_unrestricted_MP3(calculation, g, epsilons_sorted, E_MP2,
                                             o, v, silent=silent)
            else:
                E_MP3, e_ijab, t_ijab, t_dash_ijab, L = run_restricted_MP3(
                    calculation, ERI_MO, epsilons, E_MP2, o, v, silent=silent)
            timer("MP3", 1)

            if method.method_base == "MP4":
                timer("MP4", 0)
                E_MP4 = run_restricted_MP4(e_ijab, t_ijab, t_dash_ijab, L, ERI_MO,
                                           epsilons, o, v, calculation, silent=silent)
                timer("MP4", 1)

    log_spacer(calculation, silent=silent)
    return E_MP2, E_MP3, E_MP4, P, P_alpha, P_beta, natural_occ, naturals
