"""Orbital-basis transformations for correlated methods.

Twin of tuna_tpu/post/transforms.py: the AO ERI tensor is stored in
chemists' notation (mn|kl); `ao_to_mo_chemists` returns (pq|rs);
physicists' <pq|rs> = chemists (pr|qs).  The spin-orbital half serves UHF
references: spin orbitals are the alpha and beta orbitals in one list
sorted by energy, and `ao_to_so_physicists` transforms the spin-blocked AO
tensor.  Under DIRECT no AO tensor is stored: `transform_direct_mo_chemists`
builds (pq|rs), and `transform_direct_so_physicists` the spin-orbital
<pq|rs>, from the packed pair matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..drivers import common
from ..ops import motransform
from ..output import error, log, timer


def ao_to_mo_chemists(ERI_AO, C):
    """(mn|kl) -> (pq|rs) over molecular orbitals C."""
    out = ERI_AO
    for _ in range(4):
        out = torch.movedim(torch.tensordot(C.T, out, dims=([1], [0])), 0, 3)
    return out


def ao_to_so_physicists(ERI_spin_block, C1, C2):
    """Spin-blocked AO ERI (chemists) -> physicists' <pq|rs> in the SO basis:
    electron 1 carries (C2 row, C1 column) and electron 2 (C2, C1),
    interleaved (tuna_ci.py:143-193)."""
    temp = torch.einsum("mknl,ls->mnks", ERI_spin_block, C1)
    temp = torch.einsum("mnks,kr->mnrs", temp, C2)
    temp = torch.einsum("mnrs,nq->mqrs", temp, C1)
    return torch.einsum("mqrs,mp->pqrs", temp, C2)


def chemists_to_physicists(ERI):
    """(pq|rs) -> <pr|qs>, a view."""
    return ERI.transpose(1, 2)


def antisymmetrise(ERI_physicists):
    """<pq||rs> = <pq|rs> - <pq|sr>."""
    return ERI_physicists - ERI_physicists.transpose(2, 3)


def spin_block_matrix(M):
    return torch.kron(torch.eye(2, dtype=M.dtype, device=M.device), M)


def spin_block_eri(ERI_AO):
    """Spin-block the chemists' AO ERI (tuna_ci.py:560): element (P, Q, R,
    S) is (pq|rs) when P, Q have one spin and R, S one spin, else 0."""
    eye = torch.eye(2, dtype=ERI_AO.dtype, device=ERI_AO.device)
    return torch.kron(eye, torch.kron(eye, ERI_AO.contiguous()).permute(3, 2, 1, 0).contiguous())


def spin_orbital_order(epsilons_combined):
    """The energy order of the alpha-then-beta orbital energies (host)."""
    return np.argsort(np.asarray(epsilons_combined))


def spin_block_orbitals(C_alpha, C_beta, epsilons_combined):
    """(2N, n_alpha + n_beta) spin-orbital coefficients, alpha rows first,
    columns in the energy order of epsilons_combined."""
    order = torch.as_tensor(spin_orbital_order(epsilons_combined), device=C_alpha.device)
    return torch.block_diag(C_alpha, C_beta)[:, order]


def spin_orbital_fock(H_core_SO, g, o):
    """F_pq = h_pq + sum_i <pi||qi> over the occupied spin orbitals o."""
    return H_core_SO + torch.einsum("piqi->pq", g[:, o, :, o])


def transform_matrix_ao_to_so(M, C):
    return C.T @ M @ C


def density_so_to_ao(P_SO, C_spin_block, n_SO):
    C_alpha = C_spin_block[: n_SO // 2, :]
    C_beta = C_spin_block[n_SO // 2:, :]
    P_alpha = C_alpha @ P_SO @ C_alpha.T
    P_beta = C_beta @ P_SO @ C_beta.T
    return P_alpha + P_beta, P_alpha, P_beta


def transform_direct_mo_chemists(molecule, SCF_output, calculation):
    """Chemists' MO tensor straight from the packed pair sweep, the
    integral-direct correlation path (DIRECT keyword): the dense N^4 AO
    tensor, Cartesian or spherical, is never materialised."""
    plan = common.get_integral_plan(molecule)
    C = SCF_output.molecular_orbitals
    device = C.device
    coords = torch.as_tensor(molecule.coordinates, dtype=C.dtype, device=device)
    if calculation.cartesian_harmonics:
        W = C
    else:
        W = torch.as_tensor(molecule.spherical_transformation, dtype=C.dtype,
                            device=device).T @ C
    n_mo = int(C.shape[1])
    G_pair = plan.eri_pair_packed(coords)
    G_mo = motransform.pair_packed_to_mo(G_pair, plan.tensors(device)["pair_index"],
                                         W.contiguous(), n_mo)
    return motransform.expand_mo_chemists(G_mo, n_mo)


def _assemble_so_physicists(blk_aa, blk_ab, blk_bb, is_alpha, sp):
    """Sorted-basis spin-orbital <pq|rs> from spatial chemists' spin blocks.

    blk_aa, blk_ab and blk_bb are the spatial chemists' tensors (a_s b_s |
    c_t d_t) for (s, t) = (alpha, alpha), (alpha, beta), (beta, beta);
    is_alpha and sp (host arrays) give each energy-sorted spin orbital's
    spin and spatial index.  Chemists' (PQ|RS) is non-zero only for
    same-spin bra and ket pairs, so the tensor is four gathered blocks;
    physicists' <pq|rs> = (pr|qs) matches `ao_to_so_physicists`."""
    device = blk_aa.device
    n = len(is_alpha)
    alpha = torch.as_tensor(np.flatnonzero(is_alpha), device=device)
    beta = torch.as_tensor(np.flatnonzero(~is_alpha), device=device)
    sp_a = torch.as_tensor(sp[is_alpha], device=device)
    sp_b = torch.as_tensor(sp[~is_alpha], device=device)
    E = torch.zeros((n, n, n, n), dtype=blk_aa.dtype, device=device)
    for blk, left, right, sp_left, sp_right in (
            (blk_aa, alpha, alpha, sp_a, sp_a), (blk_ab, alpha, beta, sp_a, sp_b),
            (blk_ab.permute(2, 3, 0, 1), beta, alpha, sp_b, sp_a),
            (blk_bb, beta, beta, sp_b, sp_b)):
        E[left[:, None, None, None], left[None, :, None, None],
          right[None, None, :, None], right[None, None, None, :]] = blk[
            sp_left[:, None, None, None], sp_left[None, :, None, None],
            sp_right[None, None, :, None], sp_right[None, None, None, :]]
    return E.transpose(1, 2)


def transform_direct_so_physicists(molecule, SCF_output, calculation):
    """Spin-orbital <pq|rs> straight from the packed pair sweep (DIRECT):
    the three distinct spatial spin blocks transform off the packed pair
    matrix (K5, the mixed block with alpha coefficients on the left pair and
    beta on the right), and the only (2N)^4 array built is the result."""
    plan = common.get_integral_plan(molecule)
    C_a = SCF_output.molecular_orbitals_alpha
    C_b = SCF_output.molecular_orbitals_beta
    device = C_a.device
    coords = torch.as_tensor(molecule.coordinates, dtype=C_a.dtype, device=device)
    if calculation.cartesian_harmonics:
        W_a, W_b = C_a, C_b
    else:
        T_sph = torch.as_tensor(molecule.spherical_transformation, dtype=C_a.dtype,
                                device=device)
        W_a, W_b = T_sph.T @ C_a, T_sph.T @ C_b
    W_a, W_b = W_a.contiguous(), W_b.contiguous()
    n_mo = int(C_a.shape[1])
    pair_index = plan.tensors(device)["pair_index"]

    G_pair = plan.eri_pair_packed(coords)
    blk_aa = motransform.expand_mo_chemists(
        motransform.pair_packed_to_mo(G_pair, pair_index, W_a, n_mo), n_mo)
    blk_bb = motransform.expand_mo_chemists(
        motransform.pair_packed_to_mo(G_pair, pair_index, W_b, n_mo), n_mo)
    blk_ab = motransform.expand_mo_chemists(
        motransform.pair_packed_to_mo_mixed(G_pair, pair_index, W_a, W_b, n_mo), n_mo)
    del G_pair

    order = spin_orbital_order(SCF_output.epsilons_combined)
    is_alpha = order < n_mo
    sp = np.where(is_alpha, order, order - n_mo)
    return _assemble_so_physicists(blk_aa, blk_ab, blk_bb, is_alpha, sp)


# --- energy denominators ---------------------------------------------------

def singles_epsilons(epsilons, o, v, level_shift=0.0):
    return 1.0 / (epsilons[o, None] - epsilons[None, v] - level_shift)


def doubles_epsilons(eps1, eps2, o1, o2, v1, v2, level_shift=0.0):
    return 1.0 / (eps1[o1, None, None, None] + eps2[None, o2, None, None]
                  - eps1[None, None, v1, None] - eps2[None, None, None, v2]
                  - 2 * level_shift)


def triples_epsilons(epsilons, o, v, level_shift=0.0):
    e_o, e_v = epsilons[o], epsilons[v]
    n = None
    return 1.0 / (e_o[:, n, n, n, n, n] + e_o[n, :, n, n, n, n]
                  + e_o[n, n, :, n, n, n] - e_v[n, n, n, :, n, n]
                  - e_v[n, n, n, n, :, n] - e_v[n, n, n, n, n, :]
                  - 3 * level_shift)


def quadruples_epsilons(epsilons, o, v, level_shift=0.0):
    """The o^4 v^4 denominators; only CCSDTQ's update takes them ((Q) reads
    the orbital energies)."""
    e_o, e_v = epsilons[o], epsilons[v]
    n = None
    return 1.0 / (e_o[:, n, n, n, n, n, n, n] + e_o[n, :, n, n, n, n, n, n]
                  + e_o[n, n, :, n, n, n, n, n] + e_o[n, n, n, :, n, n, n, n]
                  - e_v[n, n, n, n, :, n, n, n] - e_v[n, n, n, n, n, :, n, n]
                  - e_v[n, n, n, n, n, n, :, n] - e_v[n, n, n, n, n, n, n, :]
                  - 4 * level_shift)


# --- calculation preamble ---------------------------------------------------

def begin_spatial_orbital_calculation(molecule, ERI_AO, SCF_output, calculation,
                                      silent=False):
    """Spatial-orbital setup: chemists' MO integrals + occupied/virtual slices."""
    minimum_orbital = molecule.n_core_orbitals if calculation.freeze_core else 0
    if molecule.n_core_orbitals * 2 > molecule.n_electrons:
        error("Not enough spatial orbitals to freeze!")
    if molecule.n_core_orbitals < 0:
        error("Cannot freeze a negative number of orbitals!")

    o = slice(minimum_orbital, molecule.n_doubly_occ)
    v = slice(molecule.n_doubly_occ, None)

    log("\n Preparing transformation to spatial orbital basis...", calculation, 1,
        silent=silent)
    timer("Molecular orbital transformation", 0)
    if ERI_AO is None:
        # Integral-direct SCF deferred the stored tensor; transform straight
        # from the packed pair sweep.
        ERI_MO = transform_direct_mo_chemists(molecule, SCF_output, calculation)
    else:
        ERI_MO = ao_to_mo_chemists(ERI_AO, SCF_output.molecular_orbitals)
    timer("Molecular orbital transformation", 1)

    if calculation.freeze_core and molecule.n_core_orbitals != 0:
        log(f"\n The {molecule.n_core_orbitals} lowest energy orbitals will be "
            "frozen.", calculation, 1, silent=silent)
    else:
        log("\n All electrons will be correlated.", calculation, 1, silent=silent)

    return ERI_MO, SCF_output.molecular_orbitals, SCF_output.epsilons, o, v


def begin_spin_orbital_calculation(molecule, ERI_AO, SCF_output, calculation,
                                   silent=False, keep_tensors=False):
    """Spin-orbital setup: antisymmetrised physicists' integrals, the
    spin-orbital coefficients and energies, slices and labels.  With
    keep_tensors (perturbation theory) the spin-blocked AO tensor (None
    under DIRECT) and <pq|rs> are returned after them, as tuna_tpu returns
    them; without, both are freed here."""
    minimum_orbital = molecule.n_core_spin_orbitals if calculation.freeze_core else 0
    if molecule.n_core_spin_orbitals > molecule.n_electrons:
        error("Not enough spin orbitals to freeze!")
    if molecule.n_core_orbitals < 0:
        error("Cannot freeze a negative number of orbitals!")

    o = slice(minimum_orbital, molecule.n_occ)
    v = slice(molecule.n_occ, None)

    epsilons_combined = SCF_output.epsilons_combined

    log("\n Preparing transformation to spin orbital basis...", calculation, 1,
        silent=silent)
    timer("Molecular orbital transformation", 0)
    C_spin_block = spin_block_orbitals(SCF_output.molecular_orbitals_alpha,
                                       SCF_output.molecular_orbitals_beta,
                                       epsilons_combined)
    ERI_spin_block = None
    if ERI_AO is None:
        # Integral-direct SCF deferred the stored tensor: build <pq|rs>
        # straight from the packed pair sweep.
        ERI_SO = transform_direct_so_physicists(molecule, SCF_output, calculation)
    else:
        ERI_spin_block = spin_block_eri(ERI_AO)
        ERI_SO = ao_to_so_physicists(ERI_spin_block, C_spin_block, C_spin_block)
    g = antisymmetrise(ERI_SO)
    if not keep_tensors:
        del ERI_SO, ERI_spin_block
    timer("Molecular orbital transformation", 1)

    order = spin_orbital_order(epsilons_combined)
    epsilons_sorted = torch.as_tensor(np.asarray(epsilons_combined)[order],
                                      device=C_spin_block.device)

    n_alpha_mos = SCF_output.molecular_orbitals_alpha.shape[1]
    n_beta_mos = SCF_output.molecular_orbitals_beta.shape[1]
    spin_labels = ["a"] * n_alpha_mos + ["b"] * n_beta_mos
    spin_labels_sorted = [spin_labels[i] for i in order]

    counts: dict = {}
    spin_orbital_labels_sorted = []
    for x in spin_labels_sorted:
        counts[x] = counts.get(x, 0) + 1
        spin_orbital_labels_sorted.append(f"{counts[x]}{x}")

    if calculation.freeze_core and molecule.n_core_spin_orbitals != 0:
        log(f"\n The {molecule.n_core_spin_orbitals} lowest energy spin orbitals "
            "will be frozen.", calculation, 1, silent=silent)
    else:
        log("\n All electrons will be correlated.", calculation, 1, silent=silent)

    if keep_tensors:
        return (g, C_spin_block, epsilons_sorted, o, v, spin_labels_sorted,
                spin_orbital_labels_sorted, ERI_spin_block, ERI_SO)
    return (g, C_spin_block, epsilons_sorted, o, v, spin_labels_sorted,
            spin_orbital_labels_sorted)
