"""Self-consistent field engine: restricted and unrestricted Hartree-Fock
and Kohn-Sham.

Twin of tuna_tpu/scf/__init__.py with the same iteration semantics: Fock
build from the stored ERI, or from the integral-direct J/K closure (called
once per spin for UHF), plus, for Kohn-Sham, the XC matrix of the density
at the start of the iteration (one a spin for UKS); commutator DIIS (for UHF over both spins'
Fock matrices, with their errors concatenated), Zerner-Hehenberger dynamic
damping (for UHF per spin, each with its own commutator), four-condition
convergence, and the energy of the fresh density against the previous
iteration's J/K and XC terms (tuna_scf.py:1137-1141).
A Python loop on the device takes the place of the jitted while_loop; it
prints each iteration as it completes and records its wall time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..containers import Integrals, Output, to_numpy
from ..ops import linalg
from ..output import error, log, log_big_spacer, timer


# ---------------------------------------------------------------------------
# Small pure helpers (shared with guess / post-SCF modules).  The helpers
# of the iteration take a leading batch axis too (the batched loop below).
# ---------------------------------------------------------------------------

def symmetrise(M):
    return 0.5 * (M + M.mT)


def coulomb_matrix(P, ERI):
    return torch.einsum("ijkl,kl->ij", ERI, P)


def exchange_matrix(P, ERI):
    return torch.einsum("ilkj,kl->ij", ERI, P)


def density_matrix(mos, n_occ: int, n_per_orbital: int):
    occ = mos[..., :n_occ]
    return symmetrise(n_per_orbital * occ @ occ.mT)


def diagonalise_fock(F, X):
    """Orthogonalise, polished-eigh diagonalise, back-transform."""
    F_ortho = symmetrise(X.mT @ F @ X)
    eps, vecs = linalg.eigh(F_ortho)
    return eps, X @ vecs


def clean_density_matrix(P, S, n_electrons: int):
    """Rescale so Tr(PS) = n_electrons (tuna_dft.py:35-41)."""
    if n_electrons <= 0:
        return torch.zeros_like(P)
    return P * (n_electrons / torch.trace(P @ S))


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SCFSettings:
    reference: str           # "RHF" | "UHF"
    n_basis: int
    n_alpha: int
    n_beta: int
    max_iter: int
    use_diis: bool
    max_diis: int
    use_damping: bool
    dynamic_damping: bool    # damping_factor is None -> Mulliken-driven
    partition_0: int         # AOs on first atom (for dynamic damping)
    n_atoms: int


def scf_settings(calculation, molecule) -> SCFSettings:
    """The SCF settings of a calculation on a processed molecule."""
    return SCFSettings(
        reference=calculation.reference,
        n_basis=int(molecule.n_basis),
        n_alpha=molecule.n_alpha,
        n_beta=molecule.n_beta,
        max_iter=calculation.max_iter,
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        use_damping=bool(calculation.damping),
        dynamic_damping=calculation.damping_factor is None,
        partition_0=int(molecule.partition_ranges[0]),
        n_atoms=molecule.n_atoms,
    )


# ---------------------------------------------------------------------------
# Iteration pieces
# ---------------------------------------------------------------------------

def _mulliken_populations(P, S, settings: SCFSettings):
    diag = torch.diagonal(P @ S, dim1=-2, dim2=-1)
    if settings.n_atoms == 1:
        return torch.stack([torch.sum(diag, dim=-1), torch.zeros_like(diag[..., 0])], dim=-1)
    k = settings.partition_0
    return torch.stack([torch.sum(diag[..., :k], dim=-1), torch.sum(diag[..., k:], dim=-1)],
                       dim=-1)


def _dynamic_damping_factor(P_new, P_old_damped, P_old_raw, P_very_old_damped,
                            S, settings: SCFSettings, max_damping):
    """Zerner-Hehenberger population-oscillation damping (tuna_scf.py:839-861)."""
    A_n_out = _mulliken_populations(P_new, S, settings)
    A_n1_in = _mulliken_populations(P_old_damped, S, settings)
    A_n1_out = _mulliken_populations(P_old_raw, S, settings)
    A_n2_in = _mulliken_populations(P_very_old_damped, S, settings)

    denominator = A_n_out - A_n1_out - A_n1_in + A_n2_in
    safe = torch.abs(denominator) > 1e-300
    alpha = torch.where(safe, (A_n_out - A_n1_out)
                        / torch.where(safe, denominator, torch.ones_like(denominator)), 0.0)
    alpha = torch.where(torch.all(safe, dim=-1, keepdim=True), alpha, torch.zeros_like(alpha))

    if settings.n_atoms == 2:
        n0 = settings.partition_0
        n1 = settings.n_basis - n0
        factor = (alpha[..., 0] * n0 + alpha[..., 1] * n1) / (n0 + n1)
    else:
        factor = alpha[..., 0]
    factor = torch.clamp(factor, min=0.0)
    return torch.clamp(factor, max=max_damping)


def _apply_damping(P_new, P_old_damped, P_old_raw, P_very_old_damped, commutator,
                   S, settings: SCFSettings, static_factor, max_damping, step):
    """(damped density, factor); with a batch axis, a factor a geometry."""
    zero = torch.zeros(P_new.shape[:-2], dtype=P_new.dtype, device=P_new.device)
    if not settings.use_damping:
        return P_new, zero
    if not settings.dynamic_damping:
        factor = zero + static_factor
    else:
        dynamic = _dynamic_damping_factor(P_new, P_old_damped, P_old_raw,
                                          P_very_old_damped, S, settings, max_damping)
        factor = torch.where((commutator > 0.01) & (step > 1), dynamic, zero)
    f = factor[..., None, None]
    return f * P_old_damped + (1.0 - f) * P_new, factor


def _diis_error(F, P, S, X):
    err = X.mT @ (F @ P @ S - S @ P @ F) @ X
    commutator = torch.sqrt(torch.mean(err * err, dim=(-2, -1)))
    return commutator, err


def _diis_extrapolate(focks, errors):
    """Solve the bordered DIIS equations over the stored (Fock, error)
    pairs; returns (ok, extrapolated Fock).  A UHF entry holds both spins'
    Fock matrices, stacked, and their errors, concatenated."""
    errs = torch.stack([e.reshape(-1) for e in errors])
    ok, coeffs = _diis_coefficients(errs @ errs.T)
    return ok, torch.einsum("m,m...->...", coeffs, torch.stack(focks))


def _diis_coefficients(B):
    """(ok, coefficients) of the bordered DIIS equations of the Gram matrix
    B of the stored errors, oldest first, on B's device."""
    n = B.shape[0]
    # Pre-scale the Gram block to O(1): the bordered solution is invariant
    # under B -> B/s (only the Lagrange multiplier rescales).
    s = torch.clamp(torch.max(torch.abs(B)), min=1e-30)
    A = torch.zeros((n + 1, n + 1), dtype=B.dtype, device=B.device)
    A[:n, :n] = B / s
    A[:n, n] = -1.0
    A[n, :n] = -1.0
    rhs = torch.zeros(n + 1, dtype=B.dtype, device=B.device)
    rhs[n] = -1.0
    coeffs, ok = linalg.solve_linear_small(A, rhs)
    coeffs = coeffs[:n]
    # Exact sum-to-one so solve error only multiplies the Fock spread.
    csum = torch.sum(coeffs)
    coeffs = coeffs / torch.where(torch.abs(csum) > 1e-3, csum, torch.ones_like(csum))
    ok = ok & (torch.abs(csum) > 1e-3) & torch.all(torch.isfinite(coeffs))
    return ok, coeffs


def _electronic_energy(P_a, P_b, J_a, J_b, K_a, K_b, T, V_NE, Fld, G, HFX_prop,
                       restricted: bool, E_x_grid=0.0, E_c_grid=0.0):
    """Energy and its components (kinetic, nuclear-electron, Coulomb,
    exchange, correlation, field, field gradient); E_x_grid and E_c_grid
    are the XC energies on the grid."""
    def total(A):
        return torch.sum(A, dim=(-2, -1))

    P = P_a + P_b
    kinetic = total(P * T)
    nuclear_electron = total(P * V_NE)
    field = total(P * Fld)
    field_gradient = total(P * G)
    coulomb = 0.5 * total(P * (J_a + J_b))
    if restricted:
        exchange = -0.25 * total(P * (K_a + K_b)) * HFX_prop + E_x_grid
    else:
        exchange = -0.5 * (total(P_a * K_a) + total(P_b * K_b)) * HFX_prop + E_x_grid
    correlation = torch.zeros_like(kinetic) + E_c_grid
    energy = kinetic + nuclear_electron + coulomb + exchange + correlation + field + field_gradient
    components = torch.stack([kinetic, nuclear_electron, coulomb, exchange,
                              correlation, field, field_gradient], dim=-1)
    return energy, components


def run_scf_cycles(settings: SCFSettings, T, V_NE, ERI, S, X, Fld, G, P_a0, P_b0, E0,
                   HFX_prop, conv, static_damping, max_damping, on_iteration,
                   xc_closure=None, DFX_prop=0.0, DFC_prop=0.0, fock_closure=None):
    """The SCF iteration until convergence or max_iter.

    xc_closure(P_a, P_b, DFX, DFC) -> (V_XC_a, V_XC_b, E_x_grid,
    E_c_grid, density, alpha_density, beta_density), or None for
    Hartree-Fock.  fock_closure(P) -> (J, K)
    replaces the stored-ERI contractions (integral-direct SCF; ERI may then
    be None), called once per spin for UHF.  on_iteration(step, [E, dE,
    rmsDP, maxDP, commutator, damping], seconds) is called after each
    iteration.  Returns (n_steps, converged, E, P_a, P_b, outputs of the
    last iteration)."""
    restricted = settings.reference == "RHF"
    N = settings.n_basis
    zeros = torch.zeros((N, N), dtype=T.dtype, device=T.device)
    E = torch.as_tensor(E0, dtype=T.dtype, device=T.device)
    P_a, P_b = P_a0, P_b0
    P_old_a = P_raw_prev_a = P_very_old_a = zeros
    P_old_b = P_raw_prev_b = P_very_old_b = zeros
    focks, errors = [], []
    converged = False
    outs = {}
    step = 1

    def jk(P_spin):
        if fock_closure is not None:
            return fock_closure(P_spin)
        return coulomb_matrix(P_spin, ERI), exchange_matrix(P_spin, ERI)

    def densities(F_a, F_b):
        eps_a, mos_a = diagonalise_fock(F_a, X)
        if restricted:
            P_new = density_matrix(mos_a, settings.n_alpha, 2) / 2.0
            return (eps_a, mos_a, P_new), (eps_a, mos_a, P_new)
        eps_b, mos_b = diagonalise_fock(F_b, X)
        return ((eps_a, mos_a, density_matrix(mos_a, settings.n_alpha, 1)),
                (eps_b, mos_b, density_matrix(mos_b, settings.n_beta, 1)))

    while step <= settings.max_iter and not converged:
        start = time.perf_counter()
        P = P_a + P_b
        # XC of the density at the start of the iteration (the "old" density)
        if xc_closure is not None:
            V_XC_a, V_XC_b, E_x_grid, E_c_grid, density, dens_a, dens_b = xc_closure(
                P_a, P_a if restricted else P_b, DFX_prop, DFC_prop)
        else:
            V_XC_a = V_XC_b = E_x_grid = E_c_grid = 0.0
            density = dens_a = dens_b = None
        J_a, K_a = jk(P_a)
        if restricted:
            J_b, K_b = J_a, K_a
            F_a = F_b = symmetrise(T + V_NE + Fld + G + 2.0 * J_a - K_a * HFX_prop + V_XC_a)
        else:
            J_b, K_b = jk(P_b)
            F_a = symmetrise(T + V_NE + J_a + J_b + Fld + G - K_a * HFX_prop + V_XC_a)
            F_b = symmetrise(T + V_NE + J_a + J_b + Fld + G - K_b * HFX_prop + V_XC_b)

        # DIIS error from pre-diagonalisation Fock and density
        comm_a, err_a = _diis_error(F_a, P_a, S, X)
        if restricted:
            comm_b, commutator = comm_a, comm_a
            fock_entry, err_entry = F_a, err_a
        else:
            comm_b, err_b = _diis_error(F_b, P_b, S, X)
            commutator = torch.maximum(comm_a, comm_b)
            fock_entry = torch.stack([F_a, F_b])
            err_entry = torch.cat([err_a.reshape(-1), err_b.reshape(-1)])
        if len(errors) == settings.max_diis:
            focks.pop(0)
            errors.pop(0)
        focks.append(fock_entry)
        errors.append(err_entry)

        (eps_a, mos_a, P_new_a), (eps_b, mos_b, P_new_b) = densities(F_a, F_b)

        # Energy: fresh density against this iteration's (old density's) J/K
        # and XC energies
        E_new, components = _electronic_energy(P_new_a, P_new_b, J_a, J_b, K_a, K_b,
                                               T, V_NE, Fld, G, HFX_prop, restricted,
                                               E_x_grid, E_c_grid)

        if settings.use_diis and step > 2 and float(commutator) < 0.3:
            ok, F_x = _diis_extrapolate(focks, errors)
            if bool(ok):
                F_x_a, F_x_b = (F_x, F_x) if restricted else (F_x[0], F_x[1])
                (_, _, P_new_a), (_, _, P_new_b) = densities(F_x_a, F_x_b)
            else:
                # singular DIIS system resets the history (tuna_scf.py:1038-1048)
                focks, errors = [], []

        P_raw_a, P_raw_b = P_new_a, P_new_b
        P_damp_a, damping = _apply_damping(P_new_a, P_a, P_raw_prev_a, P_very_old_a, comm_a,
                                           S, settings, static_damping, max_damping, step)
        if restricted:
            P_damp_b = P_damp_a
        else:
            P_damp_b, damping_b = _apply_damping(P_new_b, P_b, P_raw_prev_b, P_very_old_b,
                                                 comm_b, S, settings, static_damping,
                                                 max_damping, step)
            damping = torch.maximum(damping, damping_b)

        delta_E = E_new - E
        delta_P = P_damp_a + P_damp_b - P
        max_DP = torch.max(torch.abs(delta_P))
        rms_DP = torch.sqrt(torch.mean(delta_P ** 2))
        stats = torch.stack([E_new, delta_E, rms_DP, max_DP, commutator, damping]).tolist()
        converged = (abs(stats[1]) < conv["delta_E"] and stats[3] < conv["max_DP"]
                     and stats[2] < conv["RMS_DP"] and stats[4] < conv["commutator"])
        outs = {"mos_a": mos_a, "mos_b": mos_b, "eps_a": eps_a, "eps_b": eps_b,
                "F_a": F_a, "F_b": F_b, "components": components,
                "density": density, "dens_a": dens_a, "dens_b": dens_b}
        on_iteration(step, stats, time.perf_counter() - start)

        E = E_new
        P_very_old_a, P_old_a, P_raw_prev_a = P_old_a, P_a, P_raw_a
        P_very_old_b, P_old_b, P_raw_prev_b = P_old_b, P_b, P_raw_b
        P_a, P_b = P_damp_a, P_damp_b
        step += 1
    return step - 1, converged, E, P_a, P_b, outs


# ---------------------------------------------------------------------------
# The batched loop: B geometries in lockstep
# ---------------------------------------------------------------------------

def _batch_jk(ERI, P):
    """Each geometry's J and K as its serial SCF forms them: one geometry's iterations do not depend on the batch it is
    in, which a batched einsum, summing in an order that depends on the
    batch size, does not ensure where a DIIS system is nearly singular."""
    return (torch.stack([coulomb_matrix(P_i, E) for E, P_i in zip(ERI, P)]),
            torch.stack([exchange_matrix(P_i, E) for E, P_i in zip(ERI, P)]))


def scf_batch_iterations(settings: SCFSettings, T, V_NE, ERI, S, X, P_a0, P_b0, HFX_prop,
                         conv, static_damping, max_damping, xc_closures=None, DFX_prop=0.0,
                         DFC_prop=0.0, Fld=None, G=None):
    """The SCF of B geometries in lockstep, as a generator that yields after
    each iteration and returns what run_scf_cycles_batched returns.

    The semantics of jax.vmap over tuna_tpu's SCF while_loop
    (tuna_tpu/scf/__init__.py:208, cond at :425-427): every geometry
    iterates until the last one has converged or max_iter is reached, and
    a converged geometry's state (P, E, DIIS history, damping history,
    orbitals) stays as it was.  J/K (one einsum over the stacked ERI),
    eigh, damping, the energy and the convergence tests are batched; each
    geometry's DIIS keeps its own history in a ring of max_diis slots and
    is solved on the host by run_scf_cycles's arithmetic, from the Gram
    matrices of all B rings, copied in one transfer an iteration.
    T, V_NE, S, X (B, N, N) and ERI (B, N, N, N, N) on one device; the
    guesses P_a0, P_b0 (B, N, N); the starting energy is 0, as tuna_tpu's
    batch passes it.  xc_closures: one closure of run_scf_cycles's form a
    geometry (restricted or unrestricted Kohn-Sham), called for the
    geometries still iterating, or None.  Fld and G (B, N, N): each
    point's field and field-gradient matrices, zero by default; they enter
    the Fock matrix and the energy where run_scf_cycles puts them."""
    restricted = settings.reference == "RHF"
    B, N, M = T.shape[0], settings.n_basis, settings.max_diis
    device, dtype = T.device, T.dtype
    zeros = torch.zeros((B, N, N), dtype=dtype, device=device)
    Fld = zeros if Fld is None else Fld
    G = zeros if G is None else G
    E = torch.zeros(B, dtype=dtype, device=device)
    P_a, P_b = P_a0, P_b0
    P_old_a = P_raw_prev_a = P_very_old_a = zeros
    P_old_b = P_raw_prev_b = P_very_old_b = zeros
    n_spin = 1 if restricted else 2
    fock_ring = torch.zeros((B, M, n_spin, N, N), dtype=dtype, device=device)
    error_ring = torch.zeros((B, M, n_spin * N * N), dtype=dtype, device=device)
    ring_start, ring_size = [0] * B, [0] * B
    active = np.ones(B, dtype=bool)
    converged = np.zeros(B, dtype=bool)
    n_steps = np.zeros(B, dtype=np.int64)
    outs = {"mos_a": zeros, "mos_b": zeros,
            "eps_a": torch.zeros((B, N), dtype=dtype, device=device),
            "eps_b": torch.zeros((B, N), dtype=dtype, device=device),
            "iteration_seconds": []}
    step = 1

    while step <= settings.max_iter and active.any():
        start = time.perf_counter()
        rows = np.flatnonzero(active)
        live = torch.as_tensor(active, device=device)
        P = P_a + P_b
        if xc_closures is not None:
            xc = [(zeros[0], zeros[0], zeros[0, 0, 0], zeros[0, 0, 0])] * B
            for i in rows:
                V_a, V_b, E_x, E_c, *_ = xc_closures[i](
                    P_a[i], P_a[i] if restricted else P_b[i], DFX_prop, DFC_prop)
                xc[i] = (V_a, V_b, E_x, E_c)
            V_XC_a, V_XC_b, E_x_grid, E_c_grid = (torch.stack(parts) for parts in zip(*xc))
        else:
            V_XC_a = V_XC_b = E_x_grid = E_c_grid = 0.0
        J_a, K_a = _batch_jk(ERI, P_a)
        if restricted:
            J_b, K_b = J_a, K_a
            F_a = F_b = symmetrise(T + V_NE + Fld + G + 2.0 * J_a - K_a * HFX_prop + V_XC_a)
        else:
            J_b, K_b = _batch_jk(ERI, P_b)
            F_a = symmetrise(T + V_NE + J_a + J_b + Fld + G - K_a * HFX_prop + V_XC_a)
            F_b = symmetrise(T + V_NE + J_a + J_b + Fld + G - K_b * HFX_prop + V_XC_b)

        comm_a, err_a = _diis_error(F_a, P_a, S, X)
        if restricted:
            comm_b, commutator = comm_a, comm_a
            fock_entry, err_entry = F_a[:, None], err_a.reshape(B, -1)
        else:
            comm_b, err_b = _diis_error(F_b, P_b, S, X)
            commutator = torch.maximum(comm_a, comm_b)
            fock_entry = torch.stack([F_a, F_b], dim=1)
            err_entry = torch.cat([err_a.reshape(B, -1), err_b.reshape(B, -1)], dim=1)
        if settings.use_diis:
            slots = []
            for i in rows:
                if ring_size[i] == M:
                    slots.append(ring_start[i])
                    ring_start[i] = (ring_start[i] + 1) % M
                else:
                    slots.append((ring_start[i] + ring_size[i]) % M)
                    ring_size[i] += 1
            index = (torch.as_tensor(rows, device=device), torch.as_tensor(slots, device=device))
            fock_ring[index] = fock_entry[index[0]]
            error_ring[index] = err_entry[index[0]]

        eps_a, mos_a = diagonalise_fock(F_a, X)
        if restricted:
            eps_b, mos_b = eps_a, mos_a
            P_new_a = P_new_b = density_matrix(mos_a, settings.n_alpha, 2) / 2.0
        else:
            eps_b, mos_b = diagonalise_fock(F_b, X)
            P_new_a = density_matrix(mos_a, settings.n_alpha, 1)
            P_new_b = density_matrix(mos_b, settings.n_beta, 1)

        # Energy: fresh density against this iteration's (old density's) J/K
        # and XC energies
        E_new, _ = _electronic_energy(P_new_a, P_new_b, J_a, J_b, K_a, K_b, T, V_NE, Fld, G,
                                      HFX_prop, restricted, E_x_grid, E_c_grid)

        if settings.use_diis and step > 2:
            grams = (error_ring @ error_ring.mT).reshape(B, M * M)
            host = torch.cat([commutator[:, None], grams], dim=1).cpu()
            coeffs = torch.zeros((B, M), dtype=dtype)
            use = np.zeros(B, dtype=bool)
            for i in rows:
                if not float(host[i, 0]) < 0.3:
                    continue
                order = [(ring_start[i] + k) % M for k in range(ring_size[i])]
                gram = host[i, 1:].reshape(M, M)[order][:, order]
                ok, c = _diis_coefficients(gram)
                if bool(ok):
                    coeffs[i, order] = c
                    use[i] = True
                else:
                    # singular DIIS system resets the history (tuna_scf.py:1038-1048)
                    ring_size[i] = 0
            if use.any():
                F_x = torch.einsum("bm,bm...->b...", coeffs.to(device), fock_ring)
                keep = torch.as_tensor(use, device=device)[:, None, None]
                _, mos_x = diagonalise_fock(F_x[:, 0], X)
                if restricted:
                    P_x = density_matrix(mos_x, settings.n_alpha, 2) / 2.0
                    P_new_a = P_new_b = torch.where(keep, P_x, P_new_a)
                else:
                    P_new_a = torch.where(keep, density_matrix(mos_x, settings.n_alpha, 1),
                                          P_new_a)
                    _, mos_x = diagonalise_fock(F_x[:, 1], X)
                    P_new_b = torch.where(keep, density_matrix(mos_x, settings.n_beta, 1),
                                          P_new_b)

        P_damp_a, damping = _apply_damping(P_new_a, P_a, P_raw_prev_a, P_very_old_a, comm_a,
                                           S, settings, static_damping, max_damping, step)
        if restricted:
            P_damp_b = P_damp_a
        else:
            P_damp_b, damping_b = _apply_damping(P_new_b, P_b, P_raw_prev_b, P_very_old_b,
                                                 comm_b, S, settings, static_damping,
                                                 max_damping, step)
            damping = torch.maximum(damping, damping_b)

        delta_E = E_new - E
        delta_P = P_damp_a + P_damp_b - P
        max_DP = torch.amax(torch.abs(delta_P), dim=(-2, -1))
        rms_DP = torch.sqrt(torch.mean(delta_P ** 2, dim=(-2, -1)))
        stats = torch.stack([E_new, delta_E, rms_DP, max_DP, commutator, damping],
                            dim=1).cpu().numpy()
        now = ((np.abs(stats[:, 1]) < conv["delta_E"]) & (stats[:, 3] < conv["max_DP"])
               & (stats[:, 2] < conv["RMS_DP"]) & (stats[:, 4] < conv["commutator"]))

        # a converged geometry keeps its state
        def update(new, old):
            return torch.where(live.reshape(-1, *[1] * (new.dim() - 1)), new, old)

        E = update(E_new, E)
        P_very_old_a, P_old_a, P_raw_prev_a = (update(P_old_a, P_very_old_a), update(P_a, P_old_a),
                                               update(P_new_a, P_raw_prev_a))
        P_very_old_b, P_old_b, P_raw_prev_b = (update(P_old_b, P_very_old_b), update(P_b, P_old_b),
                                               update(P_new_b, P_raw_prev_b))
        P_a, P_b = update(P_damp_a, P_a), update(P_damp_b, P_b)
        for name, new in (("mos_a", mos_a), ("mos_b", mos_b), ("eps_a", eps_a), ("eps_b", eps_b)):
            outs[name] = update(new, outs[name])
        n_steps[rows] += 1
        converged[rows] = now[rows]
        active &= ~converged
        step += 1
        outs["iteration_seconds"].append(time.perf_counter() - start)
        yield
    return n_steps, converged, E, P_a, P_b, outs


def run_in_lockstep(loops):
    """Advance generators such as scf_batch_iterations one iteration each
    in turn until every one has ended; returns their return values."""
    results = [None] * len(loops)
    live = list(range(len(loops)))
    while live:
        for k in list(live):
            try:
                next(loops[k])
            except StopIteration as stop:
                results[k] = stop.value
                live.remove(k)
    return results


def run_scf_cycles_batched(*args, **kwargs):
    """The batched twin of run_scf_cycles (arguments: see
    scf_batch_iterations).  Returns (n_steps (B,), converged (B,), numpy;
    E (B,), P_a, P_b (B, N, N) and outputs: mos_a, mos_b, eps_a, eps_b of
    each geometry's last iteration and the wall seconds of each iteration
    of the batch)."""
    return run_in_lockstep([scf_batch_iterations(*args, **kwargs)])[0]


# ---------------------------------------------------------------------------
# Host-level driver
# ---------------------------------------------------------------------------

def run_self_consistent_field(molecule, calculation, integrals: Integrals, V_NN,
                              X, guess_objects, silent=False, xc_closure=None,
                              fock_closure=None) -> Output:
    """Run the SCF loop and assemble the Output container; xc_closure (see
    run_scf_cycles) makes it Kohn-Sham, fock_closure integral-direct."""
    timer("Self-consistent field", 0)
    P, P_alpha, P_beta, E_guess = guess_objects
    restricted = calculation.reference == "RHF"

    log(" Beginning self-consistent field cycle...\n", calculation, 1, silent=silent)
    log(f' Using "{calculation.SCF_conv["name"]}" SCF convergence criteria.',
        calculation, 1, silent=silent)
    _log_acceleration(calculation, silent)

    log_big_spacer(calculation, silent=silent)
    log("                                   Self-consistent Field Cycle Iterations",
        calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent)
    log("  Step          E                 DE             RMS(DP)          MAX(DP)           Error       Damping",
        calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent)

    settings = scf_settings(calculation, molecule)
    Fld = integrals.F if integrals.F is not None else torch.zeros_like(integrals.S)
    G = integrals.G if integrals.G is not None else torch.zeros_like(integrals.S)
    static_damping = calculation.damping_factor if calculation.damping_factor is not None else 0.0
    iteration_seconds = []

    def on_iteration(step, stats, seconds):
        E_it, dE, rms, mx, comm, damp = stats
        damp_str = f"{damp:.3f}" if damp != 0 else " ---"
        log(f"  {step:3.0f}  {E_it + V_NN:16.10f}  {dE:16.10f} {rms:16.10f} "
            f"{mx:16.10f} {comm:16.10f}     {damp_str}", calculation, 1, silent=silent)
        iteration_seconds.append(seconds)

    n_steps, converged, E, P_a, P_b, outs = run_scf_cycles(
        settings, integrals.T, integrals.V_NE, integrals.ERI_AO, integrals.S, X, Fld, G,
        P_alpha, P_alpha if restricted else P_beta, E_guess, calculation.HFX_prop,
        calculation.SCF_conv, static_damping, calculation.max_damping, on_iteration,
        xc_closure, calculation.DFX_prop, calculation.DFC_prop, fock_closure)

    if not converged:
        error(f"Self-consistent field not converged in {calculation.max_iter} "
              "iterations! Increase maximum iterations or give up.")

    log_big_spacer(calculation, silent=silent)
    log(f"\n Self-consistent field converged in {n_steps} cycles!\n",
        calculation, 1, silent=silent)

    mos_a, mos_b = outs["mos_a"], outs["mos_b"]
    eps_a, eps_b = outs["eps_a"], outs["eps_b"]
    if restricted:
        mos, eps = mos_a, eps_a
        F_a = F_b = outs["F_a"] / 2.0
    else:
        # both spins' orbitals in one list by energy (one electron: alpha's)
        if molecule.n_electrons > 1:
            eps, mos = torch.cat([eps_a, eps_b]), torch.cat([mos_a, mos_b], dim=1)
        else:
            eps, mos = eps_a, mos_a
        order = torch.as_tensor(np.argsort(to_numpy(eps)), device=eps.device)
        eps, mos = eps[order], mos[:, order]
        F_a, F_b = outs["F_a"], outs["F_b"]
    k, ne, co, ex, corr, fe, fge = outs["components"].tolist()

    output = Output(
        energy=float(E) + float(V_NN),
        kinetic_energy=k, nuclear_electron_energy=ne, coulomb_energy=co,
        exchange_energy=ex, correlation_energy=corr,
        electric_field_energy=fe, electric_field_gradient_energy=fge,
        P=P_a + P_b, P_alpha=P_a, P_beta=P_b, S=integrals.S, X=X,
        molecular_orbitals=mos, molecular_orbitals_alpha=mos_a,
        molecular_orbitals_beta=mos_b,
        epsilons=eps, epsilons_alpha=eps_a, epsilons_beta=eps_b,
        density=outs["density"], alpha_density=outs["dens_a"],
        beta_density=outs["dens_b"],
        F_alpha=F_a, F_beta=F_b, T=integrals.T, V_NE=integrals.V_NE,
        integrals=integrals, iteration_seconds=iteration_seconds,
    )
    timer("Self-consistent field", 1)
    return output


def _log_acceleration(calculation, silent):
    damping = calculation.damping
    factor = calculation.damping_factor
    if calculation.DIIS:
        msg = f" Using DIIS, storing {calculation.max_DIIS_matrices} matrices, for convergence acceleration"
        if damping:
            msg += ", with static damping." if factor else ", with dynamic damping."
        else:
            msg += "."
        log(msg, calculation, silent=silent)
    elif damping:
        kind = "static" if factor else "dynamic"
        log(f" Using {kind} damping for convergence acceleration.", calculation, silent=silent)
    else:
        log(" No convergence acceleration used.", calculation, 1, silent=silent)
    log("", calculation, silent=silent)
