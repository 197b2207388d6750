"""Self-consistent field engine, restricted Hartree-Fock and Kohn-Sham.

Twin of tuna_tpu/scf/__init__.py with the same iteration semantics: Fock
build from the stored ERI, or from the integral-direct J/K closure, plus,
for Kohn-Sham, the XC matrix of the density at the start of the iteration;
commutator DIIS, Zerner-Hehenberger dynamic damping, four-condition
convergence, and the energy of the fresh density against the previous
iteration's J/K and XC terms (tuna_scf.py:1137-1141).
A Python loop on the device takes the place of the jitted while_loop; it
prints each iteration as it completes and records its wall time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..containers import Integrals, Output
from ..ops import linalg
from ..output import error, log, log_big_spacer, timer


# ---------------------------------------------------------------------------
# Small pure helpers (shared with guess / post-SCF modules)
# ---------------------------------------------------------------------------

def symmetrise(M):
    return 0.5 * (M + M.T)


def coulomb_matrix(P, ERI):
    return torch.einsum("ijkl,kl->ij", ERI, P)


def exchange_matrix(P, ERI):
    return torch.einsum("ilkj,kl->ij", ERI, P)


def density_matrix(mos, n_occ: int, n_per_orbital: int):
    occ = mos[:, :n_occ]
    return symmetrise(n_per_orbital * occ @ occ.T)


def diagonalise_fock(F, X):
    """Orthogonalise, diagonalise, back-transform."""
    F_ortho = symmetrise(X.T @ F @ X)
    eps, vecs = torch.linalg.eigh(F_ortho)
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
    n_basis: int
    n_alpha: int
    max_iter: int
    use_diis: bool
    max_diis: int
    use_damping: bool
    dynamic_damping: bool    # damping_factor is None -> Mulliken-driven
    partition_0: int         # AOs on first atom (for dynamic damping)
    n_atoms: int


# ---------------------------------------------------------------------------
# Iteration pieces
# ---------------------------------------------------------------------------

def _mulliken_populations(P, S, settings: SCFSettings):
    diag = torch.diagonal(P @ S)
    if settings.n_atoms == 1:
        return torch.stack([torch.sum(diag), torch.zeros_like(diag[0])])
    k = settings.partition_0
    return torch.stack([torch.sum(diag[:k]), torch.sum(diag[k:])])


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
    alpha = torch.where(torch.all(safe), alpha, torch.zeros_like(alpha))

    if settings.n_atoms == 2:
        n0 = settings.partition_0
        n1 = settings.n_basis - n0
        factor = (alpha[0] * n0 + alpha[1] * n1) / (n0 + n1)
    else:
        factor = alpha[0]
    factor = torch.clamp(factor, min=0.0)
    return torch.clamp(factor, max=max_damping)


def _apply_damping(P_new, P_old_damped, P_old_raw, P_very_old_damped, commutator,
                   S, settings: SCFSettings, static_factor, max_damping, step):
    zero = torch.zeros((), dtype=P_new.dtype, device=P_new.device)
    if not settings.use_damping:
        return P_new, zero
    if not settings.dynamic_damping:
        factor = zero + static_factor
    else:
        dynamic = _dynamic_damping_factor(P_new, P_old_damped, P_old_raw,
                                          P_very_old_damped, S, settings, max_damping)
        factor = torch.where((commutator > 0.01) & (step > 1), dynamic, zero)
    return factor * P_old_damped + (1.0 - factor) * P_new, factor


def _diis_error(F, P, S, X):
    err = X.T @ (F @ P @ S - S @ P @ F) @ X
    commutator = torch.sqrt(torch.mean(err * err))
    return commutator, err


def _diis_extrapolate(focks, errors):
    """Solve the bordered DIIS equations over the stored (Fock, error)
    pairs; returns (ok, extrapolated Fock)."""
    n = len(errors)
    errs = torch.stack([e.reshape(-1) for e in errors])
    B = errs @ errs.T
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
    return ok, torch.einsum("m,mij->ij", coeffs, torch.stack(focks))


def _electronic_energy(P_a, P_b, J_a, J_b, K_a, K_b, T, V_NE, Fld, G, HFX_prop,
                       E_x_grid=0.0, E_c_grid=0.0):
    """Restricted energy and its components (kinetic, nuclear-electron,
    Coulomb, exchange, correlation, field, field gradient); E_x_grid and
    E_c_grid are the XC energies on the grid."""
    P = P_a + P_b
    kinetic = torch.sum(P * T)
    nuclear_electron = torch.sum(P * V_NE)
    field = torch.sum(P * Fld)
    field_gradient = torch.sum(P * G)
    coulomb = 0.5 * torch.sum(P * (J_a + J_b))
    exchange = -0.25 * torch.sum(P * (K_a + K_b)) * HFX_prop + E_x_grid
    correlation = torch.zeros_like(kinetic) + E_c_grid
    total = kinetic + nuclear_electron + coulomb + exchange + correlation + field + field_gradient
    components = torch.stack([kinetic, nuclear_electron, coulomb, exchange,
                              correlation, field, field_gradient])
    return total, components


def run_scf_cycles(settings: SCFSettings, T, V_NE, ERI, S, X, Fld, G, P_a0, E0,
                   HFX_prop, conv, static_damping, max_damping, on_iteration,
                   xc_closure=None, DFX_prop=0.0, DFC_prop=0.0, fock_closure=None):
    """The restricted SCF iteration until convergence or max_iter.

    xc_closure(P_a, P_b, DFX, DFC) -> (V_XC_a, V_XC_b, E_x_grid,
    E_c_grid, density, alpha_density, beta_density), or None for
    Hartree-Fock.  fock_closure(P_a) -> (J_a, K_a) replaces the
    stored-ERI contractions (integral-direct SCF; ERI may then be None).
    on_iteration(step, [E, dE, rmsDP, maxDP, commutator, damping],
    seconds) is called after each iteration.  Returns (n_steps, converged,
    E, P_a, outputs of the last iteration)."""
    N = settings.n_basis
    zeros = torch.zeros((N, N), dtype=T.dtype, device=T.device)
    E = torch.as_tensor(E0, dtype=T.dtype, device=T.device)
    P_a = P_a0
    P_old, P_raw_prev, P_very_old = zeros, zeros, zeros
    focks, errors = [], []
    converged = False
    outs = {}
    step = 1
    while step <= settings.max_iter and not converged:
        start = time.perf_counter()
        P = 2.0 * P_a
        # XC of the density at the start of the iteration (the "old" density)
        if xc_closure is not None:
            V_XC, _, E_x_grid, E_c_grid, density, dens_a, dens_b = xc_closure(
                P_a, P_a, DFX_prop, DFC_prop)
        else:
            V_XC, E_x_grid, E_c_grid = 0.0, 0.0, 0.0
            density = dens_a = dens_b = None
        if fock_closure is not None:
            J_a, K_a = fock_closure(P_a)
        else:
            J_a, K_a = coulomb_matrix(P_a, ERI), exchange_matrix(P_a, ERI)
        F_a = symmetrise(T + V_NE + Fld + G + 2.0 * J_a - K_a * HFX_prop + V_XC)

        # DIIS error from pre-diagonalisation Fock and density
        commutator, err_a = _diis_error(F_a, P_a, S, X)
        if len(errors) == settings.max_diis:
            focks.pop(0)
            errors.pop(0)
        focks.append(F_a)
        errors.append(err_a)

        eps_a, mos_a = diagonalise_fock(F_a, X)
        P_new = density_matrix(mos_a, settings.n_alpha, 2) / 2.0

        # Energy: fresh density against this iteration's (old density's) J/K
        # and XC energies
        E_new, components = _electronic_energy(P_new, P_new, J_a, J_a, K_a, K_a,
                                               T, V_NE, Fld, G, HFX_prop,
                                               E_x_grid, E_c_grid)

        if settings.use_diis and step > 2 and float(commutator) < 0.3:
            ok, F_x = _diis_extrapolate(focks, errors)
            if bool(ok):
                _, mos_x = diagonalise_fock(F_x, X)
                P_new = density_matrix(mos_x, settings.n_alpha, 2) / 2.0
            else:
                # singular DIIS system resets the history (tuna_scf.py:1038-1048)
                focks, errors = [], []

        P_raw = P_new
        P_damp, damping = _apply_damping(P_new, P_a, P_raw_prev, P_very_old, commutator,
                                         S, settings, static_damping, max_damping, step)

        delta_E = E_new - E
        delta_P = 2.0 * P_damp - P
        max_DP = torch.max(torch.abs(delta_P))
        rms_DP = torch.sqrt(torch.mean(delta_P ** 2))
        stats = torch.stack([E_new, delta_E, rms_DP, max_DP, commutator, damping]).tolist()
        converged = (abs(stats[1]) < conv["delta_E"] and stats[3] < conv["max_DP"]
                     and stats[2] < conv["RMS_DP"] and stats[4] < conv["commutator"])
        outs = {"mos_a": mos_a, "eps_a": eps_a, "F_a": F_a, "components": components,
                "density": density, "dens_a": dens_a, "dens_b": dens_b}
        on_iteration(step, stats, time.perf_counter() - start)

        E = E_new
        P_very_old, P_old, P_raw_prev = P_old, P_a, P_raw
        P_a = P_damp
        step += 1
    return step - 1, converged, E, P_a, outs


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
    if calculation.reference != "RHF":
        error("Unrestricted SCF is not yet ported to tuna_tpu_torch!")

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

    settings = SCFSettings(
        n_basis=int(integrals.n_basis),
        n_alpha=molecule.n_alpha,
        max_iter=calculation.max_iter,
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        use_damping=bool(calculation.damping),
        dynamic_damping=calculation.damping_factor is None,
        partition_0=int(molecule.partition_ranges[0]),
        n_atoms=molecule.n_atoms,
    )
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

    n_steps, converged, E, P_a, outs = run_scf_cycles(
        settings, integrals.T, integrals.V_NE, integrals.ERI_AO, integrals.S, X, Fld, G,
        P_alpha, E_guess, calculation.HFX_prop, calculation.SCF_conv, static_damping,
        calculation.max_damping, on_iteration, xc_closure, calculation.DFX_prop,
        calculation.DFC_prop, fock_closure)

    if not converged:
        error(f"Self-consistent field not converged in {calculation.max_iter} "
              "iterations! Increase maximum iterations or give up.")

    log_big_spacer(calculation, silent=silent)
    log(f"\n Self-consistent field converged in {n_steps} cycles!\n",
        calculation, 1, silent=silent)

    mos, eps = outs["mos_a"], outs["eps_a"]
    F_half = outs["F_a"] / 2.0
    k, ne, co, ex, corr, fe, fge = outs["components"].tolist()

    output = Output(
        energy=float(E) + float(V_NN),
        kinetic_energy=k, nuclear_electron_energy=ne, coulomb_energy=co,
        exchange_energy=ex, correlation_energy=corr,
        electric_field_energy=fe, electric_field_gradient_energy=fge,
        P=2.0 * P_a, P_alpha=P_a, P_beta=P_a, S=integrals.S, X=X,
        molecular_orbitals=mos, molecular_orbitals_alpha=mos,
        molecular_orbitals_beta=mos,
        epsilons=eps, epsilons_alpha=eps, epsilons_beta=eps,
        density=outs["density"], alpha_density=outs["dens_a"],
        beta_density=outs["dens_b"],
        F_alpha=F_half, F_beta=F_half, T=integrals.T, V_NE=integrals.V_NE,
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
