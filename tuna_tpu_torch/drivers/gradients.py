"""Analytic nuclear gradients of SCF energies (RHF, UHF, and RKS and UKS
with the port's LDA, GGA and meta-GGA functionals).

Twin of tuna_tpu/drivers/gradients.py.  For a converged SCF the energy is
variational in the density, so dE/dR is the derivative of the energy
expression at fixed density plus the Pulay term with the energy-weighted
density W (tuna_tpu's total_energy, term for term):

    dE/dR = sum P (T' + V') [+ sum_i F_i sum P D_i' + F_grad . Q']
          + E_2'(P_a, P_b) - sum W S' - Z_A Z_B / R^2 + E_xc'(R, P_a, P_b)
          [+ E_D2'(R)]

A diatomic has one coordinate, R (atom 1 at (0, 0, R)), so instead of
jax.grad's reverse mode the port takes R-tangents at fixed densities and W:
K8a (IntegralPlan.one_electron_deriv) for the one-electron integrals, K8b
(IntegralPlan.eri_deriv_energy; K8bu, eri_deriv_energy_unrestricted, with
exchange per spin) for the two-electron energy, K8c
(dft.grid.density_deriv_on_grid; K8cu, density_deriv_on_grid_spin, both
spins in one pass; K8ct and K8cut with a meta-GGA's tau) for the density
on the moving grid.  The spherical
transform is linear, so the densities and W enter in the Cartesian basis
(U^T P U).  The rest of E_xc' is elementwise torch: the functionals'
derivatives by the same autograd the SCF's V_XC uses, and the Becke
weights' R-derivative by autograd on the weights alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dft import grid as dft_grid
from ..dft import xc
from . import common

_F64 = torch.float64


def analytic_gradient_available(calculation, molecule=None) -> bool:
    """True when the SCF energy has an analytic gradient here: Hartree-Fock
    (RHF or UHF), or Kohn-Sham with the port's LDA/GGA/meta-GGA
    functionals, the correlation functional looked up in the registry of
    the reference (tuna_tpu's gate).  VV10, double hybrids and ghost-atom
    grids go through finite differences, as in tuna_tpu."""
    method = calculation.method
    if calculation.extrapolate or calculation.decontract or method.correlated_method:
        return False
    if method.name in ("HF", "UHF"):
        return True
    if calculation.DFT_calculation:
        functional = calculation.functional
        if calculation.VV10 or calculation.MPC_prop > 0:
            return False
        if molecule is not None and any(a.ghost for a in molecule.atoms):
            return False
        c_registry = (xc.CORRELATION_FUNCTIONALS if calculation.reference == "RHF"
                      else xc.UNRESTRICTED_CORRELATION_FUNCTIONALS)
        return ((functional.x_name is None or functional.x_name in xc.EXCHANGE_FUNCTIONALS)
                and (functional.c_name is None or functional.c_name in c_registry))
    return False


_GRAD_CACHE: dict = {}


def _build_xc_gradient_fn(molecule, calculation, device):
    """(R, P) -> dE_xc/dR at a fixed Cartesian density P, the total
    (restricted) or the stack (2, n, n) of both spins (unrestricted): the
    moving grid's densities and their tangents from K8c or K8cu (K8ct or
    K8cut for a meta-GGA), then the derivative of tuna_tpu's
    _build_xc_energy_fn as elementwise torch."""
    functional = calculation.functional
    restricted = calculation.reference == "RHF"
    x_fn = xc.EXCHANGE_FUNCTIONALS.get(functional.x_name)
    c_fn = (xc.CORRELATION_FUNCTIONALS.get(functional.c_name) if restricted
            else xc.UNRESTRICTED_CORRELATION_FUNCTIONALS.get(functional.c_name))
    params = xc.XCParams(x_alpha=calculation.X_alpha, method_name=calculation.method.name,
                         x_name=functional.x_name)
    needs_gradient = functional.functional_class in ("GGA", "meta-GGA")
    needs_tau = functional.functional_class == "meta-GGA"
    DFX_prop, DFC_prop = float(calculation.DFX_prop), float(calculation.DFC_prop)

    extent, n_radial, lebedev_order = dft_grid.grid_parameters(molecule, calculation)
    points_A, w_atomic = dft_grid.build_atomic_radial_and_angular_grid(
        extent, n_radial, lebedev_order)
    points_A = torch.as_tensor(points_A.reshape(3, -1), dtype=_F64, device=device)
    w_atomic = torch.as_tensor(w_atomic.reshape(-1), dtype=_F64, device=device)
    n_A = points_A.shape[1]
    X = torch.cat([points_A[0], points_A[0]])
    Y = torch.cat([points_A[1], points_A[1]])

    atoms = molecule.atoms
    chi = atoms[0].real_vdw_radius / atoms[1].real_vdw_radius
    u_het = (chi - 1) / (chi + 1)
    a_het = u_het / (u_het * u_het - 1)

    basis = dft_grid.GridBasis(molecule.cartesian_basis_functions)
    ao_moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                               dtype=torch.int32, device=device)

    def becke_weights(R):
        """tuna_tpu's becke_weights with the grid of atom 1 at +R, times
        the atomic weights (gradients.py:114-121, :172-174)."""
        Z = torch.cat([points_A[2], points_A[2] + R])
        R_A = torch.sqrt(X * X + Y * Y + Z * Z)
        R_B = torch.sqrt(X * X + Y * Y + (Z - R) ** 2)
        s = (R_A - R_B) / R
        s = s + a_het * (1 - s * s)
        for _ in range(4):
            s = (3 * s - s**3) / 2
        return torch.cat([w_atomic * ((1 - s) / 2)[:n_A], w_atomic * ((1 + s) / 2)[n_A:]])

    def cleaned(rho, grad_rho, d_rho, d_grad_rho, tau_raw=None, d_tau_raw=None):
        """The floored density, sigma and tau of xc.clean with their
        tangents (a floor passes no derivative below it)."""
        density = xc.clean(rho)
        d_density = torch.where(rho > xc.DENSITY_FLOOR, d_rho, 0.0)
        sigma = d_sigma = tau = d_tau = None
        if needs_gradient:
            sigma_raw = torch.sum(grad_rho * grad_rho, dim=-2)
            sigma = xc.clean(sigma_raw, floor=xc.SIGMA_FLOOR)
            d_sigma = torch.where(sigma_raw > xc.SIGMA_FLOOR,
                                  2 * torch.sum(grad_rho * d_grad_rho, dim=-2), 0.0)
        if needs_tau:
            tau = xc.clean(tau_raw)
            d_tau = torch.where(tau_raw > xc.DENSITY_FLOOR, d_tau_raw, 0.0)
        return density, d_density, sigma, d_sigma, tau, d_tau

    def restricted_terms(density, d_density, sigma, d_sigma, tau, d_tau):
        """(f, f') of tuna_tpu's restricted xc_energy (gradients.py:178-183),
        f the energy density on the grid before the weights."""
        f = torch.zeros_like(density)
        local = torch.zeros_like(density)
        for fn, prop in ((x_fn, DFX_prop), (c_fn, DFC_prop)):
            if fn is None:
                continue
            needs_sigma = getattr(fn, "needs_sigma", False)
            fn_tau = getattr(fn, "needs_tau", False)
            df_dn, df_ds, df_dt, eps = xc.restricted_derivatives(
                fn, density, sigma if needs_sigma else None, tau if fn_tau else None, params)
            f = f + prop * eps * density
            local = local + prop * df_dn * d_density
            if needs_sigma:
                local = local + prop * df_ds * d_sigma
            if fn_tau:
                local = local + prop * df_dt * d_tau
        return f, local

    def unrestricted_terms(density, d_density, sigma, d_sigma, tau, d_tau, grad_rho,
                           d_grad_rho):
        """(f, f') of tuna_tpu's unrestricted xc_energy (gradients.py:184-211)
        from each spin's floored density, sigma_ss and tau (stacked on the
        first axis): exchange by exact spin scaling at 2 rho_s, 4 sigma_ss
        and 2 tau_s, correlation on sigma_ab = grad rho_a . grad rho_b (no
        floor)."""
        f = torch.zeros_like(density[0])
        local = torch.zeros_like(density[0])
        if x_fn is not None:
            needs_sigma = getattr(x_fn, "needs_sigma", False)
            fn_tau = getattr(x_fn, "needs_tau", False)
            for s in range(2):
                df_dn, df_ds, df_dt, eps = xc.restricted_derivatives(
                    x_fn, 2 * density[s], 4 * sigma[s] if needs_sigma else None,
                    2 * tau[s] if fn_tau else None, params)
                f = f + 0.5 * DFX_prop * eps * (2 * density[s])
                local = local + 0.5 * DFX_prop * df_dn * (2 * d_density[s])
                if needs_sigma:
                    local = local + 0.5 * DFX_prop * df_ds * (4 * d_sigma[s])
                if fn_tau:
                    local = local + 0.5 * DFX_prop * df_dt * (2 * d_tau[s])
        if c_fn is not None:
            needs_sigma = getattr(c_fn, "needs_sigma", False)
            fn_tau = getattr(c_fn, "needs_tau", False)
            sigma_ab = d_sigma_ab = None
            if needs_sigma:
                sigma_ab = torch.sum(grad_rho[0] * grad_rho[1], dim=0)
                d_sigma_ab = torch.sum(d_grad_rho[0] * grad_rho[1]
                                       + grad_rho[0] * d_grad_rho[1], dim=0)
            dfn_a, dfn_b, dfs_aa, dfs_bb, dfs_ab, dft_a, dft_b, eps = \
                xc.unrestricted_derivatives(
                    c_fn, density[0], density[1], sigma[0] if needs_sigma else None,
                    sigma[1] if needs_sigma else None, sigma_ab,
                    tau[0] if fn_tau else None, tau[1] if fn_tau else None, params)
            f = f + DFC_prop * eps * (density[0] + density[1])
            local = local + DFC_prop * (dfn_a * d_density[0] + dfn_b * d_density[1])
            if needs_sigma:
                local = local + DFC_prop * (dfs_aa * d_sigma[0] + dfs_bb * d_sigma[1]
                                            + dfs_ab * d_sigma_ab)
            if fn_tau:
                local = local + DFC_prop * (dft_a * d_tau[0] + dft_b * d_tau[1])
        return f, local

    def xc_gradient(R, P):
        points = torch.stack([X, Y, torch.cat([points_A[2], points_A[2] + R])]).contiguous()
        origin = torch.zeros((basis.n_ao, 3), dtype=_F64, device=device)
        origin[:, 2] = ao_moves.to(_F64) * R
        if restricted:
            quantities = dft_grid.density_deriv_on_grid(
                basis, origin, ao_moves, points, n_A, P, needs_gradient, needs_tau)
            f, local = restricted_terms(*cleaned(*quantities))
        else:
            quantities = dft_grid.density_deriv_on_grid_spin(
                basis, origin, ao_moves, points, n_A, P, needs_gradient, needs_tau)
            grad_rho, d_grad_rho = quantities[1], quantities[3]
            f, local = unrestricted_terms(*cleaned(*quantities), grad_rho, d_grad_rho)
        with torch.enable_grad():
            R_t = torch.tensor(R, dtype=_F64, device=device, requires_grad=True)
            w = becke_weights(R_t)
            (d_weights,) = torch.autograd.grad(torch.sum(w * f), R_t)
        return d_weights + torch.sum(w.detach() * local)

    return xc_gradient


def _build_gradient_fn(molecule, calculation, device):
    plan = common.get_integral_plan(molecule)
    charges = torch.as_tensor(np.array([float(c) for c in molecule.charges]), dtype=_F64,
                              device=device)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    mass_fraction = float(masses[1] / masses.sum())
    U = (None if calculation.cartesian_harmonics
         else torch.as_tensor(molecule.spherical_transformation, dtype=_F64, device=device))

    field = np.asarray(calculation.electric_field, dtype=np.float64)
    field_gradient = np.asarray(calculation.electric_field_gradient, dtype=np.float64)
    use_field = bool(np.linalg.norm(field) > 0)
    use_field_gradient = bool(np.linalg.norm(field_gradient) > 0)

    restricted = calculation.reference == "RHF"
    dft = bool(calculation.DFT_calculation)
    hfx = float(calculation.HFX_prop) if dft else 1.0
    xc_gradient = _build_xc_gradient_fn(molecule, calculation, device) if dft else None

    use_d2 = bool(calculation.D2) and not calculation.monatomic
    if use_d2:
        atoms = molecule.atoms
        d2_C6 = float(np.sqrt(atoms[0].C6 * atoms[1].C6))
        d2_vdw = float(atoms[0].vdw_radius + atoms[1].vdw_radius)
        d2_S6 = calculation.functional.D2_S6 if calculation.DFT_calculation else 1.2

    Z_product = float(np.prod([float(c) for c in molecule.charges]))

    def gradient(R, P_a, P_b, W):
        """dE/dR at fixed (spherical) spin densities P_a, P_b and W; for a
        restricted reference only P_a + P_b is read."""
        coords = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, R]], dtype=_F64, device=device)
        # the densities the two-electron and XC terms read: the total P, or
        # the stack of both spins
        P_spins = P_a + P_b if restricted else torch.stack([P_a, P_b])
        if U is not None:
            P_spins, W = U.T @ P_spins @ U, U.T @ W @ U
        P_spins = P_spins.contiguous()
        P = P_spins if restricted else P_spins[0] + P_spins[1]
        dS, dT, dV, dD, dQ = plan.one_electron_deriv(coords, charges, mass_fraction * R,
                                                     mass_fraction)
        dH = dT + dV
        if use_field:
            dH = dH + sum(float(field[i]) * dD[i] for i in range(3))
        if use_field_gradient:
            Q_stack = (dQ[0], dQ[0], dQ[1])   # tuna_tpu's stacking (gradients.py:263)
            dH = dH + sum(float(field_gradient[i]) * Q_stack[i] for i in range(3))
        E_2 = (plan.eri_deriv_energy(coords, P, hfx) if restricted
               else plan.eri_deriv_energy_unrestricted(coords, P_spins[0], P_spins[1], hfx))
        total = torch.sum(P * dH) - torch.sum(W * dS) + E_2
        if xc_gradient is not None:
            total = total + xc_gradient(R, P_spins)
        total = float(total) - Z_product / R**2
        if use_d2:
            f_damp = 1.0 / (1.0 + np.exp(-20.0 * (R / d2_vdw - 1.0)))
            d_damp = 20.0 / d2_vdw * f_damp * (1.0 - f_damp)
            total -= d2_S6 * d2_C6 * (d_damp / R**6 - 6.0 * f_damp / R**7)
        return total

    return gradient


def _energy_weighted_density(SCF_output, molecule, restricted):
    """W = 2 C_occ diag(eps_occ) C_occ^T (restricted), or the sum of each
    spin's C diag(eps) C^T over its occupied orbitals (unrestricted)."""
    if restricted:
        C_occ = SCF_output.molecular_orbitals[:, :molecule.n_doubly_occ]
        eps = SCF_output.epsilons[:molecule.n_doubly_occ]
        return 2.0 * (C_occ * eps) @ C_occ.T
    C_a = SCF_output.molecular_orbitals_alpha[:, :molecule.n_alpha]
    e_a = SCF_output.epsilons_alpha[:molecule.n_alpha]
    W = (C_a * e_a) @ C_a.T
    if molecule.n_beta > 0:
        C_b = SCF_output.molecular_orbitals_beta[:, :molecule.n_beta]
        e_b = SCF_output.epsilons_beta[:molecule.n_beta]
        W = W + (C_b * e_b) @ C_b.T
    return W


def calculate_analytic_gradient(molecule, calculation, SCF_output, coordinates):
    """dE/dR for the converged SCF state at this geometry, on the device of
    its density."""
    device = SCF_output.P.device
    key = (id(common.get_integral_plan(molecule)), str(device), calculation.reference,
           bool(np.linalg.norm(calculation.electric_field) > 0),
           bool(np.linalg.norm(calculation.electric_field_gradient) > 0),
           bool(calculation.D2), calculation.cartesian_harmonics,
           calculation.functional.x_name if calculation.DFT_calculation else None,
           calculation.functional.c_name if calculation.DFT_calculation else None,
           float(calculation.HFX_prop), float(calculation.DFX_prop),
           float(calculation.DFC_prop))
    if key not in _GRAD_CACHE:
        _GRAD_CACHE[key] = _build_gradient_fn(molecule, calculation, device)
    R = float(np.linalg.norm(np.asarray(coordinates)[1] - np.asarray(coordinates)[0]))
    W = _energy_weighted_density(SCF_output, molecule, calculation.reference == "RHF")
    return _GRAD_CACHE[key](R, SCF_output.P_alpha, SCF_output.P_beta, W)
