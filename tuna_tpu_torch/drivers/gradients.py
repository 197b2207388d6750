"""Analytic nuclear gradients of restricted SCF energies (RHF and RKS with
the port's LDA and GGA functionals).

Twin of the restricted branch of tuna_tpu/drivers/gradients.py.  For a
converged SCF the energy is variational in the density, so dE/dR is the
derivative of the energy expression at fixed density plus the Pulay term
with the energy-weighted density W (tuna_tpu's total_energy, term for term):

    dE/dR = sum P (T' + V') [+ sum_i F_i sum P D_i' + F_grad . Q']
          + E_2'(P) - sum W S' - Z_A Z_B / R^2 + E_xc'(R, P) [+ E_D2'(R)]

A diatomic has one coordinate, R (atom 1 at (0, 0, R)), so instead of
jax.grad's reverse mode the port takes R-tangents at fixed P and W: K8a
(IntegralPlan.one_electron_deriv) for the one-electron integrals, K8b
(IntegralPlan.eri_deriv_energy) for the two-electron energy, K8c
(dft.grid.density_deriv_on_grid) for the density on the moving grid.  The
spherical transform is linear, so P and W enter in the Cartesian basis
(U^T P U).  The rest of E_xc' is elementwise torch: the functionals'
derivatives by the same autograd the SCF's V_XC uses, and the Becke
weights' R-derivative by autograd on the weights alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dft import grid as dft_grid
from ..dft import xc
from ..output import error
from . import common

_F64 = torch.float64


def analytic_gradient_available(calculation, molecule=None) -> bool:
    """True when the restricted SCF energy has an analytic gradient here:
    Hartree-Fock, or Kohn-Sham with the port's restricted LDA/GGA
    functionals (VV10, double hybrids and ghost-atom grids go through
    finite differences, as in tuna_tpu).  Raises for the unrestricted SCF
    energies that tuna_tpu differentiates analytically."""
    method = calculation.method
    if calculation.extrapolate or calculation.decontract or method.correlated_method:
        return False
    if calculation.reference != "RHF":
        # tuna_tpu differentiates UHF (and UKS) analytically; finite
        # differences here would take another route than the reference's
        if method.name in ("HF", "UHF") or calculation.DFT_calculation:
            error("Unrestricted analytic gradients are not yet ported to tuna_tpu_torch!")
        return False
    if method.name == "HF":
        return True
    if calculation.DFT_calculation:
        functional = calculation.functional
        if calculation.VV10 or calculation.MPC_prop > 0:
            return False
        if molecule is not None and any(a.ghost for a in molecule.atoms):
            return False
        if functional.functional_class not in ("LDA", "GGA"):
            return False
        return ((functional.x_name is None or functional.x_name in xc.EXCHANGE_FUNCTIONALS)
                and (functional.c_name is None
                     or functional.c_name in xc.CORRELATION_FUNCTIONALS))
    return False


_GRAD_CACHE: dict = {}


def _build_xc_gradient_fn(molecule, calculation, device):
    """(R, P_cart) -> dE_xc/dR at fixed P: the moving grid's density and
    its tangent from K8c, then tuna_tpu's _build_xc_energy_fn derivative
    (restricted) as elementwise torch."""
    functional = calculation.functional
    x_fn = xc.EXCHANGE_FUNCTIONALS.get(functional.x_name)
    c_fn = xc.CORRELATION_FUNCTIONALS.get(functional.c_name)
    params = xc.XCParams(x_alpha=calculation.X_alpha, method_name=calculation.method.name,
                         x_name=functional.x_name)
    needs_gradient = functional.functional_class == "GGA"
    terms = [(fn, float(prop)) for fn, prop in ((x_fn, calculation.DFX_prop),
                                               (c_fn, calculation.DFC_prop)) if fn is not None]

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

    def xc_gradient(R, P):
        points = torch.stack([X, Y, torch.cat([points_A[2], points_A[2] + R])]).contiguous()
        origin = torch.zeros((basis.n_ao, 3), dtype=_F64, device=device)
        origin[:, 2] = ao_moves.to(_F64) * R
        rho, grad_rho, d_rho, d_grad_rho = dft_grid.density_deriv_on_grid(
            basis, origin, ao_moves, points, n_A, P, needs_gradient)
        # the floors of xc.clean pass no derivative below them
        density = xc.clean(rho)
        d_density = torch.where(rho > xc.DENSITY_FLOOR, d_rho, 0.0)
        sigma = d_sigma = None
        if needs_gradient:
            sigma_raw = torch.sum(grad_rho * grad_rho, dim=0)
            sigma = xc.clean(sigma_raw, floor=xc.SIGMA_FLOOR)
            d_sigma = torch.where(sigma_raw > xc.SIGMA_FLOOR,
                                  2 * torch.sum(grad_rho * d_grad_rho, dim=0), 0.0)
        f = torch.zeros_like(density)
        local = torch.zeros_like(density)
        for fn, prop in terms:
            needs_sigma = getattr(fn, "needs_sigma", False)
            df_dn, df_ds, _, eps = xc.restricted_derivatives(
                fn, density, sigma if needs_sigma else None, None, params)
            f = f + prop * eps * density
            local = local + prop * df_dn * d_density
            if needs_sigma:
                local = local + prop * df_ds * d_sigma
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

    def gradient(R, P, W):
        coords = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, R]], dtype=_F64, device=device)
        if U is not None:
            P, W = U.T @ P @ U, U.T @ W @ U
        dS, dT, dV, dD, dQ = plan.one_electron_deriv(coords, charges, mass_fraction * R,
                                                     mass_fraction)
        dH = dT + dV
        if use_field:
            dH = dH + sum(float(field[i]) * dD[i] for i in range(3))
        if use_field_gradient:
            Q_stack = (dQ[0], dQ[0], dQ[1])   # tuna_tpu's stacking (gradients.py:263)
            dH = dH + sum(float(field_gradient[i]) * Q_stack[i] for i in range(3))
        total = (torch.sum(P * dH) - torch.sum(W * dS)
                 + plan.eri_deriv_energy(coords, P.contiguous(), hfx))
        if xc_gradient is not None:
            total = total + xc_gradient(R, P.contiguous())
        total = float(total) - Z_product / R**2
        if use_d2:
            f_damp = 1.0 / (1.0 + np.exp(-20.0 * (R / d2_vdw - 1.0)))
            d_damp = 20.0 / d2_vdw * f_damp * (1.0 - f_damp)
            total -= d2_S6 * d2_C6 * (d_damp / R**6 - 6.0 * f_damp / R**7)
        return total

    return gradient


def _energy_weighted_density(SCF_output, molecule):
    """W = 2 C_occ diag(eps_occ) C_occ^T (restricted)."""
    C_occ = SCF_output.molecular_orbitals[:, :molecule.n_doubly_occ]
    eps = SCF_output.epsilons[:molecule.n_doubly_occ]
    return 2.0 * (C_occ * eps) @ C_occ.T


def calculate_analytic_gradient(molecule, calculation, SCF_output, coordinates):
    """dE/dR for the converged restricted SCF state at this geometry, on the
    device of its density."""
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
    P = SCF_output.P_alpha + SCF_output.P_beta
    return _GRAD_CACHE[key](R, P, _energy_weighted_density(SCF_output, molecule))
