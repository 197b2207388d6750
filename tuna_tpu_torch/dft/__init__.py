"""Density functional theory: quadrature grids, exchange-correlation
functionals (autograd derivatives) and VV10 non-local dispersion.

Twin of tuna_tpu/dft/__init__.py for LDA, GGA and meta-GGA functionals,
restricted and unrestricted.  The density and its gradient come from
kernel K7b (grid.density_on_grid), with the kinetic energy density tau of
a meta-GGA from K7bt, once per spin for an unrestricted reference; the XC
matrix is assembled by plain matrix products over the grid.
"""

from __future__ import annotations

import torch

from ..output import error
from . import xc
from .grid import density_on_grid


def unported_functional(calculation, reference=None):
    """The name of the calculation's exchange or correlation functional if
    tuna_tpu_torch lacks it, else None; the correlation functional is
    looked up in the registry of the reference ("RHF" or "UHF"; the
    calculation's by default), as tuna_tpu looks it up
    (drivers/gradients.py:52-56)."""
    functional = calculation.functional
    if functional.x_name is not None and functional.x_name not in xc.EXCHANGE_FUNCTIONALS:
        return f"The {functional.x_name} exchange functional"
    registry = (xc.CORRELATION_FUNCTIONALS if (reference or calculation.reference) == "RHF"
                else xc.UNRESTRICTED_CORRELATION_FUNCTIONALS)
    if functional.c_name is not None and functional.c_name not in registry:
        return f"The {functional.c_name} correlation functional"
    return None


def make_xc_fn(calculation):
    """Validated, grid-free XC evaluator.

    Returns xc_fn(P_alpha, P_beta, DFX, DFC, bfs, w, grads) ->
    (V_XC_alpha, V_XC_beta, E_x_grid, E_c_grid, density, alpha_density,
    beta_density)."""
    missing = unported_functional(calculation)
    if missing is not None:
        error(f"{missing} is not yet ported to tuna_tpu_torch!")

    functional = calculation.functional
    restricted = calculation.reference == "RHF"
    x_fn = xc.EXCHANGE_FUNCTIONALS.get(functional.x_name)
    c_fn = (xc.CORRELATION_FUNCTIONALS.get(functional.c_name) if restricted
            else xc.UNRESTRICTED_CORRELATION_FUNCTIONALS.get(functional.c_name))
    needs_gradient = functional.functional_class in ("GGA", "meta-GGA")
    needs_tau = functional.functional_class == "meta-GGA"

    def density_quantities(P, bfs, grads):
        tau = None
        if needs_tau:
            density, gradient, tau = density_on_grid(P, bfs, grads, with_tau=True)
            tau = xc.clean(tau)
        else:
            density, gradient = density_on_grid(P, bfs, grads if needs_gradient else None)
        density = xc.clean(density)
        sigma = None
        if needs_gradient:
            sigma = xc.clean(torch.sum(gradient * gradient, dim=0), floor=xc.SIGMA_FLOOR)
        return density, sigma, tau, gradient

    def V_matrix(df_dn, df_ds, df_dt, gradient, bfs, w, grads, gradient_other=None,
                 df_ds_ab=None):
        """sum_k w_k [df/dn phi_m phi_n + 4 df/ds (grad rho . grad phi_n)
        phi_m (+ 2 df/ds_ab (grad rho_other . grad phi_n) phi_m) + 1/2 df/dt
        grad phi_m . grad phi_n], symmetrised, as plain matrix products over
        the grid."""
        n = bfs.shape[0]
        phi = bfs.reshape(n, -1)
        V = (phi * (w * df_dn).reshape(-1)) @ phi.T
        if df_ds is not None:
            grad_phi = grads.reshape(3, n, -1)
            # Z_nk = grad rho_k . grad phi_nk
            Z = torch.einsum("ak,ank->nk", gradient.reshape(3, -1), grad_phi)
            V = V + 4 * ((phi * (w * df_ds).reshape(-1)) @ Z.T)
            if df_ds_ab is not None:
                Z = torch.einsum("ak,ank->nk", gradient_other.reshape(3, -1), grad_phi)
                V = V + 2 * ((phi * (w * df_ds_ab).reshape(-1)) @ Z.T)
        if df_dt is not None:
            weighted = (w * df_dt).reshape(-1)
            V = V + 0.5 * sum((g * weighted) @ g.T for g in grads.reshape(3, n, -1))
        return 0.5 * (V + V.T)

    params = xc.XCParams(x_alpha=calculation.X_alpha, method_name=calculation.method.name,
                         x_name=functional.x_name)

    def restricted_xc_fn(P_a, P_b, DFX_prop, DFC_prop, bfs, w, grads):
        P = P_a + P_b
        density, sigma, tau, gradient = density_quantities(P, bfs, grads)
        E_x = E_c = torch.zeros((), dtype=P.dtype, device=P.device)
        V_X = V_C = torch.zeros_like(P)
        if x_fn is not None:
            df_dn, df_ds, df_dt, e_X = xc.restricted_derivatives(x_fn, density, sigma, tau,
                                                                 params)
            V_X = V_matrix(df_dn, df_ds, df_dt, gradient, bfs, w, grads)
            E_x = torch.sum(e_X * density * w) * DFX_prop
        if c_fn is not None:
            df_dn, df_ds, df_dt, e_C = xc.restricted_derivatives(c_fn, density, sigma, tau,
                                                                 params)
            V_C = V_matrix(df_dn, df_ds, df_dt, gradient, bfs, w, grads)
            E_c = torch.sum(e_C * density * w) * DFC_prop

        V_XC = V_X * DFX_prop + V_C * DFC_prop
        return (V_XC, V_XC, E_x, E_c, density.reshape(-1),
                (density / 2).reshape(-1), (density / 2).reshape(-1))

    def unrestricted_xc_fn(P_a, P_b, DFX_prop, DFC_prop, bfs, w, grads):
        dens_a, sigma_aa, tau_a, grad_a = density_quantities(P_a, bfs, grads)
        dens_b, sigma_bb, tau_b, grad_b = density_quantities(P_b, bfs, grads)
        density = dens_a + dens_b
        sigma_ab = torch.sum(grad_a * grad_b, dim=0) if needs_gradient else None
        E_x = E_c = torch.zeros((), dtype=P_a.dtype, device=P_a.device)
        V_X_a = V_X_b = V_C_a = V_C_b = torch.zeros_like(P_a)
        if x_fn is not None:
            # exact spin scaling: E_x[na, nb] = (Ex[2 na] + Ex[2 nb]) / 2
            sa = 4 * sigma_aa if sigma_aa is not None else None
            sb = 4 * sigma_bb if sigma_bb is not None else None
            ta = 2 * tau_a if tau_a is not None else None
            tb = 2 * tau_b if tau_b is not None else None
            dfn_a, dfs_a, dft_a, e_X_a = xc.restricted_derivatives(x_fn, 2 * dens_a, sa, ta,
                                                                   params)
            dfn_b, dfs_b, dft_b, e_X_b = xc.restricted_derivatives(x_fn, 2 * dens_b, sb, tb,
                                                                   params)
            dfs_a2 = 2 * dfs_a if dfs_a is not None else None
            dfs_b2 = 2 * dfs_b if dfs_b is not None else None
            V_X_a = V_matrix(dfn_a, dfs_a2, dft_a, grad_a, bfs, w, grads)
            V_X_b = V_matrix(dfn_b, dfs_b2, dft_b, grad_b, bfs, w, grads)
            E_x = (torch.sum(e_X_a * dens_a * w) + torch.sum(e_X_b * dens_b * w)) * DFX_prop
        if c_fn is not None:
            dfn_a, dfn_b, dfs_aa, dfs_bb, dfs_ab, dft_a, dft_b, e_C = \
                xc.unrestricted_derivatives(c_fn, dens_a, dens_b, sigma_aa, sigma_bb, sigma_ab,
                                            tau_a, tau_b, params)
            V_C_a = V_matrix(dfn_a, dfs_aa, dft_a, grad_a, bfs, w, grads, grad_b, dfs_ab)
            V_C_b = V_matrix(dfn_b, dfs_bb, dft_b, grad_b, bfs, w, grads, grad_a, dfs_ab)
            E_c = torch.sum(e_C * density * w) * DFC_prop

        V_XC_a = V_X_a * DFX_prop + V_C_a * DFC_prop
        V_XC_b = V_X_b * DFX_prop + V_C_b * DFC_prop
        return (V_XC_a, V_XC_b, E_x, E_c, density.reshape(-1),
                dens_a.reshape(-1), dens_b.reshape(-1))

    return restricted_xc_fn if restricted else unrestricted_xc_fn


def make_xc_closure(calculation, grid_container):
    """The per-iteration XC evaluation of the SCF: a callable (P_alpha,
    P_beta, DFX, DFC) -> (V_XC_alpha, V_XC_beta, E_x_grid, E_c_grid,
    density, alpha_density, beta_density) over the grid tensors."""
    bfs, w, grads, _ = grid_container
    xc_fn = make_xc_fn(calculation)

    def closure(P_a, P_b, DFX_prop, DFC_prop):
        return xc_fn(P_a, P_b, DFX_prop, DFC_prop, bfs, w, grads)

    return closure
