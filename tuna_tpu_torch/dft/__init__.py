"""Density functional theory: quadrature grids, restricted exchange-
correlation functionals (autograd derivatives) and VV10 non-local
dispersion.

Twin of the restricted branch of tuna_tpu/dft/__init__.py.  The density and
its gradient come from kernel K7b (grid.density_on_grid); the XC matrix is
assembled by plain matrix products over the grid.
"""

from __future__ import annotations

import torch

from ..output import error
from . import xc
from .grid import density_on_grid


def unported_functional(calculation):
    """The name of the calculation's exchange or correlation functional if
    tuna_tpu_torch lacks it, else None."""
    functional = calculation.functional
    if functional.x_name is not None and functional.x_name not in xc.EXCHANGE_FUNCTIONALS:
        return f"The {functional.x_name} exchange functional"
    if (functional.c_name is not None
            and functional.c_name not in xc.CORRELATION_FUNCTIONALS):
        return f"The {functional.c_name} correlation functional"
    return None


def make_xc_fn(calculation):
    """Validated, grid-free restricted XC evaluator.

    Returns xc_fn(P_alpha, P_beta, DFX, DFC, bfs, w, grads) ->
    (V_XC_alpha, V_XC_beta, E_x_grid, E_c_grid, density, alpha_density,
    beta_density)."""
    if calculation.reference != "RHF":
        error("Unrestricted Kohn-Sham is not yet ported to tuna_tpu_torch!")
    missing = unported_functional(calculation)
    if missing is not None:
        error(f"{missing} is not yet ported to tuna_tpu_torch!")

    functional = calculation.functional
    x_fn = xc.EXCHANGE_FUNCTIONALS.get(functional.x_name)
    c_fn = xc.CORRELATION_FUNCTIONALS.get(functional.c_name)
    needs_gradient = functional.functional_class == "GGA"

    def density_quantities(P, bfs, grads):
        density, gradient = density_on_grid(P, bfs, grads if needs_gradient else None)
        density = xc.clean(density)
        sigma = None
        if needs_gradient:
            sigma = xc.clean(torch.sum(gradient * gradient, dim=0), floor=xc.SIGMA_FLOOR)
        return density, sigma, gradient

    def V_matrix(df_dn, df_ds, gradient, bfs, w, grads):
        """sum_k w_k [df/dn phi_m phi_n + 4 df/ds (grad rho . grad phi_n)
        phi_m], symmetrised, as plain matrix products over the grid."""
        n = bfs.shape[0]
        phi = bfs.reshape(n, -1)
        V = (phi * (w * df_dn).reshape(-1)) @ phi.T
        if df_ds is not None:
            # Z_nk = grad rho_k . grad phi_nk
            Z = torch.einsum("ak,ank->nk", gradient.reshape(3, -1), grads.reshape(3, n, -1))
            V = V + 4 * ((phi * (w * df_ds).reshape(-1)) @ Z.T)
        return 0.5 * (V + V.T)

    params = xc.XCParams(x_alpha=calculation.X_alpha, method_name=calculation.method.name,
                         x_name=functional.x_name)

    def xc_fn(P_a, P_b, DFX_prop, DFC_prop, bfs, w, grads):
        P = P_a + P_b
        density, sigma, gradient = density_quantities(P, bfs, grads)
        E_x = E_c = torch.zeros((), dtype=P.dtype, device=P.device)
        V_X = V_C = torch.zeros_like(P)
        if x_fn is not None:
            df_dn, df_ds, _, e_X = xc.restricted_derivatives(x_fn, density, sigma, None, params)
            V_X = V_matrix(df_dn, df_ds, gradient, bfs, w, grads)
            E_x = torch.sum(e_X * density * w) * DFX_prop
        if c_fn is not None:
            df_dn, df_ds, _, e_C = xc.restricted_derivatives(c_fn, density, sigma, None, params)
            V_C = V_matrix(df_dn, df_ds, gradient, bfs, w, grads)
            E_c = torch.sum(e_C * density * w) * DFC_prop

        V_XC = V_X * DFX_prop + V_C * DFC_prop
        return (V_XC, V_XC, E_x, E_c, density.reshape(-1),
                (density / 2).reshape(-1), (density / 2).reshape(-1))

    return xc_fn


def make_xc_closure(calculation, grid_container):
    """The per-iteration XC evaluation of the SCF: a callable (P_alpha,
    P_beta, DFX, DFC) -> (V_XC_alpha, V_XC_beta, E_x_grid, E_c_grid,
    density, alpha_density, beta_density) over the grid tensors."""
    bfs, w, grads, _ = grid_container
    xc_fn = make_xc_fn(calculation)

    def closure(P_a, P_b, DFX_prop, DFC_prop):
        return xc_fn(P_a, P_b, DFX_prop, DFC_prop, bfs, w, grads)

    return closure
