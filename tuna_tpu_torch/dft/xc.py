"""Exchange-correlation functionals as energy densities with autograd
derivatives.

Twin of the LDA and GGA functionals of tuna_tpu/dft/xc.py: each restricted
functional is one energy-density expression f(rho, sigma, tau) = rho * eps,
each spin-resolved correlation functional one expression f(rho_a, rho_b,
sigma_aa, sigma_bb, sigma_ab, tau_a, tau_b), and their derivatives come from
torch.autograd.grad of the summed density.  Unrestricted exchange takes the
restricted functional by exact spin scaling (the caller's work).  Parameter
values follow tuna_tpu (and through it the reference and LibXC).

torch has no cube root.  Every cube root here takes an argument >= 0 (the
densities and sigma are floored by `clean`, and the spin factors 1 +- zeta
lie in [0, 2]), so `_cbrt` is `x.pow(1/3)`; for constants it is the float
power.  tests/test_torch_dft.py holds it against jnp.cbrt.

The meta-GGAs (TPSS, the SCAN family, B97M) and B97 are not ported yet:
their names are absent from the registries below, and drivers/energy.py
refuses them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

DENSITY_FLOOR = 1e-23
SIGMA_FLOOR = DENSITY_FLOOR**2
PI = math.pi


@dataclass(frozen=True)
class XCParams:
    x_alpha: float = 2 / 3
    method_name: str = ""
    x_name: str | None = None


def clean(values, floor=DENSITY_FLOOR):
    """Floor tiny/negative grid values that break functional evaluation."""
    return torch.clamp(values, min=floor)


def _cbrt(x):
    """Cube root of a positive tensor or float (torch has no cbrt)."""
    if isinstance(x, torch.Tensor):
        return x.pow(1.0 / 3.0)
    return float(x) ** (1.0 / 3.0)


# =========================================================================
# Derivative machinery
# =========================================================================

def restricted_derivatives(functional, density, sigma, tau, params: XCParams):
    """(df_dn, df_ds, df_dt, eps) for f(rho, sigma, tau) = rho * eps.

    The derivatives are autograd's of the summed energy density with respect
    to detached copies of the inputs, under enable_grad so that a caller in
    no_grad mode gets them too."""
    needs_sigma = getattr(functional, "needs_sigma", False)
    with torch.enable_grad():
        n = density.detach().requires_grad_()
        s = sigma.detach().requires_grad_() if needs_sigma else None
        f = functional(n, s, None, params)
        inputs = [n, s] if needs_sigma else [n]
        grads = torch.autograd.grad(f.sum(), inputs)
    eps = f.detach() / density
    return grads[0], grads[1] if needs_sigma else None, None, eps


def unrestricted_derivatives(functional, dens_a, dens_b, sigma_aa, sigma_bb, sigma_ab,
                             tau_a, tau_b, params: XCParams):
    """(df_dna, df_dnb, df_dsaa, df_dsbb, df_dsab, df_dta, df_dtb, eps) for
    the spin-resolved f(na, nb, saa, sbb, sab, ta, tb) = (na + nb) * eps;
    the sigma derivatives are None unless the functional reads sigma, the
    tau ones always (no meta-GGA is ported)."""
    needs_sigma = getattr(functional, "needs_sigma", False)
    with torch.enable_grad():
        inputs = [dens_a.detach().requires_grad_(), dens_b.detach().requires_grad_()]
        sigmas = [None, None, None]
        if needs_sigma:
            sigmas = [s.detach().requires_grad_() for s in (sigma_aa, sigma_bb, sigma_ab)]
            inputs += sigmas
        f = functional(inputs[0], inputs[1], *sigmas, None, None, params)
        grads = torch.autograd.grad(f.sum(), inputs, materialize_grads=True)
    eps = f.detach() / (dens_a + dens_b)
    d_sigma = grads[2:] if needs_sigma else (None, None, None)
    return (grads[0], grads[1], *d_sigma, None, None, eps)


def _mark(fn, needs_sigma=False):
    fn.needs_sigma = needs_sigma
    fn.needs_tau = False
    return fn


# =========================================================================
# Exchange energy densities (closed-shell total-density form, f = rho * eps)
# =========================================================================

def _slater_eps(density, alpha):
    return -(9 / 8) * alpha * _cbrt(3 / PI) * _cbrt(density)


def f_slater_x(density, sigma, tau, params):
    return density * _slater_eps(density, params.x_alpha)


def _b88_f_spin(rho_s, sigma_s, beta=0.0042):
    """Per-spin B88 f = rho_s * eps_s (Becke 1988)."""
    cbrt_rho = _cbrt(rho_s)
    x = torch.sqrt(sigma_s) / cbrt_rho**4
    lda = -(3 / 2) * _cbrt(3 / (4 * PI)) * rho_s * cbrt_rho
    gga = -beta * rho_s * cbrt_rho * x**2 / (1 + 6 * beta * x * torch.asinh(x))
    return lda + gga


def f_b88_x(density, sigma, tau, params):
    return 2 * _b88_f_spin(density / 2, sigma / 4)


def f_b3_x(density, sigma, tau, params):
    """B3LYP exchange mix: 0.9 B88 + 0.1 Slater (with DFX = 0.8 and HFX =
    0.2 this gives the standard 0.72/0.08/0.20 split)."""
    return 0.9 * f_b88_x(density, sigma, tau, params) + 0.1 * f_slater_x(density, sigma, tau, params)


def _pbe_x_family(density, sigma, params, kappa, form="pbe"):
    mu = 0.21952
    s_squared = sigma / (_cbrt(576 * PI**4) * _cbrt(density)**8)
    if form == "rpbe":
        F_X = 1 + kappa * (1 - torch.exp(-mu * s_squared / kappa))
    else:
        F_X = 1 + kappa - kappa / (1 + mu / kappa * s_squared)
    return density * _slater_eps(density, params.x_alpha) * F_X


def f_pbe_x(density, sigma, tau, params):
    kappa = 1.245 if params.x_name == "REVPBE" else 0.804
    return _pbe_x_family(density, sigma, params, kappa)


def f_rpbe_x(density, sigma, tau, params):
    return _pbe_x_family(density, sigma, params, 0.804, form="rpbe")


def _pw91_f_spin(rho_s, sigma_s):
    """PW91 exchange per spin (Perdew-Wang 1991 enhancement factor)."""
    k_F = _cbrt(6 * PI**2 * rho_s)
    s = torch.sqrt(sigma_s) / (2 * k_F * rho_s)
    s2 = s * s
    a, b, c, d = 0.19645, 7.7956, 0.2743, 0.1508
    F = ((1 + a * s * torch.asinh(b * s) + (c - d * torch.exp(-100.0 * s2)) * s2)
         / (1 + a * s * torch.asinh(b * s) + 0.004 * s2 * s2))
    lda = -(3 / 2) * _cbrt(3 / (4 * PI)) * rho_s * _cbrt(rho_s)
    return lda * F


def f_pw91_x(density, sigma, tau, params):
    return 2 * _pw91_f_spin(density / 2, sigma / 4)


def f_mpw91_x(density, sigma, tau, params):
    """Modified PW91 (Adamo-Barone) exchange in the reference's closed-shell
    total-density form (tuna_xc.py:521-592)."""
    beta = 5.0 / _cbrt(36.0 * PI)**5
    b, c, d, eps = 0.00426, 1.6455, 3.72, 1e-6
    e_lda = _slater_eps(density, params.x_alpha)
    cbrt_half = _cbrt(density / 2.0)
    x = torch.sqrt(sigma) / (density * cbrt_half)
    x2 = x * x
    x_pow_d = x**d
    K = e_lda / cbrt_half
    N = b * x2 - (b - beta) * x2 * torch.exp(-c * x2) - eps * x_pow_d
    D = 1.0 + 6.0 * b * x * torch.asinh(x) - eps * x_pow_d / K
    return density * (e_lda - (N / D) * cbrt_half)


# =========================================================================
# LDA correlation: VWN and PW92 parameterisations
# =========================================================================

def _seitz_radius(density):
    return _cbrt(3 / (4 * PI * density))


def _vwn_eps(density, x_0, b, c, A):
    Q = math.sqrt(4 * c - b**2)
    X_0 = x_0**2 + b * x_0 + c
    c_1 = -b * x_0 / X_0
    c_2 = 2 * b * (c - x_0**2) / (Q * X_0)
    r_s = _seitz_radius(density)
    x = torch.sqrt(r_s)
    X = r_s + b * x + c
    return A * (torch.log(r_s / X) + c_1 * torch.log((x - x_0)**2 / X)
                + c_2 * torch.atan(Q / (2 * x + b)))


_VWN3_PARA = (-0.409286, 13.0720, 42.7198, 0.0310907)
_VWN3_FERRO = (-0.743294, 20.1231, 101.578, 0.01554535)
_VWN5_PARA = (-0.10498, 3.72744, 12.9352, 0.0310907)
_VWN5_FERRO = (-0.32500, 7.06042, 18.0578, 0.01554535)
_VWN5_STIFF = (-0.0047584, 1.13107, 13.0045, 1 / (6 * PI**2))


def _pw92_eps(density, A, alpha_1, beta_1, beta_2, beta_3, beta_4, P=1):
    r_s = _seitz_radius(density)
    Q_0 = -2 * A * (1 + alpha_1 * r_s)
    Q_1 = 2 * A * (beta_1 * torch.sqrt(r_s) + beta_2 * r_s
                   + beta_3 * r_s**1.5 + beta_4 * r_s**(P + 1))
    return Q_0 * torch.log1p(1 / Q_1)


_PW92_PARA = (0.0310907, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
_PW92_FERRO = (0.01554535, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
_PW92_STIFF = (0.0168869, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)


def _zeta_f(zeta):
    return (_cbrt(1 + zeta)**4 + _cbrt(1 - zeta)**4 - 2) / (_cbrt(2)**4 - 2)


def f_vwn3_c(density, sigma, tau, params):
    return density * _vwn_eps(density, *_VWN3_PARA)


def f_vwn5_c(density, sigma, tau, params):
    return density * _vwn_eps(density, *_VWN5_PARA)


def f_pw_c(density, sigma, tau, params):
    return density * _pw92_eps(density, *_PW92_PARA)


def f_u_vwn3_c(na, nb, saa, sbb, sab, ta, tb, params):
    density = na + nb
    zeta = (na - nb) / density
    e0 = _vwn_eps(density, *_VWN3_PARA)
    e1 = _vwn_eps(density, *_VWN3_FERRO)
    return density * (e0 + (e1 - e0) * _zeta_f(zeta))


def f_u_vwn5_c(na, nb, saa, sbb, sab, ta, tb, params):
    density = na + nb
    zeta = (na - nb) / density
    e0 = _vwn_eps(density, *_VWN5_PARA)
    e1 = _vwn_eps(density, *_VWN5_FERRO)
    minus_alpha = _vwn_eps(density, *_VWN5_STIFF)
    alpha_c = -minus_alpha
    fz = _zeta_f(zeta)
    fpp0 = 8 / (9 * (_cbrt(2)**4 - 2))
    z4 = zeta**4
    eps = e0 + alpha_c * fz / fpp0 * (1 - z4) + (e1 - e0) * fz * z4
    return density * eps


def _pw92_eps_spin(density, zeta):
    e0 = _pw92_eps(density, *_PW92_PARA)
    e1 = _pw92_eps(density, *_PW92_FERRO)
    alpha_c = -_pw92_eps(density, *_PW92_STIFF)
    fz = _zeta_f(zeta)
    fpp0 = 8 / (9 * (_cbrt(2)**4 - 2))
    z4 = zeta**4
    return e0 + alpha_c * fz / fpp0 * (1 - z4) + (e1 - e0) * fz * z4


def f_u_pw_c(na, nb, saa, sbb, sab, ta, tb, params):
    density = na + nb
    zeta = (na - nb) / density
    return density * _pw92_eps_spin(density, zeta)


# =========================================================================
# GGA correlation: LYP, PBE, P86, PW91
# =========================================================================

def _lyp_f(na, nb, saa, sbb, sab):
    """Spin-resolved LYP (Miehlich-Savin-Stoll-Preuss form)."""
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    density = na + nb
    inv_cbrt = 1 / _cbrt(density)
    X = 1 + d * inv_cbrt
    C = _cbrt(2.0)**11 * 3 / 10 * _cbrt(3 * PI**2)**2
    omega = inv_cbrt**11 * torch.exp(-c * inv_cbrt) / X
    delta = inv_cbrt * (c + d / X)
    minus_abw = -a * b * omega
    product = na * nb
    power_sum = _cbrt(na)**8 + _cbrt(nb)**8

    g_aa = minus_abw * ((1 / 9) * product * (1 - 3 * delta - (delta - 11) * na / density) - nb * nb)
    g_bb = minus_abw * ((1 / 9) * product * (1 - 3 * delta - (delta - 11) * nb / density) - na * na)
    g_ab = minus_abw * ((1 / 9) * product * (47 - 7 * delta) - (4 / 3) * density * density)

    return (product * (C * minus_abw * power_sum - 4 * a / (X * density))
            + g_aa * saa + g_bb * sbb + g_ab * sab)


def f_lyp_c(density, sigma, tau, params):
    half, quarter = density / 2, sigma / 4
    return _lyp_f(half, half, quarter, quarter, quarter)


def f_u_lyp_c(na, nb, saa, sbb, sab, ta, tb, params):
    return _lyp_f(na, nb, saa, sbb, sab)


def _pbe_c_f(density, zeta, sigma):
    """PBE correlation on the PW92 LDA base (beta matched to ORCA)."""
    gamma = (1 - math.log(2.0)) / PI**2
    beta = 0.066725
    eps_lda = _pw92_eps_spin(density, zeta)
    phi = (_cbrt(1 + zeta)**2 + _cbrt(1 - zeta)**2) / 2
    k_F = _cbrt(3 * PI**2 * density)
    t_squared = sigma * PI / (16 * phi**2 * k_F * density**2)
    A = beta / (gamma * (torch.exp(-eps_lda / (gamma * phi**3)) - 1))
    k = 1 + A * t_squared
    D = k + A * A * t_squared * t_squared
    H = gamma * phi**3 * torch.log1p((beta / gamma) * t_squared * k / D)
    return density * (eps_lda + H)


def f_pbe_c(density, sigma, tau, params):
    return _pbe_c_f(density, torch.zeros_like(density), sigma)


def f_u_pbe_c(na, nb, saa, sbb, sab, ta, tb, params):
    density = na + nb
    zeta = (na - nb) / density
    sigma = saa + 2 * sab + sbb
    return _pbe_c_f(density, zeta, sigma)


def _p86_f(na, nb, saa, sbb, sab):
    """Perdew 1986 gradient correction on the PW92 local base (the reference
    convention, tuna_xc.py:2375-2556)."""
    alpha, beta, gamma_, delta, f_tilde = 0.023266, 0.000007389, 8.723, 0.472, 0.11
    density = na + nb
    sigma = clean(saa + sbb + 2 * sab, SIGMA_FLOOR)
    zeta = (na - nb) / density
    r_s = _seitz_radius(density)
    cbrt_density = _cbrt(density)

    N = 0.002568 + alpha * r_s + beta * r_s**2
    D = 1 + gamma_ * r_s + delta * r_s**2 + 1e4 * beta * r_s**3
    C = 0.001667 + N / D
    C_inf = 0.004235
    phi = (1.745 * f_tilde * C_inf / C * torch.sqrt(sigma)
           / torch.sqrt(cbrt_density**7))
    d_spin = torch.sqrt((_cbrt(clean(1 + zeta))**5
                         + _cbrt(clean(1 - zeta))**5) / 2)
    eps_lda = _pw92_eps_spin(density, zeta)
    H = (C * sigma * torch.exp(-phi) / cbrt_density**7) / d_spin
    return density * (eps_lda + H)


def f_p86_c(density, sigma, tau, params):
    half, quarter = density / 2, sigma / 4
    return _p86_f(half, half, quarter, quarter, quarter)


def f_u_p86_c(na, nb, saa, sbb, sab, ta, tb, params):
    return _p86_f(na, nb, saa, sbb, sab)


def f_3p_c(density, sigma, tau, params):
    """B3LYP-style 3-parameter correlation: 0.81 GGA + 0.19 LDA
    (tuna_xc.py:5843-5883; the "/G" spelling selects VWN-III)."""
    method = params.method_name
    lda = f_vwn3_c if "G" in method else f_vwn5_c
    gga = f_p86_c if "P86" in method else f_lyp_c
    return 0.81 * gga(density, sigma, tau, params) + 0.19 * lda(density, None, None, params)


def f_u_3p_c(na, nb, saa, sbb, sab, ta, tb, params):
    method = params.method_name
    lda = f_u_vwn3_c if "G" in method else f_u_vwn5_c
    gga = f_u_p86_c if "P86" in method else f_u_lyp_c
    return (0.81 * gga(na, nb, saa, sbb, sab, ta, tb, params)
            + 0.19 * lda(na, nb, None, None, None, None, None, params))


def _phi_zeta(zeta):
    return (_cbrt(clean(1.0 + zeta))**2 + _cbrt(clean(1.0 - zeta))**2) / 2.0


def _pw91_c_f(na, nb, sigma):
    """PW91 correlation (tuna_xc.py:2562-2918), spin-resolved form."""
    density = na + nb
    zeta = (na - nb) / density
    eps_lda = _pw92_eps_spin(density, zeta)

    C_0, C_X, alpha = 0.004235, -0.001667212, 0.09
    beta = 16.0 * _cbrt(3.0 / PI) * C_0
    r_s = _seitz_radius(density)
    k_F = _cbrt(3.0 * PI**2 * density)
    k_s = torch.sqrt(4.0 * k_F / PI)
    phi = _phi_zeta(zeta)
    phi3 = phi**3
    t2 = sigma / (2.0 * phi * k_s * density)**2

    C_num = 0.002568 + 0.023266 * r_s + 7.389e-6 * r_s**2
    C_den = 1.0 + 8.723 * r_s + 0.472 * r_s**2 + 7.389e-2 * r_s**3
    C = -C_X + C_num / C_den
    A = 2.0 * alpha / beta / (torch.exp(-2.0 * alpha * eps_lda / (phi3 * beta**2)) - 1.0)
    B = C - C_0 - 3.0 * C_X / 7.0
    At2 = A * t2
    Y = 1.0 + 2.0 * alpha / beta * t2 * (1.0 + At2) / (1.0 + At2 + At2 * At2)
    H_0 = phi3 * beta**2 / (2.0 * alpha) * torch.log(Y)
    H_1 = (16.0 * _cbrt(3.0 / PI) * B * phi3 * t2
           * torch.exp(-100.0 * phi3 * phi * t2 * k_s**2 / k_F**2))
    return density * (eps_lda + H_0 + H_1)


def f_pw91_c(density, sigma, tau, params):
    half = density / 2.0
    return _pw91_c_f(half, half, sigma)


def f_u_pw91_c(na, nb, saa, sbb, sab, ta, tb, params):
    return _pw91_c_f(na, nb, clean(saa + sbb + 2.0 * sab, SIGMA_FLOOR))


# =========================================================================
# Registries (the LDA and GGA functionals ported so far)
# =========================================================================

EXCHANGE_FUNCTIONALS = {
    "S": _mark(f_slater_x),
    "B": _mark(f_b88_x, needs_sigma=True),
    "B3": _mark(f_b3_x, needs_sigma=True),
    "PBE": _mark(f_pbe_x, needs_sigma=True),
    "REVPBE": _mark(f_pbe_x, needs_sigma=True),
    "RPBE": _mark(f_rpbe_x, needs_sigma=True),
    "PW": _mark(f_pw91_x, needs_sigma=True),
    "MPW": _mark(f_mpw91_x, needs_sigma=True),
}

CORRELATION_FUNCTIONALS = {
    "VWN3": _mark(f_vwn3_c),
    "VWN5": _mark(f_vwn5_c),
    "PW": _mark(f_pw_c),
    "LYP": _mark(f_lyp_c, needs_sigma=True),
    "3P": _mark(f_3p_c, needs_sigma=True),
    "PBE": _mark(f_pbe_c, needs_sigma=True),
    "P86": _mark(f_p86_c, needs_sigma=True),
    "UP86": _mark(f_p86_c, needs_sigma=True),
    "PW91": _mark(f_pw91_c, needs_sigma=True),
}

UNRESTRICTED_CORRELATION_FUNCTIONALS = {
    "VWN3": _mark(f_u_vwn3_c),
    "VWN5": _mark(f_u_vwn5_c),
    "PW": _mark(f_u_pw_c),
    "LYP": _mark(f_u_lyp_c, needs_sigma=True),
    "3P": _mark(f_u_3p_c, needs_sigma=True),
    "PBE": _mark(f_u_pbe_c, needs_sigma=True),
    "P86": _mark(f_u_p86_c, needs_sigma=True),
    "UP86": _mark(f_u_p86_c, needs_sigma=True),
    "PW91": _mark(f_u_pw91_c, needs_sigma=True),
}
