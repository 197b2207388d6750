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

The meta-GGAs (TPSS, revTPSS, SCAN, rSCAN, r2SCAN, B97M) read tau, the
kinetic energy density, and return df/dtau; B97 and B97-D are GGAs.  The
SCAN family's switching functions keep tuna_tpu's double `where` (the
untaken branch's argument is replaced before the exponential), so that
autograd, like jax.grad, multiplies no NaN into a derivative.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

DENSITY_FLOOR = 1e-23
SIGMA_FLOOR = DENSITY_FLOOR**2
EXPONENT_CEILING = 600
PI = math.pi


@dataclass(frozen=True)
class XCParams:
    x_alpha: float = 2 / 3
    method_name: str = ""
    x_name: str | None = None


def clean(values, floor=DENSITY_FLOOR):
    """Floor tiny/negative grid values that break functional evaluation,
    with jnp.maximum's derivative (half of it at a value on the floor, where
    torch.clamp passes all of it): the unrestricted functionals floor spin
    densities that are already at the floor."""
    return torch.maximum(values, torch.tensor(floor, dtype=values.dtype, device=values.device))


def _cbrt(x):
    """Cube root of a positive tensor or float (torch has no cbrt)."""
    if isinstance(x, torch.Tensor):
        return x.pow(1.0 / 3.0)
    return float(x) ** (1.0 / 3.0)


# =========================================================================
# Derivative machinery
# =========================================================================

def restricted_derivatives(functional, density, sigma, tau, params: XCParams):
    """(df_dn, df_ds, df_dt, eps) for f(rho, sigma, tau) = rho * eps; df_ds
    and df_dt are None unless the functional reads sigma and tau.

    The derivatives are autograd's of the summed energy density with respect
    to detached copies of the inputs, under enable_grad so that a caller in
    no_grad mode gets them too."""
    needs_sigma = getattr(functional, "needs_sigma", False)
    needs_tau = getattr(functional, "needs_tau", False)
    with torch.enable_grad():
        n = density.detach().requires_grad_()
        s = sigma.detach().requires_grad_() if needs_sigma else None
        t = tau.detach().requires_grad_() if needs_tau else None
        f = functional(n, s, t, params)
        inputs = [x for x in (n, s, t) if x is not None]
        grads = list(torch.autograd.grad(f.sum(), inputs))
    eps = f.detach() / density
    df_dn = grads.pop(0)
    df_ds = grads.pop(0) if needs_sigma else None
    df_dt = grads.pop(0) if needs_tau else None
    return df_dn, df_ds, df_dt, eps


def unrestricted_derivatives(functional, dens_a, dens_b, sigma_aa, sigma_bb, sigma_ab,
                             tau_a, tau_b, params: XCParams):
    """(df_dna, df_dnb, df_dsaa, df_dsbb, df_dsab, df_dta, df_dtb, eps) for
    the spin-resolved f(na, nb, saa, sbb, sab, ta, tb) = (na + nb) * eps;
    the sigma derivatives are None unless the functional reads sigma, the
    tau ones unless it reads tau."""
    needs_sigma = getattr(functional, "needs_sigma", False)
    needs_tau = getattr(functional, "needs_tau", False)
    with torch.enable_grad():
        inputs = [dens_a.detach().requires_grad_(), dens_b.detach().requires_grad_()]
        sigmas, taus = [None, None, None], [None, None]
        if needs_sigma:
            sigmas = [s.detach().requires_grad_() for s in (sigma_aa, sigma_bb, sigma_ab)]
            inputs += sigmas
        if needs_tau:
            taus = [t.detach().requires_grad_() for t in (tau_a, tau_b)]
            inputs += taus
        f = functional(inputs[0], inputs[1], *sigmas, *taus, params)
        grads = torch.autograd.grad(f.sum(), inputs, materialize_grads=True)
    eps = f.detach() / (dens_a + dens_b)
    d_sigma = grads[2:5] if needs_sigma else (None, None, None)
    d_tau = grads[-2:] if needs_tau else (None, None)
    return (grads[0], grads[1], *d_sigma, *d_tau, eps)


def _mark(fn, needs_sigma=False, needs_tau=False):
    fn.needs_sigma = needs_sigma
    fn.needs_tau = needs_tau
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


def _tau_uniform(density):
    return 0.3 * _cbrt(3.0 * PI**2)**2 * _cbrt(density)**5


def _reduced_gradient_p(density, sigma):
    return sigma / (4.0 * _cbrt(3.0 * PI**2)**2 * _cbrt(density)**8)


def _tpss_x_family(density, sigma, tau, params, b, c, e, kappa, mu, rev):
    """TPSS / revTPSS exchange enhancement (tuna_xc.py:602-815)."""
    p = _reduced_gradient_p(density, sigma)
    z = sigma / (8.0 * density * tau)
    tau_w = sigma / (8.0 * density)
    alpha = (tau - tau_w) / _tau_uniform(density)
    q_tilde = (0.45 * (alpha - 1.0)
               / torch.sqrt(1.0 + b * alpha * (alpha - 1.0)) + 2.0 * p / 3.0)
    z2 = z * z
    t1 = 1.0 + z2
    A = 10.0 / 81.0 + (c * z2 * z / (t1 * t1) if rev else c * z2 / (t1 * t1))
    S = torch.sqrt(0.5 * ((0.6 * z)**2 + p * p))
    sqrt_e = math.sqrt(e)
    num = (A * p + (146.0 / 2025.0) * q_tilde * q_tilde
           - (73.0 / 405.0) * q_tilde * S + (10.0 / 81.0)**2 / kappa * p * p
           + 2.0 * sqrt_e * (10.0 / 81.0) * 0.36 * z2 + e * mu * p**3)
    x = num / (1.0 + sqrt_e * p)**2
    F_X = 1.0 + kappa - kappa**2 / (kappa + x)
    return density * _slater_eps(density, params.x_alpha) * F_X


def f_tpss_x(density, sigma, tau, params):
    return _tpss_x_family(density, sigma, tau, params,
                          b=0.40, c=1.59096, e=1.537, kappa=0.804, mu=0.21951, rev=False)


def f_revtpss_x(density, sigma, tau, params):
    return _tpss_x_family(density, sigma, tau, params,
                          b=0.40, c=2.35204, e=2.1677, kappa=0.804, mu=0.14, rev=True)


_SCAN_CX = (1.0, -0.667, -0.4445555, -0.663086601049, 1.451297044490,
            -0.887998041597, 0.234528941479, -0.023185843322)
_RSCAN_CC = (1.0, -0.64, -0.4352, -1.535685604549, 3.061560252175,
             -1.915710236206, 0.516884468372, -0.051848879792)
# first derivative sums at alpha = 0
_SCAN_CX_MOMENT = float(sum(c * k for k, c in enumerate(_SCAN_CX)))
_RSCAN_CC_MOMENT = float(sum(c * k for k, c in enumerate(_RSCAN_CC)))


def _interp_scan(alpha, c1, c2, d_f):
    """SCAN iso-orbital interpolation; the untaken branch's 1 - alpha is
    replaced before the exponential (a double where), so no NaN reaches
    autograd."""
    lt, gt = alpha < 1.0, alpha > 1.0
    oma = 1.0 - alpha
    oma_lt = torch.where(lt, oma, 1.0)
    oma_gt = torch.where(gt, oma, -1.0)
    f_small = torch.exp(torch.clamp(-c1 * alpha / oma_lt, max=EXPONENT_CEILING))
    f_large = -d_f * torch.exp(torch.clamp(c2 / oma_gt, max=EXPONENT_CEILING))
    return torch.where(lt, f_small, torch.where(gt, f_large, 0.0))


def _interp_regularised(alpha, c1, c2, d_f, coeffs):
    """rSCAN/r2SCAN polynomial interpolation with exponential tails."""
    lt, gt = alpha < 0.0, alpha > 2.5
    oma = 1.0 - alpha
    oma_lt = torch.where(lt, oma, 1.0)
    oma_gt = torch.where(gt, oma, -1.0)
    f_small = torch.exp(torch.clamp(-c1 * alpha / oma_lt, max=EXPONENT_CEILING))
    f_large = -d_f * torch.exp(torch.clamp(c2 / oma_gt, max=EXPONENT_CEILING))
    poly = coeffs[7]
    for k in range(6, -1, -1):
        poly = poly * alpha + coeffs[k]
    return torch.where(lt, f_small, torch.where(gt, f_large, poly))


def _scan_x_from(density, p, alpha, f_x, params):
    """SCAN and rSCAN exchange from p, the interpolation variable and f_x
    (tuna_xc.py:819-1144)."""
    a_1, k_0, k_1, mu, b_3 = 4.9479, 0.174, 0.065, 10.0 / 81.0, 0.5
    b_2 = math.sqrt(5913.0 / 405000.0)
    b_1 = (511.0 / 13500.0) / (2.0 * b_2)
    b_4 = mu**2 / k_1 - 1606.0 / 18225.0 - b_1**2
    y_p = (b_4 / mu) * p
    oma = 1.0 - alpha
    x2 = b_1 * p + b_2 * oma * torch.exp(-b_3 * oma * oma)
    x = mu * p * (1.0 + y_p * torch.exp(-y_p)) + x2 * x2
    h_0 = 1.0 + k_0
    h_1 = 1.0 + k_1 - k_1 / (1.0 + x / k_1)
    g_x = 1.0 - torch.exp(-a_1 / torch.sqrt(torch.sqrt(p)))
    F_X = (h_1 + f_x * (h_0 - h_1)) * g_x
    return density * _slater_eps(density, params.x_alpha) * F_X


def f_scan_x(density, sigma, tau, params):
    """SCAN exchange (tuna_xc.py:819-973)."""
    p = _reduced_gradient_p(density, sigma)
    tau_w = sigma / (8.0 * density)
    alpha = (tau - tau_w) / _tau_uniform(density)
    return _scan_x_from(density, p, alpha, _interp_scan(alpha, 0.667, 0.8, 1.24), params)


def f_rscan_x(density, sigma, tau, params):
    """Regularised SCAN exchange (tuna_xc.py:976-1144)."""
    eta, alpha_r = 0.0001, 0.001
    p = _reduced_gradient_p(density, sigma)
    tau_w = sigma / (8.0 * density)
    alpha = (tau - tau_w) / (_tau_uniform(density) + eta)
    alpha2 = alpha * alpha
    alpha_prime = alpha2 * alpha / (alpha2 + alpha_r)
    f_x = _interp_regularised(alpha_prime, 0.667, 0.8, 1.24, _SCAN_CX)
    return _scan_x_from(density, p, alpha_prime, f_x, params)


def f_r2scan_x(density, sigma, tau, params):
    """r2SCAN exchange (tuna_xc.py:1147-1299)."""
    eta = 0.001
    a_1, c_1, c_2, k_0, k_1 = 4.9479, 0.667, 0.8, 0.174, 0.065
    mu, d, d_x = 10.0 / 81.0, 0.361, 1.24
    C_eta = 20.0 / 27.0 + eta * 5.0 / 3.0
    C_2 = _SCAN_CX_MOMENT * k_0

    p = _reduced_gradient_p(density, sigma)
    tau_w = sigma / (8.0 * density)
    alpha_bar = (tau - tau_w) / (_tau_uniform(density) + eta * tau_w)

    x = (C_eta * C_2 * torch.exp(-(p * p) / d**4) + mu) * p
    h_0 = 1.0 + k_0
    h_1 = 1.0 + k_1 - k_1 / (1.0 + x / k_1)
    f_x = _interp_regularised(alpha_bar, c_1, c_2, d_x, _SCAN_CX)
    g_x = 1.0 - torch.exp(-a_1 / torch.sqrt(torch.sqrt(p)))
    F_X = (h_1 + f_x * (h_0 - h_1)) * g_x
    return density * _slater_eps(density, params.x_alpha) * F_X


_B97_X_PARAMS = {"B97": (0.8094, 0.5073, 0.7481)}
_B97_X_DEFAULT = (1.08662, -0.52127, 3.25429)  # B97-D parameterisation


def f_b97_x(density, sigma, tau, params):
    """B97 / B97-D exchange (tuna_xc.py:1302-1368)."""
    c_x = _B97_X_PARAMS.get(params.method_name, _B97_X_DEFAULT)
    gamma = 0.004
    s2 = _cbrt(4.0) * sigma / _cbrt(density)**8
    x = gamma * s2 / (1.0 + gamma * s2)
    F_X = c_x[0] + (c_x[1] + c_x[2] * x) * x
    return density * _slater_eps(density, params.x_alpha) * F_X


def f_b97m_x(density, sigma, tau, params):
    """B97M(-V) exchange (tuna_xc.py:1371-1459)."""
    c_x = (1.0, 0.416, 1.308, 3.07, 1.901)
    gamma = 0.004
    s2 = _cbrt(4.0) * sigma / _cbrt(density)**8
    x = gamma * s2 / (1.0 + gamma * s2)
    t = _tau_uniform(density) / tau
    w = (t - 1.0) / (t + 1.0)
    F_X = c_x[0] + c_x[1] * w + (c_x[2] + c_x[3] * w + c_x[4] * x) * x
    return density * _slater_eps(density, params.x_alpha) * F_X


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


def _pbe_c_f(density, zeta, sigma, rev_beta=False):
    """PBE correlation on the PW92 LDA base (beta matched to ORCA);
    rev_beta selects revTPSS's r_s-dependent beta (tuna_xc.py:1972-1979)."""
    gamma = (1 - math.log(2.0)) / PI**2
    r_s = _seitz_radius(density)
    beta = (0.066725 * (1 + 0.1 * r_s) / (1 + 0.1778 * r_s)) if rev_beta else 0.066725
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
# Meta-GGA and B97-family correlation
# =========================================================================

def _pbe_c_eps(density, zeta, sigma, rev_beta=False):
    return _pbe_c_f(density, zeta, sigma, rev_beta) / density


def _tpss_c_f_restricted(density, sigma, tau, rev_beta=False):
    """TPSS/revTPSS restricted correlation (tuna_xc.py:2921-3016, 3307-3402);
    revTPSS swaps in the r_s-dependent PBE beta."""
    C, d = 0.53, 2.8
    z = sigma / (8.0 * tau * density)
    z2, z3 = z * z, z**3
    eps_pbe = _pbe_c_eps(density, torch.zeros_like(density), sigma, rev_beta)
    eps_one = _pbe_c_eps(density / 2.0, torch.ones_like(density), sigma / 4.0, rev_beta)
    eps_tilde = torch.maximum(eps_pbe, eps_one)
    eps_rev = eps_pbe * (1.0 + C * z2) - (1.0 + C) * z2 * eps_tilde
    return density * eps_rev * (1.0 + d * eps_rev * z3)


def f_tpss_c(density, sigma, tau, params):
    return _tpss_c_f_restricted(density, sigma, tau)


def _pbe_c_f_spin(na, nb, saa, sbb, sab, rev_beta=False):
    density = na + nb
    zeta = (na - nb) / density
    sigma = clean(saa + 2.0 * sab + sbb, SIGMA_FLOOR)
    return _pbe_c_f(density, zeta, sigma, rev_beta)


def _tpss_c_f_unrestricted(na, nb, saa, sbb, sab, ta, tb, c0_poly, rev_beta=False):
    """TPSS-family unrestricted correlation (tuna_xc.py:3019-3304)."""
    density = na + nb
    sigma = clean(saa + sbb + 2.0 * sab, SIGMA_FLOOR)
    tau = ta + tb
    d = 2.8
    zeta = (na - nb) / density
    zeta2 = zeta * zeta

    eps_pbe = _pbe_c_f_spin(na, nb, saa, sbb, sab, rev_beta) / density
    eps_a0 = _pbe_c_eps(clean(na), torch.ones_like(na), clean(saa, SIGMA_FLOOR), rev_beta)
    eps_0b = _pbe_c_eps(clean(nb), torch.ones_like(nb), clean(sbb, SIGMA_FLOOR), rev_beta)
    eps_tilde_a = torch.maximum(eps_pbe, eps_a0)
    eps_tilde_b = torch.maximum(eps_pbe, eps_0b)
    eps_tilde = (na * eps_tilde_a + nb * eps_tilde_b) / density

    # C(zeta, xi): spin-polarisation-gradient damped mixing coefficient
    one_p, one_m = 1.0 + zeta, clean(1.0 - zeta, SIGMA_FLOOR)
    B = clean(one_m**2 * saa + one_p**2 * sbb - 2.0 * (1.0 - zeta2) * sab, SIGMA_FLOOR)
    zeta_gradient = torch.sqrt(B) / density
    xi = zeta_gradient / (2.0 * _cbrt(3.0 * PI**2 * density))
    s = 1.0 / _cbrt(one_p)**4 + 1.0 / _cbrt(one_m)**4
    A = xi * xi * s / 2.0
    C_0 = c0_poly[0] + c0_poly[1] * zeta2 + c0_poly[2] * zeta2**2 + c0_poly[3] * zeta2**3
    C = C_0 / (1.0 + A)**4

    z = sigma / (8.0 * tau * density)
    z2, z3 = z * z, z**3
    eps_rev = eps_pbe * (1.0 + C * z2) - (1.0 + C) * z2 * eps_tilde
    return density * eps_rev * (1.0 + d * eps_rev * z3)


def f_u_tpss_c(na, nb, saa, sbb, sab, ta, tb, params):
    return _tpss_c_f_unrestricted(na, nb, saa, sbb, sab, ta, tb, (0.53, 0.87, 0.50, 2.26))


def f_revtpss_c(density, sigma, tau, params):
    return _tpss_c_f_restricted(density, sigma, tau, rev_beta=True)


def f_u_revtpss_c(na, nb, saa, sbb, sab, ta, tb, params):
    return _tpss_c_f_unrestricted(na, nb, saa, sbb, sab, ta, tb,
                                  (0.53, 0.9269, 0.6225, 2.1540), rev_beta=True)


# --- SCAN-family correlation ---------------------------------------------

def _pw92_eps_spin_drs(r_s, zeta):
    """d eps_LSDA / d r_s at fixed zeta, PW92 differentiated by hand
    (tuna_tpu takes it by jax.jvp of _pw92_eps_spin_rs): each channel
    Q_0 log1p(1 / Q_1) has the derivative Q_0' log1p(1 / Q_1) - Q_0 Q_1' /
    (Q_1^2 + Q_1)."""
    sqrt_r_s = torch.sqrt(r_s)

    def d_pw(params):
        A, alpha_1, beta_1, beta_2, beta_3, beta_4 = params
        Q_0 = -2 * A * (1 + alpha_1 * r_s)
        Q_1 = 2 * A * (beta_1 * sqrt_r_s + beta_2 * r_s + beta_3 * r_s**1.5 + beta_4 * r_s**2)
        dQ_1 = 2 * A * (0.5 * beta_1 / sqrt_r_s + beta_2 + 1.5 * beta_3 * sqrt_r_s
                        + 2 * beta_4 * r_s)
        return -2 * A * alpha_1 * torch.log1p(1 / Q_1) - Q_0 * dQ_1 / (Q_1 * Q_1 + Q_1)

    de0, de1, dalpha_c = d_pw(_PW92_PARA), d_pw(_PW92_FERRO), -d_pw(_PW92_STIFF)
    fz = _zeta_f(zeta)
    fpp0 = 8 / (9 * (_cbrt(2.0)**4 - 2))
    z4 = zeta**4
    return de0 + dalpha_c * fz / fpp0 * (1 - z4) + (de1 - de0) * fz * z4


def _scan_c_core(density, zeta, sigma, f_c, gamma, r2scan_delta=None):
    """Shared SCAN / rSCAN / r2SCAN correlation assembly."""
    b_1c, b_2c, b_3c = 0.0285764, 0.0889, 0.125541
    r_s = _seitz_radius(density)
    sqrt_r_s = torch.sqrt(r_s)
    phi = _phi_zeta(zeta)
    phi3 = phi**3
    d_x = (_cbrt(clean(1.0 + zeta))**4 + _cbrt(clean(1.0 - zeta))**4) / 2.0
    G_c = (1.0 - 2.3631 * (d_x - 1.0)) * (1.0 - zeta**12)

    eps_lsda = _pw92_eps_spin(density, zeta)
    eps_lda_0 = -b_1c / (1.0 + b_2c * sqrt_r_s + b_3c * r_s)
    w_0 = torch.exp(-eps_lda_0 / b_1c) - 1.0
    w_1 = torch.exp(-eps_lsda / (gamma * phi3)) - 1.0
    beta = 0.066725 * (1.0 + 0.1 * r_s) / (1.0 + 0.1778 * r_s)

    k_F = _cbrt(3.0 * PI**2 * density)
    s2 = sigma / (4.0 * density**2 * k_F**2)

    if r2scan_delta is None:
        chi_inf = 0.128026
        t2 = _cbrt(3.0 * PI**2 / 16.0)**2 * s2 / (phi**2 * r_s)
        y = beta / (gamma * w_1) * t2
        delta_y = 0.0
    else:
        chi_inf = (_cbrt(3.0 * PI**2 / 16.0)**2 * 0.066725
                   / (1.778 * (0.9 - 3.0 * _cbrt(3.0 / (16.0 * PI))**2)))
        k_s = torch.sqrt(4.0 * k_F / PI)
        t2 = sigma / (4.0 * k_s**2 * phi**2 * density**2)
        y = beta / (gamma * w_1) * t2
        delta_y = r2scan_delta(r_s, zeta, s2, eps_lsda, eps_lda_0, G_c, w_1,
                               gamma, phi3, b_1c, b_2c, b_3c)

    g_inf = (1.0 + 4.0 * chi_inf * s2)**(-0.25)
    g = (1.0 + 4.0 * (y - delta_y))**(-0.25)
    H_1 = gamma * phi3 * torch.log1p(w_1 * (1.0 - g))
    H_0 = b_1c * torch.log1p(w_0 * (1.0 - g_inf))
    eps_0 = (eps_lda_0 + H_0) * G_c
    eps_1 = eps_lsda + H_1
    return density * (eps_1 + f_c * (eps_0 - eps_1))


def _spin_quantities(na, nb, saa, sbb, sab):
    density = na + nb
    sigma = clean(saa + sbb + 2.0 * sab, SIGMA_FLOOR)
    zeta = (na - nb) / density
    d_s = (_cbrt(clean(1.0 + zeta))**5 + _cbrt(clean(1.0 - zeta))**5) / 2.0
    return density, sigma, zeta, d_s


def _scan_alpha(density, sigma, tau, d_s, eta=0.0, eta_on_tau_w=False):
    tau_w = sigma / (8.0 * density)
    tau_u = _tau_uniform(density) * d_s
    if eta_on_tau_w:
        denom = tau_u + eta * tau_w
    else:
        denom = tau_u + eta * d_s if eta else tau_u
    return (tau - tau_w) / denom


def f_scan_c(density, sigma, tau, params):
    zeta = torch.zeros_like(density)
    alpha = _scan_alpha(density, sigma, tau, 1.0)
    f_c = _interp_scan(alpha, 0.64, 1.5, 0.7)
    return _scan_c_core(density, zeta, sigma, f_c, 0.031091)


def f_u_scan_c(na, nb, saa, sbb, sab, ta, tb, params):
    density, sigma, zeta, d_s = _spin_quantities(na, nb, saa, sbb, sab)
    alpha = _scan_alpha(density, sigma, ta + tb, d_s)
    f_c = _interp_scan(alpha, 0.64, 1.5, 0.7)
    return _scan_c_core(density, zeta, sigma, f_c, 0.031091)


def _rscan_f_c(alpha):
    alpha2 = alpha * alpha
    alpha_prime = alpha2 * alpha / (alpha2 + 0.001)
    return _interp_regularised(alpha_prime, 0.64, 1.5, 0.7, _RSCAN_CC)


def f_rscan_c(density, sigma, tau, params):
    zeta = torch.zeros_like(density)
    alpha = _scan_alpha(density, sigma, tau, 1.0, eta=0.0001)
    return _scan_c_core(density, zeta, sigma, _rscan_f_c(alpha), 0.031091)


def f_u_rscan_c(na, nb, saa, sbb, sab, ta, tb, params):
    density, sigma, zeta, d_s = _spin_quantities(na, nb, saa, sbb, sab)
    alpha = _scan_alpha(density, sigma, ta + tb, d_s, eta=0.0001)
    return _scan_c_core(density, zeta, sigma, _rscan_f_c(alpha), 0.031091)


def _r2scan_delta_factory(d_s, eta, d_p):
    delta_f_c = _RSCAN_CC_MOMENT

    def delta_y(r_s, zeta, s2, eps_lsda, eps_lda_0, G_c, w_1, gamma, phi3,
                b_1c, b_2c, b_3c):
        denom = 1.0 + b_2c * torch.sqrt(r_s) + b_3c * r_s
        de0_drs = b_1c * (0.5 * b_2c / torch.sqrt(r_s) + b_3c) / (denom * denom)
        de0_G_drs = de0_drs * G_c
        de_lsda_drs = _pw92_eps_spin_drs(r_s, zeta)
        eps_lsda_0 = eps_lda_0 * G_c
        A_delta = delta_f_c / (27.0 * gamma * d_s * phi3 * w_1)
        B_delta = (20.0 * r_s * (de0_G_drs - de_lsda_drs)
                   - 45.0 * eta * (eps_lsda_0 - eps_lsda))
        return A_delta * s2 * torch.exp(-(s2 * s2) / d_p**4) * B_delta

    return delta_y


def f_r2scan_c(density, sigma, tau, params):
    eta, d_p = 0.001, 0.361
    zeta = torch.zeros_like(density)
    alpha_bar = _scan_alpha(density, sigma, tau, 1.0, eta=eta, eta_on_tau_w=True)
    f_c = _interp_regularised(alpha_bar, 0.64, 1.5, 0.7, _RSCAN_CC)
    return _scan_c_core(density, zeta, sigma, f_c, 0.0310907,
                        r2scan_delta=_r2scan_delta_factory(1.0, eta, d_p))


def f_u_r2scan_c(na, nb, saa, sbb, sab, ta, tb, params):
    eta, d_p = 0.001, 0.361
    density, sigma, zeta, d_s = _spin_quantities(na, nb, saa, sbb, sab)
    alpha_bar = _scan_alpha(density, sigma, ta + tb, d_s, eta=eta, eta_on_tau_w=True)
    f_c = _interp_regularised(alpha_bar, 0.64, 1.5, 0.7, _RSCAN_CC)
    return _scan_c_core(density, zeta, sigma, f_c, 0.0310907,
                        r2scan_delta=_r2scan_delta_factory(d_s, eta, d_p))


# --- B97-family correlation ----------------------------------------------

_B97_C_PARAMS = {"B97": ((0.9454, 0.7471, -4.5961), (0.1737, 2.3487, -2.4868))}
_B97_C_DEFAULT = ((0.69041, 6.30270, -14.9712), (0.22340, -1.56208, 1.94293))
_B97M_C_SS = (1.0, -5.668, -1.855, -20.497, -20.364)
_B97M_C_AB = (1.0, 2.535, 1.573, -6.427, -6.298)


def _b97_u(s2, gamma):
    return gamma * s2 / (1.0 + gamma * s2)


def f_b97_c(density, sigma, tau, params):
    """B97 / B97-D restricted correlation (tuna_xc.py:5252-5357)."""
    c_ab, c_ss = _B97_C_PARAMS.get(params.method_name, _B97_C_DEFAULT)
    s2 = _cbrt(4.0) * sigma / _cbrt(density)**8
    x_ss = _b97_u(s2, 0.2)
    x_ab = _b97_u(s2, 0.006)
    g_ss = c_ss[0] + (c_ss[1] + c_ss[2] * x_ss) * x_ss
    g_ab = c_ab[0] + (c_ab[1] + c_ab[2] * x_ab) * x_ab
    eps_lsda = _pw92_eps_spin(density, torch.zeros_like(density))
    eps_ss = _pw92_eps_spin(density / 2.0, torch.ones_like(density))
    return density * ((g_ss - g_ab) * eps_ss + g_ab * eps_lsda)


def f_u_b97_c(na, nb, saa, sbb, sab, ta, tb, params):
    """B97 / B97-D unrestricted correlation (tuna_xc.py:5360-5503)."""
    c_ab, c_ss = _B97_C_PARAMS.get(params.method_name, _B97_C_DEFAULT)
    density = na + nb
    s2_a = clean(saa, SIGMA_FLOOR) / _cbrt(clean(na))**8
    s2_b = clean(sbb, SIGMA_FLOOR) / _cbrt(clean(nb))**8
    s2_avg = 0.5 * (s2_a + s2_b)
    g_a = c_ss[0] + (c_ss[1] + c_ss[2] * _b97_u(s2_a, 0.2)) * _b97_u(s2_a, 0.2)
    g_b = c_ss[0] + (c_ss[1] + c_ss[2] * _b97_u(s2_b, 0.2)) * _b97_u(s2_b, 0.2)
    g_ab = c_ab[0] + (c_ab[1] + c_ab[2] * _b97_u(s2_avg, 0.006)) * _b97_u(s2_avg, 0.006)

    zeta = (na - nb) / density
    eps_lsda = _pw92_eps_spin(density, zeta)
    eps_a = _pw92_eps_spin(clean(na), torch.ones_like(na))
    eps_b = _pw92_eps_spin(clean(nb), torch.ones_like(nb))
    f_ab = eps_lsda * density - eps_a * na - eps_b * nb
    return g_a * eps_a * na + g_b * eps_b * nb + g_ab * f_ab


def f_b97m_c(density, sigma, tau, params):
    """B97M(-V) restricted correlation (tuna_xc.py:5506-5643)."""
    c_ss, c_ab = _B97M_C_SS, _B97M_C_AB
    spin_density, spin_sigma = density / 2.0, sigma / 4.0
    s2 = spin_sigma / _cbrt(spin_density)**8
    t = _tau_uniform(density) / tau
    w = (t - 1.0) / (t + 1.0)
    u_ss = _b97_u(s2, 0.2)
    u_ab = _b97_u(s2, 0.006)
    w3, w4 = w**3, w**4
    g_ss = (c_ss[0] + c_ss[1] * w + c_ss[2] * u_ss**2 + c_ss[3] * w3 * u_ss**2
            + c_ss[4] * w4 * u_ss**2)
    g_ab = (c_ab[0] + c_ab[1] * w + c_ab[2] * u_ab + c_ab[3] * w3 * u_ab**2
            + c_ab[4] * u_ab**3)
    eps_lsda = _pw92_eps_spin(density, torch.zeros_like(density))
    eps_ss = _pw92_eps_spin(spin_density, torch.ones_like(density))
    return density * ((g_ss - g_ab) * eps_ss + g_ab * eps_lsda)


def f_u_b97m_c(na, nb, saa, sbb, sab, ta, tb, params):
    """B97M(-V) unrestricted correlation (tuna_xc.py:5646-5840)."""
    c_ss, c_ab = _B97M_C_SS, _B97M_C_AB
    density = na + nb
    na_c, nb_c = clean(na), clean(nb)
    s2_a = clean(saa, SIGMA_FLOOR) / _cbrt(na_c)**8
    s2_b = clean(sbb, SIGMA_FLOOR) / _cbrt(nb_c)**8
    s2_ab = 0.5 * (s2_a + s2_b)
    tau_U_a = 0.3 * _cbrt(6.0 * PI**2)**2 * _cbrt(na_c)**5
    tau_U_b = 0.3 * _cbrt(6.0 * PI**2)**2 * _cbrt(nb_c)**5
    t_a = tau_U_a / clean(ta)
    t_b = tau_U_b / clean(tb)
    t_ab = 0.5 * (t_a + t_b)

    def w_of(t):
        return (t - 1.0) / (t + 1.0)

    def g_same(u, w):
        return (c_ss[0] + c_ss[1] * w + c_ss[2] * u**2 + c_ss[3] * w**3 * u**2
                + c_ss[4] * w**4 * u**2)

    u_aa, u_bb = _b97_u(s2_a, 0.2), _b97_u(s2_b, 0.2)
    u_ab = _b97_u(s2_ab, 0.006)
    w_ab = w_of(t_ab)
    g_aa = g_same(u_aa, w_of(t_a))
    g_bb = g_same(u_bb, w_of(t_b))
    g_ab = (c_ab[0] + c_ab[1] * w_ab + c_ab[2] * u_ab + c_ab[3] * w_ab**3 * u_ab**2
            + c_ab[4] * u_ab**3)

    zeta = (na - nb) / density
    eps_lsda = _pw92_eps_spin(density, zeta)
    eps_a = _pw92_eps_spin(na_c, torch.ones_like(na))
    eps_b = _pw92_eps_spin(nb_c, torch.ones_like(nb))
    f_aa = eps_a * na
    f_bb = eps_b * nb
    f_ab = eps_lsda * density - f_aa - f_bb
    return g_aa * f_aa + g_bb * f_bb + g_ab * f_ab


# =========================================================================
# Registries
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
    "TPSS": _mark(f_tpss_x, needs_sigma=True, needs_tau=True),
    "REVTPSS": _mark(f_revtpss_x, needs_sigma=True, needs_tau=True),
    "SCAN": _mark(f_scan_x, needs_sigma=True, needs_tau=True),
    "RSCAN": _mark(f_rscan_x, needs_sigma=True, needs_tau=True),
    "R2SCAN": _mark(f_r2scan_x, needs_sigma=True, needs_tau=True),
    "B97": _mark(f_b97_x, needs_sigma=True),
    "B97M": _mark(f_b97m_x, needs_sigma=True, needs_tau=True),
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
    "TPSS": _mark(f_tpss_c, needs_sigma=True, needs_tau=True),
    "REVTPSS": _mark(f_revtpss_c, needs_sigma=True, needs_tau=True),
    "SCAN": _mark(f_scan_c, needs_sigma=True, needs_tau=True),
    "RSCAN": _mark(f_rscan_c, needs_sigma=True, needs_tau=True),
    "R2SCAN": _mark(f_r2scan_c, needs_sigma=True, needs_tau=True),
    "B97": _mark(f_b97_c, needs_sigma=True),
    "B97M": _mark(f_b97m_c, needs_sigma=True, needs_tau=True),
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
    "TPSS": _mark(f_u_tpss_c, needs_sigma=True, needs_tau=True),
    "REVTPSS": _mark(f_u_revtpss_c, needs_sigma=True, needs_tau=True),
    "SCAN": _mark(f_u_scan_c, needs_sigma=True, needs_tau=True),
    "RSCAN": _mark(f_u_rscan_c, needs_sigma=True, needs_tau=True),
    "R2SCAN": _mark(f_u_r2scan_c, needs_sigma=True, needs_tau=True),
    "B97": _mark(f_u_b97_c, needs_sigma=True),
    "B97M": _mark(f_u_b97m_c, needs_sigma=True, needs_tau=True),
}
