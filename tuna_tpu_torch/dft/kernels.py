"""TD-DFT exchange-correlation kernels: second functional derivatives f_xc on
the grid and their MO-basis matrix elements K_XC.

Twin of tuna_tpu/dft/kernels.py.  Every kernel is the second derivative of
the energy density the SCF potential uses (dft/xc.py's registries), taken
by nested autograd: one definition serves energy, potential and kernel.
The matrix elements contract the grid as matrix products of the orbital
pair products, a chunk of grid points at a time (ROW_CHUNK_BYTES bounds
each chunk's pair array), on the device the grid lives on.
"""

from __future__ import annotations

import torch

from ..output import error, log
from . import grid as dft_grid
from . import xc

# Bytes of the largest (rows, points) array a chunk of the grid forms
ROW_CHUNK_BYTES = 2**28


# ---------------------------------------------------------------------------
# Autograd second derivatives
# ---------------------------------------------------------------------------
# Each energy density is pointwise in the grid: f(n)[k] depends on n[k]
# alone.  So the gradient of sum_j df/dn[j] with respect to n[k] is
# d^2 f[k] / dn[k]^2, and two reverse passes give the elementwise second
# derivative exactly (the forward-mode tangent of ones that tuna_tpu takes
# gives the same sum).

def _second_grad(f, inputs, first, second):
    """d^2 (sum f) / d inputs[first] d inputs[second], elementwise."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in inputs]
        (d_first,) = torch.autograd.grad(f(*leaves).sum(), leaves[first], create_graph=True)
        (d2,) = torch.autograd.grad(d_first.sum(), leaves[second], allow_unused=True,
                                    materialize_grads=True)
    return d2.detach()


def _d2_dn2(f, density):
    """Elementwise d^2 f / d n^2 for f mapping a grid array to a grid array."""
    return _second_grad(f, (density,), 0, 0)


def _d2_mixed(f, na, nb, wrt):
    """Elementwise second partials of f(na, nb): wrt in {"aa", "ab", "bb"}."""
    first = 0 if wrt[0] == "a" else 1
    second = 0 if wrt[1] == "a" else 1
    return _second_grad(f, (na, nb), first, second)


def _d2_dm2(f_u, density):
    """Spin-channel kernel d^2 f / d m^2 at m = 0 (m = n_a - n_b)."""
    def h(m):
        return f_u((density + m) / 2.0, (density - m) / 2.0)
    return _d2_dn2(h, torch.zeros_like(density))


_PARAMS = xc.XCParams()


def _restricted_lda(name):
    fn = xc.CORRELATION_FUNCTIONALS[name]
    return lambda n: fn(n, None, None, _PARAMS)


def _unrestricted_lda(name):
    fn = xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name]
    return lambda na, nb: fn(na, nb, None, None, None, None, None, _PARAMS)


def slater_exchange_kernel(density, x_alpha):
    params = xc.XCParams(x_alpha=x_alpha)
    return _d2_dn2(lambda n: xc.f_slater_x(n, None, None, params), density)


def correlation_density_kernel(name, density):
    return _d2_dn2(_restricted_lda(name), density)


def correlation_spin_kernel(name, density):
    return _d2_dm2(_unrestricted_lda(name), density)


def unrestricted_correlation_kernel(name, dens_a, dens_b):
    f_u = _unrestricted_lda(name)
    f_aa = _d2_mixed(f_u, dens_a, dens_b, "aa")
    f_ab = _d2_mixed(f_u, dens_a, dens_b, "ab")
    f_bb = _d2_mixed(f_u, dens_a, dens_b, "bb")
    return f_aa, f_ab, f_bb


_TD_CORRELATION = ("VWN3", "VWN5", "PW")


def _check_td_functional(calculation):
    functional = calculation.functional
    if functional.x_name not in (None, "S") or (
            functional.c_name is not None
            and functional.c_name not in _TD_CORRELATION):
        error("Time-dependent DFT kernels are only available for LDA "
              "functionals (S exchange with VWN/PW correlation)!")


# ---------------------------------------------------------------------------
# MO-basis kernel matrices
# ---------------------------------------------------------------------------

def _chunks(n_points, rows):
    """Slices of the grid whose (rows, points) arrays fit ROW_CHUNK_BYTES."""
    step = max(1, ROW_CHUNK_BYTES // (8 * max(rows, 1)))
    return [slice(start, min(start + step, n_points)) for start in range(0, n_points, step)]


def _pair_rows(A, B):
    """(i, a, k) products A[i, k] B[a, k], flattened to (i a, k)."""
    return (A[:, None, :] * B[None, :, :]).reshape(-1, A.shape[1])


def _ov_kernel(T_rows, n_rows, n_points, weights, row_sets=None):
    """K[r, c] = sum_k T[r, k] F[k] T[c, k] over the grid, chunked, for the
    (n_rows, points) pair products T_rows(chunk).  Without row_sets F is
    `weights`; with them (index tensors, one a spin) F is weights[s][t]
    between a row of set s and a column of set t."""
    F = weights if row_sets is None else weights[0][0]
    K = torch.zeros((n_rows, n_rows), dtype=F.dtype, device=F.device)
    for chunk in _chunks(n_points, n_rows):
        T = T_rows(chunk)
        if row_sets is None:
            K += (T * F[chunk]) @ T.T
            continue
        for s, rows_s in enumerate(row_sets):
            for t, rows_t in enumerate(row_sets):
                K[rows_s[:, None], rows_t[None, :]] += (
                    (T[rows_s] * weights[s][t][chunk]) @ T[rows_t].T)
    return K


def restricted_xc_kernel_matrices(o, v, density, bfs_on_grid, molecular_orbitals,
                                  calculation, weights, silent):
    """Singlet / triplet K_XC (iajb) plus the full (ia,pq) kernel, tensors
    on the grid's device (parity: tuna_dft.py:1074-1170)."""
    _check_td_functional(calculation)
    functional = calculation.functional

    log("\n Evaluating molecular orbitals on grid...    ", calculation, 1, end="", silent=silent)
    n_basis = bfs_on_grid.shape[0]
    mos = molecular_orbitals.T @ bfs_on_grid.reshape(n_basis, -1)
    n_points = mos.shape[1]
    log("[Done]", calculation, 1, silent=silent)

    log(" Evaluating exchange-correlation kernel...   ", calculation, 1, end="", silent=silent)
    density = xc.clean(density.reshape(-1))
    w = weights.reshape(-1)

    f_X = torch.zeros_like(density)
    if functional.x_name is not None:
        f_X = 2.0 * slater_exchange_kernel(density, calculation.X_alpha)
    f_C_singlet = f_C_triplet = torch.zeros_like(density)
    if functional.c_name is not None:
        f_C_singlet = 2.0 * correlation_density_kernel(functional.c_name, density)
        f_C_triplet = 2.0 * correlation_spin_kernel(functional.c_name, density)
    log("[Done]", calculation, 1, silent=silent)

    log(" Calculating matrix elements...              ", calculation, 1, end="", silent=silent)
    mos_o, mos_v = mos[o], mos[v]
    n_o, n_v = mos_o.shape[0], mos_v.shape[0]
    shape = (n_o, n_v, n_o, n_v)

    def T_rows(chunk):
        return _pair_rows(mos_o[:, chunk], mos_v[:, chunk])

    singlet = w * (f_X * calculation.DFX_prop + f_C_singlet * calculation.DFC_prop)
    triplet = w * (f_X * calculation.DFX_prop + f_C_triplet * calculation.DFC_prop)
    K_XC_singlet = _ov_kernel(T_rows, n_o * n_v, n_points, singlet).reshape(shape)
    K_XC_triplet = _ov_kernel(T_rows, n_o * n_v, n_points, triplet).reshape(shape)

    K_XC_full = None
    if calculation.DFT_calculation:
        n_mo = mos.shape[0]
        K_XC_full = torch.zeros((n_o * n_v, n_mo * n_mo), dtype=mos.dtype, device=mos.device)
        for chunk in _chunks(n_points, n_mo * n_mo):
            pair = _pair_rows(mos[:, chunk], mos[:, chunk] * singlet[chunk])
            K_XC_full += T_rows(chunk) @ pair.T
        K_XC_full = K_XC_full.reshape(n_o, n_v, n_mo, n_mo)
    log("[Done]", calculation, 1, silent=silent)
    return K_XC_singlet, K_XC_triplet, K_XC_full


def unrestricted_xc_kernel_matrices(o, v, P_alpha, P_beta, bfs_on_grid,
                                    C_spin_block, spin_labels, calculation,
                                    weights, silent, return_full_kernel=False):
    """Spin-orbital K_XC, a tensor on the grid's device (parity:
    tuna_dft.py:1180-1327)."""
    _check_td_functional(calculation)
    functional = calculation.functional

    log("\n Evaluating molecular orbitals on grid...    ", calculation, 1, end="", silent=silent)
    n_basis = bfs_on_grid.shape[0]
    bfs = bfs_on_grid.reshape(n_basis, -1)
    # the spin-blocked coefficients hold each spin orbital in one half
    mos = C_spin_block[:n_basis].T @ bfs + C_spin_block[n_basis:].T @ bfs
    n_points = mos.shape[1]
    log("[Done]", calculation, 1, silent=silent)

    log(" Evaluating exchange-correlation kernel...   ", calculation, 1, end="", silent=silent)
    dens_a = xc.clean(dft_grid.density_on_grid(P_alpha, bfs_on_grid)[0].reshape(-1))
    dens_b = xc.clean(dft_grid.density_on_grid(P_beta, bfs_on_grid)[0].reshape(-1))
    w = weights.reshape(-1)

    f_X_aa = f_X_bb = torch.zeros_like(dens_a)
    if functional.x_name is not None:
        f_X_aa = 2.0 * slater_exchange_kernel(2.0 * dens_a, calculation.X_alpha)
        f_X_bb = 2.0 * slater_exchange_kernel(2.0 * dens_b, calculation.X_alpha)
    f_C_aa = f_C_ab = f_C_bb = torch.zeros_like(dens_a)
    if functional.c_name is not None:
        f_C_aa, f_C_ab, f_C_bb = unrestricted_correlation_kernel(
            functional.c_name, dens_a, dens_b)
    log("[Done]", calculation, 1, silent=silent)

    log(" Calculating matrix elements...              ", calculation, 1, end="", silent=silent)
    labels = list(spin_labels)
    device = mos.device
    occ_labels, virt_labels = labels[o], labels[v]
    n_o, n_v = len(occ_labels), len(virt_labels)
    mos_o, mos_v = mos[o], mos[v]

    def rows_of(spin):
        occupied = torch.tensor([s == spin for s in occ_labels], device=device)
        return torch.arange(n_o * n_v, device=device).reshape(n_o, n_v)[occupied].reshape(-1)

    def T_rows(chunk):
        return _pair_rows(mos_o[:, chunk], mos_v[:, chunk])

    f_aa = w * (f_X_aa * calculation.DFX_prop + f_C_aa * calculation.DFC_prop)
    f_ab = w * f_C_ab * calculation.DFC_prop
    f_bb = w * (f_X_bb * calculation.DFX_prop + f_C_bb * calculation.DFC_prop)
    K_XC = _ov_kernel(T_rows, n_o * n_v, n_points, ((f_aa, f_ab), (f_ab, f_bb)),
                      [rows_of("a"), rows_of("b")]).reshape(n_o, n_v, n_o, n_v)

    if not return_full_kernel:
        log("[Done]", calculation, 1, silent=silent)
        return K_XC

    def mask(labels_of, spin):
        return torch.tensor([s == spin for s in labels_of], dtype=mos.dtype, device=device)

    alpha_occ, beta_occ = mask(occ_labels, "a"), mask(occ_labels, "b")
    alpha_virt, beta_virt = mask(virt_labels, "a"), mask(virt_labels, "b")
    conserving = alpha_occ[:, None] * alpha_virt[None, :] + beta_occ[:, None] * beta_virt[None, :]
    K_XC = K_XC * conserving[:, :, None, None] * conserving[None, None, :, :]

    # the spin-conserving pair products of each occupied spin
    cons_a = (alpha_occ[:, None] * alpha_virt[None, :]).reshape(-1, 1)
    cons_b = (beta_occ[:, None] * beta_virt[None, :]).reshape(-1, 1)
    n_SO = mos.shape[0]
    K_XC_full = torch.zeros((n_o * n_v, n_SO, n_SO), dtype=mos.dtype, device=device)
    for spin, f_same, f_opp, cons_same, cons_opp in (
            ("a", f_aa, f_ab, cons_a, cons_b),
            ("b", f_bb, f_ab, cons_b, cons_a)):
        idx = torch.tensor([i for i, s in enumerate(labels) if s == spin], device=device)
        n_s = len(idx)
        block = torch.zeros((n_o * n_v, n_s * n_s), dtype=mos.dtype, device=device)
        for chunk in _chunks(n_points, max(n_s * n_s, n_o * n_v)):
            T = T_rows(chunk)
            U = T * cons_same * f_same[chunk] + T * cons_opp * f_opp[chunk]
            mos_s = mos[idx][:, chunk]
            block += U @ _pair_rows(mos_s, mos_s).T
        K_XC_full[:, idx[:, None], idx[None, :]] = block.reshape(-1, n_s, n_s)
    log("[Done]", calculation, 1, silent=silent)
    return K_XC, K_XC_full.reshape(n_o, n_v, n_SO, n_SO)
