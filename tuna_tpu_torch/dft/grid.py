"""DFT quadrature grids: Gauss-Legendre radial x Lebedev angular with Becke
diatomic partitioning, the atomic orbitals (and their gradients) on the
grid, and the density on the grid.

Twin of tuna_tpu/dft/grid.py.  The grid geometry is host NumPy, copied (it
is cheap and geometry only).  The device functions dispatch on the
device of the tensors they are given:

  * basis_on_grid (AO values and gradients): kernel K7a `ao_on_grid`
    (csrc/dft_grid.cu) on a CUDA tensor, `_ao_on_grid_plain` on a CPU
    tensor; the spherical transform is a torch.matmul after either;
  * density_on_grid (rho and grad rho from P; with_tau, tau too): kernel
    K7b `density_on_grid` (K7bt with tau; one template in csrc/dft_grid.cu,
    its tile from `density_layout`) on a CUDA tensor, the reference
    einsums (`_density_on_grid_plain`) on a CPU tensor;
  * density_deriv_on_grid (rho, grad rho and their R-tangents at fixed P on
    a grid whose second half moves with atom 1, for the analytic gradient;
    with_tau, tau and its tangent too): kernel K8c (K8ct) on a CUDA tensor,
    `_density_deriv_on_grid_plain` on a CPU tensor;
    density_deriv_on_grid_spin, the same for both spins in one pass:
    kernel K8cu (K8cut) on a CUDA tensor, the plain version spin by spin
    on a CPU tensor.

Grid tensors keep tuna_tpu's layout: points (3, N, M), weights (N, M), AO
values (n_basis, N, M) and gradients (3, n_basis, N, M).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from ..output import check, log, timer, warning
from . import xc

_F64 = torch.float64

LEBEDEV_ORDERS = np.array([3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29,
                           31, 35, 41, 47, 53, 59, 65, 71, 77, 83, 89, 95, 101,
                           107, 113, 119, 125, 131])


def build_atomic_radial_and_angular_grid(radial_grid_cutoff, n_radial,
                                         lebedev_order, radial_power=3):
    """Radial Gauss-Legendre (mapped r = R t^3) x Lebedev angular grid."""
    from scipy.integrate import lebedev_rule  # scipy >= 1.15

    t_nodes, t_weights = np.polynomial.legendre.leggauss(n_radial)
    t = (t_nodes + 1) / 2
    w_t = t_weights / 2
    r = radial_grid_cutoff * t**radial_power
    dr_dt = radial_grid_cutoff * radial_power * t**(radial_power - 1)
    weights_radial = w_t * dr_dt

    directions, weights_angular = lebedev_rule(lebedev_order)
    points = np.einsum("m,in->imn", r, directions)
    weights = np.einsum("m,m,n->mn", weights_radial, r**2, weights_angular)
    return points, weights


def calculate_Becke_diatomic_weights(X, Y, Z, bond_length, atoms, steepness=4):
    """Becke fuzzy-cell weights with heteronuclear size adjustment."""
    R_A = np.sqrt(X * X + Y * Y + Z * Z)
    R_B = np.sqrt(X * X + Y * Y + (Z - bond_length) ** 2)
    s = (R_A - R_B) / bond_length

    chi = atoms[0].real_vdw_radius / atoms[1].real_vdw_radius
    u = (chi - 1) / (chi + 1)
    a = u / (u * u - 1)
    s = s + a * (1 - s * s)

    for _ in range(steepness):
        s = (3 * s - s**3) / 2

    return (1 - s) / 2, (1 + s) / 2


def build_molecular_grid(radial_grid_cutoff, n_radial, lebedev_order,
                         bond_length, atoms):
    points_A, atomic_weights_A = build_atomic_radial_and_angular_grid(
        radial_grid_cutoff, n_radial, lebedev_order)
    X_A, Y_A, Z_A = points_A

    if len(atoms) == 1 or (len(atoms) == 2 and any(a.ghost for a in atoms)):
        return points_A, atomic_weights_A

    X_B, Y_B, Z_B = X_A, Y_A, Z_A + bond_length
    X = np.concatenate([X_A, X_B], axis=0)
    Y = np.concatenate([Y_A, Y_B], axis=0)
    Z = np.concatenate([Z_A, Z_B], axis=0)
    points = np.stack((X, Y, Z), axis=0)

    weights_A, weights_B = calculate_Becke_diatomic_weights(X, Y, Z, bond_length, atoms)
    n_A = X_A.shape[0]
    weights = np.concatenate([atomic_weights_A * weights_A[:n_A],
                              atomic_weights_A * weights_B[n_A:]], axis=0)
    return points, weights


# =========================================================================
# K7a: atomic orbitals (and gradients) on the grid
# =========================================================================

class GridBasis:
    """The Cartesian AOs in the flat form kernels K7a and K8c read: per AO its
    origin and (l, m, n) and a CSR range of primitives (exponent and
    coefficient x normalisation)."""

    def __init__(self, basis_functions):
        self.n_ao = len(basis_functions)
        self.origin = np.array([bf.origin for bf in basis_functions], dtype=np.float64)
        self.lmn = np.array([bf.lmn for bf in basis_functions], dtype=np.int32).reshape(-1, 3)
        counts = [bf.num_exps for bf in basis_functions]
        self.prim_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        self.exps = np.concatenate([bf.exps for bf in basis_functions]).astype(np.float64)
        self.coefs = np.concatenate([bf.coefs * bf.norms
                                     for bf in basis_functions]).astype(np.float64)

    def tensors(self, device) -> dict:
        def f64(x):
            return torch.as_tensor(x, dtype=_F64, device=device).contiguous()

        def i32(x):
            return torch.as_tensor(x, dtype=torch.int32, device=device).contiguous()

        return {"origin": f64(self.origin), "lmn": i32(self.lmn),
                "prim_start": i32(self.prim_start), "exps": f64(self.exps),
                "coefs": f64(self.coefs)}


def ao_on_grid(basis: GridBasis, points, with_gradients: bool):
    """Cartesian AO values (n_ao, G) and, with_gradients, their gradients
    (3, n_ao, G) at points (3, G): kernel K7a on a CUDA tensor, the plain
    version on a CPU tensor."""
    if points.device.type == "cpu":
        return _ao_on_grid_plain(basis, points, with_gradients)
    if points.device.type != "cuda":
        raise ValueError(f"no AO values on the grid for device {points.device}")
    device = points.device
    G = points.shape[1]
    _kernels.check_tensor("points", points, (3, G), _F64, device)
    t = basis.tensors(device)
    values = torch.empty((basis.n_ao, G), dtype=_F64, device=device)
    grads = (torch.empty((3, basis.n_ao, G), dtype=_F64, device=device)
             if with_gradients else None)
    _kernels.launch(
        "ao_on_grid", "tuna_ao_on_grid", device,
        basis.n_ao, G, int(with_gradients), points.data_ptr(), t["origin"].data_ptr(),
        t["lmn"].data_ptr(), t["prim_start"].data_ptr(), t["exps"].data_ptr(),
        t["coefs"].data_ptr(), values.data_ptr(),
        grads.data_ptr() if with_gradients else None)
    return values, grads


def _ao_on_grid_plain(basis: GridBasis, points, with_gradients: bool):
    """Per-AO torch, term by term as tuna_tpu's NumPy evaluates it."""
    X, Y, Z = points
    values, grads = [], []
    for mu in range(basis.n_ao):
        Xr = X - float(basis.origin[mu, 0])
        Yr = Y - float(basis.origin[mu, 1])
        Zr = Z - float(basis.origin[mu, 2])
        l, m, n = (int(v) for v in basis.lmn[mu])
        r2 = Xr * Xr + Yr * Yr + Zr * Zr
        lo, hi = basis.prim_start[mu], basis.prim_start[mu + 1]
        exps = torch.as_tensor(basis.exps[lo:hi], dtype=_F64, device=points.device)
        coefs = torch.as_tensor(basis.coefs[lo:hi], dtype=_F64, device=points.device)
        exp_term = torch.exp(-exps[:, None] * r2[None, :])
        contracted = coefs @ exp_term
        values.append(contracted * Xr**l * Yr**m * Zr**n)
        if with_gradients:
            poly_x, poly_y, poly_z = Xr**l, Yr**m, Zr**n
            P = poly_x * poly_y * poly_z
            zero = torch.zeros_like(P)
            dP_dx = l * Xr**(l - 1) * poly_y * poly_z if l > 0 else zero
            dP_dy = m * poly_x * Yr**(m - 1) * poly_z if m > 0 else zero
            dP_dz = n * poly_x * poly_y * Zr**(n - 1) if n > 0 else zero
            e = exps[:, None]
            primitives = torch.stack([exp_term * (dP_dx - 2 * e * Xr * P),
                                      exp_term * (dP_dy - 2 * e * Yr * P),
                                      exp_term * (dP_dz - 2 * e * Zr * P)])
            grads.append(torch.einsum("i,aij->aj", coefs, primitives))
    return (torch.stack(values),
            torch.stack(grads, dim=1) if with_gradients else None)


def basis_on_grid(basis_functions, points, spherical_transform, with_gradients: bool):
    """(Spherical) AO values (n_basis, N, M) and gradients (3, n_basis, N,
    M) or None at points (3, N, M), the layout of tuna_tpu's
    construct_basis_functions_on_grid and ..._gradients_on_grid."""
    shape = points.shape[1:]
    flat = points.reshape(3, -1).contiguous()
    values, grads = ao_on_grid(GridBasis(basis_functions), flat, with_gradients)
    U = torch.as_tensor(spherical_transform, dtype=_F64, device=points.device)
    bfs = (U @ values).reshape(U.shape[0], *shape)
    del values  # the Cartesian values are not needed past the transform
    if grads is not None:
        grads = torch.matmul(U, grads).reshape(3, U.shape[0], *shape)
    return bfs, grads


# =========================================================================
# K7b: the density and its gradient on the grid
# =========================================================================

def density_on_grid(P, bfs, grads=None, with_tau: bool = False):
    """rho = sum_ij P_ij phi_i phi_j on the grid, shape bfs.shape[1:], and
    with grads, grad rho = 2 sum_ij P_ij phi_i grad phi_j, (3, ...); with
    with_tau (grads needed), also the kinetic energy density tau = 1/2 sum_a
    sum_ij P_ij d_a phi_i d_a phi_j, shape bfs.shape[1:] (no floor applied):
    kernel K7b (K7bt with tau) on a CUDA tensor, the reference einsums on a
    CPU tensor.  Returns (rho, grad rho or None), or (rho, grad rho, tau)."""
    if with_tau and grads is None:
        raise ValueError("tau on the grid needs the AO gradients")
    if bfs.device.type == "cpu":
        return _density_on_grid_plain(P, bfs, grads, with_tau)
    if bfs.device.type != "cuda":
        raise ValueError(f"no density on the grid for device {bfs.device}")
    shape = bfs.shape[1:]
    outputs = _density_kernel(P, bfs.reshape(bfs.shape[0], -1),
                              grads.reshape(3, bfs.shape[0], -1) if grads is not None else None,
                              with_tau)
    density, gradient = outputs[0].reshape(shape), outputs[1]
    gradient = gradient.reshape(3, *shape) if gradient is not None else None
    if with_tau:
        return density, gradient, outputs[2].reshape(shape)
    return density, gradient


# density_layout's output sets (csrc/dft_grid.cu kDensityRho, ...)
DENSITY_RHO, DENSITY_GRADIENTS, DENSITY_TAU = 0, 1, 2


def _density_kernel(P, phi, grads, with_tau: bool, layout=None):
    """Launch K7b (rho; with grads, grad rho) or K7bt (with_tau) on phi (n,
    G) and grads (3, n, G) or None: (rho (G,), grad rho (3, G) or None[,
    tau (G,)]).  The tile (points, P^T whole, buffers) comes from `layout`,
    by default density_layout's."""
    device = phi.device
    n, G = phi.shape
    _kernels.check_tensor("P", P, (n, n), _F64, device)
    _kernels.check_tensor("bfs", phi, (n, G), _F64, device)
    if grads is not None:
        _kernels.check_tensor("grads", grads, (3, n, G), _F64, device)
    outputs = (DENSITY_TAU if with_tau else DENSITY_GRADIENTS if grads is not None
               else DENSITY_RHO)
    points, whole_p, buffers = layout or density_layout(n, outputs)[:3]
    density = torch.empty(G, dtype=_F64, device=device)
    gradient = torch.empty((3, G), dtype=_F64, device=device) if grads is not None else None
    pointers = [P.data_ptr(), phi.data_ptr(), grads.data_ptr() if grads is not None else None,
                density.data_ptr(), gradient.data_ptr() if gradient is not None else None]
    if with_tau:
        tau = torch.empty(G, dtype=_F64, device=device)
        _kernels.launch("density_tau_on_grid", "tuna_density_tau_on_grid", device, n, G, points,
                        int(whole_p), buffers, *pointers, tau.data_ptr())
        return density, gradient, tau
    _kernels.launch("density_on_grid", "tuna_density_on_grid", device, n, G,
                    int(grads is not None), points, int(whole_p), buffers, *pointers)
    return density, gradient


def density_bytes(n: int, outputs: int, points: int, whole: bool, buffers: int) -> int:
    """Shared bytes of a block of K7b/K7bt: see density_layout."""
    mp, lda = -(-n // 16) * 16, -(-n // 8) * 8 + 4
    columns = 1 if outputs == DENSITY_RHO else 4
    return 8 * (buffers * columns * mp * (points + 4) + (mp if whole else 16) * lda)


def density_layouts(n: int, outputs: int) -> list[tuple[int, bool, int, int]]:
    """Every tile of K7b (outputs DENSITY_RHO, DENSITY_GRADIENTS) and K7bt
    (DENSITY_TAU) for n AOs that fits an H100 block's shared memory, in the
    host's order of preference: (points a tile, P^T staged whole, column
    buffers, shared bytes).  A block holds `buffers` sets of the tile's
    columns (phi; with gradients or tau also d phi), (1 or 4, n rounded up
    to 16, points + 4) doubles each, and P^T whole ((n rounded up to 16) x
    lda doubles, lda = n rounded up to 8, plus 4) or 16 rows of it.  The
    order: P^T whole before 16 rows, then 32, 16 and 8 points, then for K7b
    with gradients two buffers before one (four columns and one product: the
    next tile's loads in flight during it pay), for K7bt and for K7b
    without gradients one before two (four products, or one column: the
    smaller block, two blocks a multiprocessor, pays more), as
    chip_smoke.py's tiles_back_to_back_ms measured (PERF.md)."""
    order = (2, 1) if outputs == DENSITY_GRADIENTS else (1, 2)
    layouts = []
    for whole in (True, False):
        for points in (32, 16, 8):
            for buffers in order:
                shared = density_bytes(n, outputs, points, whole, buffers)
                if shared <= _kernels.SHARED_MEMORY_A_BLOCK:
                    layouts.append((points, whole, buffers, shared))
    return layouts


@functools.lru_cache(maxsize=None)
def density_layout(n: int, outputs: int) -> tuple[int, bool, int, int]:
    """The tile the wrappers of K7b and K7bt take for n AOs: the first of
    density_layouts; a shape that fits none raises (no other kernel or
    plain version takes it on the card)."""
    layouts = density_layouts(n, outputs)
    if not layouts:
        raise ValueError(f"the density on the grid: {n} AOs do not fit one block's shared "
                         f"memory ({_kernels.SHARED_MEMORY_A_BLOCK} bytes)")
    return layouts[0]


def _density_on_grid_plain(P, bfs, grads=None, with_tau: bool = False):
    density = torch.einsum("ij,i...,j...->...", P, bfs, bfs)
    gradient = (2 * torch.einsum("ij,i...,aj...->a...", P, bfs, grads)
                if grads is not None else None)
    if with_tau:
        return density, gradient, 0.5 * torch.einsum("ij,ai...,aj...->...", P, grads, grads)
    return density, gradient


# =========================================================================
# K8c: the density, its gradient and their R-tangents on a moving grid
# =========================================================================

def density_deriv_on_grid(basis: GridBasis, origin, ao_moves, points, first_moving: int, P,
                          with_gradients: bool, with_tau: bool = False):
    """(rho, grad rho or None, rho', grad rho' or None) at points (3, G)
    for the symmetric Cartesian density P, where ' is d/dR at fixed P when
    atom 1 moves along +z: its AOs (ao_moves, int32 (n_ao,), 1 on atom 1)
    and the points from `first_moving` on move with it; with_tau (which
    needs with_gradients), then also tau and tau'.  origin (n_ao, 3) holds
    the AO centres at this geometry (basis.origin is not read).  Kernel K8c
    (K8ct with tau) on a CUDA tensor, the plain version on a CPU tensor; no
    floor applied."""
    if with_tau and not with_gradients:
        raise ValueError("tau on the moving grid needs with_gradients")
    if points.device.type == "cpu":
        return _density_deriv_on_grid_plain(basis, origin, ao_moves, points, first_moving, P,
                                            with_gradients, with_tau)
    kernel = "density_tau_deriv_on_grid" if with_tau else "density_deriv_on_grid"
    return _density_deriv_kernel(kernel, "tuna_" + kernel, basis, origin, ao_moves, points,
                                 first_moving, P, with_gradients, with_tau)


def density_deriv_on_grid_spin(basis: GridBasis, origin, ao_moves, points, first_moving: int,
                               P_stack, with_gradients: bool, with_tau: bool = False):
    """density_deriv_on_grid for a stack of symmetric Cartesian densities
    P_stack (2, n_ao, n_ao), the two spins, in one pass: (rho, grad rho or
    None, rho', grad rho' or None[, tau, tau']) with shapes (2, G) and (2,
    3, G).  Kernel K8cu (K8cut with tau) on a CUDA tensor, the plain version
    of K8c density by density on a CPU tensor; no floor applied."""
    if with_tau and not with_gradients:
        raise ValueError("tau on the moving grid needs with_gradients")
    if points.device.type == "cpu":
        outs = [_density_deriv_on_grid_plain(basis, origin, ao_moves, points, first_moving, P,
                                             with_gradients, with_tau) for P in P_stack]
        return tuple(torch.stack(parts) if parts[0] is not None else None
                     for parts in zip(*outs))
    _kernels.check_tensor("P_stack", P_stack, (2, basis.n_ao, basis.n_ao), _F64, points.device)
    kernel = "density_tau_deriv_on_grid_spin" if with_tau else "density_deriv_on_grid_spin"
    return _density_deriv_kernel(kernel, "tuna_" + kernel, basis, origin, ao_moves, points,
                                 first_moving, P_stack, with_gradients, with_tau)


def _density_deriv_kernel(kernel, entry, basis, origin, ao_moves, points, first_moving, P,
                          with_gradients, with_tau=False, layout=None):
    """Launch K8c or K8ct (P (n, n)), K8cu or K8cut (P (2, n, n)), one
    template in csrc/dft_grid.cu; each output carries the leading axes of
    P.  The tile (points, P whole) comes from `layout`, by default
    density_deriv_layout's."""
    if points.device.type != "cuda":
        raise ValueError(f"no density derivative on the grid for device {points.device}")
    device = points.device
    G, n = points.shape[1], basis.n_ao
    _kernels.check_tensor("points", points, (3, G), _F64, device)
    _kernels.check_tensor("origin", origin, (n, 3), _F64, device)
    _kernels.check_tensor("ao_moves", ao_moves, (n,), torch.int32, device)
    spins = P.shape[:-2]
    _kernels.check_tensor("P", P, (*spins, n, n), _F64, device)
    tile, whole_p = layout or density_deriv_layout(n, spins[0] if spins else 1,
                                                   with_gradients)[:2]
    t = basis.tensors(device)
    density, d_density = (torch.empty((*spins, G), dtype=_F64, device=device)
                          for _ in range(2))
    gradient, d_gradient = ((torch.empty((*spins, 3, G), dtype=_F64, device=device)
                             if with_gradients else None) for _ in range(2))
    tau, d_tau = ((torch.empty((*spins, G), dtype=_F64, device=device) if with_tau else None)
                  for _ in range(2))
    outputs = [x.data_ptr() if x is not None else None
               for x in (density, gradient, d_density, d_gradient)]
    if with_tau:
        outputs += [tau.data_ptr(), d_tau.data_ptr()]
    _kernels.launch(kernel, entry, device, n, G, int(first_moving), int(with_gradients), tile,
                    int(whole_p), points.data_ptr(), origin.data_ptr(), ao_moves.data_ptr(),
                    t["lmn"].data_ptr(), t["prim_start"].data_ptr(), t["exps"].data_ptr(),
                    t["coefs"].data_ptr(), P.data_ptr(), *outputs)
    if with_tau:
        return density, gradient, d_density, d_gradient, tau, d_tau
    return density, gradient, d_density, d_gradient


def density_deriv_bytes(n: int, spins: int, points: int, whole: bool,
                        with_gradients: bool = True) -> int:
    """Shared bytes of a block of the moving-grid kernel: see
    density_deriv_layout."""
    mp, lda = -(-n // 16) * 16, -(-n // 8) * 8 + 4
    columns = 7 if with_gradients else 2
    return 8 * (columns * mp * (points + 4) + mp + spins * (mp if whole else 16) * lda)


def density_deriv_layout(n: int, spins: int,
                         with_gradients: bool = True) -> tuple[int, bool, int]:
    """The tile of the moving-grid kernel (csrc/dft_grid.cu
    moving_grid_kernel: K8c and K8ct for spins = 1, K8cu and K8cut for 2)
    for n Cartesian AOs: (points a tile, P staged whole, shared bytes).  A
    block holds the tile's columns, (7 with gradients, else 2; n rounded up
    to 16; points + 4) doubles (with tau the same seven), the AOs' move
    flags (n rounded up to 16 doubles) and each density's P whole ((n
    rounded up to 16) x lda doubles, lda = n rounded up to 8, plus 4) or 16
    rows of it; the first of 32 / spins (at most 256 threads a block), 16
    and 8 points with P whole that fits, else with 16 rows."""
    for whole in (True, False):
        for points in (32, 16, 8):
            shared = density_deriv_bytes(n, spins, points, whole, with_gradients)
            if points * spins <= 32 and shared <= _kernels.SHARED_MEMORY_A_BLOCK:
                return points, whole, shared
    raise ValueError(f"the density on the moving grid: {n} AOs with {spins} density matrices "
                     f"do not fit one block's shared memory ({_kernels.SHARED_MEMORY_A_BLOCK} "
                     f"bytes)")


def _density_deriv_on_grid_plain(basis: GridBasis, origin, ao_moves, points, first_moving: int,
                                 P, with_gradients: bool, with_tau: bool = False):
    """Per-AO torch: values, gradients and the z column of each AO's
    Hessian on every point, then the contractions with P (with tau:
    tau = 1/2 sum_a d_a phi . P d_a phi, tau' = sum_a (d_a phi)' . P d_a
    phi)."""
    X, Y, Z = points
    G = points.shape[1]
    zero = torch.zeros_like(X)
    values, grads, hess_z = [], [], []
    for mu in range(basis.n_ao):
        Xr, Yr, Zr = X - origin[mu, 0], Y - origin[mu, 1], Z - origin[mu, 2]
        l, m, n = (int(v) for v in basis.lmn[mu])
        lo, hi = basis.prim_start[mu], basis.prim_start[mu + 1]
        exps = torch.as_tensor(basis.exps[lo:hi], dtype=_F64, device=points.device)
        coefs = torch.as_tensor(basis.coefs[lo:hi], dtype=_F64, device=points.device)
        e = torch.exp(-exps[:, None] * (Xr * Xr + Yr * Yr + Zr * Zr)[None, :])
        s0, s1, s2 = coefs @ e, (coefs * exps) @ e, (coefs * exps * exps) @ e
        px, py, pz = Xr**l, Yr**m, Zr**n
        poly = px * py * pz
        dx = l * Xr**(l - 1) * py * pz if l > 0 else zero
        dy = m * px * Yr**(m - 1) * pz if m > 0 else zero
        dz = n * px * py * Zr**(n - 1) if n > 0 else zero
        dxz = l * n * Xr**(l - 1) * py * Zr**(n - 1) if l > 0 and n > 0 else zero
        dyz = m * n * px * Yr**(m - 1) * Zr**(n - 1) if m > 0 and n > 0 else zero
        dzz = n * (n - 1) * px * py * Zr**(n - 2) if n > 1 else zero
        values.append(s0 * poly)
        grads.append(torch.stack([dx * s0 - 2 * Xr * poly * s1, dy * s0 - 2 * Yr * poly * s1,
                                  dz * s0 - 2 * Zr * poly * s1]))
        hess_z.append(torch.stack([
            dxz * s0 - 2 * Zr * dx * s1 - 2 * Xr * dz * s1 + 4 * Xr * Zr * poly * s2,
            dyz * s0 - 2 * Zr * dy * s1 - 2 * Yr * dz * s1 + 4 * Yr * Zr * poly * s2,
            dzz * s0 - 4 * Zr * dz * s1 - 2 * poly * s1 + 4 * Zr * Zr * poly * s2]))
    phi = torch.stack(values)                    # (n, G)
    grad_phi = torch.stack(grads, dim=1)         # (3, n, G)
    point_moves = (torch.arange(G, device=points.device) >= first_moving).to(_F64)
    moves = point_moves[None, :] - ao_moves.to(_F64)[:, None]
    d_phi = moves * grad_phi[2]
    Yv, dY = P @ phi, P @ d_phi
    density = torch.sum(phi * Yv, dim=0)
    d_density = 2 * torch.sum(d_phi * Yv, dim=0)
    if not with_gradients:
        return density, None, d_density, None
    d_grad_phi = moves * torch.stack(hess_z, dim=1)
    gradient = 2 * torch.sum(grad_phi * Yv, dim=1)
    d_gradient = 2 * torch.sum(grad_phi * dY + d_grad_phi * Yv, dim=1)
    if not with_tau:
        return density, gradient, d_density, d_gradient
    Ya = P @ grad_phi                            # (3, n, G)
    tau = 0.5 * torch.sum(grad_phi * Ya, dim=(0, 1))
    d_tau = torch.sum(d_grad_phi * Ya, dim=(0, 1))
    return density, gradient, d_density, d_gradient, tau, d_tau


def construct_density_on_grid(P, bfs_on_grid, clean_density=True):
    density, _ = density_on_grid(P, bfs_on_grid)
    return xc.clean(density) if clean_density else density


def integrate_on_grid(integrand, weights):
    return float(torch.sum(integrand.reshape(weights.shape) * weights))


def integrate_final_density(alpha_density, beta_density, density, weights,
                            calculation, silent=False):
    n_a = integrate_on_grid(alpha_density, weights)
    n_b = integrate_on_grid(beta_density, weights)
    n_total = integrate_on_grid(density, weights)
    log(f"\n Integral of the alpha density:       {n_a:13.10f}", calculation, 1, silent=silent)
    log(f" Integral of the beta density:        {n_b:13.10f}\n", calculation, 1, silent=silent)
    log(f" Integral of the total density:       {n_total:13.10f}", calculation, 1, silent=silent)


def grid_parameters(molecule, calculation):
    """Static grid dimensions (extent, n_radial, Lebedev order) for this
    molecule/accuracy pair."""
    extent_multiplier = calculation.grid_conv["extent_multiplier"]
    integral_accuracy = (calculation.grid_conv["integral_accuracy"]
                         if not calculation.integral_accuracy_requested
                         else calculation.integral_accuracy)

    extent = extent_multiplier * max(
        a.real_vdw_radius for a in molecule.atoms) / 6

    n = int(integral_accuracy * 9)
    Lebedev_order = int(LEBEDEV_ORDERS[np.abs(LEBEDEV_ORDERS - n).argmin()])
    n_radial = int(extent * integral_accuracy)
    return extent, n_radial, Lebedev_order


def set_up_integration_grid(molecule, P_guess_alpha, P_guess_beta, calculation,
                            silent, device):
    """Build the molecular grid on the host, move points and weights to
    `device` once, and evaluate the basis (and gradients) there.  Returns
    (bfs, weights, gradients or None, points)."""
    timer("Integration grid setup", 0)
    log(f' Setting up DFT integration grid with "{calculation.grid_conv["name"]}" '
        "accuracy...  ", calculation, 1, end="", silent=silent)

    extent, n_radial, Lebedev_order = grid_parameters(molecule, calculation)

    points, weights = build_molecular_grid(extent, n_radial, Lebedev_order,
                                           molecule.bond_length, molecule.atoms)
    log("[Done]", calculation, 1, silent=silent)

    total_points = points.shape[1] * points.shape[2]
    log(f"\n Integration grid has {n_radial} radial and {points.shape[2]} angular "
        f"points, a Lebedev order of {Lebedev_order}.", calculation, 1, silent=silent)
    log(f" In total there are {total_points} grid points, "
        f"{total_points // molecule.n_atoms} per atom.", calculation, 1, silent=silent)

    log("\n Building guess density on grid...  ", calculation, 1, end="", silent=silent)
    points = torch.as_tensor(points, dtype=_F64, device=device).contiguous()
    weights = torch.as_tensor(weights, dtype=_F64, device=device).contiguous()
    needs_gradients = (calculation.functional.functional_class in ("GGA", "meta-GGA")
                       or calculation.VV10)
    bfs_on_grid, bf_gradients_on_grid = basis_on_grid(
        molecule.cartesian_basis_functions, points, molecule.spherical_transformation,
        needs_gradients)

    alpha_density = construct_density_on_grid(
        torch.as_tensor(P_guess_alpha, dtype=_F64, device=device), bfs_on_grid)
    beta_density = construct_density_on_grid(
        torch.as_tensor(P_guess_beta, dtype=_F64, device=device), bfs_on_grid)
    density = alpha_density + beta_density
    log("[Done]", calculation, 1, silent=silent)

    n_a = integrate_on_grid(alpha_density, weights)
    n_b = integrate_on_grid(beta_density, weights)
    n_total = integrate_on_grid(density, weights)
    log(f"\n Integral of the guess alpha density: {n_a:14.10f}", calculation, 1, silent=silent)
    log(f" Integral of the guess beta density:  {n_b:14.10f}\n", calculation, 1, silent=silent)
    log(f" Integral of the guess total density: {n_total:14.10f}\n", calculation, 1, silent=silent)

    if abs(n_total - molecule.n_electrons) > 0.0001:
        warning(" Integral of density is far from the number of electrons! "
                "Be careful with your results.")
        check(abs(n_total - molecule.n_electrons) < 0.5,
              "Integral for the density is completely wrong!")

    log(f" Using {100 * calculation.DFX_prop:.1f}% density functional exchange and "
        f"{100 * calculation.HFX_prop:.1f}% Hartree-Fock exchange.", calculation, 2, silent=silent)
    log(f" Using {100 * calculation.DFC_prop:.1f}% density functional correlation and "
        f"{100 * calculation.MPC_prop:.1f}% Moller-Plesset correlation.\n",
        calculation, 2, silent=silent)

    timer("Integration grid setup", 1)
    return bfs_on_grid, weights, bf_gradients_on_grid, points
