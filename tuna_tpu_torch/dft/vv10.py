"""VV10 non-local dispersion energy (Vydrov-Van Voorhis 2010).

Twin of tuna_tpu/dft/vv10.py::calculate_VV10_energy and
vv10_energies_batch.  The density and its gradient on the grid come from
kernel K7b; the points with density above 1e-10 form the active set, and
the O(M^2) pair sum over it runs through `vv10_energy`: kernel K6
(csrc/vv10.cu) on CUDA tensors, the row-chunked plain version on CPU
tensors.  A batch of densities, each on its own grid, runs through
`vv10_energy_batch`: kernel K6b, one launch over the concatenated active
sets, on CUDA tensors, the plain version element by element on CPU
tensors.  tuna_tpu pads the active set to a bucket so that XLA compiles
once; padded points carry zero weight, so the port sums the active points
alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from ..output import log, log_spacer, timer
from . import xc
from .grid import density_on_grid

_F64 = torch.float64
VV10_TILE = 512     # points a tile of csrc/vv10.cu, which visits the tile pairs J >= I
_PLAIN_ROWS = 256    # rows per chunk of the plain pair sum


def _vv10_point_terms(density, w, sigma, b, C):
    """omega, kappa and w rho per point (tuna_tpu/dft/vv10.py:28-31) and
    beta."""
    weighted_density = density * w
    s_over_n2 = sigma / (density * density)
    omega = torch.sqrt(C * s_over_n2 * s_over_n2 + (4.0 / 3.0) * math.pi * density)
    kappa = 1.5 * math.pi * b * (density / (9.0 * math.pi)) ** (1.0 / 6.0)
    beta = (1.0 / 32.0) * (3.0 / b**2) ** (3.0 / 4.0)
    return omega, kappa, weighted_density, beta


def vv10_energy(density, w, sigma, pts, b, C):
    """The unscaled VV10 energy (a 0-d tensor) of M points: density, w and
    sigma (M,), pts (M, 3).  Kernel K6 on CUDA tensors, the plain version on
    CPU tensors."""
    omega, kappa, weighted_density, beta = _vv10_point_terms(density, w, sigma, b, C)
    if pts.device.type == "cpu":
        return _vv10_pair_sum_plain(pts, omega, kappa, weighted_density, beta)
    if pts.device.type != "cuda":
        raise ValueError(f"no VV10 energy for device {pts.device}")
    return _vv10_pair_sum_kernel(pts, omega, kappa, weighted_density, beta)


def _vv10_pair_sum_kernel(pts, omega, kappa, weighted_density, beta):
    device = pts.device
    M = pts.shape[0]
    _kernels.check_tensor("pts", pts, (M, 3), _F64, device)
    for name, tensor in (("omega", omega), ("kappa", kappa),
                         ("weighted_density", weighted_density)):
        _kernels.check_tensor(name, tensor, (M,), _F64, device)
    if M == 0:
        return torch.zeros((), dtype=_F64, device=device)
    n_tiles = -(-M // VV10_TILE)
    partial = torch.empty(n_tiles * (n_tiles + 1) // 2, dtype=_F64, device=device)
    _kernels.launch(
        "vv10_energy", "tuna_vv10_energy", device,
        M, n_tiles, pts.data_ptr(), omega.data_ptr(), kappa.data_ptr(),
        weighted_density.data_ptr(), float(beta), partial.data_ptr())
    return torch.sum(partial)


def vv10_energy_batch(counts, density, w, sigma, pts, b, C):
    """The unscaled VV10 energies (B,) of a ragged batch: element k holds
    the next counts[k] points of density, w and sigma (M,) and pts (M, 3),
    M = sum(counts).  Kernel K6b, one launch, on CUDA tensors; the plain
    version, element by element, on CPU tensors."""
    omega, kappa, weighted_density, beta = _vv10_point_terms(density, w, sigma, b, C)
    if pts.device.type == "cpu":
        return _vv10_pair_sums_plain(counts, pts, omega, kappa, weighted_density, beta)
    if pts.device.type != "cuda":
        raise ValueError(f"no VV10 energy for device {pts.device}")
    return _vv10_pair_sums_kernel(counts, pts, omega, kappa, weighted_density, beta)


def _vv10_pair_sums_kernel(counts, pts, omega, kappa, weighted_density, beta):
    device = pts.device
    M = pts.shape[0]
    if M != sum(counts) or min(counts, default=-1) < 0:
        raise ValueError(f"vv10_energy_batch: counts {counts} do not split {M} points")
    _kernels.check_tensor("pts", pts, (M, 3), _F64, device)
    for name, tensor in (("omega", omega), ("kappa", kappa),
                         ("weighted_density", weighted_density)):
        _kernels.check_tensor(name, tensor, (M,), _F64, device)
    tiles = [-(-m // VV10_TILE) for m in counts]
    pair_offsets = np.cumsum([0] + [t * (t + 1) // 2 for t in tiles])
    n_batch, n_pairs = len(counts), int(pair_offsets[-1])
    # both offset arrays in one host-to-device copy
    offsets = torch.as_tensor(np.concatenate([np.cumsum([0, *counts]), pair_offsets]),
                              dtype=torch.int32).to(device)
    partial = torch.empty(n_pairs, dtype=_F64, device=device)
    energies = torch.empty(n_batch, dtype=_F64, device=device)
    _kernels.launch(
        "vv10_energy_batch", "tuna_vv10_energy_batch", device,
        n_batch, n_pairs, offsets.data_ptr(), offsets.data_ptr() + 4 * (n_batch + 1),
        pts.data_ptr(), omega.data_ptr(), kappa.data_ptr(), weighted_density.data_ptr(),
        float(beta), partial.data_ptr(), energies.data_ptr())
    return energies


def _vv10_pair_sums_plain(counts, pts, omega, kappa, weighted_density, beta):
    """The plain pair sum, element by element, of a ragged batch."""
    bounds = np.cumsum([0, *counts])
    return torch.stack([
        _vv10_pair_sum_plain(pts[s:e], omega[s:e], kappa[s:e], weighted_density[s:e], beta)
        for s, e in zip(bounds[:-1], bounds[1:])])


def _vv10_pair_sum_plain(pts, omega, kappa, weighted_density, beta):
    """The row-chunked pair sum of tuna_tpu/dft/vv10.py:38-50."""
    inner = torch.empty_like(weighted_density)
    x, y, z = pts.T
    for start in range(0, pts.shape[0], _PLAIN_ROWS):
        rows = slice(start, start + _PLAIN_ROWS)
        # the reference's expressions, evaluated in place to spare memory
        d2 = (x[rows, None] - x).square_()
        d2 += (y[rows, None] - y).square_()
        d2 += (z[rows, None] - z).square_()
        g_i = d2 * omega[rows, None]
        g_i += kappa[rows, None]
        g_j = d2.mul_(omega).add_(kappa)
        kernel = (g_i + g_j).mul_(g_i.mul_(g_j)).reciprocal_().mul_(-1.5)
        inner[rows] = kernel @ weighted_density
    return weighted_density @ (beta + 0.5 * inner)


def _active_points(P, bfs, bf_grads, weights, points):
    """(density, w, sigma, points (M, 3)) at the M grid points whose
    density is above 1e-10."""
    density_full, gradient = density_on_grid(P, bfs, bf_grads)
    density_full = xc.clean(density_full).reshape(-1)
    sigma_full = torch.sum(gradient * gradient, dim=0).reshape(-1)
    mask = density_full > 1e-10
    return (density_full[mask], weights.reshape(-1)[mask], sigma_full[mask],
            points.reshape(3, -1).T[mask].contiguous())


def _parameters(functional):
    """(b, C, scaling) of the functional, tuna_tpu's defaults without one."""
    if functional is None:
        return 3.9, 0.0093, 1.0
    return functional.VV10_b, functional.VV10_C, functional.VV10_scaling


def vv10_energies_batch(P_batch, bfs_b, grads_b, w_b, pts_b, functional,
                        grid_axes=(0, 0, 0, 0)):
    """The scaled VV10 energies (B,) of B converged densities P_batch.

    Twin of tuna_tpu/dft/vv10.py:63: bfs_b, grads_b, w_b and pts_b hold a
    grid an element along their first axis (a stacked tensor or a list),
    or, where grid_axes has None, one grid all elements share.  The
    density and sigma come through K7b once an element, the pair sums
    through vv10_energy_batch (one K6b launch on CUDA tensors)."""
    b, C, scaling = _parameters(functional)
    active = []
    for i, P in enumerate(P_batch):
        grid = [x if axis is None else x[i]
                for x, axis in zip((bfs_b, grads_b, w_b, pts_b), grid_axes)]
        active.append(_active_points(P, *grid))
    counts = [int(a[0].shape[0]) for a in active]
    density, w, sigma, pts = (torch.cat(parts) for parts in zip(*active))
    return vv10_energy_batch(counts, density, w, sigma, pts.contiguous(), b, C) * scaling


def calculate_VV10_energy(P, grid_container, calculation, silent):
    bfs, weights, bf_grads, points = grid_container
    functional = calculation.functional
    b, C, _ = _parameters(functional)

    timer("Non-local VV10 dispersion", 0)
    log_spacer(calculation, 1, silent=silent)
    log("             Non-local Dispersion Energy", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    log(f'  Using a "b" value of {b} and "c" value of {C}.', calculation, 3,
        silent=silent, end="\n\n")
    log("  Calculating VV10 dispersion energy...      ", calculation, 1,
        silent=silent, end="")

    E_VV10 = float(vv10_energy(*_active_points(P, bfs, bf_grads, weights, points), b, C))
    E_VV10 *= functional.VV10_scaling

    log("[Done]", calculation, 1, silent=silent)
    log(f"\n  Energy from VV10:                {E_VV10:16.10f}", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    timer("Non-local VV10 dispersion", 1)
    return E_VV10
