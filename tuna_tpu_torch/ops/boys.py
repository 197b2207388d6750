"""Boys function F_n(T) in plain torch, float64.

Twin of tuna_tpu/ops/boys.py with the same table-driven two-regime scheme
and constants:

  T < T_SWITCH : Taylor expansion of F_nmax about the nearest grid point
                 T_i (spacing 0.1, |dT| <= 0.05, 10 terms),
                     F_m(T_i + dT) = sum_k F_{m+k}(T_i) (-dT)^k / k!,
                 then downward recursion F_{m-1} = (2T F_m + e^-T) / (2m - 1)
  T >= T_SWITCH: F_0 = sqrt(pi/(4T)), then upward recursion
                 F_{m+1} = ((2m+1) F_m - e^-T) / (2T)

The grid values are computed once on the host by the Kummer series in
float64 numpy.  The CUDA kernels evaluate the same scheme on the device
(csrc/boys.cuh) from the same table, staged in shared memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

T_SWITCH = 30.0
_GRID_STEP = 0.1
_N_TAYLOR = 10
_N_SERIES_TERMS = 200  # host-side table build only


def _host_boys_top(m: int, T: np.ndarray) -> np.ndarray:
    """F_m(T) by the Kummer series, float64 numpy, T <= T_SWITCH only."""
    two_T = 2.0 * T
    denominators = 2.0 * m + 2.0 * np.arange(1, _N_SERIES_TERMS + 1) + 1.0
    ratios = two_T[..., None] / denominators
    series = 1.0 + np.sum(np.cumprod(ratios, axis=-1), axis=-1)
    return np.exp(-T) * series / (2.0 * m + 1.0)


_TABLE_CACHE: dict[int, np.ndarray] = {}


def _taylor_table(nmax: int) -> np.ndarray:
    """(n_grid, _N_TAYLOR) table: tab[i, k] = F_{nmax+k}(T_i) (-1)^k / k!."""
    tab = _TABLE_CACHE.get(nmax)
    if tab is None:
        n_grid = int(round(T_SWITCH / _GRID_STEP)) + 1
        grid = np.arange(n_grid) * _GRID_STEP
        # series at the highest order, downward recursion for the rest
        top = nmax + _N_TAYLOR - 1
        rows = [_host_boys_top(top, grid)]
        exp_g = np.exp(-grid)
        for m in range(top, nmax, -1):
            rows.append((2.0 * grid * rows[-1] + exp_g) / (2.0 * m - 1.0))
        F = np.stack(rows[::-1], axis=-1)  # (n_grid, K), orders nmax..top
        sign_fact = np.array([(-1.0) ** k / math.factorial(k)
                              for k in range(_N_TAYLOR)])
        tab = F * sign_fact
        _TABLE_CACHE[nmax] = tab
    return tab


def taylor_table(nmax: int, device) -> torch.Tensor:
    """The Taylor table for `nmax` as a contiguous float64 tensor."""
    return torch.as_tensor(_taylor_table(nmax), dtype=torch.float64, device=device)


def boys_table(nmax: int, T: torch.Tensor) -> torch.Tensor:
    """Boys functions F_0..F_nmax of T, shape T.shape + (nmax + 1,)."""
    # Clamp each branch's argument into its own safe domain; selection at the
    # end picks the valid branch, so the clamped values never leak.
    T_small = torch.clamp(T, max=T_SWITCH)
    T_large = torch.clamp(T, min=T_SWITCH)

    exp_small = torch.exp(-T_small)

    # --- small-T branch: Taylor about the nearest grid point, then
    # downward recursion ----------------------------------------------------
    tab = taylor_table(nmax, T.device)
    idx = torch.clamp(torch.round(T_small / _GRID_STEP).to(torch.int64),
                      0, tab.shape[0] - 1)
    dT = T_small - idx.to(T.dtype) * _GRID_STEP  # |dT| <= 0.05
    coeffs = tab[idx]  # (..., K): F_{nmax+k}(T_i) (-1)^k / k!
    F_top = coeffs[..., -1]
    for k in range(_N_TAYLOR - 2, -1, -1):
        F_top = F_top * dT + coeffs[..., k]

    two_T = 2.0 * T_small
    downward = [F_top]
    for m in range(nmax, 0, -1):
        downward.append((two_T * downward[-1] + exp_small) / (2.0 * m - 1.0))
    F_small = torch.stack(downward[::-1], dim=-1)  # (..., nmax+1), order 0..nmax

    # --- large-T branch: closed-form F_0, then upward recursion -----------
    # erf(sqrt(T)) = 1 to ~1e-15 relative at T >= 30, so F_0 needs no erf.
    sqrt_T = torch.sqrt(T_large)
    F0 = math.sqrt(math.pi) / (2.0 * sqrt_T)
    exp_large = torch.exp(-T_large)
    upward = [F0]
    for m in range(nmax):
        upward.append(((2.0 * m + 1.0) * upward[-1] - exp_large) / (2.0 * T_large))
    F_large = torch.stack(upward, dim=-1)

    return torch.where((T < T_SWITCH)[..., None], F_small, F_large)
