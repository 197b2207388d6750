"""Dense float64 linear algebra for the port.

Twin of tuna_tpu/ops/linalg.py.  S^-1/2 comes from the library's eigh as it
is: tuna_tpu's Newton-Schulz refinement exists because the TPU has no f64
LAPACK, while cuSOLVER and LAPACK factorise in native float64.  The SCF's
eigh keeps tuna_tpu's polish (`eigh`) on every device, because it is part
of the algorithm there and not only a repair of the TPU's precision: it
zeroes the mixing inside near-degenerate blocks and sorts by Rayleigh
quotient, which decides the orbitals of a degenerate shell.
"""

from __future__ import annotations

import numpy as np
import torch


POLISH_STEPS = 3


def eigh(A: torch.Tensor):
    """Symmetric eigendecomposition of A (..., n, n), polished as
    tuna_tpu/ops/linalg.py::eigh polishes it: the library's eigh, then
    POLISH_STEPS first-order perturbation steps (H = V^T A V; rotate V
    by K_ij = H_ij / (w_j - w_i), zero inside blocks whose gaps are below
    1e-9 of the largest |w|; re-orthonormalise V <- V (3 I - V^T V) / 2),
    and eigenvalues from the final Rayleigh quotients, stably sorted."""
    w, V = torch.linalg.eigh(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for _ in range(POLISH_STEPS):
        H = V.mT @ A @ V
        w = torch.diagonal(H, dim1=-2, dim2=-1)
        scale = torch.clamp(torch.amax(torch.abs(w), dim=-1, keepdim=True), min=1e-30)
        gaps = w[..., None, :] - w[..., :, None]
        degenerate = torch.abs(gaps) < 1e-9 * scale[..., None]
        K = torch.where(degenerate, 0.0, H / torch.where(degenerate, 1.0, gaps))
        K = K - torch.diag_embed(torch.diagonal(K, dim1=-2, dim2=-1))
        V = V + V @ K
        V = V @ (1.5 * eye - 0.5 * (V.mT @ V))
    w = torch.diagonal(V.mT @ A @ V, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.take_along_dim(w, order, dim=-1),
            torch.take_along_dim(V, order[..., None, :], dim=-1))


def inverse_sqrt(S: torch.Tensor):
    """(X = S^-1/2, smallest eigenvalue of S, S^-1) from one eigh of SPD S."""
    w, V = torch.linalg.eigh(S)
    X = (V * (1.0 / torch.sqrt(w))) @ V.T
    X = 0.5 * (X + X.T)
    S_inverse = (V * (1.0 / w)) @ V.T
    return X, torch.min(w), 0.5 * (S_inverse + S_inverse.T)


def _two_sum(a, b):
    """s + t = a + b exactly, s = fl(a + b) (Knuth)."""
    s = a + b
    b_virtual = s - a
    return s, (a - (s - b_virtual)) + (b - b_virtual)


def _two_product(a, b):
    """p + e = a b exactly, p = fl(a b) (Dekker, Veltkamp's split)."""
    def split(x):
        c = 134217729.0 * x
        high = c - (c - x)
        return high, x - high

    p = a * b
    a_high, a_low = split(a)
    b_high, b_low = split(b)
    return p, ((a_high * b_high - p) + a_high * b_low + a_low * b_high) + a_low * b_low


def _round_to_odd_sum(a, b):
    """a + b rounded to odd: fl(a + b) when exact, else whichever neighbour
    of the exact sum has an odd last mantissa bit."""
    s, t = _two_sum(a, b)
    even = (s.view(np.int64) & 1) == 0
    toward = np.where(t > 0, np.inf, -np.inf)
    return np.where((t != 0) & even, np.nextafter(s, toward), s)


def fused_multiply_add(a, b, c):
    """a b + c rounded once, elementwise on float64 arrays (Boldo and
    Melquiond's emulation by rounding to odd; NumPy has no fma)."""
    u_high, u_low = _two_product(a, b)
    t_high, t_low = _two_sum(c, u_high)
    return t_high + _round_to_odd_sum(t_low, u_low)


def solve_linear_small(A: torch.Tensor, b: torch.Tensor):
    """Solve a small dense system (DIIS) by row-equilibrated Gauss-Jordan
    elimination without pivoting; returns (x on A's device, ok).

    The arithmetic of tuna_tpu/ops/linalg.py::solve_linear_small as XLA
    compiles it inside tuna_tpu's jitted SCF: each elimination update
    M - f r is one fused multiply-add (rounded once).  Late in a
    small-basis SCF the bordered DIIS system is close to singular, and
    another arithmetic gives other coefficients there and so another
    number of iterations: LAPACK's pivoted LU took 8 instead of 6 for
    H2/6-31G B3LYP, the update rounded twice 7 instead of 6 for H2/6-31G
    HF (its fourth error's pivot cancels to zero).  The system is at most
    (max DIIS + 1) square, so it is solved on the host in NumPy: one copy
    each way instead of some 10 (n + 1) tiny device launches.  ok (a bool)
    is False when the residual is not small, the caller's signal to reset
    its DIIS history."""
    A_host = A.detach().cpu().numpy()
    b_host = b.detach().cpu().numpy()
    n = A_host.shape[0]
    r = np.max(np.abs(A_host), axis=1)
    r = np.where(r > 0, r, 1.0)
    M = np.concatenate([A_host / r[:, None], (b_host / r)[:, None]], axis=1)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(n):
            pivot = M[k, k]
            row_k = M[k] * (1.0 / pivot if abs(pivot) > 1e-300 else 0.0)
            factors = M[:, k].copy()
            factors[k] = 0.0
            M = fused_multiply_add(-factors[:, None], row_k[None, :], M)
            M[k] = row_k
    x = M[:, n]
    residual = np.linalg.norm(A_host @ x - b_host)
    ok = bool(np.isfinite(residual) and residual < 1e-8 * (1.0 + np.linalg.norm(b_host)))
    return torch.as_tensor(x, dtype=A.dtype, device=A.device), ok


def solve_symmetric(A: torch.Tensor, b: torch.Tensor):
    """Solve A x = b for symmetric A through the polished eigendecomposition,
    as tuna_tpu/ops/linalg.py::solve_symmetric does: eigenvalues below
    1e-14 of the largest |w| are dropped (a pseudo-inverse for near-singular
    systems).  Returns (x, ok), ok a bool tensor that certifies a small
    residual."""
    w, V = eigh(A)
    cutoff = 1e-14 * torch.clamp(torch.max(torch.abs(w)), min=1e-300)
    safe = torch.abs(w) > cutoff
    inv_w = torch.where(safe, 1.0 / torch.where(safe, w, 1.0), 0.0)
    x = V @ (inv_w * (V.T @ b))
    residual = torch.linalg.norm(A @ x - b)
    return x, residual < 1e-8 * (1.0 + torch.linalg.norm(b))


def expm_skew(K: torch.Tensor):
    """exp(K) for skew-symmetric K (orbital rotations), through the polished
    eigh of -K^2 as tuna_tpu/ops/linalg.py::expm_skew: -K^2 has eigenpairs
    (theta^2, V), and on each invariant plane exp(K) = cos(theta) + K
    sinc(theta)."""
    w, V = eigh(-K @ K)
    theta = torch.sqrt(torch.clamp(w, min=0.0))
    cos_term = (V * torch.cos(theta)) @ V.T
    safe = theta > 1e-12
    sinc = torch.where(safe, torch.sin(theta) / torch.where(safe, theta, 1.0), 1.0)
    return cos_term + K @ ((V * sinc) @ V.T)
