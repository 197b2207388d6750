"""Dense float64 linear algebra for the port.

Twin of tuna_tpu/ops/linalg.py without its polishing: the TPU has no f64
LAPACK, so tuna_tpu refines eigh and S^-1/2 with matmul iterations; the GPU
(cuSOLVER) and the CPU (LAPACK) factorise in native float64, so the port
calls torch.linalg.eigh directly and uses the library results as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def inverse_sqrt(S: torch.Tensor):
    """(X = S^-1/2, smallest eigenvalue of S, S^-1) from one eigh of SPD S."""
    w, V = torch.linalg.eigh(S)
    X = (V * (1.0 / torch.sqrt(w))) @ V.T
    X = 0.5 * (X + X.T)
    S_inverse = (V * (1.0 / w)) @ V.T
    return X, torch.min(w), 0.5 * (S_inverse + S_inverse.T)


def solve_linear_small(A: torch.Tensor, b: torch.Tensor):
    """Solve a small dense system (DIIS) by row-equilibrated Gauss-Jordan
    elimination without pivoting; returns (x on A's device, ok).

    The arithmetic of tuna_tpu/ops/linalg.py::solve_linear_small.  Late in
    a small-basis SCF the bordered DIIS system is close to singular, and
    another factorisation (LAPACK's pivoted LU) gives other coefficients
    there and so another number of iterations (8 instead of 6 for
    H2/6-31G B3LYP).  The system is at most (max DIIS + 1) square, so it
    is solved on the host in NumPy: one copy each way instead of some
    10 (n + 1) tiny device launches.  ok (a bool) is False when the
    residual is not small, the caller's signal to reset its DIIS history."""
    A_host = A.detach().cpu().numpy()
    b_host = b.detach().cpu().numpy()
    n = A_host.shape[0]
    r = np.max(np.abs(A_host), axis=1)
    r = np.where(r > 0, r, 1.0)
    M = np.concatenate([A_host / r[:, None], (b_host / r)[:, None]], axis=1)
    for k in range(n):
        pivot = M[k, k]
        row_k = M[k] * (1.0 / pivot if abs(pivot) > 1e-300 else 0.0)
        factors = M[:, k].copy()
        factors[k] = 0.0
        M = M - factors[:, None] * row_k[None, :]
        M[k] = row_k
    x = M[:, n]
    residual = np.linalg.norm(A_host @ x - b_host)
    ok = bool(np.isfinite(residual) and residual < 1e-8 * (1.0 + np.linalg.norm(b_host)))
    return torch.as_tensor(x, dtype=A.dtype, device=A.device), ok
