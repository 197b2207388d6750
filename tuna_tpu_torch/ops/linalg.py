"""Dense float64 linear algebra for the port.

Twin of tuna_tpu/ops/linalg.py without its polishing: the TPU has no f64
LAPACK, so tuna_tpu refines eigh and S^-1/2 with matmul iterations; the GPU
(cuSOLVER) and the CPU (LAPACK) factorise in native float64, so the port
calls torch.linalg.eigh directly and uses the library results as they are.
"""

from __future__ import annotations

import torch


def inverse_sqrt(S: torch.Tensor):
    """(X = S^-1/2, smallest eigenvalue of S, S^-1) from one eigh of SPD S."""
    w, V = torch.linalg.eigh(S)
    X = (V * (1.0 / torch.sqrt(w))) @ V.T
    X = 0.5 * (X + X.T)
    S_inverse = (V * (1.0 / w)) @ V.T
    return X, torch.min(w), 0.5 * (S_inverse + S_inverse.T)


def solve_linear_small(A: torch.Tensor, b: torch.Tensor):
    """Solve a small dense system (DIIS); returns (x, ok).

    ok is False when the factorisation fails or the residual is not small,
    the caller's signal to reset its DIIS history."""
    x, info = torch.linalg.solve_ex(A, b)
    residual = torch.linalg.norm(A @ x - b)
    ok = ((info == 0) & torch.isfinite(residual)
          & (residual < 1e-8 * (1.0 + torch.linalg.norm(b))))
    return x, ok
