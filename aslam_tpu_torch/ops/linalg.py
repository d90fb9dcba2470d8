"""Batched small symmetric-positive-definite solves.

Port of `aslam_tpu/ops/linalg.py::chol_solve`: an unrolled Cholesky-Crout
factorisation and triangular substitution for static n (3 or 6).  It clamps
the pivot at `_EPS` instead of failing, so padded or degenerate rows never
raise and never give NaN; callers mask those rows downstream.  The unrolled
form keeps the reference's operation order (and so its float32 results).
"""

from __future__ import annotations

import torch

_EPS = 1e-30


def _chol_lower(A: torch.Tensor):
    """Unrolled lower Cholesky of [..., n, n] SPD; returns row lists."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=_EPS))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    return L


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^{-1} b for batched SPD A [..., n, n], b [..., n]."""
    L = _chol_lower(A)
    n = A.shape[-1]
    y = [None] * n
    for i in range(n):                       # forward: L y = b
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):             # backward: L^T x = y
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
