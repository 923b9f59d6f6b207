"""Small dense linear algebra.

The reference's `f32_matmul` scope has no counterpart here: the package
turns TF32 off for every matmul when it is imported (see `__init__.py`).
"""
from __future__ import annotations

import torch


def solve_psd_small(A, b, eps: float = 1e-12):
    """Solve A x = b for symmetric positive-(semi)definite A of small static
    size n, batched over leading dimensions: an unrolled Cholesky with the
    pivots clamped to `eps`, then two triangular solves. No pivoting, no
    host sync, and the same operation order as the reference."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
