"""Robust losses for iteratively-reweighted least squares.

Huber with delta² = 5.991 for 2-DoF residuals and 7.815 for 3-DoF, as in
the reference's g2o kernels, expressed as IRLS weights w(r) = rho'(r²).
"""
from __future__ import annotations

import functools

import torch

# chi-square 95% quantiles used throughout the reference
CHI2_2DOF = 5.991
CHI2_3DOF = 7.815


@functools.lru_cache(maxsize=None)
def _sqrt_in(v: float, dtype: torch.dtype) -> float:
    """sqrt of a Python threshold taken in the tensor's precision, as the
    reference does (a double sqrt rounded to f32 can differ by one ulp)."""
    return float(torch.sqrt(torch.tensor(v, dtype=dtype)))


def huber_weight(chi2, delta2):
    """IRLS weight for Huber on squared error: 1 if chi2<=delta2 else
    delta/sqrt(chi2)."""
    safe = torch.sqrt(torch.clamp(chi2, min=1e-12))
    delta = _sqrt_in(delta2, chi2.dtype)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), delta / safe)


def huber_rho(chi2, delta2):
    """Huber robust cost of a squared error."""
    delta = _sqrt_in(delta2, chi2.dtype)
    r = torch.sqrt(torch.clamp(chi2, min=0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * delta * r - delta2)


def cauchy_weight(chi2, delta2):
    return 1.0 / (1.0 + chi2 / delta2)
