"""Rigid motions as (R, t) pairs of world -> camera maps."""
from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp(xi: torch.Tensor):
    """exp of the twists (…, 6) = [translation part, rotation part]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = (phi * phi).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th2 / 6, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(safe)) / safe ** 2)
    c = torch.where(small, 1 / 6 - th2 / 120,
                    (safe - torch.sin(safe)) / safe ** 3)
    W = hat(phi)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = I + a * W + b * (W @ W)
    V = I + b * W + c * (W @ W)
    return R, (V @ rho[..., None])[..., 0]


def update(R, t, xi):
    """exp(xi) · (R, t): the step applied on the world side's left."""
    dR, dt = exp(xi)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt


def transform(R, t, X):
    """R X + t for points X (…, 3) under one pose or one pose each."""
    if R.dim() == 2:
        return X @ R.T + t
    return (R @ X[..., None])[..., 0] + t


def pose_gap(Ra, ta, Rb, tb) -> tuple[float, float]:
    """(camera centres apart in metres, rotation apart in degrees)."""
    Ra, ta, Rb, tb = (torch.as_tensor(x).to(torch.float64).cpu()
                      for x in (Ra, ta, Rb, tb))
    ca, cb = -Ra.T @ ta, -Rb.T @ tb
    D = Ra @ Rb.T
    w = torch.stack([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    deg = float(torch.rad2deg(torch.atan2(torch.linalg.vector_norm(w) / 2,
                                          (torch.trace(D) - 1) / 2)))
    m = float(torch.linalg.vector_norm(ca - cb))
    return m, deg
