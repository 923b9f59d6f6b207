"""Residuals and closed-form Jacobians of the pose-tracking edges.

Conventions as in the reference: the camera pose is Tcw (world→camera) with
a LEFT-multiplicative SE3 tangent [rho, phi]; residual e = observation −
prediction; Jacobians are ∂e/∂ξ (camera) and ∂e/∂X (landmark). The
point-transfer, relative-pose and Sim3 edges follow with the slices that
use them.
"""
from __future__ import annotations

import torch

from ..core import lie


def _rot(R, X):
    """R·X as a broadcast multiply-reduce, the reference's exact-f32 form."""
    return torch.sum(R * X[..., None, :], dim=-1)


def _mm_small(A, B):
    """Batched (…,m,k)@(…,k,n) for tiny m,k,n via broadcast-reduce."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _proj_jac(Xc, fx, fy):
    """∂(u,v)/∂Xc for pinhole projection. Xc (…,3) -> (…,2,3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-9)
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    Ju = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    Jv = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    return torch.stack([Ju, Jv], dim=-2)


def _xc_jacs(Xc, R):
    """∂Xc/∂ξ = [I | −[Xc]×] (left-mult tangent) and ∂Xc/∂Xw = R."""
    I = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    return torch.cat([I, -lie.hat(Xc)], dim=-1), R


def mono_reproj(R, t, Xw, obs_uv, fx, fy, cx, cy):
    """Monocular reprojection edge.
    Returns (e (…,2), J_xi (…,2,6), J_X (…,2,3), depth_ok (…,))."""
    Xc = _rot(R, Xw) + t
    z = Xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-9)
    pred = torch.stack([fx * Xc[..., 0] * zi + cx, fy * Xc[..., 1] * zi + cy],
                       dim=-1)
    e = obs_uv - pred
    Jp = _proj_jac(Xc, fx, fy)
    Jxi_xc, _ = _xc_jacs(Xc, R)
    return e, -_mm_small(Jp, Jxi_xc), -_mm_small(Jp, R), z > 1e-6


def mono_reproj_cost(R, t, Xw, obs_uv, info, fx, fy, cx, cy):
    """Residual + chi² only (no Jacobians)."""
    Xc = _rot(R, Xw) + t
    z = Xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-9)
    pred = torch.stack([fx * Xc[..., 0] * zi + cx, fy * Xc[..., 1] * zi + cy],
                       dim=-1)
    e = obs_uv - pred
    return e, torch.sum(e * e, dim=-1) * info, z > 1e-6


def stereo_reproj(R, t, Xw, obs_uvr, fx, fy, cx, cy, bf):
    """Stereo edge: residual (u, v, u_right) with u_r = u − bf/z."""
    Xc = _rot(R, Xw) + t
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-9)
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    pred = torch.stack([u, v, u - bf * zi], dim=-1)
    e = obs_uvr - pred
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    Ju = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    Jv = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    Jur = torch.stack([fx * zi, zero, -fx * x * zi2 + bf * zi2], dim=-1)
    Jp = torch.stack([Ju, Jv, Jur], dim=-2)  # (…,3,3)
    Jxi_xc, _ = _xc_jacs(Xc, R)
    return e, -_mm_small(Jp, Jxi_xc), -_mm_small(Jp, R), z > 1e-6


def stereo_reproj_cost(R, t, Xw, obs_uvr, info, fx, fy, cx, cy, bf):
    """Residual + chi² only (no Jacobians) of the stereo edge."""
    Xc = _rot(R, Xw) + t
    z = Xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-9)
    u = fx * Xc[..., 0] * zi + cx
    v = fy * Xc[..., 1] * zi + cy
    e = obs_uvr - torch.stack([u, v, u - bf * zi], dim=-1)
    return e, torch.sum(e * e, dim=-1) * info, z > 1e-6


def bird_point(R, t, Xw, obs_pc):
    """BEV 3D point-to-point edge: e = pc_obs − (R Xw + t), camera frame."""
    Xc = _rot(R, Xw) + t
    e = obs_pc - Xc
    Jxi_xc, _ = _xc_jacs(Xc, R)
    return e, -Jxi_xc, -R.expand(Xc.shape[:-1] + (3, 3))
