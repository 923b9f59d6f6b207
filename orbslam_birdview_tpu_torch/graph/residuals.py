"""Residuals and closed-form Jacobians of the pose-tracking edges.

Conventions as in the reference: the camera pose is Tcw (world→camera) with
a LEFT-multiplicative SE3 tangent [rho, phi]; residual e = observation −
prediction; Jacobians are ∂e/∂ξ (camera) and ∂e/∂X (landmark). The
relative-pose edges return residuals only: the pose graph takes their
Jacobians by autodiff.
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


def point_transform(R12, t12, pc2, pc1_obs):
    """Frame-to-frame point transfer: e = pc1_obs − T12 · pc2, Jacobian
    wrt T12."""
    p1 = _rot(R12, pc2) + t12
    Jxi_xc, _ = _xc_jacs(p1, R12)
    return pc1_obs - p1, -Jxi_xc


def se3_relative(Ri, ti, Rj, tj, Rij_meas, tij_meas):
    """SE3 relative-pose edge: e = log(T_meas⁻¹ · Ti · Tj⁻¹)."""
    Rm_inv, tm_inv = lie.se3_inv(Rij_meas, tij_meas)
    Rj_inv, tj_inv = lie.se3_inv(Rj, tj)
    R1, t1 = lie.se3_mul(Ri, ti, Rj_inv, tj_inv)
    R2, t2 = lie.se3_mul(Rm_inv, tm_inv, R1, t1)
    return lie.se3_log(R2, t2)


def sim3_relative(Ri, ti, si, Rj, tj, sj, Rij, tij, sij):
    """Sim3 relative-pose edge of the essential graph:
    e = log(S_ji_meas · S_iw · S_jw⁻¹), zero when S_jw = S_ji · S_iw (the
    measurement maps frame i into frame j)."""
    Rj_inv, tj_inv, sj_inv = lie.sim3_inv(Rj, tj, sj)
    R1, t1, s1 = lie.sim3_mul(Ri, ti, si, Rj_inv, tj_inv, sj_inv)
    R2, t2, s2 = lie.sim3_mul(Rij, tij, sij, R1, t1, s1)
    return lie.sim3_log(R2, t2, s2)
