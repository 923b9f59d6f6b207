"""Sim3 absolute orientation (Horn) with batched RANSAC, for loop closing.

The closed-form quaternion method on matched 3D point sets, with an
optional fixed scale (stereo / RGB-D), and bidirectional reprojection chi²
gating. The transform maps frame-2 points into frame 1: p1 ≈ s R p2 + t.

The hypothesis sets come from `ransac`'s split sampler: `sim3_ransac`
takes a `torch.Generator` or the (n_hyp, 3) draws themselves.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from . import ransac
from .epnp import finite_or, poison

CHI2_SIM3 = 9.210  # 99% 2-DoF, as the reference's Sim3Solver


def horn_sim3(p1, p2, w=None, fix_scale: bool = False):
    """Closed-form Sim3, batched over leading dimensions: p1, p2 (…,N,3),
    w (…,N). Returns (R (…,3,3), t (…,3), s (…,)) with p1 ≈ s R p2 + t."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    sw = torch.clamp(w.sum(-1), min=1e-9)
    c1 = (p1 * w[..., None]).sum(-2) / sw[..., None]
    c2 = (p2 * w[..., None]).sum(-2) / sw[..., None]
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = (q2 * w[..., None]).transpose(-1, -2) @ q1  # rows frame 2, cols 1
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    # Horn's symmetric 4x4 N: its top eigenvector is the rotation
    # quaternion taking frame 2 into frame 1
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    # eigh refuses non-finite input where the reference returns NaN
    N, ok = finite_or(N, 0.0)
    _, vecs = torch.linalg.eigh(N)                 # ascending
    R = poison(lie.quat_to_rot(vecs[..., :, -1]), ok)
    rot_q2 = q2 @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        # the reference's asymmetric scale
        num = (q1 * rot_q2 * w[..., None]).sum((-1, -2))
        den = torch.clamp((rot_q2 * rot_q2 * w[..., None]).sum((-1, -2)),
                          min=1e-12)
        s = num / den
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return R, t, s


class Sim3Result(NamedTuple):
    ok: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _proj(p, fx, fy, cx, cy):
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)


def sim3_ransac(source, p1_cam, p2_cam, valid, max_err1, max_err2,
                fx1: float, fy1: float, cx1: float, cy1: float,
                fx2: float, fy2: float, cx2: float, cy2: float,
                fix_scale: bool = False, n_hyp: int = 256,
                min_inliers: int = 20, device=None) -> Sim3Result:
    """RANSAC Horn between the camera-frame point sets of two keyframes,
    on `device` (`cuda` unless given). `source` is a `torch.Generator` or
    the (n_hyp, 3) int32 draws. max_err1/2: per-point squared-pixel gates
    (9.21·σ² of the octave). The least-squares refit on the winner's
    inliers is kept only if it loses no reprojection inliers."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=dev).to(torch.float32)

    p1_cam, p2_cam = f32(p1_cam), f32(p2_cam)
    max_err1, max_err2 = f32(max_err1), f32(max_err2)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    idx, hyp_ok = ransac.sample_minimal_sets(source, valid, n_hyp, 3)
    idx = idx.long()
    Rs, ts, ss = horn_sim3(p1_cam[idx], p2_cam[idx], fix_scale=fix_scale)
    uv1_obs = _proj(p1_cam, fx1, fy1, cx1, cy1)
    uv2_obs = _proj(p2_cam, fx2, fy2, cx2, cy2)

    def score(R, t, s):
        # p2 into cam1 by the Sim3, p1 into cam2 by its inverse; R (…,3,3)
        p2_in1 = (s[..., None, None] * (p2_cam @ R.transpose(-1, -2))
                  + t[..., None, :])
        Ri, ti, si = lie.sim3_inv(R, t, s)
        p1_in2 = (si[..., None, None] * (p1_cam @ Ri.transpose(-1, -2))
                  + ti[..., None, :])
        e1 = ((_proj(p2_in1, fx1, fy1, cx1, cy1) - uv1_obs) ** 2).sum(-1)
        e2 = ((_proj(p1_in2, fx2, fy2, cx2, cy2) - uv2_obs) ** 2).sum(-1)
        return (e1 < max_err1) & (e2 < max_err2) & valid

    inl = score(Rs, ts, ss)                                   # (H,N)
    counts = inl.sum(-1, dtype=torch.int32)
    best, _ = ransac.best_hypothesis(counts.to(torch.float32), hyp_ok)
    R1, t1, s1 = horn_sim3(p1_cam, p2_cam, inl[best].to(p1_cam.dtype),
                           fix_scale=fix_scale)
    inl1 = score(R1, t1, s1)
    n1 = inl1.sum(dtype=torch.int32)
    n0 = counts[best]
    take = n1 >= n0
    R = torch.where(take, R1, Rs[best])
    t = torch.where(take, t1, ts[best])
    s = torch.where(take, s1, ss[best])
    inliers = torch.where(take, inl1, inl[best])
    n = torch.maximum(n0, n1)
    return Sim3Result(n >= min_inliers, R, t, s, inliers, n)


def fetch_result(res: Sim3Result) -> Sim3Result:
    """The result with numpy fields, landed in ONE transfer."""
    flat = torch.cat([res.ok.reshape(1).to(torch.float32),
                      res.R.reshape(-1), res.t, res.s.reshape(1),
                      res.inliers.to(torch.float32),
                      res.n_inliers.reshape(1).to(torch.float32)])
    a = flat.cpu().numpy()
    return Sim3Result(bool(a[0]), a[1:10].reshape(3, 3).copy(),
                      a[10:13].copy(), float(a[13]), a[14:-1] > 0.5,
                      int(a[-1]))
