"""Two-frame Sim3 refinement by bidirectional reprojection
(`Optimizer::OptimizeSim3`): given matched camera-frame points of two
keyframes, refine the relative Sim3 S12 to minimize the reprojection error
in BOTH images (Huber, chi² gate 10), with an outlier-removal round and a
re-optimization. The RANSAC Horn estimate that feeds it is too loose for a
loop correction: a scale error of a few percent smears around the loop.

The Jacobian over the 7-dim left tangent is `torch.func.jacfwd`; the
damped Gauss-Newton loop has a fixed length and accepts or rejects each
step with `torch.where`, so it never waits on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import lie, linalg
from ..core.robust import huber_rho, huber_weight

CHI2_SIM3 = 10.0


def _project(p, fx, fy, cx, cy):
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)


def optimize_sim3_two_frame(R, t, s, p1_cam, p2_cam, uv1, uv2, info1, info2,
                            valid, fx: float, fy: float, cx: float,
                            cy: float, fix_scale: bool = False,
                            iters: int = 10, device=None):
    """Refine the initial S12 (cam2 -> cam1) on `device` (`cuda` unless
    given). p1_cam, p2_cam (N,3); uv1, uv2 (N,2); info1, info2 (N,) 1/σ²;
    valid (N,). Returns (R, t, s, inliers, n_inliers)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=dev).to(torch.float32)

    # the scale rides as a (1,) tensor: forward-mode AD promotes the
    # tangent of a Python float times a 0-dim tensor to f64
    R, t, s = f32(R), f32(t), f32(s).reshape(1)
    p1_cam, p2_cam, uv1, uv2 = f32(p1_cam), f32(p2_cam), f32(uv1), f32(uv2)
    info1, info2 = f32(info1), f32(info2)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    dtype = R.dtype
    one = torch.ones(1, dtype=dtype, device=dev)
    eye7 = torch.eye(7, dtype=dtype, device=dev)

    def update(xi, R, t, s):
        dR, dt, ds = lie.sim3_exp(xi[None])
        R2, t2, s2 = lie.sim3_mul(dR, dt, ds, R[None], t[None], s)
        return R2[0], t2[0], one if fix_scale else s2

    def residuals_of(xi, R, t, s):
        R2, t2, s2 = update(xi, R, t, s)
        p2_in1 = s2 * (p2_cam @ R2.T) + t2
        Ri, ti, si = lie.sim3_inv(R2, t2, s2)
        p1_in2 = si * (p1_cam @ Ri.T) + ti
        return (uv1 - _project(p2_in1, fx, fy, cx, cy),
                uv2 - _project(p1_in2, fx, fy, cx, cy))

    zero = torch.zeros(7, dtype=dtype, device=dev)
    info = torch.cat([info1, info2], 0)

    def chi_of(e1, e2):
        return (torch.sum(e1 * e1, -1) * info1, torch.sum(e2 * e2, -1) * info2)

    def gn_round(R, t, s, active, n_steps):
        lam = torch.tensor(1e-5, dtype=dtype, device=dev)
        act = torch.cat([active, active], 0).to(dtype)
        for _ in range(n_steps):
            e1, e2 = residuals_of(zero, R, t, s)
            J = torch.func.jacfwd(
                lambda xi: torch.cat(residuals_of(xi, R, t, s), 0))(zero)
            e = torch.cat([e1, e2], 0)                       # (2N,2)
            chi2 = torch.sum(e * e, -1) * info
            w = huber_weight(chi2, CHI2_SIM3) * info * act
            Jf = J.reshape(-1, 7)
            wf = torch.repeat_interleave(w, 2)
            H = Jf.T @ (Jf * wf[:, None])
            g = Jf.T @ (e.reshape(-1) * wf)
            if fix_scale:
                H = H.clone()
                H[6, :] = 0.0
                H[:, 6] = 0.0
                H[6, 6] = 1.0
                g = torch.cat([g[:6], torch.zeros_like(g[6:])])
            dx = -linalg.solve_psd_small(H + lam * eye7, g)
            Rn, tn, sn = update(dx, R, t, s)
            c1n, c2n = chi_of(*residuals_of(zero, Rn, tn, sn))
            c1o, c2o = chi_of(e1, e2)
            cost1 = torch.where(active, huber_rho(c1n + c2n, CHI2_SIM3),
                                0.0).sum()
            cost0 = torch.where(active, huber_rho(c1o + c2o, CHI2_SIM3),
                                0.0).sum()
            ok = (cost1 < cost0) & torch.isfinite(cost1)
            R = torch.where(ok, Rn, R)
            t = torch.where(ok, tn, t)
            s = torch.where(ok, sn, s)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0),
                              1e-10, 1e8)
        return R, t, s

    def classify(R, t, s):
        c1, c2 = chi_of(*residuals_of(zero, R, t, s))
        return valid & (c1 < CHI2_SIM3) & (c2 < CHI2_SIM3)

    R, t, s = gn_round(R, t, s, valid, iters // 2)
    active = classify(R, t, s)
    R, t, s = gn_round(R, t, s, active, iters - iters // 2)
    inl = classify(R, t, s)
    return R, t, s[0], inl, inl.sum(dtype=torch.int32)
