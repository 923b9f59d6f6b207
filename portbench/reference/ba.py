"""A local bundle adjustment, written plainly from its specification in
the precision it is handed.

The specification (ORB-SLAM2's LocalBundleAdjustment with the fork's BEV
edges, as the program defines it): keyframe poses (world -> camera) and
points move together to lower the sum of Huber-weighted χ² of the
reprojection edges (u, v; 5.991), the stereo edges (u, v, u - bf/z;
7.815) and the BEV point-to-point edges in the camera's frame (7.815).
Fixed or invalid keyframes and points that no valid edge sees stay put.
Levenberg-Marquardt: λ from 1e-4, halved after a step that lowers the
cost and quadrupled after one that does not (within 1e-9..1e8), each
diagonal entry damped by λ times itself (at least 1e-6); 5 iterations,
then every edge reclassified by its χ² (an edge behind its camera is out)
and 10 iterations more over the inliers. An edge behind its camera
(z ≤ 1e-6) costs 10 times its threshold. The points are eliminated
(Schur complement) and the keyframes' system solved dense.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import se3

CHI2 = {"mono": 5.991, "stereo": 7.815, "bird": 7.815}


class Problem(NamedTuple):
    R: torch.Tensor          # (C, 3, 3)
    t: torch.Tensor          # (C, 3)
    cam_free: torch.Tensor   # (C,) bool
    X: torch.Tensor          # (P, 3)
    pt_free: torch.Tensor    # (P,) bool
    edges: dict              # kind -> (cam, pt, obs, info, valid)
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float


class Solution(NamedTuple):
    R: torch.Tensor          # (C, 3, 3)
    t: torch.Tensor          # (C, 3)
    X: torch.Tensor          # (P, 3)
    edges: dict              # the second phase's edges: the inliers


def _terms(kind, R, t, X, es, p: Problem):
    """(residual, ∂/∂twist, ∂/∂point, χ², in front) of each edge."""
    cam, pt, obs, info, _ = es
    Rc = R[cam]
    Xc = se3.transform(Rc, t[cam], X[pt])
    n = len(cam)
    I = torch.eye(3, dtype=X.dtype, device=X.device).expand(n, 3, 3)
    dX = torch.cat([I, -se3.hat(Xc)], -1)                 # ∂Xc/∂twist
    if kind == "bird":
        r = obs - Xc
        front = torch.ones(n, dtype=torch.bool, device=X.device)
        Jp = I
    else:
        x, y, z = Xc.unbind(-1)
        front = z > 1e-6
        iz = 1 / z.clamp(min=1e-9)
        u = p.fx * x * iz + p.cx
        rows = [u, p.fy * y * iz + p.cy]
        Jp = torch.zeros(n, 3 if kind == "stereo" else 2, 3, dtype=X.dtype,
                         device=X.device)
        Jp[:, 0, 0], Jp[:, 0, 2] = p.fx * iz, -p.fx * x * iz * iz
        Jp[:, 1, 1], Jp[:, 1, 2] = p.fy * iz, -p.fy * y * iz * iz
        if kind == "stereo":
            rows.append(u - p.bf * iz)
            Jp[:, 2, 0] = p.fx * iz
            Jp[:, 2, 2] = -p.fx * x * iz * iz + p.bf * iz * iz
        r = obs - torch.stack(rows, -1)
    chi2 = (r * r).sum(-1) * info
    return r, -(Jp @ dX), -(Jp @ Rc), chi2, front


def _huber(chi2, th, valid, front):
    """(IRLS weight, cost) of the edges."""
    w = torch.where(chi2 <= th, 1.0, math.sqrt(th) / chi2.clamp(min=1e-12)
                    .sqrt())
    rho = torch.where(chi2 <= th, chi2,
                      2 * math.sqrt(th) * chi2.clamp(min=0).sqrt() - th)
    cost = (torch.where(valid & front, rho, 0).sum()
            + 10 * th * (valid & ~front).sum())
    return w * (valid & front), cost


def huber_cost(R, t, X, edges, p):
    """The Huber cost of the state over the valid edges."""
    total = 0.0
    for kind, es in edges.items():
        _, _, _, chi2, front = _terms(kind, R, t, X, es, p)
        total = total + _huber(chi2, CHI2[kind], es[4], front)[1]
    return total


def _damped(H, lam):
    d = torch.diagonal(H, dim1=-2, dim2=-1).clamp(min=1e-6)
    return H + torch.diag_embed(lam * d)


def _step(R, t, X, edges, p: Problem, lam):
    C, P = len(R), len(X)
    dt = X.dtype
    Hcc = torch.zeros(C, 6, 6, dtype=dt, device=X.device)
    bc = torch.zeros(C, 6, dtype=dt, device=X.device)
    Hpp = torch.zeros(P, 3, 3, dtype=dt, device=X.device)
    bp = torch.zeros(P, 3, dtype=dt, device=X.device)
    Wcp = torch.zeros(C, P, 6, 3, dtype=dt, device=X.device)
    cost = 0.0
    for kind, es in edges.items():
        cam, pt, _, info, valid = es
        r, Jc, Jx, chi2, front = _terms(kind, R, t, X, es, p)
        w, c = _huber(chi2, CHI2[kind], valid, front)
        cost = cost + c
        w = (w * info)[:, None, None]
        JcT, JxT = Jc.transpose(1, 2), Jx.transpose(1, 2)
        Hcc.index_add_(0, cam, JcT @ (w * Jc))
        bc.index_add_(0, cam, (JcT @ (w * r[..., None]))[..., 0])
        Hpp.index_add_(0, pt, JxT @ (w * Jx))
        bp.index_add_(0, pt, (JxT @ (w * r[..., None]))[..., 0])
        Wcp.index_put_((cam, pt), JcT @ (w * Jx), accumulate=True)
    Hcc, Hpp = _damped(Hcc, lam), _damped(Hpp, lam)
    eye3 = torch.eye(3, dtype=dt, device=X.device)
    Hpp = torch.where(p.pt_free[:, None, None], Hpp, eye3)
    bp = torch.where(p.pt_free[:, None], bp, 0.0)
    Wcp = Wcp * p.pt_free[None, :, None, None]
    Hinv = torch.linalg.inv(Hpp)
    Wm = Wcp.permute(0, 2, 1, 3).reshape(6 * C, 3 * P)
    Y = (Wcp @ Hinv[None]).permute(0, 2, 1, 3).reshape(6 * C, 3 * P)
    S = torch.block_diag(*Hcc) - Y @ Wm.T
    rhs = bc.reshape(-1) - Y @ bp.reshape(-1)
    free = p.cam_free.repeat_interleave(6)
    S = torch.where(free[:, None] & free[None, :], S, 0.0)
    S = S + torch.diag((~free).to(dt))
    dc = -torch.linalg.solve(S, torch.where(free, rhs, 0.0))
    dx = -(Hinv @ (bp + (Wm.T @ dc).reshape(P, 3))[..., None])[..., 0]
    dx = torch.where(p.pt_free[:, None], dx, 0.0)
    return dc.reshape(C, 6), dx, cost


def _run(R, t, X, edges, p, iters):
    lam = 1e-4
    for _ in range(iters):
        dc, dx, c0 = _step(R, t, X, edges, p, lam)
        Rn, tn = se3.update(R, t, dc)
        Xn = X + dx
        c1 = huber_cost(Rn, tn, Xn, edges, p)
        ok = (bool(torch.isfinite(dc).all()) and bool(torch.isfinite(dx).all())
              and bool(torch.isfinite(c1)) and bool(c1 < c0))
        if ok:
            R, t, X = Rn, tn, Xn
        lam = min(max(lam * 0.5 if ok else lam * 4.0, 1e-9), 1e8)
    return R, t, X


def solve(p: Problem, iters=(5, 10)) -> Solution:
    """The adjusted problem's state, with the edges its second phase
    kept."""
    R, t, X = _run(p.R, p.t, p.X, p.edges, p, iters[0])
    inl = {}
    for kind, es in p.edges.items():
        _, _, _, chi2, front = _terms(kind, R, t, X, es, p)
        inl[kind] = es[:4] + (es[4] & front & (chi2 <= CHI2[kind]),)
    return Solution(*_run(R, t, X, inl, p, iters[1]), inl)
