"""Perspective-n-Point with batched RANSAC, for relocalization.

Hundreds of hypotheses are scored at once: 4-point EPnP minimal sets
(`solvers/epnp.py`) by default, or 6-point DLT sets (`solver="dlt"`), each
hypothesis a slice of a leading batch dimension; the first hypothesis with
the most inliers is polished by Gauss-Newton on all its inliers.

The hypothesis sets come from `ransac`'s split sampler: `pnp_ransac` takes
either a `torch.Generator` or the (n_hyp, k) draws themselves, so a run can
score exactly the sets another run (or the reference package) scored.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import lie, linalg
from . import ransac
from .epnp import epnp


def pnp_dlt(Xw, xy_norm):
    """Direct linear transform pose from 6 <= k <= 32 3D-2D pairs (the 2k
    rows of its system at most `linalg.MAX_TALL_M`), batched over leading
    dimensions. Xw (…,k,3) world points; xy_norm (…,k,2)
    normalized image coordinates (K⁻¹x). Returns (R, t) with x ~ [R|t] X."""
    X = torch.cat([Xw, torch.ones_like(Xw[..., :1])], -1)       # (…,k,4)
    z = torch.zeros_like(X)
    u, v = xy_norm[..., 0:1], xy_norm[..., 1:2]
    r1 = torch.cat([X, z, -u * X], -1)
    r2 = torch.cat([z, X, -v * X], -1)
    A = torch.cat([r1, r2], -2)                               # (…,2k,12)
    _, _, vh = linalg.svd_small(A, full_matrices=True)
    P = vh[..., -1, :].reshape(*vh.shape[:-2], 3, 4)
    # scale: rows of R must be unit norm; orthogonalize through the SVD
    U, s, Vh = linalg.svd_small(P[..., :3].contiguous())
    scale = s.mean(-1)
    R = U @ Vh
    sgn = torch.sign(linalg.det_closed(R))
    R = R * sgn[..., None, None]
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None] * sgn[..., None]
    # cheirality: the majority of the points must be in front
    z_cam = (Xw @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    flip = torch.sign(z_cam).sum(-1) < 0
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    # −R has det −1 after the flip: take R back
    R = torch.where((linalg.det_closed(R) < 0)[..., None, None], -R, R)
    return R, t


def gn_refine_pose(R, t, Xw, xy_norm, w, iters: int = 10):
    """Gauss-Newton on SE3 (left-multiplicative update) minimizing the
    normalized reprojection error with per-point weights w."""
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        Xc = Xw @ R.T + t
        x, y, zc = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        zi = 1.0 / torch.clamp(zc, min=1e-6)
        pred = torch.stack([x * zi, y * zi], -1)
        r = (pred - xy_norm) * w[:, None]
        zi2 = zi * zi
        zero = torch.zeros_like(zi)
        Ju = torch.stack([zi, zero, -x * zi2], -1)
        Jv = torch.stack([zero, zi, -y * zi2], -1)
        Jp = torch.stack([Ju, Jv], 1)                       # (N,2,3)
        # d Xc / d xi = [I | -[Xc]x]
        Jx = torch.cat([eye3.expand(Xc.shape[0], 3, 3), -lie.hat(Xc)], -1)
        J = (Jp @ Jx) * w[:, None, None]                    # (N,2,6)
        Jf = J.reshape(-1, 6)
        rf = r.reshape(-1)
        H = Jf.T @ Jf + 1e-8 * eye6
        g = Jf.T @ rf
        dx = -linalg.solve_psd_small(H + 1e-9 * eye6, g)
        R, t = lie.se3_update_left(R, t, dx)
    return R, t


class PnPResult(NamedTuple):
    ok: torch.Tensor          # scalar bool
    R: torch.Tensor           # (3,3)
    t: torch.Tensor           # (3,)
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # scalar int32


def pnp_ransac(source, Xw, xy_norm, valid, chi2_per_point, n_hyp: int = 256,
               min_inliers: int = 10, refine_iters: int = 10,
               solver: str = "epnp", device=None) -> PnPResult:
    """RANSAC PnP on `device` (`cuda` unless given). `source` is a
    `torch.Generator` or the (n_hyp, k) int32 draws (k = 4 for EPnP, 6 for
    DLT). chi2_per_point: per-point gate on the squared normalized
    reprojection error (the reference scales it by the octave's σ²)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=dev).to(torch.float32)

    Xw, xy_norm, chi2 = f32(Xw), f32(xy_norm), f32(chi2_per_point)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    min_set = 4 if solver == "epnp" else 6
    idx, hyp_ok = ransac.sample_minimal_sets(source, valid, n_hyp, min_set)
    idx = idx.long()
    fit = epnp if solver == "epnp" else pnp_dlt
    Rs, ts = fit(Xw[idx], xy_norm[idx])                      # (H,3,3), (H,3)

    def inl_of(R, t):
        Xc = Xw @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp(Xc[..., 2], min=1e-6)
        pred = Xc[..., :2] / z[..., None]
        e2 = ((pred - xy_norm) ** 2).sum(-1)
        return (e2 < chi2) & valid & (Xc[..., 2] > 0)

    inl = inl_of(Rs, ts)                                     # (H,N)
    counts = inl.sum(-1, dtype=torch.int32)
    best, _ = ransac.best_hypothesis(counts.to(torch.float32), hyp_ok)
    R, t = gn_refine_pose(Rs[best], ts[best], Xw, xy_norm,
                          inl[best].to(Xw.dtype), iters=refine_iters)
    inliers = inl_of(R, t)
    n = inliers.sum(dtype=torch.int32)
    return PnPResult(n >= min_inliers, R, t, inliers, n)


def fetch_result(res: PnPResult) -> PnPResult:
    """The result with numpy fields, landed in ONE transfer."""
    flat = torch.cat([res.ok.reshape(1).to(torch.float32),
                      res.R.reshape(-1), res.t,
                      res.inliers.to(torch.float32),
                      res.n_inliers.reshape(1).to(torch.float32)])
    a = flat.cpu().numpy()
    return PnPResult(bool(a[0]), a[1:10].reshape(3, 3).copy(),
                     a[10:13].copy(), a[13:-1] > 0.5, int(a[-1]))
