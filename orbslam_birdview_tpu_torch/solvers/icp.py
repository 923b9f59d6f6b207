"""Point-set registration (Kabsch/Umeyama) in 2D and 3D with batched RANSAC.

3D registration via centroid + cross-covariance SVD with a det guard (chi²
gate 7.815), and the 2D ground-plane variant used by the birdview metric
initializer (chi² 5.991, minimal set 2). All hypotheses run as one leading
batch dimension.

Transforms map set-2 points onto set-1: p1 ≈ R @ p2 + t.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import linalg
from . import ransac

CHI2_2D = 5.991
CHI2_3D = 7.815


def kabsch(p1, p2, w=None):
    """Weighted LSQ rigid transform (R, t) with p1 ≈ R p2 + t.
    p1, p2 (…,N,D); w (…,N) weights. D in {2,3}."""
    D = p1.shape[-1]
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    sw = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c1 = (p1 * w[..., None]).sum(-2) / sw
    c2 = (p2 * w[..., None]).sum(-2) / sw
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    H = (q2 * w[..., None]).transpose(-1, -2) @ q1   # Σ w · q2 q1ᵀ
    U, _, Vh = linalg.svd_small(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = linalg.det_small(V @ Ut)
    # S = diag(1, …, 1, d): scaling V's last column keeps R a rotation
    # whichever signs the SVD chose
    S = torch.ones(H.shape[:-1], dtype=p1.dtype, device=p1.device)
    S = torch.cat([S[..., :D - 1], d[..., None]], dim=-1)
    R = (V * S[..., None, :]) @ Ut
    t = c1 - torch.einsum("...ij,...j->...i", R, c2)
    return R, t


def _residual_chi2(R, t, p1, p2, sigma2):
    """R (…,D,D), t (…,D) against all N pairs -> (…,N)."""
    r = p1 - (p2 @ R.transpose(-1, -2) + t[..., None, :])
    return torch.sum(r * r, dim=-1) / sigma2


class IcpResult(NamedTuple):
    ok: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _icp_ransac(source, p1, p2, valid, sigma, chi2_th, min_set, n_hyp,
                min_inliers):
    sigma2 = sigma * sigma
    idx, hyp_ok = ransac.sample_minimal_sets(source, valid, n_hyp, min_set)
    Rs, ts = kabsch(p1[idx], p2[idx])
    chi2 = _residual_chi2(Rs, ts, p1, p2, sigma2)
    inl = (chi2 < chi2_th) & valid[None, :]
    counts = inl.sum(dim=1, dtype=torch.int32)
    best, _ = ransac.best_hypothesis(counts.to(torch.float32), hyp_ok)
    # refine on the best hypothesis' inliers
    R, t = kabsch(p1, p2, inl[best].to(p1.dtype))
    inliers = (_residual_chi2(R, t, p1, p2, sigma2) < chi2_th) & valid
    n = inliers.sum(dtype=torch.int32)
    return IcpResult(n >= min_inliers, R, t, inliers, n)


def _on_device(device, *xs):
    dev = resolve_device(device)
    return [torch.as_tensor(x, device=dev) for x in xs]


def icp2d_ransac(source, p1, p2, valid, sigma: float, n_hyp: int = 256,
                 min_inliers: int = 10, device=None):
    """2D ground-plane registration. `source`: generator or (n_hyp, 2)
    draws."""
    p1, p2, valid = _on_device(device, p1, p2, valid)
    return _icp_ransac(source, p1, p2, valid, sigma, CHI2_2D, 2, n_hyp,
                       min_inliers)


def icp3d_ransac(source, p1, p2, valid, sigma: float, n_hyp: int = 256,
                 min_inliers: int = 10, device=None):
    """3D registration. `source`: generator or (n_hyp, 3) draws."""
    p1, p2, valid = _on_device(device, p1, p2, valid)
    return _icp_ransac(source, p1, p2, valid, sigma, CHI2_3D, 3, n_hyp,
                       min_inliers)


def rt2d_to_se3(R2, t2):
    """Lift a 2D ground-plane (R,t) into an SE3 acting on (x,y,z): rotation
    about +z, zero z-translation."""
    R = torch.eye(3, dtype=R2.dtype, device=R2.device)
    R[:2, :2] = R2
    return R, torch.cat([t2, torch.zeros(1, dtype=t2.dtype, device=t2.device)])
