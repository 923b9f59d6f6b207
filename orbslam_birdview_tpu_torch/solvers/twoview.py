"""Two-view geometry: homography / fundamental estimation, scoring, motion
recovery, triangulation.

Both models score hundreds of RANSAC hypotheses at once; every function is
batched over leading dimensions where the reference package maps over
hypotheses. Scoring formulas, chi-square gates and the model-select ratio
RH > 0.40 are ORB-SLAM2's `Initializer`.

H and F come out of SVD null vectors, which are defined up to sign (and
the library's last digits); everything downstream — scores, inlier masks,
the recovered motion — is invariant to that.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import linalg
from . import ransac

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991


def normalize_points(xy, valid):
    """Hartley normalization: zero-mean, unit mean abs deviation.
    Returns (xy_n, T 3x3)."""
    w = valid.to(xy.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (xy * w[:, None]).sum(0) / n
    d = (xy - mean) * w[:, None]
    mdev = d.abs().sum(0) / n
    s = 1.0 / torch.clamp(mdev, min=1e-8)
    xy_n = (xy - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one]),
    ])
    return xy_n, T


def _null_vector(A):
    """Last right singular vector of A (…,m,9), m < 9, as (…,3,3)."""
    _, _, vh = torch.linalg.svd(A, full_matrices=True)
    return vh[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def _dlt_homography(x1, x2):
    """4+ point DLT; x1,x2 (…,k,2) -> H (…,3,3) mapping x1→x2."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u)
    o = torch.ones_like(u)
    r1 = torch.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], dim=-1)
    r2 = torch.stack([u, v, o, z, z, z, -up * u, -up * v, -up], dim=-1)
    return _null_vector(torch.cat([r1, r2], dim=-2))   # A is (…,2k,9)


def _eightpoint_fundamental(x1, x2):
    """8-point algorithm with rank-2 projection; x1,x2 (…,k,2)."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, o], dim=-1)
    F = _null_vector(A)
    uF, sF, vFh = torch.linalg.svd(F)
    sF = torch.cat([sF[..., :2], torch.zeros_like(sF[..., :1])], dim=-1)
    return (uF * sF[..., None, :]) @ vFh


def _el(M, i, j):
    """Entry (i,j) of a batch of matrices, shaped to broadcast over N
    points: (…,) -> (…,1)."""
    return M[..., i, j][..., None]


def score_homography(H21, xy1, xy2, valid, sigma: float):
    """Symmetric transfer error scoring. H21 (…,3,3); returns
    (score (…,), inliers (…,N))."""
    inv_s2 = 1.0 / (sigma * sigma)
    # a singular hypothesis gives a non-finite inverse and scores nothing
    H12 = torch.linalg.inv_ex(H21).inverse

    def transfer(H, a, b):
        den = _el(H, 2, 0) * a[:, 0] + _el(H, 2, 1) * a[:, 1] + _el(H, 2, 2)
        den = torch.where(den.abs() > 1e-12, den, 1e-12)
        px = (_el(H, 0, 0) * a[:, 0] + _el(H, 0, 1) * a[:, 1]
              + _el(H, 0, 2)) / den
        py = (_el(H, 1, 0) * a[:, 0] + _el(H, 1, 1) * a[:, 1]
              + _el(H, 1, 2)) / den
        return ((b[:, 0] - px) ** 2 + (b[:, 1] - py) ** 2) * inv_s2

    chi2_1 = transfer(H21, xy1, xy2)
    chi2_2 = transfer(H12, xy2, xy1)
    ok = (chi2_1 < CHI2_H) & (chi2_2 < CHI2_H) & valid
    score = torch.sum(
        torch.where(valid & (chi2_1 < CHI2_H), CHI2_H - chi2_1, 0.0)
        + torch.where(valid & (chi2_2 < CHI2_H), CHI2_H - chi2_2, 0.0),
        dim=-1)
    return score, ok


def score_fundamental(F21, xy1, xy2, valid, sigma: float):
    """Epipolar point-line distance scoring. F21 (…,3,3)."""
    inv_s2 = 1.0 / (sigma * sigma)

    def line_dist2(F, a, b):
        # l = F [a;1]; dist of b to l
        la = _el(F, 0, 0) * a[:, 0] + _el(F, 0, 1) * a[:, 1] + _el(F, 0, 2)
        lb = _el(F, 1, 0) * a[:, 0] + _el(F, 1, 1) * a[:, 1] + _el(F, 1, 2)
        lc = _el(F, 2, 0) * a[:, 0] + _el(F, 2, 1) * a[:, 1] + _el(F, 2, 2)
        num = la * b[:, 0] + lb * b[:, 1] + lc
        den = torch.clamp(la * la + lb * lb, min=1e-12)
        return num * num / den * inv_s2

    chi2_1 = line_dist2(F21, xy1, xy2)
    chi2_2 = line_dist2(F21.transpose(-1, -2), xy2, xy1)
    ok = (chi2_1 < CHI2_F) & (chi2_2 < CHI2_F) & valid
    score = torch.sum(
        torch.where(valid & (chi2_1 < CHI2_F), SCORE_TH - chi2_1, 0.0)
        + torch.where(valid & (chi2_2 < CHI2_F), SCORE_TH - chi2_2, 0.0),
        dim=-1)
    return score, ok


class TwoViewFit(NamedTuple):
    model: torch.Tensor    # (3,3) H21 or F21
    score: torch.Tensor
    inliers: torch.Tensor  # (N,) bool


def _fit_inputs(device, xy1, xy2, valid):
    dev = resolve_device(device)
    return (torch.as_tensor(xy1, dtype=torch.float32, device=dev),
            torch.as_tensor(xy2, dtype=torch.float32, device=dev),
            torch.as_tensor(valid, dtype=torch.bool, device=dev))


def fit_homography_ransac(source, xy1, xy2, valid, sigma: float,
                          n_hyp: int = 256, device=None):
    """`source`: a `torch.Generator` or (n_hyp, 4) draws."""
    xy1, xy2, valid = _fit_inputs(device, xy1, xy2, valid)
    xy1n, T1 = normalize_points(xy1, valid)
    xy2n, T2 = normalize_points(xy2, valid)
    idx, hyp_ok = ransac.sample_minimal_sets(source, valid, n_hyp, 4)
    Hn = _dlt_homography(xy1n[idx], xy2n[idx])
    H = torch.linalg.inv_ex(T2).inverse @ Hn @ T1
    scores, inl = score_homography(H, xy1, xy2, valid, sigma)
    best, s = ransac.best_hypothesis(scores, hyp_ok)
    return TwoViewFit(H[best], s, inl[best])


def fit_fundamental_ransac(source, xy1, xy2, valid, sigma: float,
                           n_hyp: int = 256, device=None):
    """`source`: a `torch.Generator` or (n_hyp, 8) draws."""
    xy1, xy2, valid = _fit_inputs(device, xy1, xy2, valid)
    xy1n, T1 = normalize_points(xy1, valid)
    xy2n, T2 = normalize_points(xy2, valid)
    idx, hyp_ok = ransac.sample_minimal_sets(source, valid, n_hyp, 8)
    Fn = _eightpoint_fundamental(xy1n[idx], xy2n[idx])
    F = T2.T @ Fn @ T1
    scores, inl = score_fundamental(F, xy1, xy2, valid, sigma)
    best, s = ransac.best_hypothesis(scores, hyp_ok)
    return TwoViewFit(F[best], s, inl[best])


# ---------------------------------------------------------------------------
# Triangulation + cheirality
# ---------------------------------------------------------------------------

def triangulate_dlt(P1, P2, xy1, xy2):
    """Batched linear triangulation. P1,P2 (…,3,4); xy1,xy2 (…,N,2) ->
    (…,N,3), leading dimensions broadcast.

    HOMOGENEOUS DLT, with the null vector of A from inverse iteration on
    the equilibrated 4x4 normal matrix instead of a batched SVD. Two
    details are load-bearing:
    - ROW equilibration of A before forming AᵀA: it preserves the null
      space exactly (D A v = 0 iff A v = 0) and keeps cond(AᵀA) inside f32;
    - the inhomogeneous shortcut (fix w=1) is NOT equivalent: it biases
      low-parallax points."""
    def rows(P, xy):
        Pn = P[..., None, :, :]                    # (…,1,3,4) against N
        return (xy[..., 0:1] * Pn[..., 2, :] - Pn[..., 0, :],
                xy[..., 1:2] * Pn[..., 2, :] - Pn[..., 1, :])

    r1, r2 = rows(P1, xy1)
    r3, r4 = rows(P2, xy2)
    A = torch.stack(torch.broadcast_tensors(r1, r2, r3, r4), dim=-2)
    rn = torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True),
                     min=1e-30)
    A = A / rn
    B = torch.einsum("...ki,...kj->...ij", A, A)     # (…,N,4,4) PSD
    d = torch.sqrt(torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1),
                               min=1e-30))
    Bn = B / (d[..., :, None] * d[..., None, :])
    Bs = Bn + 1e-9 * torch.eye(4, dtype=B.dtype, device=B.device)
    v = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=B.dtype,
                     device=B.device).expand(d.shape)
    for _ in range(8):
        v = linalg.solve_psd_small(Bs, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    v = v / d                                        # unscale
    w = v[..., 3]
    w = torch.where(w.abs() > 1e-12, w, 1e-12)
    return v[..., :3] / w[..., None]


def check_rt(R, t, xy1, xy2, valid, K, sigma: float):
    """Count points passing cheirality/parallax/reprojection gates for
    candidate motions R (…,3,3), t (…,3).

    Returns (n_good (…,), parallax_deg (…,), points (…,N,3), good (…,N));
    parallax is the 50th-smallest good parallax (index min(50, n)-1 of the
    sorted parallaxes)."""
    dtype, dev = K.dtype, K.device
    P1 = K @ torch.cat([torch.eye(3, dtype=dtype, device=dev),
                        torch.zeros((3, 1), dtype=dtype, device=dev)], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    O2 = -torch.einsum("...ji,...j->...i", R, t)
    X = triangulate_dlt(P1, P2, xy1, xy2)
    finite = torch.isfinite(X).all(dim=-1)

    n1 = X                                     # camera 1 sits at the origin
    n2 = X - O2[..., None, :]
    d1 = torch.linalg.vector_norm(n1, dim=-1)
    d2 = torch.linalg.vector_norm(n2, dim=-1)
    cos_par = torch.sum(n1 * n2, dim=-1) / torch.clamp(d1 * d2, min=1e-12)

    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = Xc2[..., 2]
    # negative depth only rejects when the parallax is sufficient
    good_depth = (((z1 > 0) | (cos_par > 0.99998))
                  & ((z2 > 0) | (cos_par > 0.99998)))

    def reproj_err2(P, X, xy):
        Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
        ph = Xh @ P.transpose(-1, -2)           # (…,N,3)
        den = torch.where(ph[..., 2].abs() > 1e-12, ph[..., 2], 1e-12)
        return ((ph[..., 0] / den - xy[:, 0]) ** 2
                + (ph[..., 1] / den - xy[:, 1]) ** 2)

    th2 = 4.0 * sigma * sigma
    e1 = reproj_err2(P1, X, xy1)
    e2 = reproj_err2(P2, X, xy2)
    good = (valid & finite & good_depth & (e1 < th2) & (e2 < th2)
            & (cos_par < 0.99998))
    n_good = good.sum(dim=-1, dtype=torch.int32)

    par = torch.where(good, cos_par, -2.0)      # descending cos == asc angle
    par_sorted = torch.sort(par, dim=-1, descending=True).values
    idx50 = torch.clamp(torch.clamp(n_good, max=50) - 1, 0,
                        valid.shape[0] - 1)
    cos_sel = torch.gather(par_sorted, -1, idx50[..., None].long())[..., 0]
    parallax_deg = torch.rad2deg(torch.acos(torch.clamp(cos_sel, -1.0, 1.0)))
    parallax_deg = torch.where(n_good > 0, parallax_deg, 0.0)
    return n_good, parallax_deg, X, good


def decompose_essential(E):
    """E -> (R1, R2, t) with ||t||=1."""
    u, _, vh = torch.linalg.svd(E)
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vh
    R2 = u @ W.T @ vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    return R1, R2, t


def motion_hypotheses_from_F(F21, K):
    """The 4 (R,t) hypotheses from E = Kᵀ F K."""
    R1, R2, t = decompose_essential(K.T @ F21 @ K)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def motion_hypotheses_from_H(H21, K):
    """Faugeras SVD decomposition of a homography into 8 (R,t)
    hypotheses."""
    dtype, dev = H21.dtype, H21.device
    A = torch.linalg.inv_ex(K).inverse @ H21 @ K
    U, s, Vh = torch.linalg.svd(A)
    detUV = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = s[0], s[1], s[2]

    eps = 1e-9
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dtype, device=dev) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dtype, device=dev) * aux3
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dtype, device=dev)
    cross = torch.sqrt(torch.clamp(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def finish(Rp, tp):
        R = detUV * (U @ Rp @ Vh)
        t = U @ tp
        return R, t / torch.clamp(torch.linalg.vector_norm(t), min=eps)

    # case d' > 0
    den_p = torch.clamp((d1 + d3) * d2, min=eps)
    cos_t = (d2 * d2 + d1 * d3) / den_p
    stheta = signs * (cross / den_p)

    def make_Rt_pos(x1, x3, st):
        Rp = torch.stack([torch.stack([cos_t, zero, -st]),
                          torch.stack([zero, one, zero]),
                          torch.stack([st, zero, cos_t])])
        return finish(Rp, torch.stack([x1, zero, -x3]) * (d1 - d3))

    # case d' < 0
    den_n = torch.clamp((d1 - d3) * d2, min=eps)
    cos_p = (d1 * d3 - d2 * d2) / den_n
    sphi = signs * (cross / den_n)

    def make_Rt_neg(x1, x3, sp):
        Rp = torch.stack([torch.stack([cos_p, zero, sp]),
                          torch.stack([zero, -one, zero]),
                          torch.stack([sp, zero, -cos_p])])
        return finish(Rp, torch.stack([x1, zero, x3]) * (d1 + d3))

    hyps = [make_Rt_pos(x1s[i], x3s[i], stheta[i]) for i in range(4)]
    hyps += [make_Rt_neg(x1s[i], x3s[i], sphi[i]) for i in range(4)]
    return (torch.stack([h[0] for h in hyps]),
            torch.stack([h[1] for h in hyps]))


def select_motion(Rs, ts, xy1, xy2, inliers, K, sigma: float,
                  min_parallax: float = 1.0, min_triangulated: int = 50):
    """Score all motion hypotheses with check_rt; pick a clear winner, the
    first of equal counts. Returns (ok, R, t, points, good_mask)."""
    n_goods, pars, Xs, goods = check_rt(Rs, ts, xy1, xy2, inliers, K, sigma)
    best = ransac.first_argmax(n_goods)
    max_good = n_goods[best]
    # a high-scoring hypothesis only competes if geometrically distinct from
    # the winner (the birdview path injects an ICP hypothesis that may
    # coincide with the E-derived one)
    dR = Rs[best].T @ Rs                       # R_bestᵀ R_n
    tr = torch.diagonal(dR, dim1=-2, dim2=-1).sum(-1)
    ang = torch.acos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    distinct = ang > 0.01
    n_similar = ((n_goods > 0.7 * max_good) & distinct).sum() + 1
    n_inl = inliers.sum(dtype=torch.int32)
    min_good = torch.clamp((0.9 * n_inl).to(torch.int32),
                           min=min_triangulated)
    ok = ((max_good >= min_good) & (n_similar == 1)
          & (pars[best] > min_parallax))
    return ok, Rs[best], ts[best], Xs[best], goods[best]
