"""EPnP: Efficient Perspective-n-Point (Lepetit et al.), batched.

Four control points by PCA, barycentric coordinates, the 2n×12 M system,
the β cases N=1..3 (seeded by constrained least squares on L·b10 = ρ and
polished by Gauss-Newton on the six control-point distances), the pose of
each case by Procrustes, and the case with the least mean squared
reprojection error. Every function takes leading batch dimensions, so the
hypotheses of a RANSAC run are solved in one call.

The eigenvectors of `eigh` and the singular vectors of `svd` are defined up
to sign (and, inside a near-null cluster, up to rotation) and the libraries
choose differently; the β cases absorb a sign, so compare poses, never V or
the betas.
"""
from __future__ import annotations

import torch

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# (i, j), i <= j, in the order of the 10-vector b10 and of L's columns:
# [b11, b12, b13, b14, b22, b23, b24, b33, b34, b44]
_B10 = tuple((i, j) for i in range(4) for j in range(i, 4))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def finite_or(x, fill):
    """(x with every non-finite matrix of the batch replaced by `fill`, the
    mask of the finite ones). `eigh` and `svd` refuse non-finite input
    where the reference's return NaN; the caller puts the NaN back with
    `poison`, so a degenerate hypothesis still scores nothing."""
    ok = torch.isfinite(x).all(-1).all(-1)
    return torch.where(ok[..., None, None], x, fill), ok


def poison(x, ok):
    """x where ok, NaN elsewhere (ok over x's batch dimensions)."""
    while ok.dim() < x.dim():
        ok = ok[..., None]
    return torch.where(ok, x, torch.nan)


def _solve(A, b):
    """A x = b without a singularity check: a singular system gives a
    non-finite x, as the reference's solve does, and the hypothesis scores
    nothing."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _control_points(Xw):
    """PCA control points (…,4,3): centroid + principal axes scaled by
    their standard deviations."""
    c = Xw.mean(-2)
    Q = Xw - c[..., None, :]
    cov, ok = finite_or(Q.transpose(-1, -2) @ Q / Xw.shape[-2], _eye(3, Q))
    w, V = torch.linalg.eigh(cov)  # ascending
    V = poison(V, ok)
    s = torch.sqrt(torch.clamp(w, min=1e-12))
    return torch.stack([c, c + s[..., 2, None] * V[..., :, 2],
                        c + s[..., 1, None] * V[..., :, 1],
                        c + s[..., 0, None] * V[..., :, 0]], -2)


def _barycentric(Xw, cw):
    """alphas (…,n,4) with Xw = alphas @ cw."""
    B = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)  # (…,3,3)
    Binv = torch.linalg.inv_ex(B + 1e-12 * _eye(3, B))[0]
    a123 = (Xw - cw[..., :1, :]) @ Binv.transpose(-1, -2)
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return torch.cat([a0, a123], -1)


def _build_M(alphas, xy_norm):
    """(…,2n,12) system: per point, one row for u and one for v over the 4
    control points (normalized coordinates: fx = fy = 1, cx = cy = 0)."""
    one = torch.ones_like(xy_norm[..., :1])
    zero = torch.zeros_like(one)
    u, v = xy_norm[..., 0:1], xy_norm[..., 1:2]
    row_u = torch.cat([alphas[..., j:j + 1] * torch.cat([one, zero, -u], -1)
                       for j in range(4)], -1)
    row_v = torch.cat([alphas[..., j:j + 1] * torch.cat([zero, one, -v], -1)
                       for j in range(4)], -1)
    return torch.cat([row_u, row_v], -2)


def _rho(cw):
    """(…,6) squared distances between the control-point pairs."""
    return torch.stack([((cw[..., a, :] - cw[..., b, :]) ** 2).sum(-1)
                        for a, b in _PAIRS], -1)


def _L_matrix(V):
    """V (…,12,4): the four smallest eigenvectors. L (…,6,10) over b10."""
    vs = [V[..., :, k].reshape(*V.shape[:-2], 4, 3) for k in range(4)]
    rows = []
    for a, b in _PAIRS:
        dv = [v[..., a, :] - v[..., b, :] for v in vs]
        row = []
        for i, j in _B10:
            coef = (dv[i] * dv[j]).sum(-1)
            row.append(coef if i == j else 2.0 * coef)
        rows.append(torch.stack(row, -1))
    return torch.stack(rows, -2)


def _b10_quad(b):
    """β (…,4) → (…,10) products β_iβ_j (i ≤ j); the factor 2 of the cross
    terms lives in `_L_matrix`'s columns."""
    return torch.stack([b[..., i] * b[..., j] for i, j in _B10], -1)


def _b10_jac(b):
    """(…,10,4) Jacobian of `_b10_quad`."""
    zero = torch.zeros_like(b[..., 0])
    rows = []
    for i, j in _B10:
        rows.append(torch.stack([
            (b[..., j] if k == i else zero) + (b[..., i] if k == j else zero)
            for k in range(4)], -1))
    return torch.stack(rows, -2)


def _gn_betas(L, rho, betas, iters: int = 5):
    for _ in range(iters):
        J = L @ _b10_jac(betas)
        r = (L @ _b10_quad(betas)[..., None])[..., 0] - rho
        H = J.transpose(-1, -2) @ J + 1e-9 * _eye(4, J)
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        betas = betas - _solve(H, g)
    return betas


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _procrustes(pw, pc):
    """Rigid (R, t) with pc ≈ R pw + t (Horn / Kabsch)."""
    cw = pw.mean(-2)
    cc = pc.mean(-2)
    H = (pw - cw[..., None, :]).transpose(-1, -2) @ (pc - cc[..., None, :])
    H, ok = finite_or(H, _eye(3, H))
    U, _, Vh = torch.linalg.svd(H)
    U = poison(U, ok)
    V = Vh.transpose(-1, -2)
    d = _det3(V @ U.transpose(-1, -2))
    S = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], -1))
    R = V @ S @ U.transpose(-1, -2)
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def epnp(Xw, xy_norm, valid=None):
    """EPnP on k >= 4 correspondences, batched over leading dimensions.

    Xw (…,k,3) world points, xy_norm (…,k,2) normalized image coordinates;
    returns (R (…,3,3), t (…,3)) of the β case with the least mean squared
    reprojection error. Rows with `valid` False are replaced by the valid
    rows' centroids so they do not pull the fit."""
    if valid is not None:
        w = valid.to(Xw.dtype)[..., None]
        n = torch.clamp(w.sum(-2), min=1.0)
        cm = (Xw * w).sum(-2) / n
        um = (xy_norm * w).sum(-2) / n
        Xw = torch.where(w > 0, Xw, cm[..., None, :])
        xy_norm = torch.where(w > 0, xy_norm, um[..., None, :])
    cw = _control_points(Xw)
    alphas = _barycentric(Xw, cw)
    M = _build_M(alphas, xy_norm)
    MtM, ok = finite_or(M.transpose(-1, -2) @ M, _eye(12, M))
    _, vecs = torch.linalg.eigh(MtM)  # ascending: the first 4 are null-ish
    vecs = poison(vecs, ok)
    V = vecs[..., :, :4]
    L = _L_matrix(V)
    rho = _rho(cw)

    def lsq(cols):
        A = L[..., :, list(cols)]
        AtA = A.transpose(-1, -2) @ A + 1e-10 * _eye(len(cols), A)
        return _solve(AtA, (A.transpose(-1, -2) @ rho[..., None])[..., 0])

    def sqrt_abs(x):
        return torch.sqrt(x.abs())

    zero = torch.zeros_like(rho[..., 0])
    # N=1: columns b11, b12, b13, b14 → β1 = √b11, βk = b1k / β1
    b = lsq((0, 1, 2, 3))
    b1 = sqrt_abs(b[..., 0])
    den = torch.clamp(b1, min=1e-12)
    case1 = torch.stack([b1, b[..., 1] / den, b[..., 2] / den,
                         b[..., 3] / den], -1)
    # N=2: columns b11, b12, b22
    b = lsq((0, 1, 4))
    b1 = sqrt_abs(b[..., 0])
    b2 = sqrt_abs(b[..., 2]) * torch.sign(b[..., 1]) * torch.sign(b[..., 0])
    case2 = torch.stack([b1, b2, zero, zero], -1)
    # N=3: columns b11, b12, b22, b13, b23
    b = lsq((0, 1, 4, 2, 5))
    b1 = sqrt_abs(b[..., 0])
    b2 = sqrt_abs(b[..., 2]) * torch.sign(b[..., 1]) * torch.sign(b[..., 0])
    b3 = b[..., 3] / torch.clamp(b1, min=1e-12)
    case3 = torch.stack([b1, b2, b3, zero], -1)

    errs, Rs, ts = [], [], []
    for init in (case1, case2, case3):
        betas = _gn_betas(L, rho, init)
        ccam = (V @ betas[..., None])[..., 0].reshape(*betas.shape[:-1], 4, 3)
        pc = alphas @ ccam
        # cheirality: flip the whole solution if the depths come out negative
        sign = torch.where(pc[..., 2].mean(-1) < 0, -1.0, 1.0)
        pc = pc * sign[..., None, None]
        R, t = _procrustes(Xw, pc)
        Xc = Xw @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp(Xc[..., 2], min=1e-6)
        proj = Xc[..., :2] / z[..., None]
        errs.append(((proj - xy_norm) ** 2).sum(-1).mean(-1))
        Rs.append(R)
        ts.append(t)
    errs = torch.stack(errs, -1)
    # the first minimum, where a NaN counts as the least (the reference's
    # argmin propagates NaN): a hypothesis with a degenerate case keeps its
    # non-finite pose and scores nothing, in both packages
    key = torch.where(torch.isnan(errs), -torch.inf, errs)
    iota = torch.arange(3, device=errs.device)
    best = torch.where(key == key.amin(-1, keepdim=True), iota, 3).amin(-1)
    R = torch.stack(Rs, -3)
    t = torch.stack(ts, -2)
    R = torch.gather(R, -3, best[..., None, None, None].expand(
        *best.shape, 1, 3, 3)).squeeze(-3)
    t = torch.gather(t, -2, best[..., None, None].expand(
        *best.shape, 1, 3)).squeeze(-2)
    return R, t
