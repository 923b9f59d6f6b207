"""Fixed-shape (padded + masked) ops shared by the tracking and mapping
stages: projection, the frustum test of the local-map candidates, the
projection and frame-to-frame matchers, and the two mapping ops of a
keyframe — epipolar triangulation against its neighbours (batched over
the neighbour axis) and the bidirectional fuse projection (row by row) —
each over all neighbours in one call, with the accepted candidates
compacted on the device before they are fetched.
"""
from __future__ import annotations

import torch

from ..core import lie
from ..frontend import matcher
from ..frontend.keypoints import unpack_bits_to_pm1
from ..solvers.twoview import triangulate_dlt

TRI_COMPACT_CAP = 2048   # max accepted triangulations shipped per keyframe
FUSE_COMPACT_CAP = 6144  # max fuse matches shipped per keyframe


def project_points(R, t, pos, fx, fy, cx, cy, width, height):
    """World points -> (uv, depth, in_front_and_in_image)."""
    Xc = pos @ R.T + t
    z = Xc[:, 2]
    zi = 1.0 / torch.where(z.abs() > 1e-9, z, 1e-9)
    u = fx * Xc[:, 0] * zi + cx
    v = fy * Xc[:, 1] * zi + cy
    uv = torch.stack([u, v], -1)
    ok = (z > 0.05) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return uv, z, ok


def frustum_gate(R, t, pos, normal, min_dist, max_dist, valid,
                 fx, fy, cx, cy, width, height, n_levels, log_scale):
    """Full `Frame::isInFrustum`: image bounds, scale band, viewing angle;
    predicts the octave and the search-radius factor."""
    uv, z, in_img = project_points(R, t, pos, fx, fy, cx, cy, width, height)
    center = -R.T @ t
    po = pos - center[None]
    dist = torch.linalg.vector_norm(po, dim=-1)
    band = (dist >= min_dist * 0.8) & (dist <= max_dist * 1.2)
    view_cos = torch.sum(po * normal, -1) / torch.clamp(dist, min=1e-9)
    angle_ok = view_cos > 0.5
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred_octave = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
        .to(torch.int32), 0, n_levels - 1)
    radius_factor = torch.where(view_cos > 0.998, 2.5, 4.0)
    ok = in_img & band & angle_ok & valid
    return uv, pred_octave, radius_factor, ok


def match_projected(proj_uv, pt_ok, pt_desc_u8, kp_xy, kp_octave, kp_valid,
                    kp_desc_pm1, radius, pred_octave,
                    max_dist_th: int = matcher.TH_HIGH):
    """Projected map points against frame keypoints, duplicates resolved."""
    idx, dist = matcher.search_by_projection(
        proj_uv, pt_ok, unpack_bits_to_pm1(pt_desc_u8), kp_xy, kp_octave,
        kp_valid, kp_desc_pm1, radius, pred_octave, max_dist=max_dist_th)
    # the table is sized by the source count alone, as the reference's
    return matcher.resolve_duplicate_targets(idx, dist), dist


def match_frames_window(xy_a, desc_a_pm1, valid_a, xy_b, desc_b_pm1, valid_b,
                        radius):
    """Mutual-best windowed match of frame a's keypoints into frame b's."""
    dist = matcher.hamming_matrix(desc_a_pm1, desc_b_pm1, valid_a, valid_b)
    return matcher.match_window(xy_a, xy_b, dist, radius,
                                max_dist=matcher.TH_LOW, ratio=0.9)


def match_frames_window_rot(xy_a, ang_a, desc_a_pm1, valid_a,
                            xy_b, ang_b, desc_b_pm1, valid_b, radius):
    """`match_frames_window` with the rotation-histogram consistency check
    (matches outside the 3 fullest of 30 angle-difference bins go)."""
    idx, d = match_frames_window(xy_a, desc_a_pm1, valid_a, xy_b,
                                 desc_b_pm1, valid_b, radius)
    m = idx >= 0
    keep = matcher.rotation_consistency_mask(
        ang_a, ang_b, torch.where(m, idx, 0).long(), m)
    return torch.where(keep, idx, -1), d


def epipolar_triangulate(R1, t1, R2, t2, K, kp1_xy, kp1_octave, kp1_free,
                         desc1_pm1, kp2_xy, kp2_octave, kp2_free, desc2_pm1,
                         level_sigma2):
    """`LocalMapping::CreateNewMapPoints` against one neighbour as one
    dense masked op: match the unassociated keypoints of KF1 against KF2
    under the epipolar constraint, triangulate, and apply the acceptance
    gates (cheirality, parallax, reprojection, scale consistency).
    KF2's arguments may carry leading batch dimensions (…), one entry per
    neighbour. Returns (idx2 (…,K1), points (…,K1,3), ok (…,K1))."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def rot(X, R, t):      # X (…,n,3) in the frame of (R (…,3,3), t (…,3))
        return X @ R.mT + t[..., None, :]

    # fundamental from the relative pose: F12 = K⁻ᵀ [t]x R K⁻¹, T12 = T1 T2⁻¹
    R12 = R1 @ R2.mT
    t12 = t1 - (R12 @ t2[..., None])[..., 0]
    E = lie.hat(t12) @ R12
    Kinv = torch.linalg.inv_ex(K)[0]
    F12 = Kinv.T @ E @ Kinv

    dist = matcher.hamming_matrix(desc1_pm1, desc2_pm1, kp1_free, kp2_free)
    # epipolar distance of kp2 to the line F12ᵀ x1
    x1h = torch.cat([kp1_xy, torch.ones_like(kp1_xy[:, :1])], -1)
    lines = x1h @ F12  # (…,K1,3): line in image 2
    num = (lines[..., :, None, 0] * kp2_xy[..., None, :, 0]
           + lines[..., :, None, 1] * kp2_xy[..., None, :, 1]
           + lines[..., :, None, 2])
    den = torch.clamp(lines[..., 0] ** 2 + lines[..., 1] ** 2,
                      min=1e-12)[..., None]
    d2 = num * num / den
    sig2_2 = level_sigma2[kp2_octave.long()]
    dist = torch.where(d2 < 3.84 * sig2_2[..., None, :], dist,
                       matcher.BIG_DIST)
    idx2, _ = matcher.match_mutual(dist, max_dist=matcher.TH_LOW, ratio=0.9)
    m = idx2 >= 0
    i2 = torch.where(m, idx2, 0).long()

    P1 = K @ torch.cat([R1, t1[:, None]], 1)
    P2 = K @ torch.cat([R2, t2[..., None]], -1)
    xy2 = torch.take_along_dim(kp2_xy, i2[..., None], dim=-2)
    X = triangulate_dlt(P1, P2, kp1_xy, xy2)
    finite = torch.isfinite(X).all(-1)

    c1 = -R1.T @ t1
    c2 = -(R2.mT @ t2[..., None])[..., 0]
    r1 = X - c1
    r2 = X - c2[..., None, :]
    n1 = torch.linalg.vector_norm(r1, dim=-1)
    n2 = torch.linalg.vector_norm(r2, dim=-1)
    cos_par = (r1 * r2).sum(-1) / torch.clamp(n1 * n2, min=1e-12)
    z1 = rot(X, R1, t1)[..., 2]
    z2 = rot(X, R2, t2)[..., 2]

    def reproj2(R, t, xy, sig2):
        Xc = rot(X, R, t)
        zi = 1.0 / torch.clamp(Xc[..., 2], min=1e-9)
        u = fx * Xc[..., 0] * zi + cx
        v = fy * Xc[..., 1] * zi + cy
        e2 = (u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2
        return e2 / torch.clamp(sig2, min=1e-12)

    sig2_1 = level_sigma2[kp1_octave.long()]
    sig2_2i = torch.take_along_dim(sig2_2, i2, dim=-1)
    e1 = reproj2(R1, t1, kp1_xy, sig2_1)
    e2 = reproj2(R2, t2, xy2, sig2_2i)
    ratio_dist = n1 / torch.clamp(n2, min=1e-9)
    ratio_octave = torch.sqrt(sig2_1 / torch.clamp(sig2_2i, min=1e-12))
    scale_ok = ((ratio_dist < ratio_octave * 1.5)
                & (ratio_dist * 1.5 > ratio_octave))
    ok = (m & finite & (cos_par < 0.9998) & (cos_par > 0)
          & (z1 > 0) & (z2 > 0) & (e1 < 5.991) & (e2 < 5.991) & scale_ok)
    return idx2, X, ok


def _compact(flat_ok, cap: int):
    """Indices of the accepted entries of a flat mask, in ascending order
    (row-major: neighbour first), padded with rejected ones to `cap`, and
    the accept count. The scores ok·n − index are distinct, so a sorted
    top-k gives exactly the reference's order."""
    n = flat_ok.shape[0]
    cap = min(cap, n)
    score = (flat_ok.to(torch.int32) * n
             - torch.arange(n, dtype=torch.int32, device=flat_ok.device))
    sel = torch.topk(score, cap, sorted=True).indices
    return sel, flat_ok.sum(dtype=torch.int32)


def epipolar_triangulate_batch(R1, t1, R2s, t2s, nb_ok, K,
                               kp1_xy, kp1_octave, kp1_free, desc1_u8,
                               kp2s_xy, kp2s_octave, kp2s_free, desc2s_u8,
                               level_sigma2):
    """All triangulation neighbours of one keyframe as one batched op over
    the neighbour axis: that axis is padded (`nb_ok` masks the padding),
    descriptors come packed and are unpacked on the device, and the
    accepted candidates are compacted on the device in neighbour-major
    order (the consumer's first-neighbour-wins rule depends on it) to at
    most TRI_COMPACT_CAP rows.
    Returns (sel_n, sel_k1, sel_idx2, sel_X, sel_valid, n_acc)."""
    idx2, X, good = epipolar_triangulate(
        R1, t1, R2s, t2s, K, kp1_xy, kp1_octave, kp1_free,
        unpack_bits_to_pm1(desc1_u8), kp2s_xy, kp2s_octave,
        kp2s_free & nb_ok[:, None], unpack_bits_to_pm1(desc2s_u8),
        level_sigma2)
    good = good & nb_ok[:, None]
    N, K1 = good.shape
    flat_ok = good.reshape(-1)
    sel, n_acc = _compact(flat_ok, TRI_COMPACT_CAP)
    return ((sel // K1).to(torch.int32), (sel % K1).to(torch.int32),
            idx2.reshape(-1)[sel], X.reshape(-1, 3)[sel], flat_ok[sel], n_acc)


def _fuse_row(R, t, ok, pos, pval, pdesc_u8, kxy, koct, kval, kdesc_pm1,
              fx, fy, cx, cy, width, height, radius):
    uv, _, pok = project_points(R, t, pos, fx, fy, cx, cy, width, height)
    idx, _ = match_projected(uv, pok & ok & pval, pdesc_u8, kxy, koct,
                             kval & ok, kdesc_pm1, radius, None,
                             max_dist_th=50)
    return idx


def fuse_project_batch2(R2s, t2s, nb_ok, mp_pos, mp_valid, mp_desc_u8,
                        kp2s_xy, kp2s_octave, kp2s_valid, desc2s_u8,
                        fx, fy, cx, cy, width, height, radius):
    """`LocalMapping::SearchInNeighbors` over all rows in one call that
    matches row by row on the host's loop, with a landmark set per row
    ((N,P,3) positions, (N,P) validity, (N,P,32) descriptors); the (row,
    landmark slot, target keypoint) triples of the matches are compacted on
    the device in row-major order to at most FUSE_COMPACT_CAP.
    Returns (sel_row, sel_p, sel_tgt, sel_ok, n_acc)."""
    desc2s_pm1 = unpack_bits_to_pm1(desc2s_u8)
    idx = torch.stack([_fuse_row(
        R2s[n], t2s[n], nb_ok[n], mp_pos[n], mp_valid[n], mp_desc_u8[n],
        kp2s_xy[n], kp2s_octave[n], kp2s_valid[n], desc2s_pm1[n],
        fx, fy, cx, cy, width, height, radius) for n in range(R2s.shape[0])])
    return _compact_fuse(idx)


def _compact_fuse(idx):
    N, P = idx.shape
    flat_ok = (idx >= 0).reshape(-1)
    sel, n_acc = _compact(flat_ok, FUSE_COMPACT_CAP)
    return ((sel // P).to(torch.int32), (sel % P).to(torch.int32),
            idx.reshape(-1)[sel], flat_ok[sel], n_acc)


def fuse_project_batch2_fr(R2s, t2s, nb_ok, fwd_pos, fwd_valid, fwd_desc_u8,
                           rev_pos, rev_valid, rev_desc_u8,
                           kp2s_xy, kp2s_octave, kp2s_valid, desc2s_u8,
                           fx, fy, cx, cy, width, height, radius):
    """`fuse_project_batch2` where the first N−1 (forward) rows share one
    landmark set and the last row is the reverse pass, so only two (P,·)
    sets are uploaded."""
    n_fwd = R2s.shape[0] - 1

    def rows(fwd, rev):
        return torch.cat([fwd.expand(n_fwd, *fwd.shape), rev[None]])

    return fuse_project_batch2(
        R2s, t2s, nb_ok, rows(fwd_pos, rev_pos), rows(fwd_valid, rev_valid),
        rows(fwd_desc_u8, rev_desc_u8), kp2s_xy, kp2s_octave, kp2s_valid,
        desc2s_u8, fx, fy, cx, cy, width, height, radius)
