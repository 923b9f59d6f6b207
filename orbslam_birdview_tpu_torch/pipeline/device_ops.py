"""Fixed-shape (padded + masked) ops shared by the tracking stages:
projection, the frustum test of the local-map candidates, and the
frame-to-frame matchers of initialization. The mapping ops of the
reference's module (triangulation, fuse) follow with local mapping.
"""
from __future__ import annotations

import torch

from ..frontend import matcher
from ..frontend.keypoints import unpack_bits_to_pm1


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
