"""Fixed-shape (padded + masked) geometry ops of the tracking step:
projection and the frustum test of the local-map candidates. The mapping
ops of the reference's module follow with local mapping.
"""
from __future__ import annotations

import torch


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
