"""Camera models: pinhole projection with radial-tangential distortion, and
the bird's-eye-view (BEV) metric ground-plane camera. Batched PyTorch; the
cameras are hashable NamedTuples of Python numbers, so they can be passed
as static configuration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie


class PinholeCamera(NamedTuple):
    """Intrinsics + distortion (k1,k2,p1,p2,k3), OpenCV convention."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    # stereo baseline times fx (reference `mbf`); 0 for monocular
    bf: float = 0.0

    @property
    def K(self):
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32)

    def project(self, pc):
        """Camera-frame points (…,3) -> pixels (…,2), no distortion (the
        reference projects undistorted keypoints)."""
        z = pc[..., 2]
        inv_z = 1.0 / torch.where(z.abs() > 1e-9, z, 1e-9)
        u = self.fx * pc[..., 0] * inv_z + self.cx
        v = self.fy * pc[..., 1] * inv_z + self.cy
        return torch.stack([u, v], dim=-1)

    def backproject(self, uv, depth):
        """Pixels (…,2) + depth (…) -> camera-frame points (…,3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x * depth, y * depth, depth], dim=-1)

    def distort_normalized(self, xn):
        """Apply distortion to normalized coords (…,2)."""
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2 + self.k3 * r2 ** 3
        xd = x * radial + 2 * self.p1 * x * y + self.p2 * (r2 + 2 * x * x)
        yd = y * radial + self.p1 * (r2 + 2 * y * y) + 2 * self.p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def undistort_points(self, uv, iters: int = 8):
        """Fixed-point undistortion (cv::undistortPoints equivalent)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        xd = torch.stack([x, y], dim=-1)
        xu = xd
        for _ in range(iters):
            xu = xu - (self.distort_normalized(xu) - xd)
        u = self.fx * xu[..., 0] + self.cx
        v = self.fy * xu[..., 1] + self.cy
        return torch.stack([u, v], dim=-1)

    def in_image(self, uv, margin: float = 0.0):
        return ((uv[..., 0] >= margin) & (uv[..., 0] < self.width - margin)
                & (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin))


class BirdviewCamera(NamedTuple):
    """Metric BEV camera: fixed pixel<->meter scale on the ground plane
    (pixel2meter = 0.03984·1.7, rear axle 1.393 m behind the image centre).
    Vehicle base frame: x forward, y left, z up; the BEV image centre maps
    to the vehicle centre."""

    pixel2meter: float = 0.03984 * 1.7
    rear_axle_to_center: float = 1.393
    width: int = 384
    height: int = 384
    vehicle_length: float = 4.63
    vehicle_width: float = 1.901

    @property
    def meter2pixel(self):
        return 1.0 / self.pixel2meter

    def pixel_to_base_xy(self, uv):
        """BEV pixel (…,2) -> vehicle base-frame (x,y) in meters (…,2).
        u (col) grows rightward = -y; v (row) grows downward = -x."""
        x = ((self.height / 2.0 - uv[..., 1]) * self.pixel2meter
             + self.rear_axle_to_center)
        y = (self.width / 2.0 - uv[..., 0]) * self.pixel2meter
        return torch.stack([x, y], dim=-1)

    def base_xy_to_pixel(self, xy):
        u = self.width / 2.0 - xy[..., 1] * self.meter2pixel
        v = (self.height / 2.0
             - (xy[..., 0] - self.rear_axle_to_center) * self.meter2pixel)
        return torch.stack([u, v], dim=-1)

    def in_image(self, uv, margin: float = 0.0):
        return ((uv[..., 0] >= margin) & (uv[..., 0] < self.width - margin)
                & (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin))

    def footprint_mask_bounds(self):
        """Vehicle footprint rectangle in pixels (masks self-reflections)."""
        half_l = 0.5 * self.vehicle_length * self.meter2pixel
        half_w = 0.5 * self.vehicle_width * self.meter2pixel
        cx, cy = self.width / 2.0, self.height / 2.0
        return (cx - half_w, cy - half_l, cx + half_w, cy + half_l)


def camera_to_base_extrinsics(q_wxyz, t, device="cpu"):
    """(R_bc, t_bc): camera-to-base SE3 from a wxyz quaternion and a
    translation (`Frame::CalculateExtrinsics` in the reference)."""
    R = lie.quat_to_rot(torch.as_tensor(q_wxyz, dtype=torch.float32,
                                        device=device))
    return R, torch.as_tensor(t, dtype=torch.float32, device=device)


# The reference's hardcoded extrinsic quaternion/translation, kept as the
# default and overridable through configuration.
DEFAULT_BIRDVIEW_TBC_QUAT = (-0.003, 0.8205, -0.5717, -0.0095)
DEFAULT_BIRDVIEW_TBC_T = (1.30494, 0.0, 1.62757)
