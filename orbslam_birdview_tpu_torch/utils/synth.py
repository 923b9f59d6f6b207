"""Synthetic sequences with exact ground truth, in numpy and scipy.

The JAX package's `utils/synth.py` without OpenCV — the textured wall
seen by a moving camera (`WallSequence`, with the wall's exact depth for
RGB-D), the textured box room seen by the front camera, the textured
ground seen by the BEV camera (`BirdSequence`), a camera orbiting inside
the room (`CircleSequence`), the hostile-imaging model (`degrade`) and the
ATE metric: the 3×3 Gaussian and the box blur are scipy's, and cv2.remap /
cv2.warpPerspective become bilinear sampling written out here (the wall
through the inverse of its homography). The renders are close to, not
bit-equal with, the OpenCV ones; parity tests hand one numpy image to both
packages. `degrade` is bit-equal with the JAX one.

`seed_fields` builds the local-map and ground-landmark bundles of a frame
from ground truth, so the step can be judged without the mapping thread.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy import ndimage

from ..core.camera import BirdviewCamera, PinholeCamera


def make_texture(seed: int, size: int = 2048, n_blobs: int = 4000) -> np.ndarray:
    """Uniform noise with bright rectangles, blurred 3×3 (sigma 0.8)."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(20, 70, (size, size)).astype(np.float32)
    ys = rng.integers(5, size - 40, n_blobs)
    xs = rng.integers(5, size - 40, n_blobs)
    hs = rng.integers(4, 36, n_blobs)
    ws = rng.integers(4, 36, n_blobs)
    vals = rng.uniform(50, 185, n_blobs)
    for y, x, h, w, v in zip(ys, xs, hs, ws, vals):
        tex[y: y + h, x: x + w] += v
    k = np.exp(-np.arange(-1, 2) ** 2 / (2 * 0.8 ** 2))
    k = (k / k.sum()).astype(np.float32)
    # reflect-101 border, as cv2.GaussianBlur's default
    tex = ndimage.correlate1d(np.clip(tex, 0, 255), k, axis=0, mode="mirror")
    tex = ndimage.correlate1d(tex, k, axis=1, mode="mirror")
    return np.clip(tex, 0, 255).astype(np.float32)


def sample_bilinear(tex: np.ndarray, tx: np.ndarray, ty: np.ndarray,
                    wrap: bool) -> np.ndarray:
    """tex sampled at float pixel coords (tx = col, ty = row): wrapped
    around the edges, or 0 outside them."""
    H, W = tex.shape
    x0 = np.floor(tx).astype(np.int64)
    y0 = np.floor(ty).astype(np.int64)
    fx = (tx - x0).astype(np.float32)
    fy = (ty - y0).astype(np.float32)
    out = np.zeros(np.shape(tx), np.float32)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            if wrap:
                v = tex[yy % H, xx % W]
            else:
                inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                v = np.where(inside, tex[np.clip(yy, 0, H - 1),
                                         np.clip(xx, 0, W - 1)], 0.0)
            out += wy * wx * v
    return out


def render_wall_view(cam: PinholeCamera, tex: np.ndarray, R_cw: np.ndarray,
                     t_cw: np.ndarray, wall_z: float,
                     meters_per_tex: float = 0.005) -> np.ndarray:
    """The camera view of the textured plane z = wall_z (world frame): the
    texture warped by its homography H = K·[r1 r2 wall_z·r3 + t]·A, each
    pixel sampled at H⁻¹·(u, v, 1), 0 outside the texture.

    Texture pixel (tx, ty) maps to world (x, y) = ((tx, ty) − size/2)·mpt."""
    size = tex.shape[0]
    A = np.array(
        [[meters_per_tex, 0.0, -size / 2 * meters_per_tex],
         [0.0, meters_per_tex, -size / 2 * meters_per_tex],
         [0.0, 0.0, 1.0]], np.float64)
    R_cw = np.asarray(R_cw, np.float64)
    t_cw = np.asarray(t_cw, np.float64)
    Hc = np.column_stack([R_cw[:, 0], R_cw[:, 1], wall_z * R_cw[:, 2] + t_cw])
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                 np.float64)
    Hinv = np.linalg.inv(K @ Hc @ A)
    us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    src = np.stack([us, vs, np.ones_like(us)], -1) @ Hinv.T
    w = src[..., 2]
    return sample_bilinear(tex, src[..., 0] / w, src[..., 1] / w, wrap=False)


@dataclass
class WallSequence:
    """Camera translating laterally in front of a wall at z=wall_z, with a
    gentle push-in; exact ground truth poses (world→cam)."""

    cam: PinholeCamera
    n_frames: int = 60
    wall_z: float = 4.0
    step: float = 0.02        # meters per frame along +x
    push: float = 0.004       # meters per frame along +z
    yaw_rate: float = 0.0
    seed: int = 3

    def __post_init__(self):
        self.tex = make_texture(self.seed)

    def gt_pose(self, i: int):
        """Returns (R_cw, t_cw): world→camera."""
        yaw = self.yaw_rate * i
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        p = np.array([self.step * i, 0.0, self.push * i], np.float32)
        R_cw = R_wc.T
        t_cw = -R_cw @ p
        return R_cw, t_cw

    def frame(self, i: int):
        R_cw, t_cw = self.gt_pose(i)
        img = render_wall_view(self.cam, self.tex, R_cw, t_cw, self.wall_z)
        return img, (R_cw, t_cw)

    def depth(self, i: int) -> np.ndarray:
        """Exact per-pixel depth (camera z, metres) of the wall plane."""
        R_cw, t_cw = self.gt_pose(i)
        R_wc = R_cw.T
        p = -R_wc @ t_cw
        cam = self.cam
        us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                             np.arange(cam.height, dtype=np.float64))
        xn = (us - cam.cx) / cam.fx
        yn = (vs - cam.cy) / cam.fy
        dw_z = R_wc[2, 0] * xn + R_wc[2, 1] * yn + R_wc[2, 2]
        depth = (self.wall_z - p[2]) / np.maximum(dw_z, 1e-9)
        return depth.astype(np.float32)


def degrade(img: np.ndarray, i: int, rng: np.random.Generator,
            noise_std: float = 0.0, blur_px: int = 0,
            exposure_amp: float = 0.0, exposure_period: int = 80,
            occluders: int = 0, occluder_size: int = 120,
            blackout: bool = False) -> np.ndarray:
    """Hostile-imaging model for stress tests: photometric noise, blur,
    exposure change and occlusion on a clean render.

    - noise_std: additive Gaussian intensity noise (sensor noise)
    - blur_px: horizontal box blur (motion blur), odd width applied
    - exposure_amp: multiplicative gain swinging ±amp over exposure_period
      frames (auto-exposure drift)
    - occluders: N gray rectangles sweeping across the image (dynamic
      foreground objects with NO valid texture)
    - blackout: the frame is black (dropped exposure / tunnel)

    The box blur is `cv2.blur(img, (blur_px, 1))`'s: a mean over blur_px
    columns with the reflect-101 border (scipy's "mirror")."""
    out = np.asarray(img, np.float32).copy()
    if blackout:
        return np.zeros_like(out)
    if exposure_amp:
        out *= 1.0 + exposure_amp * np.sin(2 * np.pi * i / exposure_period)
    if blur_px and blur_px > 1:
        out = ndimage.uniform_filter1d(out, blur_px, axis=1, mode="mirror")
    if occluders:
        h, w = out.shape[:2]
        for k in range(occluders):
            # deterministic sweep: each occluder crosses the frame over
            # ~120 frames at its own phase/row
            x0 = int((i * (7 + 3 * k) + k * 211) % (w + occluder_size)) \
                - occluder_size
            y0 = int((k * 313) % max(h - occluder_size, 1))
            x1 = max(x0, 0)
            out[y0:y0 + occluder_size,
                x1:max(x0 + occluder_size, 0)] = 90.0 + 20.0 * k
    if noise_std:
        out += rng.normal(0.0, noise_std, out.shape)
    return np.clip(out, 0, 255)


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False):
    """Absolute trajectory error after optional Umeyama alignment (the TUM
    evaluation metric)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape
    if align:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        E, G = est - mu_e, gt - mu_g
        W = G.T @ E / len(est)
        U, d, Vt = np.linalg.svd(W)
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        if with_scale:
            var_e = (E * E).sum() / len(est)
            s = np.trace(np.diag(d) @ S) / max(var_e, 1e-12)
        else:
            s = 1.0
        t = mu_g - s * R @ mu_e
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def _box_walls(box_half: float):
    # (axis of the wall's normal, its offset, the two in-plane axes)
    return [(0, +box_half, 1, 2), (0, -box_half, 1, 2),
            (1, +box_half, 0, 2), (1, -box_half, 0, 2)]


def cast_box_rays(p: np.ndarray, d_w: np.ndarray, box_half: float):
    """Ray parameters of the nearest box wall along world rays d_w (…,3)
    from p: (t (…), wall index (…), -1 where nothing is hit)."""
    best_t = np.full(d_w.shape[:-1], np.inf)
    wall = np.full(d_w.shape[:-1], -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i, (axis, D, _, _) in enumerate(_box_walls(box_half)):
            t = (D - p[axis]) / d_w[..., axis]
            hit = (t > 0.1) & (t < best_t) & np.isfinite(t)
            best_t = np.where(hit, t, best_t)
            wall = np.where(hit, i, wall)
    return best_t, wall


def _camera_rays(cam: PinholeCamera, R_cw: np.ndarray, u, v):
    d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                      np.ones_like(u)], -1)
    return d_cam @ R_cw  # = (R_wc @ d)ᵀ row-wise


def render_box_view(cam: PinholeCamera, textures, R_cw: np.ndarray,
                    t_cw: np.ndarray, box_half: float = 8.0,
                    meters_per_tex: float = 0.01) -> np.ndarray:
    """Ray-cast view of a textured square room (4 vertical walls at
    x=±box_half, y=±box_half, world z vertical), one texture per wall."""
    if isinstance(textures, np.ndarray):
        textures = [textures] * 4
    R_cw = np.asarray(R_cw, np.float64)
    p = -R_cw.T @ np.asarray(t_cw, np.float64)
    us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    d_w = _camera_rays(cam, R_cw, us, vs)
    t, wall = cast_box_rays(p, d_w, box_half)
    img = np.zeros(us.shape, np.float32)
    for i, (tex, (_, _, pa, pb)) in enumerate(zip(textures,
                                                  _box_walls(box_half))):
        hit = wall == i
        if not hit.any():
            continue
        size = tex.shape[0]
        a = p[pa] + t[hit] * d_w[hit][:, pa]
        b = p[pb] + t[hit] * d_w[hit][:, pb]
        img[hit] = sample_bilinear(tex, a / meters_per_tex + size / 2,
                                   b / meters_per_tex + size / 2, wrap=True)
    return img


def render_bev(bv: BirdviewCamera, ground: np.ndarray, x: float, y: float,
               yaw: float, meters_per_tex: float = 0.02) -> np.ndarray:
    """Top-down view of the ground texture around vehicle pose (x,y,yaw)."""
    size = ground.shape[0]
    h, w = bv.height, bv.width
    us, vs = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    bx = (h / 2.0 - vs) * bv.pixel2meter + bv.rear_axle_to_center
    by = (w / 2.0 - us) * bv.pixel2meter
    c, s = np.cos(yaw), np.sin(yaw)
    wx = x + c * bx - s * by
    wy = y + s * bx + c * by
    return sample_bilinear(ground, wx / meters_per_tex + size / 2,
                           wy / meters_per_tex + size / 2, wrap=False)


def footprint_mask(bv: BirdviewCamera) -> np.ndarray:
    """(H,W) f32 BEV detection mask: 0 on the vehicle footprint, 1 elsewhere."""
    u0, v0, u1, v1 = bv.footprint_mask_bounds()
    us, vs = np.meshgrid(np.arange(bv.width), np.arange(bv.height))
    inside = (us >= u0) & (us <= u1) & (vs >= v0) & (vs <= v1)
    return np.where(inside, 0.0, 1.0).astype(np.float32)


@dataclass
class BirdSequence:
    """Vehicle driving on a textured ground plane inside a textured box
    room: the front camera sees the walls, the BEV camera the ground.
    Metric ground truth."""

    cam: PinholeCamera
    bv: BirdviewCamera
    n_frames: int = 60
    speed: float = 0.12       # m per frame along +x (vehicle forward)
    yaw_rate: float = 0.004
    wall_x: float = 14.0      # half-size of the box room
    seed: int = 5

    def __post_init__(self):
        self.ground = make_texture(self.seed, size=4096)
        self.wall = [make_texture(self.seed + 1 + i) for i in range(4)]
        # camera→base: camera z forward (+x base), x right (−y base),
        # y down (−z base); mounted at base origin, height 1.2 m
        self.R_bc = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
        self.t_bc = np.array([0.0, 0.0, 1.2], np.float32)

    def gt_pose2d(self, i: int):
        yaw = self.yaw_rate * i
        if abs(self.yaw_rate) < 1e-9:
            return self.speed * i, 0.0, yaw
        r = self.speed / self.yaw_rate
        return r * np.sin(yaw), r * (1 - np.cos(yaw)), yaw

    def gt_base_pose(self, i: int):
        """Base→world (R_wb, t_wb) of frame i."""
        x, y, yaw = self.gt_pose2d(i)
        c, s = np.cos(yaw), np.sin(yaw)
        R_wb = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        return R_wb, np.array([x, y, 0], np.float32)

    def gt_cam_pose(self, i: int):
        """World→camera SE3 from the vehicle 2-D pose + extrinsics."""
        R_wb, t_wb = self.gt_base_pose(i)
        R_wc = R_wb @ self.R_bc
        t_wc = R_wb @ self.t_bc + t_wb
        R_cw = R_wc.T
        return R_cw, -R_cw @ t_wc

    def frame(self, i: int):
        x, y, yaw = self.gt_pose2d(i)
        bev = render_bev(self.bv, self.ground, x, y, yaw)
        R_cw, t_cw = self.gt_cam_pose(i)
        img = render_box_view(self.cam, self.wall, R_cw, t_cw,
                              box_half=self.wall_x)
        return img, bev, (R_cw, t_cw)


def seed_fields(seq: BirdSequence, i: int, kp: dict, bkp: dict,
                n_levels: int, scale_factor: float, P: int, Pb: int):
    """Bundle fields (numpy) seeded from frame i's keypoints and ground truth.

    `kp` / `bkp` hold numpy `xy`, `octave`, `valid` and `desc_u8` of the
    front and BEV keypoints. Each valid front keypoint's ray is cast under
    the GT pose onto the box walls (the renderer's ray cast); the hit is the
    landmark, its normal is the unit ray and its scale band follows
    `MapPoint::UpdateNormalAndDepth`: max = dist·s^octave, min =
    max/s^(L−1). Each valid BEV keypoint maps through `pixel_to_base_xy`
    and the GT vehicle pose to a ground point with z = 0. Returns
    (lm, bird): dicts of the LocalMapDevice / BirdMapDevice fields, padded
    to P and Pb slots."""
    R_cw, t_cw = (np.asarray(a, np.float64) for a in seq.gt_cam_pose(i))
    centre = -R_cw.T @ t_cw
    sel = np.flatnonzero(kp["valid"])
    xy = np.asarray(kp["xy"], np.float64)[sel]
    d_w = _camera_rays(seq.cam, R_cw, xy[:, 0], xy[:, 1])
    t, wall = cast_box_rays(centre, d_w, seq.wall_x)
    hit = wall >= 0
    sel, d_w, t = sel[hit][:P], d_w[hit][:P], t[hit][:P]
    pos = centre + t[:, None] * d_w
    ray = pos - centre
    dist = np.linalg.norm(ray, axis=1)
    octave = np.asarray(kp["octave"])[sel]
    max_dist = dist * scale_factor ** octave
    n = len(sel)
    lm = dict(pos=np.zeros((P, 3), np.float32),
              normal=np.zeros((P, 3), np.float32),
              min_dist=np.zeros(P, np.float32),
              max_dist=np.zeros(P, np.float32),
              valid=np.zeros(P, bool),
              desc_u8=np.zeros((P, 32), np.uint8))
    lm["pos"][:n] = pos
    lm["normal"][:n] = ray / dist[:, None]
    lm["max_dist"][:n] = max_dist
    lm["min_dist"][:n] = max_dist / scale_factor ** (n_levels - 1)
    lm["valid"][:n] = True
    lm["desc_u8"][:n] = np.asarray(kp["desc_u8"])[sel]

    bsel = np.flatnonzero(bkp["valid"])[:Pb]
    buv = np.asarray(bkp["xy"], np.float64)[bsel]
    bv = seq.bv
    bx = (bv.height / 2.0 - buv[:, 1]) * bv.pixel2meter + bv.rear_axle_to_center
    by = (bv.width / 2.0 - buv[:, 0]) * bv.pixel2meter
    R_wb, t_wb = (np.asarray(a, np.float64) for a in seq.gt_base_pose(i))
    ground = np.stack([bx, by, np.zeros_like(bx)], -1) @ R_wb.T + t_wb
    ground[:, 2] = 0.0
    nb = len(bsel)
    bird = dict(pos=np.zeros((Pb, 3), np.float32), valid=np.zeros(Pb, bool),
                desc_u8=np.zeros((Pb, 32), np.uint8))
    bird["pos"][:nb] = ground
    bird["valid"][:nb] = True
    bird["desc_u8"][:nb] = np.asarray(bkp["desc_u8"])[bsel]
    return lm, bird


def keypoints_numpy(kp) -> dict:
    """The fields `seed_fields` reads, as numpy, from a Keypoints tuple of
    either package."""
    out = {}
    for k in ("xy", "octave", "valid", "desc_u8"):
        v = getattr(kp, k)
        out[k] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


@dataclass
class CircleSequence:
    """Monocular camera orbiting inside a textured box room — KITTI-style
    revisits: the trajectory closes a loop every `frames_per_rev` frames.
    Same vehicle-on-ground pose math as BirdSequence, no BEV stream."""

    cam: PinholeCamera
    n_frames: int = 400
    speed: float = 0.05        # m per frame along heading
    frames_per_rev: int = 400
    box_half: float = 10.0
    seed: int = 7

    def __post_init__(self):
        self.walls = [make_texture(self.seed + i) for i in range(4)]
        self.R_bc = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
        self.t_bc = np.array([0.0, 0.0, 1.2], np.float32)
        self.yaw_rate = 2 * np.pi / self.frames_per_rev

    def gt_pose(self, i: int):
        yaw = self.yaw_rate * i
        r = self.speed / self.yaw_rate
        x = r * np.sin(yaw)
        y = r * (1 - np.cos(yaw))
        c, s = np.cos(yaw), np.sin(yaw)
        R_wb = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        R_wc = R_wb @ self.R_bc
        t_wc = R_wb @ self.t_bc + np.array([x, y, 0], np.float32)
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc
        return R_cw, t_cw

    def frame(self, i: int):
        R_cw, t_cw = self.gt_pose(i)
        img = render_box_view(self.cam, self.walls, R_cw.astype(np.float64),
                              t_cw.astype(np.float64),
                              box_half=self.box_half)
        return img, (R_cw, t_cw)
