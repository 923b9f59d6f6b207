"""The street: a long straight road between two textured facades, driven
by a vehicle with a gentle weave, rendered on the device in plain torch.

The traffic file (`traffic/<name>.json`, `"generator": "street"`) sets the
vehicle's speed, the weave, the facades and the texture scales; the
configuration's `rig` sets the cameras. Nothing here imports the program.

- The facades are the planes y = ±facade_offset_m (0 <= z <= facade
  height), the road is the plane z = 0; world x runs down the street, z up.
- Each surface is cut into tiles of `tile_m` along x. Every tile of every
  surface is its own random texture (uniform noise with bright integer
  rectangles, blurred 3-tap), all drawn from one generator seeded with the
  run's seed, so no view recurs along the drive.
- The vehicle's base is at x = v·i, y = A·sin(2πx/λ + φ), heading along the
  curve, with the traffic's phase φ: every seed drives the same path, and
  the seed draws only the textures.
- Radiance fades into a haze with distance (exp(−d/haze_m)), and each
  pixel averages `supersample`² rays, so far texture does not alias into
  flickering corners.
- Images are rendered in chunks of frames, rounded to uint8 on the device
  and copied to host memory once: what a camera driver hands a program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# camera -> vehicle base: camera z forward (+x base), x right (−y base),
# y down (−z base)
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
HAZE_VALUE = 150.0      # the grey that far surfaces and the sky fade into
RECTS_PER_TEXEL = 4000 / 2048 ** 2   # the density of the classic drive's
VIEW_AHEAD_M = 150.0    # texture laid beyond the last frame's position


@dataclass
class Drive:
    """A rendered drive: uint8 host images and the exact poses."""
    front: np.ndarray                 # (N, H, W) uint8
    right: Optional[np.ndarray]       # (N, H, W) uint8, stereo rigs
    bev: Optional[np.ndarray]         # (N, Hb, Wb) uint8, BEV rigs
    bev_mask: Optional[np.ndarray]    # (Hb, Wb) f32, 0 on the footprint
    Tcw: np.ndarray                   # (N, 4, 4) float64 world -> camera
    base_xy_yaw: np.ndarray           # (N, 3) float64
    tiles: int                        # texture tiles per surface
    step_m: float                     # metres per frame along the street


def base_poses(traffic: dict, fps: float, n_frames: int) -> np.ndarray:
    """(N, 3) vehicle (x, y, yaw) of each frame."""
    v = traffic["speed_m_per_s"] / fps
    amp = traffic["weave_amplitude_m"]
    lam = traffic["weave_period_m"]
    phase = traffic["weave_phase_rad"]
    x = v * np.arange(n_frames, dtype=np.float64)
    w = 2 * math.pi / lam
    y = amp * np.sin(w * x + phase)
    yaw = np.arctan(amp * w * np.cos(w * x + phase))
    return np.stack([x, y, yaw], 1)


def camera_poses(base: np.ndarray, height: float,
                 lateral: float = 0.0) -> np.ndarray:
    """(N, 4, 4) world -> camera of a camera at `height` above the base,
    shifted `lateral` metres along its own x axis (a stereo right eye)."""
    n = len(base)
    c, s = np.cos(base[:, 2]), np.sin(base[:, 2])
    R_wb = np.zeros((n, 3, 3))
    R_wb[:, 0, 0], R_wb[:, 0, 1] = c, -s
    R_wb[:, 1, 0], R_wb[:, 1, 1] = s, c
    R_wb[:, 2, 2] = 1.0
    R_wc = R_wb @ R_BC
    t_wc = np.stack([base[:, 0], base[:, 1], np.full(n, height)], 1)
    t_wc = t_wc + R_wc @ np.array([lateral, 0.0, 0.0])
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R_wc.transpose(0, 2, 1)
    T[:, :3, 3] = -np.einsum("nji,nj->ni", R_wc, t_wc)
    return T


def textures(gen: torch.Generator, n_tiles: int, h: int, w: int,
             device) -> torch.Tensor:
    """(n_tiles, h, w) f32 in [0, 255]: uniform noise in [20, 70] plus
    bright rectangles 4-35 texels a side, blurred by [.16 .68 .16] with a
    mirrored border. The rectangles are summed as integers, so the result
    does not depend on the order of the device's atomic adds."""
    noise = torch.rand((n_tiles, h, w), generator=gen, device=device) * 50 + 20
    n_rects = max(1, round(RECTS_PER_TEXEL * h * w))
    r = torch.rand((n_tiles, n_rects, 5), generator=gen, device=device)
    y0 = (r[..., 0] * (h - 45)).long() + 5
    x0 = (r[..., 1] * (w - 45)).long() + 5
    rh = (r[..., 2] * 32).long() + 4
    rw = (r[..., 3] * 32).long() + 4
    val = (r[..., 4] * 135).long() + 50
    tile = torch.arange(n_tiles, device=device)[:, None].expand_as(y0)
    diff = torch.zeros((n_tiles, h + 1, w + 1), dtype=torch.int64,
                       device=device)
    for dy, dx, sign in ((0, 0, 1), (0, 1, -1), (1, 0, -1), (1, 1, 1)):
        diff.index_put_((tile, (y0 + dy * rh).clamp(max=h),
                         (x0 + dx * rw).clamp(max=w)), sign * val,
                        accumulate=True)
    rects = diff.cumsum(1).cumsum(2)[:, :h, :w]
    tex = (noise + rects.to(torch.float32)).clamp(0, 255)
    k = math.exp(-1 / (2 * 0.8 ** 2))
    k0, k1 = 1 / (1 + 2 * k), k / (1 + 2 * k)
    p = F.pad(tex[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    tex = k1 * p[:, :-2, 1:-1] + k0 * p[:, 1:-1, 1:-1] + k1 * p[:, 2:, 1:-1]
    p = F.pad(tex[:, None], (1, 1, 0, 0), mode="reflect")[:, 0]
    tex = k1 * p[:, :, :-2] + k0 * p[:, :, 1:-1] + k1 * p[:, :, 2:]
    return tex.clamp(0, 255)


def _bilinear(tex: torch.Tensor, tile, u, v) -> torch.Tensor:
    """tex[tile] sampled at texel coords (u col, v row), clamped to the
    tile."""
    n, h, w = tex.shape
    flat = tex.reshape(-1)
    u = u.clamp(0, w - 1.001)
    v = v.clamp(0, h - 1.001)
    u0, v0 = u.floor(), v.floor()
    fu, fv = u - u0, v - v0
    base = tile * (h * w) + v0.long() * w + u0.long()
    a = flat[base]
    b = flat[base + 1]
    c = flat[base + w]
    d = flat[base + w + 1]
    return (a * (1 - fu) + b * fu) * (1 - fv) + (c * (1 - fu) + d * fu) * fv


class Street:
    """The street's surfaces for one drive, textures on the device."""

    def __init__(self, traffic: dict, x_end: float, seed: int, device):
        self.p = traffic
        self.device = device
        self.tile_m = traffic["tile_m"]
        self.x0 = -2 * self.tile_m
        self.n_tiles = int(math.ceil((x_end + VIEW_AHEAD_M - self.x0)
                                     / self.tile_m))
        gen = torch.Generator(device=device).manual_seed(int(seed))
        fm = traffic["facade_m_per_texel"]
        gm = traffic["ground_m_per_texel"]
        fw = int(round(self.tile_m / fm))
        fh = int(round(traffic["facade_height_m"] / fm))
        gw = int(round(self.tile_m / gm))
        gh = int(round(2 * traffic["ground_half_width_m"] / gm))
        self.facades = textures(gen, 2 * self.n_tiles, fh, fw, device)
        self.ground = textures(gen, self.n_tiles, gh, gw, device)

    def _tile(self, x):
        k = torch.floor((x - self.x0) / self.tile_m)
        inside = (k >= 0) & (k < self.n_tiles)
        k = k.clamp(0, self.n_tiles - 1)
        return k.long(), x - self.x0 - k * self.tile_m, inside

    def ground_at(self, x, y):
        """Ground radiance at world (x, y), and where it is laid."""
        gm = self.p["ground_m_per_texel"]
        k, along, inside = self._tile(x)
        val = _bilinear(self.ground, k, along / gm,
                        (y + self.p["ground_half_width_m"]) / gm)
        return val, inside

    def cast(self, centre: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """Radiance along rays d (..., 3) from centres (..., 3)."""
        p = self.p
        W, Hf = p["facade_offset_m"], p["facade_height_m"]
        fm = p["facade_m_per_texel"]
        inf = torch.full(d.shape[:-1], math.inf, device=d.device)
        cx, cy, cz = centre.unbind(-1)
        dx, dy, dz = d.unbind(-1)
        value = torch.full(d.shape[:-1], HAZE_VALUE, device=d.device)
        best = inf
        for side, wall_y in ((0, W), (1, -W)):
            t = (wall_y - cy) / dy
            z = cz + t * dz
            hit = (t > 0) & (z >= 0) & (z <= Hf)
            x = cx + t * dx
            k, along, inside = self._tile(x)
            hit &= inside
            val = _bilinear(self.facades, 2 * k + side, along / fm,
                            (Hf - z) / fm)
            take = hit & (t < best)
            best = torch.where(take, t, best)
            value = torch.where(take, val, value)
        t = -cz / dz
        gval, inside = self.ground_at(cx + t * dx, cy + t * dy)
        take = (t > 0) & inside & (t < best)
        best = torch.where(take, t, best)
        value = torch.where(take, gval, value)
        dist = best * d.norm(dim=-1)
        fade = torch.exp(-dist / p["haze_m"]).nan_to_num(0.0)
        return HAZE_VALUE + (value - HAZE_VALUE) * fade


def _pixel_grid(w: int, h: int, ss: int, device):
    """(h·w·ss², 2) sample positions (u, v), ss² per pixel, pixel-major."""
    off = (torch.arange(ss, device=device, dtype=torch.float32) + 0.5) / ss - 0.5
    v, u, sv, su = torch.meshgrid(
        torch.arange(h, device=device, dtype=torch.float32),
        torch.arange(w, device=device, dtype=torch.float32), off, off,
        indexing="ij")
    return torch.stack([(u + su).reshape(-1), (v + sv).reshape(-1)], -1)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return x.round().clamp(0, 255).to(torch.uint8)


def render_camera(street: Street, cam: dict, Tcw: np.ndarray, ss: int,
                  chunk: int) -> torch.Tensor:
    """(N, H, W) uint8 views of the street from the poses Tcw."""
    dev = street.device
    w, h = cam["width"], cam["height"]
    uv = _pixel_grid(w, h, ss, dev)
    rays = torch.stack([(uv[:, 0] - cam["cx"]) / cam["fx"],
                        (uv[:, 1] - cam["cy"]) / cam["fy"],
                        torch.ones_like(uv[:, 0])], -1)
    out = []
    for s in range(0, len(Tcw), chunk):
        T = torch.as_tensor(Tcw[s:s + chunk], dtype=torch.float32, device=dev)
        R_wc = T[:, :3, :3].transpose(1, 2)
        centre = -(R_wc @ T[:, :3, 3:])[..., 0]
        d = rays[None] @ R_wc.transpose(1, 2)
        val = street.cast(centre[:, None].expand_as(d), d)
        out.append(_to_u8(val.reshape(-1, h, w, ss * ss).mean(-1)))
    return torch.cat(out)


def bev_footprint_mask(bev: dict) -> np.ndarray:
    """(H, W) f32: 0 on the vehicle's footprint rectangle, 1 elsewhere."""
    m2p = 1.0 / bev["pixel2meter"]
    half_l = 0.5 * bev["vehicle_length"] * m2p
    half_w = 0.5 * bev["vehicle_width"] * m2p
    cx, cy = bev["width"] / 2.0, bev["height"] / 2.0
    us, vs = np.meshgrid(np.arange(bev["width"]), np.arange(bev["height"]))
    inside = ((us >= cx - half_w) & (us <= cx + half_w)
              & (vs >= cy - half_l) & (vs <= cy + half_l))
    return np.where(inside, 0.0, 1.0).astype(np.float32)


def render_bev(street: Street, bev: dict, base: np.ndarray, ss: int,
               chunk: int) -> torch.Tensor:
    """(N, Hb, Wb) uint8 top-down views of the road around each base pose
    (image centre = vehicle centre, `rear_axle_to_center` ahead of the
    base; u grows to −y, v to −x)."""
    dev = street.device
    w, h = bev["width"], bev["height"]
    uv = _pixel_grid(w, h, ss, dev)
    bx = (h / 2.0 - uv[:, 1]) * bev["pixel2meter"] + bev["rear_axle_to_center"]
    by = (w / 2.0 - uv[:, 0]) * bev["pixel2meter"]
    out = []
    for s in range(0, len(base), chunk):
        b = torch.as_tensor(base[s:s + chunk], dtype=torch.float32,
                            device=dev)
        c, sn = torch.cos(b[:, 2:3]), torch.sin(b[:, 2:3])
        wx = b[:, 0:1] + c * bx - sn * by
        wy = b[:, 1:2] + sn * bx + c * by
        val, _ = street.ground_at(wx, wy)
        out.append(_to_u8(val.reshape(-1, h, w, ss * ss).mean(-1)))
    return torch.cat(out)


def render(traffic: dict, rig: dict, fps: float, n_frames: int, seed: int,
           device, chunk: int = 16) -> Drive:
    """The whole drive of `n_frames` frames for `rig` (the configuration's
    cameras: `camera`, `camera_height_m`, optional `stereo_baseline_m` and
    `bev`)."""
    base = base_poses(traffic, fps, n_frames)
    street = Street(traffic, float(base[-1, 0]), seed, device)
    ss = int(traffic["supersample"])
    cam = rig["camera"]
    Tcw = camera_poses(base, rig["camera_height_m"])
    front = render_camera(street, cam, Tcw, ss, chunk)
    right = bev = mask = None
    if rig.get("stereo_baseline_m"):
        T_r = camera_poses(base, rig["camera_height_m"],
                           rig["stereo_baseline_m"])
        right = render_camera(street, cam, T_r, ss, chunk).cpu().numpy()
    if rig.get("bev"):
        bev = render_bev(street, rig["bev"], base, ss, chunk).cpu().numpy()
        mask = bev_footprint_mask(rig["bev"])
    return Drive(front=front.cpu().numpy(), right=right, bev=bev,
                 bev_mask=mask, Tcw=Tcw, base_xy_yaw=base,
                 tiles=street.n_tiles, step_m=traffic["speed_m_per_s"] / fps)
