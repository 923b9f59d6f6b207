"""Headless visualization without OpenCV or matplotlib: map / trajectory /
frame overlays rasterized in numpy and written with the port's PNG writer.

The JAX package's `utils/viz.py` draws with `cv2` and `matplotlib`; the
overlays here keep its content and colours:
- `draw_frame`: keypoints as radius-2 circles with exactly `cv2.circle`'s
  pixels (green = tracked landmark, blue = detected only) and a state
  banner. The banner is a 5×7 bitmap font at twice its size, not OpenCV's
  Hershey glyphs.
- `plot_map`: top-down map points, bird points, keyframe path,
  covisibility edges (weight >= 100) and optional ground truth, with a
  metric grid and a legend, on a fixed-size canvas instead of a matplotlib
  figure.
- `plot_trajectories`: estimate (solid) against ground truth (dashed).
Images are BGR uint8, as OpenCV's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import imageio

# BGR colours of the JAX package's plots
GRAY = (153, 153, 153)      # map points, "#999999"
BIRD = (42, 157, 42)        # bird points, "#2a9d2a"
BLUE = (255, 0, 0)          # keyframes / estimate, "b"
CYAN = (255, 255, 0)        # covisibility edges, "c"
RED = (0, 0, 255)           # ground truth, "r"
TRACKED = (0, 255, 0)
DETECTED = (255, 128, 0)

# the pixels `cv2.circle(img, c, 2, color, 1)` sets around an integer c
CIRCLE2 = np.array([(-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 2), (1, -1),
                    (1, 1), (2, 0)])

# 5×7 glyphs, one 5-bit row each (bit 4 = leftmost column)
_FONT = {
    "0": (14, 17, 19, 21, 25, 17, 14), "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31), "3": (31, 2, 4, 2, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2), "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14), "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14), "9": (14, 17, 17, 15, 1, 2, 12),
    "A": (14, 17, 17, 17, 31, 17, 17), "B": (30, 17, 17, 30, 17, 17, 30),
    "C": (14, 17, 16, 16, 16, 17, 14), "D": (28, 18, 17, 17, 17, 18, 28),
    "E": (31, 16, 16, 30, 16, 16, 31), "F": (31, 16, 16, 30, 16, 16, 16),
    "G": (14, 17, 16, 23, 17, 17, 15), "H": (17, 17, 17, 31, 17, 17, 17),
    "I": (14, 4, 4, 4, 4, 4, 14), "J": (7, 2, 2, 2, 2, 18, 12),
    "K": (17, 18, 20, 24, 20, 18, 17), "L": (16, 16, 16, 16, 16, 16, 31),
    "M": (17, 27, 21, 21, 17, 17, 17), "N": (17, 17, 25, 21, 19, 17, 17),
    "O": (14, 17, 17, 17, 17, 17, 14), "P": (30, 17, 17, 30, 16, 16, 16),
    "Q": (14, 17, 17, 17, 21, 18, 13), "R": (30, 17, 17, 30, 20, 18, 17),
    "S": (15, 16, 16, 14, 1, 1, 30), "T": (31, 4, 4, 4, 4, 4, 4),
    "U": (17, 17, 17, 17, 17, 17, 14), "V": (17, 17, 17, 17, 17, 10, 4),
    "W": (17, 17, 17, 21, 21, 21, 10), "X": (17, 17, 10, 4, 10, 17, 17),
    "Y": (17, 17, 17, 10, 4, 4, 4), "Z": (31, 1, 2, 4, 8, 16, 31),
    " ": (0,) * 7, "=": (0, 0, 31, 0, 31, 0, 0),
    ":": (0, 12, 12, 0, 12, 12, 0), ".": (0, 0, 0, 0, 0, 12, 12),
    ",": (0, 0, 0, 0, 12, 4, 8), "-": (0, 0, 0, 31, 0, 0, 0),
    "+": (0, 4, 4, 31, 4, 4, 0), "_": (0, 0, 0, 0, 0, 0, 31),
    "/": (0, 1, 2, 4, 8, 16, 0), "(": (2, 4, 8, 8, 8, 4, 2),
    ")": (8, 4, 2, 2, 2, 4, 8), "%": (24, 25, 2, 4, 8, 19, 3),
    "?": (14, 17, 1, 2, 4, 0, 4),
}


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    """A gray image clipped to [0, 255] as 3-channel uint8 (a BGR image
    passes through)."""
    img = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    return img.copy() if img.ndim == 3 else np.repeat(img[..., None], 3, -1)


def _plot(img, xs, ys, color):
    """Sets the pixels (xs, ys) that lie inside the image."""
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    h, w = img.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[inside], xs[inside]] = color


def draw_text(img: np.ndarray, text: str, org, color, scale: int = 2):
    """The bitmap font's text with its baseline's left end at `org`
    (x, y), as `cv2.putText`'s origin; lower case is drawn in capitals."""
    x0, y0 = int(org[0]), int(org[1]) - 7 * scale + 1
    for k, ch in enumerate(text.upper()):
        rows = np.array(_FONT.get(ch, _FONT["?"]))[:, None]
        glyph = ((rows >> (4 - np.arange(5))) & 1).astype(bool)   # (7, 5)
        gy, gx = np.nonzero(np.kron(glyph, np.ones((scale, scale), bool)))
        _plot(img, x0 + k * 6 * scale + gx, y0 + gy, color)


def line_pixels(p0, p1, thickness: int = 1, dash: int = 0):
    """Pixels of the segment p0 → p1 (x, y), one sample per pixel step
    along its longer axis; thickness 2 adds the pixel right of and below
    each sample; `dash` > 0 keeps alternate runs of that many samples."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    if not np.isfinite(p0).all() or not np.isfinite(p1).all():
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    n = int(np.ceil(np.abs(p1 - p0).max())) + 1
    n = min(n, 1 << 16)
    s = np.linspace(0.0, 1.0, n)[:, None]
    pts = np.rint(p0 + s * (p1 - p0)).astype(np.int64)
    if dash:
        pts = pts[(np.arange(n) // dash) % 2 == 0]
    if thickness > 1:
        offs = [(dx, dy) for dx in range(thickness) for dy in range(thickness)]
        pts = np.concatenate([pts + np.array(o) for o in offs])
    return pts[:, 0], pts[:, 1]


def draw_line(img, p0, p1, color, thickness: int = 1, dash: int = 0):
    _plot(img, *line_pixels(p0, p1, thickness, dash), color)


def draw_frame(img: np.ndarray, kp_xy: np.ndarray, kp_valid: np.ndarray,
               kp_tracked: Optional[np.ndarray] = None,
               state_text: str = "") -> np.ndarray:
    """FrameDrawer::DrawFrame — keypoints as radius-2 circles (green =
    tracked landmark, blue = detected only) and a state banner. Returns a
    BGR uint8 image."""
    out = gray_to_bgr(img)
    idx = np.nonzero(np.asarray(kp_valid))[0]
    xy = np.asarray(kp_xy)[idx].astype(np.float64).astype(np.int64)  # int()
    tracked = (np.asarray(kp_tracked)[idx].astype(bool)
               if kp_tracked is not None else np.zeros(len(idx), bool))
    # every circle's pixels in keypoint order; where circles share a
    # pixel the later keypoint's colour wins, as cv2 draws them one by one
    px = (xy[:, None, :] + CIRCLE2[None, :, ::-1]).reshape(-1, 2)
    col = np.repeat(tracked, len(CIRCLE2))
    h, w = out.shape[:2]
    inside = ((px[:, 0] >= 0) & (px[:, 0] < w) & (px[:, 1] >= 0)
              & (px[:, 1] < h))
    px, col = px[inside], col[inside]
    flat = px[:, 1] * w + px[:, 0]
    _, last = np.unique(flat[::-1], return_index=True)
    last = len(flat) - 1 - last
    palette = np.array([DETECTED, TRACKED], np.uint8)
    out[px[last, 1], px[last, 0]] = palette[col[last].astype(np.int64)]
    if state_text:
        draw_text(out, state_text, (10, 20), (255, 255, 255))
    return out


class _Plot:
    """A white canvas with world → pixel mapping at equal aspect."""

    def __init__(self, points, height: int, width: int, margin: int = 24,
                 top: int = 56):
        """`points`: the (N, 2) world coordinates the view must hold; the
        top `top` pixels stay free for the legend."""
        pts = np.concatenate([np.zeros((0, 2))] + [np.asarray(p, np.float64)
                                                  for p in points])
        pts = pts[np.isfinite(pts).all(1)]
        if not len(pts):
            pts = np.zeros((1, 2))
        lo, hi = pts.min(0), pts.max(0)
        span = np.maximum(hi - lo, 1e-3)
        self.scale = min((width - 2 * margin) / span[0],
                         (height - margin - top) / span[1])
        self.centre = (lo + hi) / 2
        self.h, self.w = height, width
        self.v0 = (height + top - margin) / 2     # pixel row of the centre
        self.img = np.full((height, width, 3), 255, np.uint8)
        self._grid()

    def px(self, uv):
        uv = np.asarray(uv, np.float64).reshape(-1, 2)
        return np.stack([self.w / 2 + (uv[:, 0] - self.centre[0]) * self.scale,
                         self.v0 - (uv[:, 1] - self.centre[1]) * self.scale],
                        -1)

    def _grid(self):
        """Light grid lines at a 1/2/5·10^k metre spacing, ~8 per side."""
        raw = max(self.w, self.h) / self.scale / 8
        e = 10.0 ** np.floor(np.log10(raw))
        step = e * min((m for m in (1, 2, 5, 10) if m * e >= raw),
                       default=10)
        # the world rectangle the canvas shows
        lo = np.array([self.centre[0] - self.w / 2 / self.scale,
                       self.centre[1] - (self.h - self.v0) / self.scale])
        hi = np.array([self.centre[0] + self.w / 2 / self.scale,
                       self.centre[1] + self.v0 / self.scale])
        for axis in (0, 1):
            for g in np.arange(np.ceil(lo[axis] / step),
                               np.floor(hi[axis] / step) + 1) * step:
                a = np.array([[g, lo[1]], [g, hi[1]]]) if axis == 0 else \
                    np.array([[lo[0], g], [hi[0], g]])
                p = self.px(a)
                draw_line(self.img, p[0], p[1], (230, 230, 230))
        draw_text(self.img, f"grid {step:g} m", (8, self.h - 6), (120, 120,
                                                                  120), 1)

    def points(self, uv, color, size=1):
        p = np.floor(self.px(uv)).astype(np.int64)
        for dx in range(size):
            for dy in range(size):
                _plot(self.img, p[:, 0] + dx, p[:, 1] + dy, color)

    def polyline(self, uv, color, dash=0, thickness=1):
        p = self.px(uv)
        for a, b in zip(p[:-1], p[1:]):
            draw_line(self.img, a, b, color, thickness, dash)

    def legend(self, entries):
        for k, (label, color) in enumerate(entries):
            y = 16 + 12 * k
            self.img[y - 6:y + 1, 8:15] = color
            draw_text(self.img, label, (20, y), (40, 40, 40), 1)


def _z_forward(store) -> bool:
    """Heuristic plotting plane: if keyframes spread more in (x,z) than
    (x,y), plot x-z (camera-forward convention)."""
    kfs = store.valid_kf_ids()
    if len(kfs) < 2:
        return True
    C = np.stack([store.kf_center(k) for k in kfs])
    return C[:, 2].std() >= C[:, 1].std()


def plot_map(store, path: str, gt_centers: Optional[np.ndarray] = None,
             show_covis: bool = True, height: int = 480, width: int = 640):
    """MapDrawer equivalent: top-down map points, keyframe positions,
    covisibility edges, optional ground truth. Saves a PNG."""
    zf = _z_forward(store)

    def plane(P):
        P = np.asarray(P, np.float64).reshape(-1, 3)
        return np.stack([P[:, 0], P[:, 2] if zf else P[:, 1]], -1)

    ids, bids, kfs = (store.valid_mp_ids(), store.valid_bmp_ids(),
                      store.valid_kf_ids())
    mp = plane(store.mp_pos[ids]) if len(ids) else np.zeros((0, 2))
    bp = plane(store.bmp_pos[bids]) if len(bids) else np.zeros((0, 2))
    kc = (plane(np.stack([store.kf_center(k) for k in kfs])) if len(kfs)
          else np.zeros((0, 2)))
    gt = (np.asarray(gt_centers, np.float64)[:, :2] if gt_centers is not None
          else np.zeros((0, 2)))
    plot = _Plot([mp, bp, kc, gt], height, width)
    entries = []
    if len(mp):
        plot.points(mp, GRAY, 1)
        entries.append(("map points", GRAY))
    if len(bp):
        plot.points(bp, BIRD, 2)
        entries.append(("bird points", BIRD))
    if len(kc):
        if show_covis:
            sub = store.covis[np.ix_(kfs, kfs)]
            a, b = np.nonzero(np.triu(sub >= 100, 1))
            for i, j in zip(a, b):
                plot.polyline(kc[[i, j]], CYAN)
        plot.polyline(kc, BLUE)
        plot.points(kc - 1.0 / plot.scale, BLUE, 3)
        entries.append(("keyframes", BLUE))
    if len(gt):
        plot.polyline(gt, RED, dash=4)
        entries.append(("ground truth", RED))
    plot.legend(entries)
    imageio.imwrite(path, plot.img)


def plot_trajectories(est: np.ndarray, gt: Optional[np.ndarray], path: str,
                      height: int = 480, width: int = 640):
    """x-y of the estimate (blue, solid) and of the ground truth (red,
    dashed), saved as a PNG."""
    est = np.asarray(est, np.float64)[:, :2]
    g = np.asarray(gt, np.float64)[:, :2] if gt is not None else \
        np.zeros((0, 2))
    plot = _Plot([est, g], height, width)
    plot.polyline(est, BLUE)
    entries = [("estimate", BLUE)]
    if len(g):
        plot.polyline(g, RED, dash=4)
        entries.append(("ground truth", RED))
    plot.legend(entries)
    imageio.imwrite(path, plot.img)
