"""ORB features of one image, written plainly from the extractor's
specification, level by level, in the precision it is handed.

The specification (the program's extractor, an ORB-SLAM2 front end with a
grid in place of the octree):
- the pyramid: level l has round(H / s^l) × round(W / s^l) pixels and is
  resized from level l − 1 by bilinear interpolation with half-pixel
  centres (cv::resize INTER_LINEAR, float32 coefficients), then rounded
  to whole grey values, half to even;
- FAST-9 on the 16-pixel circle at the minimum threshold; the response is
  the summed excess of the arc's pixels over the threshold; nothing within
  19 pixels of a level's border, nor outside the mask (resized to the
  level, kept above one half);
- 3×3 non-maximum suppression that keeps ties; in every 16×16 cell the 4
  strongest (ties to the first in row order), then across the level every
  cell's best before any cell's second, each rank by response (ties to
  the lower cell), up to the level's share of the features (ORB-SLAM2's
  geometric split);
- a parabola through the raw response about each corner, in x and in y
  where both neighbours respond, at most half a pixel;
- the intensity-centroid angle over the circle of radius 15;
- steered BRIEF-256 (OpenCV's pattern) on the level blurred by a 7×7
  Gaussian of sigma 2 (float32 taps, edges replicated) and rounded.

Resizing and blurring are matrix products, the way one writes them
plainly, so that TF32 (the control) reaches them.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

MARGIN = 19
CELL = 16
PER_CELL = 4
RADIUS = 15
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
          (-1, -3))
PATTERN = np.load(Path(__file__).parent / "orb_pattern.npy")  # x1 y1 x2 y2


class Features(NamedTuple):
    """One image's keypoints in the extractor's order (level by level,
    strongest first); positions in level-0 pixels."""
    xy: torch.Tensor        # (K, 2)
    octave: torch.Tensor    # (K,) int64
    bits: torch.Tensor      # (K, 256) bool, bit 8j+k = byte j's bit k


class Extractor(NamedTuple):
    n_features: int
    n_levels: int
    scale_factor: float
    min_threshold: float

    def budgets(self) -> list[int]:
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        out = [int(round(n0 * f ** l)) for l in range(self.n_levels - 1)]
        return out + [max(self.n_features - sum(out), 0)]


def interp_matrix(n_out: int, n_in: int, dtype, device) -> torch.Tensor:
    """(n_out, n_in) bilinear interpolation, half-pixel centres, edge
    clamped, float32 coefficients."""
    A = np.zeros((n_out, n_in), np.float64)
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    a = (src - lo).astype(np.float32)
    w0 = np.float32(1.0) - a
    rows = np.arange(n_out)
    np.add.at(A, (rows, np.clip(lo, 0, n_in - 1)), w0)
    np.add.at(A, (rows, np.clip(lo + 1, 0, n_in - 1)), a)
    return torch.as_tensor(A, dtype=dtype, device=device)


def resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    H, W = img.shape
    Ah = interp_matrix(h, H, img.dtype, img.device)
    Aw = interp_matrix(w, W, img.dtype, img.device)
    return Ah @ img @ Aw.T


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """7×7 Gaussian of sigma 2, edges replicated, as two banded products."""
    k = np.exp(-np.arange(-3, 4) ** 2 / 8.0)
    k = (k / k.sum()).astype(np.float32)
    H, W = img.shape

    def band(n):
        B = np.zeros((n, n + 6), np.float64)
        for j in range(7):
            B[np.arange(n), np.arange(n) + j] = k[j]
        return torch.as_tensor(B, dtype=img.dtype, device=img.device)

    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    return band(H) @ p @ band(W).T


def fast(img: torch.Tensor, th: float) -> torch.Tensor:
    """FAST-9 response, 0 where no arc of 9."""
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                        for dx, dy in CIRCLE])
    out = torch.zeros_like(img)
    for sign in (1.0, -1.0):
        excess = sign * (ring - img) - th          # > 0 on the arc
        on = excess > 0
        twice = torch.cat([on, on[:8]])             # arcs wrap around
        arc = torch.zeros_like(img, dtype=torch.bool)
        for s in range(16):
            arc |= twice[s:s + 9].all(dim=0)
        out = out + torch.where(arc, torch.where(on, excess, 0).sum(0), 0)
    return out


def _select(resp: torch.Tensor, k_out: int):
    """(ys, xs) of the level's kept corners, in the extractor's order."""
    H, W = resp.shape
    Hp, Wp = -(-H // CELL) * CELL, -(-W // CELL) * CELL
    r = F.pad(resp, (0, Wp - W, 0, Hp - H))
    ncx = Wp // CELL
    cells = r.reshape(Hp // CELL, CELL, ncx, CELL).permute(0, 2, 1, 3)
    cells = cells.reshape(-1, CELL * CELL)
    # in each cell: strongest first, ties to the first pixel in row order
    order = torch.sort(cells, dim=1, descending=True, stable=True).indices
    top = order[:, :PER_CELL]
    vals = torch.gather(cells, 1, top)
    n_cells = cells.shape[0]
    rank = torch.arange(PER_CELL, device=resp.device).expand(n_cells, -1)
    cell = torch.arange(n_cells, device=resp.device)[:, None].expand(
        -1, PER_CELL)
    ok = vals > 0
    rank, cell, vals, top = rank[ok], cell[ok], vals[ok], top[ok]
    # rank first, then response, then the cell
    key = torch.argsort(cell, stable=True)
    key = key[torch.argsort(vals[key], descending=True, stable=True)]
    key = key[torch.argsort(rank[key], stable=True)][:k_out]
    cell, top = cell[key], top[key]
    ys = (cell // ncx) * CELL + top // CELL
    xs = (cell % ncx) * CELL + top % CELL
    return ys, xs


def _parabola(resp, ys, xs):
    H, W = resp.shape
    yc, xc = ys.clamp(1, H - 2), xs.clamp(1, W - 2)
    c = resp[yc, xc]

    def fit(m, p):
        den = 2.0 * (2.0 * c - m - p)
        den = torch.where(den.abs() > 1e-6, den, torch.full_like(den, 1e-6))
        off = ((p - m) / den).clamp(-0.5, 0.5)
        return torch.where((m > 0) & (p > 0), off, 0.0)

    return (fit(resp[yc, xc - 1], resp[yc, xc + 1]),
            fit(resp[yc - 1, xc], resp[yc + 1, xc]))


def _circle_offsets():
    """(dv, du) of the orientation patch (OpenCV's umax rows)."""
    umax = [0] * (RADIUS + 2)
    vmax = int(math.floor(RADIUS * math.sqrt(2) / 2 + 1))
    vmin = int(math.ceil(RADIUS * math.sqrt(2) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(RADIUS * RADIUS - v * v)))
    v0 = 0
    for v in range(RADIUS, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return [(dv, du) for dv in range(-RADIUS, RADIUS + 1)
            for du in range(-umax[abs(dv)], umax[abs(dv)] + 1)]


OFFSETS = np.array(_circle_offsets(), np.int64)


def _angle(img, ys, xs):
    dv = torch.as_tensor(OFFSETS[:, 0], device=img.device)
    du = torch.as_tensor(OFFSETS[:, 1], device=img.device)
    v = img[ys[:, None] + dv, xs[:, None] + du]
    m01 = (v * dv.to(img.dtype)).sum(1)
    m10 = (v * du.to(img.dtype)).sum(1)
    a = torch.atan2(m01, m10)
    return torch.where(a < 0, a + 2 * math.pi, a)


def _brief(blur, ys, xs, angle):
    pat = torch.as_tensor(PATTERN, dtype=blur.dtype, device=blur.device)
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

    def sample(x, y):
        rx = torch.round(x * c - y * s).long()
        ry = torch.round(x * s + y * c).long()
        return blur[ys[:, None] + ry, xs[:, None] + rx]

    return (sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3]))


def extract(img, ex: Extractor, dtype, mask=None) -> Features:
    """Keypoints of a grey image (uint8 or whole values), in `dtype`."""
    img = torch.round(torch.as_tensor(img).to(dtype))
    H, W = img.shape
    m0 = None if mask is None else torch.as_tensor(mask).to(dtype)
    xy, octave, bits = [], [], []
    level = img
    for l, budget in enumerate(ex.budgets()):
        s = ex.scale_factor ** l
        h, w = int(round(H / s)), int(round(W / s))
        if l:
            level = torch.round(resize(level, h, w))
        resp = fast(level, ex.min_threshold)
        inner = torch.zeros_like(resp, dtype=torch.bool)
        if h > 2 * MARGIN and w > 2 * MARGIN:
            inner[MARGIN:h - MARGIN, MARGIN:w - MARGIN] = True
        if m0 is not None:
            inner &= resize(m0, h, w) > 0.5
        resp = torch.where(inner, resp, 0)
        peak = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
        ys, xs = _select(torch.where(resp >= peak, resp, 0), max(budget, 1))
        dx, dy = _parabola(resp, ys, xs)
        xy.append(torch.stack([(xs + dx) * s, (ys + dy) * s], -1))
        octave.append(torch.full_like(ys, l))
        bits.append(_brief(torch.round(gaussian_blur(level)), ys, xs,
                           _angle(level, ys, xs)))
    return Features(torch.cat(xy), torch.cat(octave), torch.cat(bits))


def unpack(desc_u8: torch.Tensor) -> torch.Tensor:
    """(…, 32) uint8 -> (…, 256) bool, bit 8j+k = byte j's bit k."""
    w = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                     device=desc_u8.device)
    b = (desc_u8[..., None] & w) != 0
    return b.reshape(*desc_u8.shape[:-1], 256)
