"""ORB extraction in PyTorch: pyramid, FAST, orientation, steered BRIEF.

A port of the JAX package's `frontend/orb.py` with the same fixed-shape,
mask-based design (invalid slots are masked, never dropped) and the same
numerics where they decide integers:

- the pyramid is integer-valued (rounded after every resize, as cv::ORB
  keeps uint8 levels). The resize is written as its two taps per output
  pixel: rows accumulate as fma(w1, x1, w0·x0), columns as w0·y0 + w1·y1.
  The reference's two banded matmuls take one of these two orders or the
  other on the CPU, depending on the shape; this fixed choice matches them
  bit for bit at the front stream's full 950×400, and elsewhere about 1
  pixel in 10^4 rounds the other way (by 1). The taps are deterministic on
  the CPU and the GPU alike, where a matmul would sum in yet another order;
- keypoint selection keeps the first of equal values everywhere: per-cell
  `argmax` and a stable descending sort in place of `approx_max_k`;
- the patch gather is the port's CUDA kernel (`patch_kernel.py`);
- BRIEF samples the rounded blurred patches with one indexed gather where
  the TPU used one-hot matmuls; the bits are the same.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from . import patch_kernel
from .keypoints import Keypoints, pack_bits, unpack_bits_to_pm1

HALF_PATCH = 15  # orientation patch radius
EDGE_MARGIN = 19  # min distance of a keypoint from the level border

# FAST-16 Bresenham circle (x=col, y=row), OpenCV tap order.
FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

_PATTERN = np.load(Path(__file__).parent / "orb_pattern.npy")  # (256,4) x1,y1,x2,y2


def _umax_table() -> np.ndarray:
    """OpenCV's circular-patch row extents for IC_Angle."""
    umax = np.zeros(HALF_PATCH + 2, dtype=np.int64)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: HALF_PATCH + 1]


def _ic_angle_offsets():
    """(P,2) int32 (dv, du) offsets inside the circular orientation patch."""
    umax = _umax_table()
    offs = []
    for dv in range(-HALF_PATCH, HALF_PATCH + 1):
        u = int(umax[abs(dv)])
        for du in range(-u, u + 1):
            offs.append((dv, du))
    return np.array(offs, dtype=np.int32)


_IC_OFFSETS = _ic_angle_offsets()  # (~707, 2)

_ARC_PATTERNS = [(((0x1FF << k) | (0x1FF >> (16 - k))) & 0xFFFF)
                 for k in range(16)]


class ORBConfig(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0   # main threshold (iniThFAST)
    min_threshold: float = 7.0     # fallback threshold (minThFAST)
    cell: int = 16                 # spatial-uniformity cell size (px)
    per_cell: int = 4              # candidates kept per cell before global top-k

    def level_scales(self) -> list[float]:
        return [self.scale_factor ** l for l in range(self.n_levels)]

    def level_budgets(self) -> list[int]:
        """Geometric per-level feature budget (ORBextractor.cc:435-446)."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        budgets = [int(round(n0 * f ** l)) for l in range(self.n_levels - 1)]
        budgets.append(max(self.n_features - sum(budgets), 0))
        return budgets

    def padded_capacity(self) -> int:
        """Length of the Keypoints arrays `extract_orb` returns: per-level
        budgets (each ≥1) summed, rounded up to a multiple of 128."""
        total = sum(max(b, 1) for b in self.level_budgets())
        return -(-total // 128) * 128


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device):
    """Constant tables on a device, made once per device."""
    if name == "fast_weights":
        return torch.tensor([1 << k for k in range(16)], dtype=torch.int32,
                            device=device)[:, None, None]
    if name == "ic_du" or name == "ic_dv":
        du = np.zeros((31, 31), np.float32)
        dv = np.zeros((31, 31), np.float32)
        for v, u in _IC_OFFSETS:
            du[v + 15, u + 15] = u
            dv[v + 15, u + 15] = v
        return torch.from_numpy(du if name == "ic_du" else dv).to(device)
    if name == "brief_px" or name == "brief_py":
        cols = [0, 2] if name == "brief_px" else [1, 3]
        return torch.from_numpy(
            _PATTERN[:, cols].T.reshape(-1).astype(np.float32)).to(device)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# Pyramid + blur
# ---------------------------------------------------------------------------

def _gauss7() -> np.ndarray:
    """The 7 taps of the Gaussian with sigma=2, normalized, in f32."""
    k1 = np.array([np.exp(-(i * i) / (2 * 2.0 ** 2)) for i in range(-3, 4)])
    return (k1 / k1.sum()).astype(np.float32)


def gaussian_blur7(img):
    """7x7 Gaussian, sigma=2, reflect-101 border — cv::GaussianBlur parity.
    Separable: along rows, then along columns."""
    k = torch.from_numpy(_gauss7()).to(img.device)
    x = F.pad(img[None, None], (3, 3, 3, 3), mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, 1, 7))
    return F.conv2d(x, k.reshape(1, 1, 7, 1))[0, 0]


@functools.lru_cache(maxsize=None)
def _resize_taps(n_out: int, n_in: int, device: torch.device):
    """The two taps of bilinear interpolation with half-pixel centres
    (cv::resize INTER_LINEAR): (i0, i1, w0, w1) per output index. Where the
    clamp puts both taps on one pixel their weights merge into one, as they
    do in the reference's dense interpolation matrix."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    a = (src - i0).astype(np.float32)
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    w0 = (1.0 - a).astype(np.float32)
    w1 = a.copy()
    same = i0c == i1c
    w0[same] = w0[same] + w1[same]
    w1[same] = 0.0
    return tuple(torch.from_numpy(v).to(device) for v in (i0c, i1c, w0, w1))


def resize_bilinear(img, h: int, w: int):
    """cv::resize INTER_LINEAR equivalent (half-pixel centres): the
    reference's A_h @ img @ A_wᵀ written as two taps (see module doc)."""
    H, W = img.shape
    r0, r1, a0, a1 = _resize_taps(h, H, img.device)
    c0, c1, b0, b1 = _resize_taps(w, W, img.device)
    # rows: one rounding of w1·x1 + round(w0·x0), i.e. a fused multiply-add
    # (exact in f64 here: both products of f32 values fit its mantissa)
    p0 = a0[:, None] * img[r0]
    y = (a1[:, None].double() * img[r1].double() + p0.double()).float()
    # columns: two rounded products and a rounded sum
    return b0[None, :] * y[:, c0] + b1[None, :] * y[:, c1]


def level_sizes(h: int, w: int, cfg: ORBConfig) -> list[tuple[int, int]]:
    return [(int(round(h / s)), int(round(w / s))) for s in cfg.level_scales()]


# ---------------------------------------------------------------------------
# FAST
# ---------------------------------------------------------------------------

def _circle_views(img):
    """(16, H, W) stack of the 16 circle-tap images (edge-padded)."""
    H, W = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    return torch.stack([pad[3 + int(dy):3 + int(dy) + H, 3 + int(dx):3 + int(dx) + W]
                        for dx, dy in FAST_OFFSETS])


def fast_response(img, threshold):
    """FAST-9/16 corner mask + response.

    Returns (response (H,W) float32, corner (H,W) bool). The response is the
    bright/dark excess sum (original FAST score), 0 where not a corner.
    """
    taps = _circle_views(img)
    c = img[None]
    bright = taps > c + threshold
    dark = taps < c - threshold
    wb = _const("fast_weights", img.device)
    bbits = (bright.to(torch.int32) * wb).sum(dim=0, dtype=torch.int32)
    dbits = (dark.to(torch.int32) * wb).sum(dim=0, dtype=torch.int32)
    is_b = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    is_d = torch.zeros_like(is_b)
    for pk in _ARC_PATTERNS:
        is_b = is_b | ((bbits & pk) == pk)
        is_d = is_d | ((dbits & pk) == pk)
    corner = is_b | is_d
    sb = torch.where(bright, taps - c - threshold, 0.0).sum(dim=0)
    sd = torch.where(dark, c - taps - threshold, 0.0).sum(dim=0)
    resp = torch.where(is_b, sb, 0.0) + torch.where(is_d, sd, 0.0)
    return resp, corner


def nms3(resp):
    """3x3 non-max suppression; keeps ties."""
    m = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(resp >= m, resp, 0.0)


# ---------------------------------------------------------------------------
# Spatially-uniform top-k selection (octree replacement)
# ---------------------------------------------------------------------------

def _resp_to_cells(resp, cell: int):
    """(H,W) response -> ((ncells, cell²) rows, ncy, ncx)."""
    H, W = resp.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    r = F.pad(resp, (0, Wp - W, 0, Hp - H))
    ncy, ncx = Hp // cell, Wp // cell
    cells = r.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell)
    return cells, ncy, ncx


def _cells_topk(cells, per_cell: int):
    """Per-cell top-k by iterated max (`argmax` returns the first of equal
    values, as the reference's does). Returns (vals, idx), (ncells, per_cell)."""
    lanes = torch.arange(cells.shape[1], device=cells.device)
    rem = cells
    vals_l, idx_l = [], []
    for _ in range(per_cell):
        i = torch.argmax(rem, dim=1)
        vals_l.append(torch.gather(rem, 1, i[:, None])[:, 0])
        idx_l.append(i)
        rem = torch.where(lanes[None, :] == i[:, None], -math.inf, rem)
    return torch.stack(vals_l, dim=1), torch.stack(idx_l, dim=1)


def _pick_topk(vals, idx, k_out: int, cell: int, ncx: int):
    """Global rank-penalized top-k over one level's per-cell candidates:
    every cell's best ranks above any cell's second-best. The reference's
    `approx_max_k` is an exact top-k off the TPU, with ties to the lower
    index; a stable descending sort gives exactly that order."""
    per_cell = vals.shape[1]
    valid_cand = vals > 0.0
    rank_pen = (torch.arange(per_cell, dtype=vals.dtype, device=vals.device)
                * torch.tensor(1e7, dtype=vals.dtype))
    comp = torch.where(valid_cand, vals - rank_pen[None, :], -math.inf)
    top_comp, top_idx = torch.sort(comp.reshape(-1), descending=True,
                                   stable=True)
    top_comp, top_idx = top_comp[:k_out], top_idx[:k_out]
    cell_id = top_idx // per_cell
    pix = idx.reshape(-1)[top_idx]
    cy, cx = cell_id // ncx, cell_id % ncx
    dy, dx = pix // cell, pix % cell
    ys = cy * cell + dy
    xs = cx * cell + dx
    valid = top_comp > -math.inf
    resp_out = vals.reshape(-1)[top_idx]
    return ys, xs, torch.where(valid, resp_out, 0.0), valid


def select_uniform_topk(resp, k_out: int, cell: int, per_cell: int):
    """Pick k_out keypoints, spatially balanced (see _pick_topk).
    Returns (ys, xs, resp_out, valid)."""
    cells, _, ncx = _resp_to_cells(resp, cell)
    vals, idx = _cells_topk(cells, per_cell)
    return _pick_topk(vals, idx, k_out, cell, ncx)


# ---------------------------------------------------------------------------
# Orientation + BRIEF on per-keypoint patches
# ---------------------------------------------------------------------------

PATCH = 48          # patch side; center pixel at (24, 24)
PATCH_C = 24        # covers BRIEF's rotated reach (±18) + blur margin (±3)
BLUR_PATCH = PATCH - 6   # after VALID 7x7 blur; center at 21
BLUR_C = PATCH_C - 3


def _pad_for_patches(img, size: int):
    pad = size // 2
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def extract_patches(img, ys, xs, size: int = PATCH):
    """(K,) int coords -> (K,size,size) patches centred at (y,x), cut from
    the edge-padded image by the patch-gather kernel."""
    return patch_kernel.gather_patches(_pad_for_patches(img, size),
                                       ys.to(torch.int32), xs.to(torch.int32),
                                       size)


def extract_patches_levels(imgs, ys_levels, xs_levels, size: int = PATCH):
    """`extract_patches` for all levels of one extraction in one call of
    the patch-gather kernel: lists of (H_l,W_l) images and (K_l,) int
    coords -> (ΣK_l,size,size), level 0 first."""
    counts = [ys.shape[0] for ys in ys_levels]
    # one cast for all levels; the kernel reads each level's slice in place
    ys32 = torch.cat(ys_levels).to(torch.int32).split(counts)
    xs32 = torch.cat(xs_levels).to(torch.int32).split(counts)
    return patch_kernel.gather_patches_levels(
        [_pad_for_patches(img, size) for img in imgs], ys32, xs32, size)


@functools.lru_cache(maxsize=None)
def _blur_matrix(n_in: int, device: torch.device):
    """Banded (n_in−6, n_in) matrix applying the 7-tap Gaussian (sigma=2)
    as a VALID 1-D convolution."""
    k1 = _gauss7()
    n_out = n_in - 6
    B = np.zeros((n_out, n_in), np.float32)
    for j in range(7):
        B[np.arange(n_out), np.arange(n_out) + j] = k1[j]
    return torch.from_numpy(B).to(device)


def blur_patches(patches):
    """7x7 Gaussian (sigma=2) per patch, VALID, as the reference's two
    banded matmuls B @ patch @ Bᵀ."""
    B = _blur_matrix(patches.shape[-1], patches.device)
    y = torch.einsum("oi,kij->koj", B, patches)
    return torch.einsum("koj,pj->kop", y, B)


def ic_angle_from_patches(patches):
    """(K,S,S) raw patches -> orientation (K,) radians [0,2π). The moments
    are sums of integer products below 2^24, so exact in f32 in any order."""
    c = PATCH_C
    sub = patches[:, c - 15: c + 16, c - 15: c + 16]
    m10 = torch.einsum("kij,ij->k", sub, _const("ic_du", patches.device))
    m01 = torch.einsum("kij,ij->k", sub, _const("ic_dv", patches.device))
    ang = torch.atan2(m01, m10)
    return torch.where(ang < 0, ang + 2 * math.pi, ang)


def brief_from_patches(patches_blur, angle):
    """Steered BRIEF-256 from blurred patches (K,Sb,Sb) centred at BLUR_C.

    The blurred samples are compared as integers, as the reference does
    (cv2 blurs the uint8 image); each of the 512 rotated taps is read with
    one gather from the rounded patch."""
    K, S = patches_blur.shape[0], patches_blur.shape[-1]
    px = _const("brief_px", angle.device)
    py = _const("brief_py", angle.device)
    a = torch.cos(angle)[:, None]
    b = torch.sin(angle)[:, None]
    rx = torch.round(px[None, :] * a - py[None, :] * b).to(torch.int64)
    ry = torch.round(px[None, :] * b + py[None, :] * a).to(torch.int64)
    row = torch.clamp(BLUR_C + ry, 0, S - 1)  # (K,512)
    col = torch.clamp(BLUR_C + rx, 0, S - 1)
    pb = torch.round(patches_blur).reshape(K, S * S)
    samp = torch.gather(pb, 1, row * S + col)
    return pack_bits(samp[:, :256] < samp[:, 256:])


def ic_angle(img, ys, xs):
    """Intensity-centroid orientation (K,) at integer coords (K,) of a
    whole image, through the patch path: on a CUDA tensor `extract_patches`
    launches the patch-gather kernel once."""
    return ic_angle_from_patches(extract_patches(img, ys, xs))


def brief_descriptors(img_blur, ys, xs, angle):
    """Steered BRIEF-256 at integer coords on an already-blurred image:
    the (K, BLUR_PATCH, BLUR_PATCH) windows of the edge-padded image,
    centred at BLUR_C, through `brief_from_patches`."""
    S = BLUR_PATCH
    padded = _pad_for_patches(img_blur, S)
    r = torch.arange(S, device=img_blur.device)
    rows = ys.to(torch.int64)[:, None, None] + r[None, :, None]
    cols = xs.to(torch.int64)[:, None, None] + r[None, None, :]
    return brief_from_patches(padded[rows, cols], angle)


def _subpixel_offsets(resp, ys, xs):
    """1-D parabola fits on the detector response around each corner.
    Returns (dx, dy) in (−0.5, 0.5)."""
    H, W = resp.shape
    yc = torch.clamp(ys, 1, H - 2)
    xc = torch.clamp(xs, 1, W - 2)

    def fit(m, c, p):
        denom = 2.0 * (2.0 * c - m - p)
        off = (p - m) / torch.where(denom.abs() > 1e-6, denom, 1e-6)
        return torch.clamp(off, -0.5, 0.5)

    c = resp[yc, xc]
    left, right = resp[yc, xc - 1], resp[yc, xc + 1]
    up, down = resp[yc - 1, xc], resp[yc + 1, xc]
    dx = fit(left, c, right)
    dy = fit(up, c, down)
    # NMS zeroes the neighbours of isolated maxima; refine only when both
    # neighbours carry response
    okx = (left > 0) & (right > 0)
    oky = (up > 0) & (down > 0)
    return torch.where(okx, dx, 0.0), torch.where(oky, dy, 0.0)


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _border_mask(h: int, w: int, margin: int, device: torch.device):
    m = torch.zeros((h, w), dtype=torch.float32)
    if h > 2 * margin and w > 2 * margin:
        m[margin: h - margin, margin: w - margin] = 1.0
    return m.to(device)


def _extract_impl(img, mask, cfg: ORBConfig) -> Keypoints:
    height, width = img.shape
    dev = img.device
    sizes = level_sizes(height, width, cfg)
    budgets = cfg.level_budgets()
    scales = cfg.level_scales()

    out_xy, out_resp, out_oct, out_val = [], [], [], []
    lvl_imgs, lvl_ys, lvl_xs = [], [], []
    lvl_img = torch.round(img)
    for l in range(cfg.n_levels):
        h, w = sizes[l]
        if l > 0:
            lvl_img = torch.round(resize_bilinear(lvl_img, h, w))
        resp, corner = fast_response(lvl_img, cfg.min_threshold)
        resp = torch.where(corner, resp, 0.0)
        resp = resp * _border_mask(h, w, EDGE_MARGIN, dev)
        if mask is not None:
            lvl_mask = resize_bilinear(mask, h, w) > 0.5
            resp = torch.where(lvl_mask, resp, 0.0)
        resp_raw = resp
        resp = nms3(resp)
        k_l = max(budgets[l], 1)
        ys, xs, r, valid = select_uniform_topk(resp, k_l, cfg.cell,
                                               cfg.per_cell)
        lvl_imgs.append(lvl_img)
        lvl_ys.append(ys)
        lvl_xs.append(xs)
        # subpixel refinement: quadratic fit on the response surface
        dx, dy = _subpixel_offsets(resp_raw, ys, xs)
        s = scales[l]
        out_xy.append(torch.stack([(xs.float() + dx) * s,
                                   (ys.float() + dy) * s], -1))
        out_resp.append(r)
        out_oct.append(torch.full((k_l,), l, dtype=torch.int32, device=dev))
        out_val.append(valid)

    xy = torch.cat(out_xy, 0)
    response = torch.cat(out_resp, 0)
    octave = torch.cat(out_oct, 0)
    valid = torch.cat(out_val, 0)
    # one gather for all levels, then orientation + BRIEF over its patches
    patches_all = extract_patches_levels(lvl_imgs, lvl_ys, lvl_xs)
    angle = ic_angle_from_patches(patches_all)
    desc_u8 = brief_from_patches(blur_patches(patches_all), angle)

    # capacity padded to a multiple of 128, as in the reference
    total = xy.shape[0]
    pad = -(-total // 128) * 128 - total
    if pad:
        xy = F.pad(xy, (0, 0, 0, pad))
        response = F.pad(response, (0, pad))
        angle = F.pad(angle, (0, pad))
        octave = F.pad(octave, (0, pad))
        valid = F.pad(valid, (0, pad))
        desc_u8 = F.pad(desc_u8, (0, 0, 0, pad))

    desc_u8 = torch.where(valid[:, None], desc_u8, 0).to(torch.uint8)
    desc_pm1 = torch.where(valid[:, None], unpack_bits_to_pm1(desc_u8),
                           0).to(torch.int8)
    return Keypoints(
        xy=xy,
        response=torch.where(valid, response, -math.inf),
        angle=angle,
        octave=octave,
        valid=valid,
        desc_u8=desc_u8,
        desc_pm1=desc_pm1,
    )


def extract_orb(img, cfg: ORBConfig = ORBConfig(), mask=None,
                device=None) -> Keypoints:
    """Extract ORB features from a grayscale image (H,W) in [0,255].

    `mask`, if given, restricts detection (nonzero = allowed) — the BEV
    stream's vehicle-footprint mask. Runs on `cuda` unless `device` says
    otherwise; inputs are moved there."""
    dev = resolve_device(device)
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    return _extract_impl(img, mask, cfg)
