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
- the detection of every level (pyramid, FAST, suppression, selection,
  sub-pixel fit: `detect_levels`) is the port's CUDA kernels on the card
  (`detect_kernel.py`), bit for bit `detect_levels_plain`, which CPU
  tensors take;
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
from . import detect_kernel, patch_kernel
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


def _resize_taps_np(n_out: int, n_in: int):
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
    return i0c, i1c, w0, w1


@functools.lru_cache(maxsize=None)
def _resize_taps(n_out: int, n_in: int, device: torch.device):
    """`_resize_taps_np` on a device, made once per device."""
    return tuple(torch.from_numpy(v).to(device)
                 for v in _resize_taps_np(n_out, n_in))


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


class Detection(NamedTuple):
    """One extraction's detection, every level's slots in level order.

    `padded`: each level's image, edge-padded by PATCH // 2 for the patch
    gather; `ys`, `xs`: (K,) int32 keypoint coordinates on their level, K
    the levels' slots summed; `xy` (C,2), `response` (C,), `octave` (C,)
    int32 and `valid` (C,) bool, C the capacity (`padded_capacity`): image
    coordinates, the response (−inf where not valid) and the level of each
    slot, with the slots past K empty."""
    padded: list
    ys: torch.Tensor
    xs: torch.Tensor
    xy: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    valid: torch.Tensor

    @property
    def levels(self) -> list:
        """The level images: views of `padded` without the padding."""
        c = PATCH // 2
        return [p[c:p.shape[0] - c, c:p.shape[1] - c] for p in self.padded]


def detect_level_plain(lvl_img, mask, level: int, cfg: ORBConfig):
    """One pyramid level's detection: FAST at `min_threshold` inside the
    border margin (and the mask, resized to the level, where given), 3×3
    suppression, the spatially uniform pick of the level's slots and the
    sub-pixel fit. Returns (ys, xs, xy, response, valid), response 0 where
    not valid."""
    h, w = lvl_img.shape
    resp, corner = fast_response(lvl_img, cfg.min_threshold)
    resp = torch.where(corner, resp, 0.0)
    resp = resp * _border_mask(h, w, EDGE_MARGIN, lvl_img.device)
    if mask is not None:
        lvl_mask = resize_bilinear(mask, h, w) > 0.5
        resp = torch.where(lvl_mask, resp, 0.0)
    k_l = max(cfg.level_budgets()[level], 1)
    ys, xs, r, valid = select_uniform_topk(nms3(resp), k_l, cfg.cell,
                                           cfg.per_cell)
    # subpixel refinement: quadratic fit on the response surface
    dx, dy = _subpixel_offsets(resp, ys, xs)
    s = cfg.level_scales()[level]
    xy = torch.stack([(xs.float() + dx) * s, (ys.float() + dy) * s], -1)
    return ys, xs, xy, r, valid


def detect_levels_plain(img, mask, cfg: ORBConfig) -> Detection:
    """The plain version of `detect_levels`: the integer-valued pyramid
    (rounded after every resize, as cv::ORB keeps uint8 levels), each
    level through `detect_level_plain`."""
    height, width = img.shape
    sizes = level_sizes(height, width, cfg)
    padded, ys_l, xs_l, xy_l, resp_l, oct_l, val_l = ([] for _ in range(7))
    lvl_img = torch.round(img)
    for l, (h, w) in enumerate(sizes):
        if l > 0:
            lvl_img = torch.round(resize_bilinear(lvl_img, h, w))
        ys, xs, xy, r, valid = detect_level_plain(lvl_img, mask, l, cfg)
        padded.append(_pad_for_patches(lvl_img, PATCH))
        ys_l.append(ys)
        xs_l.append(xs)
        xy_l.append(xy)
        resp_l.append(r)
        oct_l.append(torch.full((ys.shape[0],), l, dtype=torch.int32,
                                device=img.device))
        val_l.append(valid)
    valid = torch.cat(val_l)
    # capacity padded to a multiple of 128, as in the reference
    pad = cfg.padded_capacity() - valid.shape[0]
    valid = F.pad(valid, (0, pad))
    return Detection(
        padded=padded,
        ys=torch.cat(ys_l).to(torch.int32),
        xs=torch.cat(xs_l).to(torch.int32),
        xy=F.pad(torch.cat(xy_l), (0, 0, 0, pad)),
        response=torch.where(valid, F.pad(torch.cat(resp_l), (0, pad)),
                             -math.inf),
        octave=F.pad(torch.cat(oct_l), (0, pad)),
        valid=valid)


@functools.lru_cache(maxsize=None)
def _detect_plan(height: int, width: int, mask_shape, cfg: ORBConfig,
                 device: torch.device) -> detect_kernel.Plan:
    """The kernels' layout and resize taps for one image size, mask size
    and configuration, made once per device."""
    sizes = level_sizes(height, width, cfg)
    taps = []
    for l, (h, w) in enumerate(sizes):
        prev = sizes[l - 1] if l else None
        taps.append((
            _resize_taps_np(h, prev[0]) if l else None,
            _resize_taps_np(w, prev[1]) if l else None,
            _resize_taps_np(h, mask_shape[0]) if mask_shape else None,
            _resize_taps_np(w, mask_shape[1]) if mask_shape else None))
    return detect_kernel.Plan(
        (height, width), sizes, [max(b, 1) for b in cfg.level_budgets()],
        cfg.level_scales(), cfg.cell, cfg.per_cell, cfg.min_threshold,
        EDGE_MARGIN, PATCH // 2, cfg.padded_capacity(), taps, mask_shape,
        device)


def detect_levels(img, mask, cfg: ORBConfig) -> Detection:
    """Every level's detection for one (H,W) float32 image and optional
    mask (nonzero = allowed). CPU tensors take `detect_levels_plain`; CUDA
    tensors launch the kernels of `detect_kernel` once (contiguous float32
    on one device; anything else raises)."""
    dev = img.device
    if dev.type == "cpu":
        return detect_levels_plain(img, mask, cfg)
    if img.dim() != 2 or (mask is not None and mask.dim() != 2):
        raise ValueError("detect_levels: the image and the mask must be 2-D")
    plan = _detect_plan(img.shape[0], img.shape[1],
                        None if mask is None else tuple(mask.shape), cfg, dev)
    return Detection(*detect_kernel.detect(img, mask, plan))


def _extract_impl(img, mask, cfg: ORBConfig) -> Keypoints:
    det = detect_levels(img, mask, cfg)
    valid = det.valid
    # one gather for all levels, then orientation + BRIEF over its patches
    counts = [max(b, 1) for b in cfg.level_budgets()]
    patches_all = patch_kernel.gather_patches_levels(
        det.padded, det.ys.split(counts), det.xs.split(counts), PATCH)
    angle = ic_angle_from_patches(patches_all)
    desc_u8 = brief_from_patches(blur_patches(patches_all), angle)
    # capacity padded to a multiple of 128, as in the reference
    pad = valid.shape[0] - angle.shape[0]
    if pad:
        angle = F.pad(angle, (0, pad))
        desc_u8 = F.pad(desc_u8, (0, 0, 0, pad))

    desc_u8 = torch.where(valid[:, None], desc_u8, 0).to(torch.uint8)
    desc_pm1 = torch.where(valid[:, None], unpack_bits_to_pm1(desc_u8),
                           0).to(torch.int8)
    return Keypoints(
        xy=det.xy,
        response=det.response,
        angle=angle,
        octave=det.octave,
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
    img = torch.as_tensor(img, dtype=torch.float32, device=dev).contiguous()
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32,
                               device=dev).contiguous()
    return _extract_impl(img, mask, cfg)
