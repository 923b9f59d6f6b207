"""Dataset loaders for the standard SLAM benchmarks, without OpenCV.

The JAX package's `cli/datasets.py`, record for record, on the port's
image reader (`utils/imageio.py`):
- TUM RGB-D: `rgb.txt` / `depth.txt`, associated inline by nearest
  timestamp; mono reads rgb.txt only.
- KITTI odometry: `image_0/%06d.png` + `times.txt` (`image_1/` for stereo).
- EuRoC: `mav0/cam0/data/` + `data.csv` (cam1 for stereo, rectified with
  the configuration's LEFT./RIGHT. blocks).
- Fisheye-birdview: `associate.txt` with timestamp, 2D odom pose and the
  image / birdview / mask triplets of the fork's `mono_fisheye`.

The rectifier's maps are `cv2.initUndistortRectifyMap`'s (radial-tangential
distortion through R⁻¹ and P[:3, :3]), computed in float64 and stored as
float32, and `cv2.remap`'s bilinear sampling with a zero border; the
fisheye front image's 0.5× resize is `cv2.resize`'s bilinear halving. All
of it runs on the host, as the JAX package runs OpenCV there.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..utils import imageio
from ..utils.synth import sample_bilinear


@dataclass
class FrameRecord:
    timestamp: float
    img: np.ndarray
    depth: Optional[np.ndarray] = None
    right: Optional[np.ndarray] = None
    bird: Optional[np.ndarray] = None
    bird_mask: Optional[np.ndarray] = None
    odom_pose: Optional[np.ndarray] = None  # (x, y, theta) if present


def _gray(path: str) -> np.ndarray:
    return imageio.imread(path, imageio.IMREAD_GRAYSCALE).astype(np.float32)


def _read_or_none(path: str, flags: int) -> Optional[np.ndarray]:
    """The image, or None where OpenCV's reader gives None: a missing or
    undecodable file."""
    try:
        return imageio.imread(path, flags)
    except (OSError, ValueError):
        return None


def load_tum_mono(root: str) -> Iterator[FrameRecord]:
    with open(os.path.join(root, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            yield FrameRecord(float(ts), _gray(os.path.join(root, rel)))


def load_tum_rgbd(root: str, depth_factor: float = 5000.0,
                  max_dt: float = 0.02) -> Iterator[FrameRecord]:
    """Associates rgb.txt and depth.txt by nearest timestamp (the reference
    expects a pre-built associations.txt; the association runs inline)."""
    def read_list(name):
        out = []
        with open(os.path.join(root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), rel))
        return out

    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    d_ts = np.array([t for t, _ in depth])
    for ts, rel in rgb:
        j = int(np.argmin(np.abs(d_ts - ts)))
        if abs(d_ts[j] - ts) > max_dt:
            continue
        img = _gray(os.path.join(root, rel))
        d = _read_or_none(os.path.join(root, depth[j][1]),
                          imageio.IMREAD_UNCHANGED)
        if d is None:
            continue
        yield FrameRecord(ts, img, depth=d.astype(np.float32) / depth_factor)


def load_kitti(root: str, stereo: bool = False) -> Iterator[FrameRecord]:
    with open(os.path.join(root, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    for i, ts in enumerate(times):
        left = _gray(os.path.join(root, "image_0", f"{i:06d}.png"))
        right = (_gray(os.path.join(root, "image_1", f"{i:06d}.png"))
                 if stereo else None)
        yield FrameRecord(ts, left, right=right)


def undistort_rectify_map(K, D, R, P, width: int, height: int):
    """`cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], (width, height),
    CV_32FC1)`: for every pixel of the rectified image, where to sample the
    raw one. D holds k1, k2, p1, p2[, k3]."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = np.zeros(5)
    D = np.asarray(D, np.float64).ravel()
    d[:len(D)] = D[:5]
    k1, k2, p1, p2, k3 = d
    iR = np.linalg.inv(np.asarray(P, np.float64).reshape(3, -1)[:3, :3]
                       @ np.asarray(R, np.float64).reshape(3, 3))
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x, y = X / W, Y / W
    x2, y2, xy2 = x * x, y * y, 2 * x * y
    r2 = x2 + y2
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    mu = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + K[0, 2]
    mv = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + K[1, 2]
    return mu.astype(np.float32), mv.astype(np.float32)


class StereoRectifier:
    """Stereo rectification with per-camera K/D/R/P, the reference's EuRoC
    preprocessing: rectification maps from the `LEFT.*` / `RIGHT.*` YAML
    entries, and every image pair remapped before tracking."""

    def __init__(self, left_K, left_D, left_R, left_P,
                 right_K, right_D, right_R, right_P, width: int, height: int):
        size = (int(width), int(height))
        self._ml = undistort_rectify_map(left_K, left_D, left_R, left_P, *size)
        self._mr = undistort_rectify_map(right_K, right_D, right_R, right_P,
                                         *size)

    @staticmethod
    def _remap(img, maps):
        """`cv2.remap(img, mx, my, INTER_LINEAR)`: bilinear, 0 outside."""
        return sample_bilinear(np.asarray(img, np.float32), maps[0], maps[1],
                               wrap=False)

    def __call__(self, left: np.ndarray, right: np.ndarray):
        return self._remap(left, self._ml), self._remap(right, self._mr)


def parse_rectification(path: str) -> Optional[StereoRectifier]:
    """Parse `LEFT.*`/`RIGHT.*` rectification blocks from a YAML config.

    Accepts both the reference's `!!opencv-matrix` multi-line blocks and
    the repo's flat one-line `LEFT.K: [a, b, ...]` form; returns None if no
    blocks are present."""
    import re

    with open(path) as f:
        text = f.read()
    vals = {}
    # flat scalar form: LEFT.width: 752
    for m in re.finditer(r"^\s*((?:LEFT|RIGHT)\.\w+)\s*:\s*([-+0-9.eE]+)\s*$",
                         text, re.M):
        vals[m.group(1)] = float(m.group(2))
    # flat list form: LEFT.K: [a, b, ...]
    for m in re.finditer(r"^\s*((?:LEFT|RIGHT)\.\w+)\s*:\s*\[([^\]]*)\]",
                         text, re.M):
        vals[m.group(1)] = np.array(
            [float(x) for x in m.group(2).replace(",", " ").split()])
    # opencv-matrix form: LEFT.K: !!opencv-matrix ... data: [a, b, ...]
    for m in re.finditer(
            r"((?:LEFT|RIGHT)\.\w+)\s*:\s*!!opencv-matrix.*?data\s*:\s*\[([^\]]*)\]",
            text, re.S):
        vals[m.group(1)] = np.array(
            [float(x) for x in m.group(2).replace(",", " ").split()])
    need = [f"{side}.{k}" for side in ("LEFT", "RIGHT")
            for k in ("K", "D", "R", "P")]
    if not all(k in vals for k in need):
        return None
    return StereoRectifier(
        vals["LEFT.K"], vals["LEFT.D"], vals["LEFT.R"], vals["LEFT.P"],
        vals["RIGHT.K"], vals["RIGHT.D"], vals["RIGHT.R"], vals["RIGHT.P"],
        int(vals.get("LEFT.width", 752)), int(vals.get("LEFT.height", 480)))


def load_euroc(root: str, cam: str = "cam0", stereo: bool = False,
               rectifier: Optional[StereoRectifier] = None
               ) -> Iterator[FrameRecord]:
    data_dir = os.path.join(root, "mav0", cam, "data")
    right_dir = os.path.join(root, "mav0", "cam1", "data")
    entries = []
    with open(os.path.join(root, "mav0", cam, "data.csv")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            ts_ns, name = line.strip().split(",")[:2]
            entries.append((int(ts_ns) * 1e-9, name))
    for ts, name in entries:
        img = _gray(os.path.join(data_dir, name))
        if not stereo:
            yield FrameRecord(ts, img)
            continue
        # EuRoC cam0/cam1 are hardware-synced: same filename both sides
        rpath = os.path.join(right_dir, name)
        if not os.path.exists(rpath):
            continue
        right = _gray(rpath)
        if rectifier is not None:
            img, right = rectifier(img, right)
        yield FrameRecord(ts, img, right=right)


def resize_half(img: np.ndarray) -> np.ndarray:
    """`cv2.resize(img, None, fx=0.5, fy=0.5)` (INTER_LINEAR) of a float32
    image: output pixel i samples source coordinate 2i + 0.5, i.e. pixels
    2i and 2i + 1 at weight 1/2, as OpenCV's lerp a + (b − a)·½, along the
    rows and then the columns; an odd last row or column clamps to its
    last pixel. The output size rounds half to even, as OpenCV's does. On
    integer-valued images this is the mean of each 2×2 block."""
    def half(x, axis):
        n = x.shape[axis]
        m = int(np.rint(n / 2))
        a = np.take(x, 2 * np.arange(m), axis=axis)
        b = np.take(x, np.minimum(2 * np.arange(m) + 1, n - 1), axis=axis)
        return a + (b - a) * np.float32(0.5)

    return half(half(np.asarray(img, np.float32), 1), 0)


def load_fisheye_birdview(root: str, crop=(1900, 800), scale: float = 0.5,
                          front_mask_path: Optional[str] = None
                          ) -> Iterator[FrameRecord]:
    """The fork's `mono_fisheye` format:

    - `associate.txt` lines are `timestamp x y theta image_name` (FIVE
      whitespace fields); the three per-frame files are `image/<name>`,
      `birdview/<name>`, `mask/<name>` — the name appears ONCE per line.
    - the front image is zeroed wherever a GLOBAL front mask's green
      channel exceeds 250 (`mask_new_front.png`, loaded once), then cropped
      from the ORIGIN to 1900x800 and downscaled 0.5x.
    - the per-frame birdview mask is binarized on its GREEN channel:
      <20 -> masked out; the vehicle footprint rectangle is carved by the
      Frame construction downstream.
    """
    if scale not in (1.0, 0.5):
        raise ValueError(f"front image scale {scale}: only 1.0 and 0.5 "
                         "are implemented")
    if front_mask_path is None:
        cand = os.path.join(root, "mask_new_front.png")
        front_mask_path = cand if os.path.exists(cand) else None
    fmask = None
    if front_mask_path is not None:
        fm = _read_or_none(front_mask_path, imageio.IMREAD_COLOR)
        if fm is not None:
            fmask = fm[:, :, 1] > 250   # green channel, BGR order
    with open(os.path.join(root, "associate.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            ts, x, y, th = (float(p) for p in parts[:4])
            name = parts[4]
            img = _gray(os.path.join(root, "image", name))
            bird = _gray(os.path.join(root, "birdview", name))
            mask = _read_or_none(os.path.join(root, "mask", name),
                                 imageio.IMREAD_COLOR)
            if fmask is not None and fmask.shape == img.shape:
                img = np.where(fmask, np.float32(0.0), img)
            h, w = img.shape
            cw, ch = crop
            if w >= cw and h >= ch:
                img = img[:ch, :cw]   # origin crop, not centered
            if scale != 1.0:
                img = resize_half(img)
            bmask = ((mask[:, :, 1] >= 20).astype(np.float32)
                     if mask is not None else None)
            yield FrameRecord(ts, img, bird=bird, bird_mask=bmask,
                              odom_pose=np.array([x, y, th]))
