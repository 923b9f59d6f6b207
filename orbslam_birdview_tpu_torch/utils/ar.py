"""Augmented-reality overlay: plane detection + virtual-object rendering.

The JAX package's `utils/ar.py` without OpenCV: detect a dominant plane
from the currently tracked map points (RANSAC plane fit, the same draws
for the same seed) and render a virtual cube anchored to it into the
camera image using the tracked pose. Headless (returns images) and
vectorized — all hypotheses are scored as one batched op. The cube's
edges are 2-pixel lines from the port's rasterizer (`utils/viz.py`) in
place of OpenCV's thick lines: every drawn pixel lies within 2 px of a
projected edge.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from . import viz


class Plane(NamedTuple):
    normal: np.ndarray   # (3,) unit, world frame
    d: float             # plane: n·x + d = 0
    origin: np.ndarray   # (3,) anchor point on the plane (inlier centroid)
    inliers: np.ndarray  # (N,) bool


def detect_plane(points: np.ndarray, n_hyp: int = 128,
                 inlier_th: Optional[float] = None, min_inliers: int = 20,
                 seed: int = 0) -> Optional[Plane]:
    """RANSAC dominant-plane fit over tracked map points
    (`ViewerAR::DetectPlane` semantics: 50 iterations over 3-point samples,
    distance threshold scaled to point spread; here all hypotheses are
    scored as one batched tensor op)."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n < max(3, min_inliers):
        return None
    if inlier_th is None:
        med = np.median(pts, axis=0)
        inlier_th = 0.02 * float(np.median(np.linalg.norm(pts - med, axis=1)))
        inlier_th = max(inlier_th, 1e-4)
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, n, size=(n_hyp, 3))
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    nrm = np.cross(p1 - p0, p2 - p0)                     # (H,3)
    norm = np.linalg.norm(nrm, axis=1, keepdims=True)
    ok_h = norm[:, 0] > 1e-12
    nrm = nrm / np.maximum(norm, 1e-12)
    d = -np.einsum("hj,hj->h", nrm, p0)                  # (H,)
    dist = np.abs(pts @ nrm.T + d[None, :])              # (N,H)
    votes = (dist < inlier_th).sum(0) * ok_h
    best = int(np.argmax(votes))
    if votes[best] < min_inliers:
        return None
    inl = dist[:, best] < inlier_th
    # least-squares refit on inliers
    c = pts[inl].mean(0)
    _, _, Vt = np.linalg.svd(pts[inl] - c)
    normal = Vt[2]
    if normal[1] > 0:  # keep "up" consistent (y-down camera convention)
        normal = -normal
    return Plane(normal=normal, d=float(-normal @ c), origin=c,
                 inliers=inl)


def cube_vertices(plane: Plane, size: float) -> np.ndarray:
    """(8,3) world-frame vertices of a cube of side `size` resting on the
    plane at its anchor point."""
    n = plane.normal
    a = np.array([1.0, 0.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    h = size / 2.0
    base = plane.origin
    out = []
    for k in (0.0, 1.0):  # bottom face on the plane, top lifted along n
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            out.append(base + su * h * u + sv * h * v + k * size * n)
    return np.array(out)


CUBE_COLOR = (0, 200, 255)
_CUBE_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
               (4, 5), (5, 6), (6, 7), (7, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_virtual_cube(img: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray,
                      K: np.ndarray, plane: Plane, size: float = 0.1
                      ) -> np.ndarray:
    """Render the cube wireframe into the (grayscale or RGB) image using
    the current world→camera pose (`ViewerAR::Run` draw path). Returns BGR
    uint8."""
    rgb = viz.gray_to_bgr(img)
    X = cube_vertices(plane, size)
    Xc = X @ np.asarray(R_cw).T + np.asarray(t_cw)[None]
    if np.any(Xc[:, 2] <= 1e-6):
        return rgb
    uv = (Xc @ np.asarray(K).T)
    uv = uv[:, :2] / uv[:, 2:3]
    pts = uv.round().astype(int)
    for i, j in _CUBE_EDGES:
        viz.draw_line(rgb, pts[i], pts[j], CUBE_COLOR, thickness=2)
    return rgb
