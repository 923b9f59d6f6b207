"""The yardstick's arithmetic: percentiles, drift, the union of device
intervals, the patch gather's bytes and the chip's peaks. Plain Python and
numpy; nothing here reads a clock or the program."""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
PATCH_SIZE = 48                       # the extractor's window side


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def relative_motion(T_i: np.ndarray, T_j: np.ndarray) -> np.ndarray:
    """Camera i -> camera j of two world -> camera poses."""
    return T_j @ np.linalg.inv(T_i)


def drift_pct(est: dict, exact: np.ndarray, gap: int) -> Optional[float]:
    """KITTI-style translational drift over `gap` frames, in %.

    `est` maps a frame index to its tracked world -> camera pose (4×4);
    `exact` holds every frame's exact pose. For each pair (i, i+gap) with
    both tracked, the translation of exact⁻¹·estimated relative motion over
    the distance the camera drove between them (the sum of its steps);
    the mean over the pairs, no scale alignment. None without a pair."""
    centres = -np.einsum("nji,nj->ni", exact[:, :3, :3], exact[:, :3, 3])
    steps = np.linalg.norm(np.diff(centres, axis=0), axis=1)
    errs = []
    for i in sorted(est):
        j = i + gap
        if j not in est:
            continue
        d_est = relative_motion(est[i], est[j])
        d_gt = relative_motion(exact[i], exact[j])
        err = np.linalg.inv(d_gt) @ d_est
        driven = steps[i:j].sum()
        errs.append(np.linalg.norm(err[:3, 3]) / driven)
    return 100.0 * float(np.mean(errs)) if errs else None


def union_length(intervals: Iterable[tuple[float, float]]) -> float:
    """Total length covered by the intervals (start, end)."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Iterable[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def gather_bytes(levels: Iterable[tuple[int, int, int]],
                 size: int = PATCH_SIZE) -> int:
    """Least bytes one patch-gather launch moves: each padded level
    (Hp, Wp) read once, its K int32 row and column starts read once, its
    K size×size f32 windows written once. `levels` holds (Hp, Wp, K)."""
    return sum((hp * wp + 2 * k) * 4 + k * size * size * 4
               for hp, wp, k in levels)


def orb_gather_levels(height: int, width: int, n_features: int,
                      n_levels: int, scale_factor: float,
                      size: int = PATCH_SIZE) -> list[tuple[int, int, int]]:
    """(Hp, Wp, K) of each level of one extraction: the level sizes of the
    pyramid, padded by size/2 on each side, and the level's feature
    budget (ORBextractor's geometric split, at least 1)."""
    f = 1.0 / scale_factor
    n0 = n_features * (1 - f) / (1 - f ** n_levels)
    budgets = [int(round(n0 * f ** l)) for l in range(n_levels - 1)]
    budgets.append(max(n_features - sum(budgets), 0))
    out = []
    for l in range(n_levels):
        s = scale_factor ** l
        h, w = int(round(height / s)), int(round(width / s))
        out.append((h + size, w + size, max(budgets[l], 1)))
    return out
