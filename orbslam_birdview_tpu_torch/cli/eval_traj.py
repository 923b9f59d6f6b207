"""Trajectory evaluation: ATE RMSE and RPE on TUM-format files.

The scorer for the trajectory files `System` writes: timestamp
association, SE3/Sim3 Umeyama alignment, ATE RMSE (absolute trajectory
error) and RPE (relative pose error over a fixed frame delta), compatible
with the TUM rgbd-benchmark conventions. numpy only, as the JAX package's.

Usage:
    python -m orbslam_birdview_tpu_torch.cli.eval_traj gt.txt est.txt \
        [--scale] [--max-dt 0.02] [--rpe-delta 1]
"""
from __future__ import annotations

import argparse

import numpy as np


def load_tum(path: str):
    """Returns (timestamps (N,), positions (N,3), quaternions (N,4) xyzw)."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            if len(v) < 8:
                continue
            ts.append(float(v[0]))
            pos.append([float(x) for x in v[1:4]])
            quat.append([float(x) for x in v[4:8]])
    return np.array(ts), np.array(pos), np.array(quat)


def associate(ts_a, ts_b, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (TUM associate.py semantics).
    Returns (idx_a, idx_b) index arrays of equal length."""
    pairs = []
    used_b: set[int] = set()
    j = 0
    order = np.argsort(ts_b)
    ts_b_sorted = ts_b[order]
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b_sorted, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(ts_b_sorted):
                dt = abs(ts_b_sorted[k] - t)
                if dt <= best_dt and int(order[k]) not in used_b:
                    best, best_dt = int(order[k]), dt
        if best >= 0:
            pairs.append((i, best))
            used_b.add(best)
    if not pairs:
        return np.zeros(0, int), np.zeros(0, int)
    ia, ib = zip(*pairs)
    return np.array(ia), np.array(ib)


def umeyama(src, dst, with_scale: bool):
    """Least-squares similarity dst ≈ s·R·src + t. Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    S, D = src - mu_s, dst - mu_d
    W = D.T @ S / len(src)
    U, d, Vt = np.linalg.svd(W)
    Sg = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Sg[2, 2] = -1
    R = U @ Sg @ Vt
    if with_scale:
        var_s = (S * S).sum() / len(src)
        s = float(np.trace(np.diag(d) @ Sg) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def quat_to_rot(q):
    """xyzw quaternion (N,4) -> rotation matrices (N,3,3)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def evaluate(gt_path: str, est_path: str, with_scale: bool = False,
             max_dt: float = 0.02, rpe_delta: int = 1):
    """Returns a dict with ate_rmse, rpe_trans_rmse, rpe_rot_rmse_deg,
    n_pairs, scale."""
    ts_g, p_g, q_g = load_tum(gt_path)
    ts_e, p_e, q_e = load_tum(est_path)
    ia, ib = associate(ts_g, ts_e, max_dt)
    if len(ia) < 2:
        raise ValueError(
            f"only {len(ia)} associations between {gt_path} and {est_path}")
    g, e = p_g[ia], p_e[ib]
    s, R, t = umeyama(e, g, with_scale)
    e_al = (s * (R @ e.T)).T + t
    err = np.linalg.norm(e_al - g, axis=1)
    ate = float(np.sqrt((err ** 2).mean()))

    # RPE over a delta of `rpe_delta` associated frames (TUM rpe tool with
    # --fixed_delta in frame units)
    Rg = quat_to_rot(q_g[ia])
    Re = quat_to_rot(q_e[ib])
    dtr, drot = [], []
    for k in range(len(ia) - rpe_delta):
        j = k + rpe_delta
        dg = Rg[k].T @ (g[j] - g[k])
        de = Re[k].T @ (e[j] - e[k]) * s
        dtr.append(np.linalg.norm(de - dg))
        Rrel = (Rg[k].T @ Rg[j]).T @ (Re[k].T @ Re[j])
        c = np.clip((np.trace(Rrel) - 1) / 2, -1.0, 1.0)
        drot.append(np.degrees(np.arccos(c)))
    return {
        "ate_rmse": ate,
        "rpe_trans_rmse": float(np.sqrt(np.mean(np.square(dtr)))),
        "rpe_rot_rmse_deg": float(np.sqrt(np.mean(np.square(drot)))),
        "n_pairs": int(len(ia)),
        "scale": s,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("gt", help="ground-truth TUM trajectory file")
    ap.add_argument("est", help="estimated TUM trajectory file")
    ap.add_argument("--scale", action="store_true",
                    help="Sim3 (7-DoF) alignment — use for monocular")
    ap.add_argument("--max-dt", type=float, default=0.02,
                    help="max timestamp difference for association [s]")
    ap.add_argument("--rpe-delta", type=int, default=1,
                    help="frame delta for relative pose error")
    args = ap.parse_args(argv)
    m = evaluate(args.gt, args.est, args.scale, args.max_dt, args.rpe_delta)
    print(f"pairs:          {m['n_pairs']}")
    print(f"ATE RMSE:       {m['ate_rmse']:.6f} m"
          + (f"  (scale {m['scale']:.4f})" if args.scale else ""))
    print(f"RPE trans RMSE: {m['rpe_trans_rmse']:.6f} m")
    print(f"RPE rot RMSE:   {m['rpe_rot_rmse_deg']:.4f} deg")
    return m


if __name__ == "__main__":
    main()
