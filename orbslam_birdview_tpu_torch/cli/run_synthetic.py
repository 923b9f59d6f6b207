"""Synthetic end-to-end runner: renders a ground-truth sequence, runs SLAM,
prints the ATE. The runnable acceptance check without a dataset.

Usage: python -m orbslam_birdview_tpu_torch.cli.run_synthetic
       [--mode mono|bird|loop] [--frames N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="bird", choices=["mono", "bird", "loop"])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)

    from ..api.config import SlamConfig
    from ..api.system import System
    from ..core import lie
    from ..core.camera import BirdviewCamera, PinholeCamera
    from ..frontend.orb import ORBConfig
    from ..utils.synth import BirdSequence, WallSequence, ate_rmse

    cam = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                        width=640, height=480)
    if args.mode == "mono":
        N = args.frames or 40
        seq = WallSequence(cam, n_frames=N, step=0.03)
        cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                         sensor="mono")
        sys_ = System(cfg, device=args.device)
        gt, est, times = [], [], []
        for i in range(N):
            img, (R_cw, t_cw) = seq.frame(i)
            t0 = time.perf_counter()
            fd = sys_.track_monocular(img, i / 30.0)
            times.append(time.perf_counter() - t0)
            if fd.pose_ok:
                est.append(-fd.R.T @ fd.t)
                gt.append(-R_cw.T @ t_cw)
        ate = ate_rmse(np.array(est), np.array(gt), with_scale=True)
        print(f"mono: tracked {len(est)}/{N}, ATE(scale-aligned) {ate:.4f} m, "
              f"median frame {np.median(times[5:])*1e3:.0f} ms")
        return dict(mode="mono", tracked=len(est), frames=N, ate_m=ate)

    bv = BirdviewCamera(width=384, height=384)
    if args.mode == "bird":
        N = args.frames or 50
        seq = BirdSequence(cam, bv, n_frames=N, speed=0.12, yaw_rate=0.004)
    else:
        N = args.frames or 150
        seq = BirdSequence(cam, bv, n_frames=N, speed=0.1,
                           yaw_rate=2 * np.pi / 120, wall_x=8.0)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                     sensor="mono_bird", birdview=bv)
    q = lie.rot_to_quat(torch.as_tensor(seq.R_bc)).numpy()
    cfg.tbc_quat = tuple(q.tolist())
    cfg.tbc_t = tuple(seq.t_bc.tolist())
    sys_ = System(cfg, device=args.device)
    GT = {i: seq.gt_cam_pose(i) for i in range(N)}
    times = []
    for i in range(N):
        img, bev, _ = seq.frame(i)
        t0 = time.perf_counter()
        sys_.track_monocular_with_birdview(img, bev, None, i / 25.0)
        times.append(time.perf_counter() - t0)
    store = sys_.store
    est, gt = [], []
    for k in store.valid_kf_ids():
        fid = int(store.kf_frame_id[k])
        Rg, tg = GT[fid]
        est.append(-store.kf_R[k].T @ store.kf_t[k])
        gt.append(-Rg.T @ tg)
    ate = ate_rmse(np.array(est), np.array(gt), with_scale=False)
    loops = sys_.loop_closer.n_loops_closed if sys_.loop_closer else 0
    print(f"{args.mode}: {sys_.n_keyframes()} KFs, "
          f"{sys_.n_map_points()} pts, loops={loops}, "
          f"METRIC ATE {ate:.4f} m, median frame {np.median(times[5:])*1e3:.0f} ms")
    return dict(mode=args.mode, keyframes=sys_.n_keyframes(),
                map_points=sys_.n_map_points(), loops=loops, ate_m=ate,
                frames=N)


if __name__ == "__main__":
    main()
