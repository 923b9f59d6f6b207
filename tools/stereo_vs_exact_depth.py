"""The smoke's KITTI stereo drive twice through `System` on the card: once
with depth from the right image (`track_stereo`), once with the wall's
exact depth (`track_rgbd`, the same camera and frames). Prints one JSON
object per run: the pose errors frame by frame, the metric ATE (rigid, no
scale) over the first n frames, the keyframes, and the first keyframe's
depth errors against the wall.

    python3 tools/stereo_vs_exact_depth.py

What it shows: the gap between the two runs is what the stereo depth
costs; the first keyframe's depth spread is the stereo refinement's
fallback to integer disparities (ROADMAP Queue 3).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from orbslam_birdview_tpu_torch.utils.synth import ate_rmse  # noqa: E402

PREFIXES = (10, 16, 21, 25, 30, 35, 40)
STEREO_WALL_Z = smoke.STEREO_WALL["wall_z"]


def run(mode, dev):
    cfg = smoke.depth_config("stereo")
    n = smoke.STEREO_FRAMES
    if mode == "exact_depth":
        cfg.sensor = "rgbd"
        seq, frames, _ = smoke.render_depth_drive("rgbd", cfg, n,
                                                  smoke.STEREO_WALL)
        frames = [(np.clip(img, 0, 255).astype(np.uint8), depth, gt)
                  for img, depth, gt in frames]
    else:
        seq, frames, _ = smoke.render_depth_drive("stereo", cfg, n,
                                                  smoke.STEREO_WALL)
    system = smoke.make_system(cfg, dev)
    track = system.track_stereo if mode == "stereo" else system.track_rgbd
    fds = [track(a, b, i / cfg.fps) for i, (a, b, _) in enumerate(frames)]
    system._flush()
    gts = [seq.gt_pose(i) for i in range(n)]
    rows = [(i, *smoke.pose_errors(fd.R, fd.t, *gt))
            for i, (fd, gt) in enumerate(zip(fds, gts))]
    est = np.array([-fd.R.T @ fd.t for fd in fds])
    gt = np.array([-R.T @ t for R, t in gts])
    store = system.store
    obs = store.kf_kp_mp[0]
    z = store.mp_pos[obs[obs >= 0], 2] - STEREO_WALL_Z
    return dict(
        mode=mode, frames=n, tracked=int(sum(fd.pose_ok for fd in fds)),
        per_frame=[dict(frame=i, pos_err_m=p, rot_err_deg=r)
                   for i, p, r in rows],
        ate_first_n_m={k: ate_rmse(est[:k], gt[:k]) for k in PREFIXES
                       if k <= n},
        keyframe_frames=store.kf_frame_id[:store.n_kf].tolist(),
        first_keyframe_depth_err_m=dict(
            n=int(len(z)), median=float(np.median(z)), std=float(z.std()),
            p90_abs=float(np.percentile(np.abs(z), 90))))


def main() -> int:
    if not torch.cuda.is_available():
        print("stereo_vs_exact_depth: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(smoke.card_line())
    for mode in ("stereo", "exact_depth"):
        print(json.dumps(run(mode, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
