"""The smoke's RGB-D revisit (`chip_smoke.rgbd_circle_drive`) through
`System.track_rgbd` in three variants, on the card unless a device is
given:

- `smoke`: as `chip_smoke.py` runs it (a keyframe at least every 3 frames,
  each frame's pose read as the call returns it);
- `poses_unread`: the same with every pose left unread until the drive
  ends, so the lag queue retires frames late;
- `tum1_default_kf`: TUM1's own `max_frames_between_kf` (30), poses read.

Prints one JSON object per variant: frames tracked, keyframes minted,
loops, keyframe ATE before and after the GBA, or the smoke check that
failed.

    python3 tools/rgbd_circle_variants.py [--device cpu] [--frames N]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

KEYS = ("tracked", "keyframes_minted", "loops", "ate_before_gba_m", "ate_m",
        "max_frames_between_kf", "poses_read_per_frame")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=smoke.RGBD_CIRCLE_FRAMES)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from orbslam_birdview_tpu_torch.core import linalg
        from orbslam_birdview_tpu_torch.frontend import (detect_kernel,
                                                         patch_kernel)
        from orbslam_birdview_tpu_torch.utils import build
        build.build_libraries([patch_kernel.LIBRARY, linalg.LIBRARY,
                               detect_kernel.LIBRARY])
        print(smoke.card_line(), flush=True)
    for name, kf_gap, read in (
            ("smoke", smoke.RGBD_CIRCLE_MAX_FRAMES_BETWEEN_KF, True),
            ("poses_unread", smoke.RGBD_CIRCLE_MAX_FRAMES_BETWEEN_KF, False),
            ("tum1_default_kf", None, True)):
        cfg = smoke.depth_config("rgbd")
        if kf_gap is not None:
            cfg.tracking.max_frames_between_kf = kf_gap
        try:
            r = smoke.rgbd_circle_drive(dev, cfg, args.frames, read)
            out = {k: r[k] for k in KEYS}
        except smoke.SmokeFailure as e:
            out = dict(failed=str(e))
        print(json.dumps({name: out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
