"""Dataset CLI — the reference's example mains
(`Examples/Monocular/mono_tum.cc` etc.) as one configurable entry point,
on the port: no OpenCV, no matplotlib, no JAX.

Usage:
  python -m orbslam_birdview_tpu_torch.cli.run_slam --dataset tum_mono \
      --root /data/rgbd_dataset_freiburg1_xyz --config configs/tum1_mono.yaml \
      --out traj.txt

Runs on the GPU (`--device cuda`, the default; it raises when no GPU
exists) unless `--device cpu` is given. Prints per-frame timing stats at
exit (median/mean, like the fork's `mono_fisheye.cc`); `main(argv)`
returns the frame count, the per-frame times and the `System`.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True,
                    choices=["tum_mono", "tum_rgbd", "kitti_mono",
                             "kitti_stereo", "euroc", "euroc_stereo",
                             "fisheye_bird"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--config", default=None, help="ORB-SLAM2-style YAML")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--out-kf", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--vocab", default=None,
                    help="vocabulary: DBoW2 text (ORBvoc.txt), DBoW2 "
                         "binary (.bin), or an .npz saved by "
                         "Vocabulary.save")
    ap.add_argument("--realtime", action="store_true",
                    help="pace frames by dataset timestamp deltas")
    ap.add_argument("--timing", action="store_true",
                    help="print the System's span record at exit: each "
                         "host stage and device span, and the counters")
    ap.add_argument("--profile-trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run "
                         "(DIR/trace.json, Chrome trace format)")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="render an incremental map + frame overlay PNG "
                         "every N frames into --viz-dir (headless "
                         "equivalent of the reference's live Pangolin "
                         "viewer)")
    ap.add_argument("--viz-dir", default="viz", metavar="DIR")
    ap.add_argument("--live-viewer", type=int, default=None, nargs="?",
                    const=8765, metavar="PORT",
                    help="serve a live interactive map viewer (canvas UI "
                         "with follow-camera / graph / localization-mode "
                         "menu) at http://127.0.0.1:PORT")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (the default; "
                         "raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..api.config import SlamConfig
    from ..api.system import System
    from ..utils import profiling
    from . import datasets

    device = resolve_device(args.device)
    sensor = {
        "tum_mono": "mono", "tum_rgbd": "rgbd", "kitti_mono": "mono",
        "kitti_stereo": "stereo", "euroc": "mono",
        "euroc_stereo": "stereo", "fisheye_bird": "mono_bird",
    }[args.dataset]
    if args.config:
        cfg = SlamConfig.from_yaml(args.config, sensor=sensor)
    else:
        cfg = SlamConfig(sensor=sensor)
    if sensor == "mono_bird" and cfg.birdview is None:
        from ..core.camera import BirdviewCamera

        cfg.birdview = BirdviewCamera()

    loader = {
        "tum_mono": lambda: datasets.load_tum_mono(args.root),
        "tum_rgbd": lambda: datasets.load_tum_rgbd(
            args.root, depth_factor=cfg.depth_map_factor),
        "kitti_mono": lambda: datasets.load_kitti(args.root, stereo=False),
        "kitti_stereo": lambda: datasets.load_kitti(args.root, stereo=True),
        "euroc": lambda: datasets.load_euroc(args.root),
        # stereo EuRoC pre-rectifies with the LEFT./RIGHT. blocks from the
        # config, as `stereo_euroc.cc` does (raw EuRoC frames are
        # unrectified)
        "euroc_stereo": lambda: datasets.load_euroc(
            args.root, stereo=True,
            rectifier=(datasets.parse_rectification(args.config)
                       if args.config else None)),
        "fisheye_bird": lambda: datasets.load_fisheye_birdview(args.root),
    }[args.dataset]()

    vocabulary = None
    if args.vocab:
        from ..mapping import vocab as V

        # suffix-dispatched like the reference: .npz native, .bin DBoW2
        # binary, else DBoW2 text
        vocabulary = V.load_dbow2(args.vocab)
        print(f"vocabulary: {vocabulary.n_words} words "
              f"(k={vocabulary.branching}, L={vocabulary.depth})")

    sys_ = System(cfg, vocabulary=vocabulary,
                  enable_loop_closing=not args.no_loop_closing,
                  device=device)
    viewer = None
    if args.live_viewer is not None:
        from ..utils.live_viewer import LiveViewer

        viewer = LiveViewer(sys_, port=args.live_viewer).start()
        print(f"live viewer: {viewer.url}")

    trace_ctx = (profiling.torch_trace(args.profile_trace)
                 if args.profile_trace else contextlib.nullcontext())
    times = []
    n = 0
    prev_ts = None
    with trace_ctx:
        for rec in loader:
            if args.realtime and prev_ts is not None and times:
                # sleep out the residual of the inter-frame timestamp gap;
                # the sleep happens BEFORE t0 so times[] holds pure
                # tracking time
                gap = rec.timestamp - prev_ts
                residual = gap - times[-1]
                if residual > 0:
                    time.sleep(min(residual, 2.0))
            prev_ts = rec.timestamp
            t0 = time.perf_counter()
            if rec.depth is not None:
                sys_.track_rgbd(rec.img, rec.depth, rec.timestamp)
            elif rec.right is not None:
                sys_.track_stereo(rec.img, rec.right, rec.timestamp)
            elif rec.bird is not None:
                sys_.track_monocular_with_birdview(
                    rec.img, rec.bird, rec.bird_mask, rec.timestamp)
            else:
                sys_.track_monocular(rec.img, rec.timestamp)
            times.append(time.perf_counter() - t0)
            n += 1
            if viewer is not None and n % 10 == 0:
                # overlay refresh ~3 Hz at 30 fps input; device-resident
                # keypoints fall back to a plain image (no forced fetch)
                viewer.update_frame(rec.img, sys_.tracker.last_frame)
            if n % 50 == 0:
                # peek, don't flush: get_tracking_state() drains the lag
                # pipeline and the mapper, destroying the very overlap a
                # perf run is measuring
                print(f"frame {n}: state={sys_.peek_tracking_state()} "
                      f"kfs={sys_.n_keyframes()} mps={sys_.n_map_points()}")
            if args.viz_every and n % args.viz_every == 0:
                _write_viz(sys_, rec, n, args.viz_dir)
            if args.max_frames and n >= args.max_frames:
                break

    times = np.array(times)
    print(f"processed {n} frames; median {np.median(times)*1e3:.1f} ms, "
          f"mean {times.mean()*1e3:.1f} ms")
    if args.dataset.startswith("kitti"):
        sys_.save_trajectory_kitti(args.out)
    else:
        sys_.save_trajectory_tum(args.out)
    if args.out_kf:
        sys_.save_keyframe_trajectory_tum(args.out_kf)
        if sensor == "mono_bird":
            # the birdview example also saves the base/odom-frame trajectory
            # (the fork's System::SaveKeyFrameTrajectoryOdomTUM)
            sys_.save_keyframe_trajectory_odom_tum(
                os.path.splitext(args.out_kf)[0] + "_odom.txt")
    print(f"saved trajectory to {args.out}")
    if args.timing:
        # the System's span record: tracker, mapper and loop-closer
        # stages, and the device spans (CUDA only)
        print(sys_.timer.summary())
    if viewer is not None:
        viewer.stop()
    return dict(frames=n, times_s=times.tolist(), system=sys_)


def _write_viz(sys_, rec, n: int, viz_dir: str):
    """The frame overlay (keypoints landed on the host in one transfer)
    and the map, as PNGs."""
    from ..utils import imageio, viz

    os.makedirs(viz_dir, exist_ok=True)
    fd = sys_.tracker.last_frame
    if fd is not None:
        sys_.tracker.resolve_associations(fd)
        kp = sys_.tracker._kp_host(fd)
        ov = viz.draw_frame(rec.img, kp.xy, kp.valid,
                            kp_tracked=fd.kp_mp >= 0,
                            state_text=f"frame {n} kfs={sys_.n_keyframes()}")
        imageio.imwrite(f"{viz_dir}/frame_{n:06d}.png", ov)
    viz.plot_map(sys_.store, f"{viz_dir}/map_{n:06d}.png")


if __name__ == "__main__":
    main()
