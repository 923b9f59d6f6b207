#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. setup: a CUDA device is required; prints the card's name and power
   limit and builds the CUDA kernels from the sources in the checkout
   (csrc/patch_gather.cu and csrc/small_linalg.cu, one nvcc each, at
   once);
2. kernels: every kernel of the path, called through its wrapper on the
   inputs the main path gives it (and on starts outside the image, which
   the path never produces), held against its plain PyTorch version
   (bit-exact), and timed beside its plain version, one PyTorch library
   call computing the same function, and its bound from bytes;
3. slice: the fused mono+birdview tracking step (`track_step_mono`) at the
   fork's full width — 950×400 front with the fisheye rig's intrinsics
   (configs/fisheye_birdview.yaml), 2000 features on 8 levels, minThFAST 5;
   384×384 BEV with the footprint mask, 2000 features on 4 levels; a
   6144-point local map and a 2048-point ground bundle seeded from frame
   0's ground truth — over 10 frames of a rendered drive, chained on the
   device pose chain; then 5 mono-only frames. One more frame runs under
   torch.profiler (after every timed drive, so that no timed drive follows
   a profiler session), which attributes its device kernels to the two
   extractions, the pose LM and the rest of the step;
4. init: a `Tracker` with a `LocalMapper` and a `MapStore` is fed the
   drive's frames through `Tracker.process` until it has initialized: ORB
   on both streams, frame-to-frame matching, two-view initialization with
   the BEV ICP's metric scale, the initial map and its bundle adjustment.
   The drive moves 0.12 m a frame and the ICP vetoes baselines under
   0.3 m, so the first attempts fail by design. The result is held against
   the drive's ground truth expressed in the reference keyframe's camera
   frame, with no scale alignment;
5. tracked from init: `_refresh_local_map` turns the store into the step's
   bundles, and the drive's next 10 frames go through `track_step_mono`
   from the second keyframe's pose, against the same ground truth;
6. system: the SLAM loop through `System(cfg)` (loop closing on, the
   packaged vocabulary) with `track_monocular_with_birdview` at full width
   over 60 frames of the drive, after one `System.prewarm()`, then
   `_flush`: tracking (fused and slow paths, the lag queue), keyframes,
   local mapping (triangulation, fuse, local BA, culling) and every
   keyframe's BoW registration. Held to the bars of tests/test_e2e.py's
   birdview test (metric ATE < 0.05 m with no scale alignment, path
   length within 2 %, > 200 bird landmarks), >= 95 % of the frames after
   initialization tracked, >= 4 keyframes, >= 2 local BAs landed, every
   keyframe's stages applied, no compaction overflow, no loop closed on
   the straight drive, two patch-gather launches a frame;
7. loop: the circle of tests/test_loop_closing.py (0.1 m and 2π/120 rad a
   frame, 142 frames) at full width with the fisheye rig through
   `System(cfg)`: at least one loop closed, the keyframes' metric ATE
   < 0.05 m with no scale alignment after the loop and the GBA; the loop's
   keyframe pair, Sim3, pose graph and GBA recorded; one local BA and one
   GBA round on its map under torch.profiler;
8. e2e: the four mono and mono+bird tests and the four stereo and RGB-D
   tests of tests/test_e2e.py on the port with their own configurations
   and bars, loop closing on, and tests/test_loop_closing.py's circle at
   640×480 with its bars;
9. relocalization: dense keyframes over 20 frames of the drive, 3 blank
   front and BEV frames (LOST, no reset), then frame 5 again, which must
   relocalize within 0.02 m of its first pass (the keyframe database's
   candidates counted);
10. depth: `System.track_stereo` over 40 frames of a wall 12 m away at the
   KITTI stereo configuration (configs/kitti00-02_stereo.yaml, 1241×376,
   2000 features, 8-bit images, the right camera bf/fx = 0.537 m to the
   right) and `System.track_rgbd` over 60 frames of a wall 2 m away at
   TUM1's RGB-D one (configs/tum1_rgbd.yaml, 640×480, 1000 features, the
   wall's exact depth in metres, distortion zeroed), loop closing on: OK
   at frame 0, >= 95 % tracked, metric ATE < 0.05 m with no scale, the
   patch-gather launches exactly 2 a fused and 3 a slow-path stereo
   frame, 1 an RGB-D frame; the gather timed at the KITTI stereo frame's
   shapes; `stereo_match` / `refine_stereo_subpixel` on the CPU against
   the GPU. Then `rgbd_circle`, fixed-scale loop closing end to end: the
   circle of the loop phase (2π/120 rad a frame, 142 frames) at 0.04 m a
   frame inside a box room of half-width 2.4 m, rendered with the port's
   `synth` with each pixel's exact depth, through `System.track_rgbd` at
   TUM1's configuration (a keyframe at least every 3 frames), each
   frame's pose read as the call returns it: OK at frame 0, >= 95 %
   tracked, at least one loop closed with the Sim3 scale exactly 1, the
   keyframes' metric ATE after the loop and the GBA < 0.05 m with no
   scale, the gather 1 launch a frame and the eigh kernel launched by
   `sim3_ransac`; the loop pair, solvers, `_correct_loop` and GBA
   dispatch ms recorded. The e2e phase (8.) also runs the four stereo and
   RGB-D tests of tests/test_e2e.py with their bars;
11. cli: the outer surface through the entry points a user calls, on
   datasets written with the port's PNG writer, with no OpenCV:
   `cli.run_slam` over a KITTI stereo layout of the depth
   phase's wall (12 frames at configs/kitti00-02_stereo.yaml; the KITTI
   file turned into TUM lines and scored by `cli.eval_traj`, ATE < 0.05 m
   with no scale), over a TUM RGB-D layout (20 frames at TUM1's
   configuration with the distortion zeroed, 3-channel PNGs, 16-bit depth
   at factor 5000; ATE < 0.05 m; `--viz-every 10`'s overlays and maps
   decode), and over the fork's fisheye-birdview layout (every
   `FrameRecord` equal to the render bit for bit after the front mask,
   the origin crop and the 0.5× resize; 10 frames through the CLI, the
   trajectory, keyframe and odometry files written; tracking not held);
   `cli.run_synthetic --mode bird --frames 20` (METRIC ATE < 0.05 m);
   `LiveViewer` on the system phase's `System` (/state, /frame); the
   native loader against the port's decoder. The gather's launches held
   to the path rule in every run;
12. parallel (after cli): the multi-device layer on 4 shards of the card
   (`parallel/`; shards on one card run one after another, so its times
   are not multi-GPU speeds): (a) `dryrun_multichip` at full scale — the
   sharded GBA (C=512, P=65,536, E=262,144, mono/stereo/bird, 2+2 LM, 24
   CG) and the sharded PCG pose graph (K=1024, 10 GN, 128 CG) with their
   asserts, each timed with CUDA events and profiled for its kernels
   beside the one-device `bundle_adjust_large` / `optimize_sim3_graph_pcg`
   on the same problem; the sharded GBA twice, bit for bit, and within
   1e-3 (poses) and 2e-3 m (median point) of the one-device solve; the
   sharded pose graph against the spread of f32 solves from summation
   order alone (the one-device PCG on its edges and on three permutations
   of them, each held against the one-device PCG in f64): no farther from
   the f64 solve than PG_SPREAD_FACTOR times the farthest of them; one
   frame per shard through `extract_orb`; (b) the loop phase's circle
   through `System(cfg, mesh=Mesh([cuda:0] * 4))`: the loop at the
   one-device run's keyframe pair, the sharded essential graph and GBA
   named, keyframe ATE < 0.05 m; (c) two processes with two shards each,
   gloo through a `file://` store under chiprun_out/, against the
   in-process 4-shard mesh (translations 1e-3, cost 1e-2 relative), and
   an NCCL group of world size 1; (d) the JPEG fixtures of tests/data/jpeg
   against their stored cv2 decodes;
13. reference: the step, `initialize_two_view`, `bundle_adjust`,
   `pnp_ransac`, the two compacting mapping ops, `sim3_ransac`,
   `optimize_sim3_two_frame`, the three pose-graph solvers and
   `bundle_adjust_large` on small inputs on the CPU and on the GPU, which
   must agree; and the whole-image ORB API (`gaussian_blur7`, `ic_angle`
   through the patch gather, `brief_descriptors`) on the slice's
   full-width front frame and its keypoints: blur within 1e-3, angles
   within 1e-4 rad, descriptors from the same angles bit-equal except in
   windows where the two blurs round apart (such bits counted);
14. small_linalg: the solvers' SVD and eigh kernels
   (`core/linalg.svd_small` / `eigh_small`, csrc/small_linalg.cu) against
   their plain versions at every site of tests/small_linalg_cases.py and
   on the inputs `initialize_two_view`, `pnp_ransac` and `sim3_ransac`
   build on the card, with that file's invariants and tolerances (NaN
   exactly in the non-finite entries), each wrapper call one launch under
   sync debug mode "error"; the three solvers' remaining sync warnings
   under "warn" (a reading); each kernel timed over the solvers' calls
   beside its plain version, torch.linalg, its bound (the larger of its
   bytes and the textbook operation count of an SVD / eigh, over the
   card's rates) and its launch floor (as many launches of an empty
   kernel of the same library, timed the same way). The init path counts the SVD kernel's launches, the
   recovering relocalization call both kernels', the loop drive eigh's
   (each must be above 0). The relocalization record splits the
   recovering call: its `pnp_ransac` call, a second call on the same
   inputs, and the process's first torch.linalg svd / eigh; the init
   record holds the process's first torch.linalg.det, timed just after
   initialization, which must call it on no CUDA tensor (`det_small`
   takes its closed form there), and `det_small`'s sign on the card
   against the library's on the matrices of the solvers' det sites.

Prints the card line, a `slice` JSON line, an `init` JSON line, a `system`
JSON line, a `loop` JSON line, a `depth` JSON line, a `cli` JSON line, a
`parallel` JSON line, a `small_linalg` JSON line, the `kernels` JSON line
(every kernel: patch_gather, jacobi_svd_f32, jacobi_eigh_f32) and, last,
`{"ok": true, "device": {...}}`. `python3 chip_smoke.py --gloo-worker RANK WORLD STORE OUT DEVICE`
is one process of the parallel phase's (c).
Writes the full record to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_FRAMES = 10            # seeded bird frames after the seed frame
N_MONO = 5               # seeded mono-only frames
N_INIT_DRIVE = 14        # frames fed to initialization and tracked from it
SYSTEM_FRAMES = 60       # frames fed to System
RELOC_FRAMES = 20        # frames before the camera goes blind
# the loop phase's circle: tests/test_loop_closing.py's drive (0.1 m and
# 2π/120 rad a frame, a 1.91 m radius, room half-size 8 m), 142 frames
LOOP_FRAMES = 142
CIRCLE = dict(speed=0.1, yaw_rate=2 * math.pi / 120, wall_x=8.0)
P, PB = 6144, 2048       # fused_point_cap, fused_bird_cap (api/config.py)
BEV = 384                # BirdviewCamera default (core/camera.py)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
REPS = 20                # timing repetitions per kernel measurement
SLEEP_CYCLES = 200_000_000   # ~0.1 s of GPU clock: the queue fills behind it

# Acceptance on the rendered drive, from the JAX package's own run of this
# drive cut to half size (tools/port_reference.py; PERF.md): it kept >= 231
# front and >= 248 bird inliers a frame, within 0.015 m / 0.04 deg with the
# bird edges and 0.038 m / 0.14 deg without. Full width doubles the features.
MIN_FRONT_INLIERS = 200
MIN_BIRD_INLIERS = 200
MIN_MONO_INLIERS = 200
MAX_POS_ERR_M = 0.05
MAX_ROT_ERR_DEG = 0.3
# CPU against GPU on the small input: the GPU's matmuls sum in another
# order (blur, LM), so the same budgets as the CPU parity tests hold
SMALL_POSE_TOL, SMALL_COUNT_TOL = 2e-3, 2
# the whole-image ORB API, GPU against CPU: the 7×7 blur's sums in another
# order (a few ulps of 255), atan2 of exact integer moments
WHOLE_BLUR_TOL, WHOLE_ANGLE_TOL = 1e-3, 1e-4
# Initialization on the drive. The JAX package's own run of the drive at
# half size (tools/port_reference.py; PERF.md) initialized on the fourth
# frame (keyframes 0 and 3) with 243 map points and 179 bird landmarks, its
# baseline 0.18 % short of the true one, T21's rotation 0.03 deg off, and
# a median reprojection error of 0.13 px after the BA; the port on the CPU
# read 246 / 178, 0.20 %, 0.04 deg and T21's direction 1.5 deg off (1 cm
# sideways over 0.36 m). Full width doubles the features and the BEV's
# resolution.
MAX_INIT_FRAMES = 10
MAX_BASELINE_REL_ERR = 0.02    # the bar of test_birdview_metric_scale
MAX_INIT_ROT_ERR_DEG = 0.3
MAX_INIT_DIR_ERR_DEG = 3.0
MIN_MAP_POINTS = 250
MIN_BIRD_LANDMARKS = 150
MAX_MEDIAN_REPROJ_PX = 1.0
# Tracked from the initialized map, against ground truth in the reference
# keyframe's frame, no scale alignment. Inliers: the seeded drive's floors.
# The half-size reference cannot show them (its map holds 246 points where
# the seeded bundle holds 984, and kept >= 57 front and >= 102 bird inliers
# a frame; port on the CPU 54 / 104); at full width the map holds 845
# points and 911 bird landmarks and the worst frame keeps 246 / 603. Pose
# limits from the half-size rows with margin: 0.019 m, 0.17 deg (port on
# the CPU 0.23 deg).
MIN_INIT_FRONT_INLIERS = MIN_FRONT_INLIERS
MIN_INIT_BIRD_INLIERS = MIN_BIRD_INLIERS
MAX_INIT_POS_ERR_M = 0.06
MAX_INIT_ROT_ERR_DEG_TRACKED = 0.5
# initialize_two_view and bundle_adjust, CPU against GPU with fixed draws
SMALL_INIT_TOL, SMALL_BA_TOL, SMALL_MASK_TOL = 1e-3, 1e-3, 3
# The GPU sums in another order than the CPU, and the fixed-length LM then
# stops at another place along the weakly observed depths of the mono
# points (10 m away over a baseline of at most 0.9 m): they move along their
# rays by up to ~9 mm with no inlier decision changed, while the ground
# points, observed in 3-D, stay put (the worst of SMALL_BA_GPU_RUNS runs is
# in chip_smoke.json under slice.small_reference.bundle_adjust). So the
# points are held where the cost observes them, their reprojections, to
# SMALL_BA_REPROJ_TOL pixels, and every point to SMALL_BA_POINT_MAX metres.
# The scatter sums are deterministic (graph/segsum.py: edges sorted by
# target once per problem, then a segment sum): the GPU runs agree bit for
# bit. Measured by tools/scatter_ab.py on an NVIDIA H100 80GB HBM3 at
# 700 W: mapping calls 744.267 / 712.509 ms median with index_add_,
# 582.820 / 608.789 with the sorted sums (no cost); the two index_add_
# runs read ATE 0.0018510 and 0.0018518 m, the two sorted runs 0.0018524 m
# both (PERF.md).
SMALL_BA_GPU_RUNS = 8
SMALL_BA_REPROJ_TOL, SMALL_BA_POINT_MAX = 0.02, 5e-2
# The SLAM loop through System on the drive: the bars of
# tests/test_e2e.py::test_birdview_metric_scale (metric ATE < 0.05 m with no
# scale alignment, path length within 2 %, > 200 bird landmarks); at least
# 95 % of the frames after initialization tracked; at least 4 keyframes and
# 2 local BAs landed. Both packages' System on the drive at half size on the
# CPU (tools/port_reference.py; PERF.md) tracked every frame after
# initialization with an ATE of 5 mm, a path-length ratio within 0.1 % and
# 8 keyframes over 40 frames.
MIN_SYSTEM_TRACKED_SHARE = 0.95
MAX_SYSTEM_ATE_M = 0.05
MIN_SYSTEM_KEYFRAMES = 4
MIN_SYSTEM_BA_LANDED = 2
MIN_SYSTEM_BIRD_LANDMARKS = 200
# relocalization: the bar of tests/test_e2e.py::test_relocalization_after_lost
RELOC_MAX_M = 0.02
# the loop phase: the bar of tests/test_loop_closing.py (metric keyframe
# ATE < 0.05 m, no scale alignment, after the loop and the GBA). Both
# packages on the circle at half size on the CPU (tools/port_reference.py;
# PERF.md) closed one loop at keyframes 2 and 38, ATE 0.019 (JAX) and
# 0.019 m (port) after two GBA rounds
MAX_LOOP_ATE_M = 0.05
# pnp_ransac and the two compacting mapping ops, CPU against GPU: the same
# draws and the same integer matching; poses sum in another order
SMALL_PNP_TOL, SMALL_TRI_RTOL = 1e-3, 5e-4
# the loop-closing solvers, CPU against GPU: the same draws and integer
# gates; f32 sums in another order (the parity tests' bars against the JAX
# package: 1e-4 for the Sim3, 1e-3 / 5e-3 for the pose graphs)
SMALL_SIM3_TOL = 1e-4
SMALL_GRAPH_S_TOL, SMALL_GRAPH_T_TOL = 1e-3, 5e-3
# The depth phase: System.track_stereo on the KITTI stereo configuration
# (configs/kitti00-02_stereo.yaml: 1241×376, 2000 features, 8 levels, bf
# 386.1448, ThDepth 35) and System.track_rgbd on TUM1's RGB-D one
# (configs/tum1_rgbd.yaml: 640×480, 1000 features, bf 40, ThDepth 40;
# distortion set to zero, the renders being pinhole), each at its full
# width on a textured wall. Bars: tracking OK at frame 0 (the depth
# initialization), >= 95 % of the frames tracked, metric ATE < 0.05 m with
# no scale alignment over the frames that see the whole textured wall (its
# share of the image not yet falling: the wall is 10.24 m wide and the
# KITTI camera, 12 m away, sees 20.7 m of it; from about frame 19 the
# texture leaves the view on the left and is down to a quarter of the image
# at frame 39). The ATE of the whole drive is recorded beside it:
# 0.0579 m over the 40 stereo frames on an NVIDIA H100 80GB HBM3 at 700 W,
# against 0.0070 m for the same frames with the wall's exact depth
# (tools/stereo_vs_exact_depth.py; PERF.md), because the reference's
# stereo refinement keeps the integer disparity of a match whose
# refinement failed (ROADMAP Queue 3). Patch-gather launches
# exactly: 2 a fused stereo frame (left and right in the step), 3 a
# slow-path stereo frame (left and right for the splatted depth map, the
# left again in make_frame), 1 an RGB-D frame.
STEREO_FRAMES = 40
STEREO_WALL = dict(wall_z=12.0, step=0.25, push=0.02)   # ~32 px disparity
RGBD_FRAMES = 60
RGBD_WALL = dict(wall_z=2.0, step=0.01, push=0.002)     # TUM's hand pace
MIN_DEPTH_TRACKED_SHARE = 0.95
MAX_DEPTH_ATE_M = 0.05
# the RGB-D revisit: tests/test_loop_closing.py's circle of 2π/120 rad a
# frame inside a box room small enough for the walls in view to lie within
# TUM1's close-depth threshold ThDepth·bf/fx = 3.1 m (the values of
# tests/torch_circle_depth.py); the loop closes with the scale fixed at 1
RGBD_CIRCLE_FRAMES = 142
RGBD_CIRCLE = dict(speed=0.04, yaw_rate=2 * math.pi / 120, wall_x=2.4)
# a keyframe at least every 3 frames (the tests' depth configurations,
# tests/torch_midrun.py). The keyframe policy of both packages has no
# depth-mode close-point trigger (ORB-SLAM2's bNeedToInsertClose): on a map
# whose points carry one observation each it mints on max_frames alone, and
# at 3° a frame TUM1's default of 30 frames outlasts the view
RGBD_CIRCLE_MAX_FRAMES_BETWEEN_KF = 3
MAX_RGBD_LOOP_ATE_M = 0.05
# cli: frames of each CLI run, and the ATE bar of the scored runs
CLI_FRAMES = dict(kitti=12, tum=20, fisheye=10, synthetic=20)
MAX_CLI_ATE_M = 0.05
# stereo_match / refine_stereo_subpixel, CPU against GPU on a small pair:
# integer matches equal; uR from SAD sums in another order
SMALL_STEREO_UR_TOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS, saturate=True) -> float:
    """Mean time of fn() over reps calls, after one warm-up, between CUDA
    events. With `saturate` the GPU first spins while the host enqueues all
    reps, so the events measure the device running them back to back;
    without it they also take in whatever the host adds between launches."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if saturate:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def front_camera(scale=1.0):
    from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
    return PinholeCamera(fx=348.5 * scale, fy=347.0 * scale, cx=480.0 * scale,
                         cy=302.0 * scale, width=round(950 * scale),
                         height=round(400 * scale))


def configs(n_front=2000, n_bird=2000):
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    return (ORBConfig(n_features=n_front, n_levels=8, min_threshold=5.0),
            ORBConfig(n_features=n_bird, n_levels=4))


def pose_errors(R, t, R_gt, t_gt):
    """(camera-centre error in m, rotation error in degrees)."""
    c = -R.T @ t
    c_gt = -R_gt.T @ t_gt
    cos = (np.trace(R @ R_gt.T) - 1.0) / 2.0
    return (float(np.linalg.norm(c - c_gt)),
            math.degrees(math.acos(min(1.0, max(-1.0, cos)))))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def kernel_phase(img, bev, mask, cfg, bcfg, dev):
    """The patch gather on one front and one BEV frame (2 calls over 12
    level shapes): see `gather_measure`."""
    return dict(
        name="patch_gather", route="cuda",
        source="orbslam_birdview_tpu_torch/csrc/patch_gather.cu",
        replaces="orbslam_birdview_tpu/frontend/patch_kernel.py:110",
        launches=None,
        **gather_measure([(img, cfg, None), (bev, bcfg, mask)], dev),
        note="per frame: one front + one BEV extraction, 12 levels; ms is "
             "the kernel's 2 launches (one per extraction), plain_ms and "
             "library_ms their 12 per-level calls, all with the device "
             "queue full; host_bound_ms the 2 launches as the step issues "
             "them; launch_floor_ms 2 launches of an empty kernel")


def gather_measure(extractions, dev):
    """Hold the patch gather against its plain version on the inputs the
    extractor gives it for each (image, ORBConfig, mask) of `extractions`
    (one call each) and on starts outside the image, and time the calls
    against the plain version, one PyTorch library call and the bound from
    bytes."""
    from orbslam_birdview_tpu_torch.frontend import orb, patch_kernel

    calls = []
    launch = patch_kernel.gather_patches_levels

    def record(padded_levels, ys_levels, xs_levels, size):
        calls.append((padded_levels, ys_levels, xs_levels, size))
        return launch(padded_levels, ys_levels, xs_levels, size)

    patch_kernel.gather_patches_levels = record
    try:
        for img, cfg, mask in extractions:
            orb.extract_orb(img, cfg, mask=mask, device=dev)
    finally:
        patch_kernel.gather_patches_levels = launch
    want = [cfg.n_levels for _, cfg, _ in extractions]
    check([len(c[0]) for c in calls] == want,
          f"expected gathers of {want} levels, got "
          f"{[len(c[0]) for c in calls]}")
    # the same calls level by level: (padded, ys, xs, size) per level
    levels = [lv for pl, yl, xl, size in calls
              for lv in zip(pl, yl, xl, [size] * len(pl))]

    def hold(padded_levels, ys_levels, xs_levels, size):
        """Kernel against plain for one call, whole and level by level."""
        out = launch(padded_levels, ys_levels, xs_levels, size)
        ref = patch_kernel.gather_patches_levels_plain(
            padded_levels, ys_levels, xs_levels, size)
        torch.cuda.synchronize()
        check(out.shape == ref.shape, f"shape {out.shape} != {ref.shape}")
        check(torch.equal(out, ref), "kernel != plain over "
              f"{[tuple(p.shape) for p in padded_levels]}")
        err = float((out - ref).abs().max())
        parts = out.split([ys.shape[0] for ys in ys_levels])
        for part, padded, ys, xs in zip(parts, padded_levels, ys_levels,
                                        xs_levels):
            one = patch_kernel.gather_patches_plain(padded, ys, xs, size)
            check(torch.equal(part, one),
                  f"kernel's slice != plain at level {tuple(padded.shape)}")
            check(torch.equal(patch_kernel.gather_patches(padded, ys, xs,
                                                          size), one),
                  f"one-level kernel != plain at {tuple(padded.shape)}")
            err = max(err, float((part - one).abs().max()))
        return err

    max_err = max(hold(*c) for c in calls)
    # starts past the far edge and negative starts: the clamp
    gen = torch.Generator(device=dev).manual_seed(0)
    for padded_levels, ys_levels, _, size in calls:
        def starts(extent):
            return [torch.randint(-size, p.shape[extent] + size,
                                  ys.shape, generator=gen, device=dev,
                                  dtype=torch.int32)
                    for p, ys in zip(padded_levels, ys_levels)]
        ys_out, xs_out = starts(0), starts(1)
        check(any(bool((y < 0).any()) for y in ys_out)
              and any(bool((x > p.shape[1] - size).any())
                      for x, p in zip(xs_out, padded_levels)),
              "the out-of-range case has no out-of-range start")
        max_err = max(max_err, hold(padded_levels, ys_out, xs_out, size))

    shapes = [[*padded.shape, ys.shape[0]] for padded, ys, _, _ in levels]
    n_bytes = sum((padded.numel() + 2 * ys.numel()) * 4
                  + ys.shape[0] * size * size * 4
                  for padded, ys, _, size in levels)

    def library(padded, ys, xs, size):
        yc, xc = patch_kernel.clamp_starts(padded, ys.long(), xs.long(), size)
        return padded.unfold(0, size, 1).unfold(1, size, 1)[yc, xc]

    for lv in levels:
        check(torch.equal(library(*lv),
                          patch_kernel.gather_patches_plain(*lv)),
              "library call != plain")
    kernel_ms = cuda_ms(lambda: [launch(*c) for c in calls])
    plain_ms = cuda_ms(lambda: [patch_kernel.gather_patches_plain(*lv)
                                for lv in levels])
    library_ms = cuda_ms(lambda: [library(*lv) for lv in levels])
    # the same 2 launches as the step issues them: host wrapper included
    kernel_host_ms = cuda_ms(lambda: [launch(*c) for c in calls],
                             saturate=False)
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=library_ms, host_bound_ms=kernel_host_ms,
                launch_floor_ms=launch_floor_ms(len(calls), dev),
                bytes=n_bytes, level_shapes=shapes)


def launch_floor_ms(count, dev):
    """`count` launches of an empty kernel of one block
    (`small_linalg_empty` of csrc/small_linalg.cu) through the wrappers'
    ctypes launch, timed as `cuda_ms` times the kernels: the floor under
    that many launches of any of them."""
    from orbslam_birdview_tpu_torch.core import linalg

    empty = linalg._kernels()[2]
    return cuda_ms(lambda: [linalg._launch(empty, (), dev)
                            for _ in range(count)])


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------

def seed_state(seq, img0, bev0, mask, cfg, bcfg, n_lm, n_bird, dev):
    from orbslam_birdview_tpu_torch.frontend import orb
    from orbslam_birdview_tpu_torch.pipeline import state
    from orbslam_birdview_tpu_torch.utils import synth

    kp = synth.keypoints_numpy(orb.extract_orb(img0, cfg, device=dev))
    bkp = synth.keypoints_numpy(orb.extract_orb(bev0, bcfg, mask=mask,
                                                device=dev))
    lm, bird = synth.seed_fields(seq, 0, kp, bkp, cfg.n_levels,
                                 cfg.scale_factor, n_lm, n_bird)
    sf = np.array(cfg.level_scales(), np.float32)
    return state.carry_across(
        lm, sf, (1.0 / sf ** 2).astype(np.float32), cfg._asdict(),
        bird_lm=bird, bird_cfg=bcfg._asdict(), bv=seq.bv._asdict(),
        R_bc=seq.R_bc, t_bc=seq.t_bc, device=dev)


def run_drive(st, frames, cam, mask, bird, dev, start=None):
    """Chain the step over frames[1:] on the device pose chain, starting
    from `start` (R, t), or else from frame 0's ground-truth pose; per-frame
    records."""
    from orbslam_birdview_tpu_torch.pipeline import fused_track

    R0, t0 = (torch.as_tensor(a, device=dev)
              for a in (frames[0][2] if start is None else start))
    R_pred, t_pred, R_last, t_last = R0, t0, R0, t0
    vis = found = None
    rows = []
    for img, bev, (R_gt, t_gt) in frames[1:]:
        kw = {}
        if bird:
            kw = dict(bird_img=bev, bird_mask=mask, bird_lm=st.bird_lm,
                      bird_cfg=st.bird_cfg, bv=st.bv, R_bc=st.R_bc,
                      t_bc=st.t_bc)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_start = time.perf_counter()
        out = fused_track.track_step_mono(
            img, R_pred, t_pred, st.lm, st.scale_factors, st.inv_sigma2,
            st.cfg, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
            R_last=R_last, t_last=t_last, vis_acc=vis, found_acc=found,
            device=dev, **kw)
        s = fused_track.unpack_summary(out.summary.cpu().numpy())
        step_ms = (time.perf_counter() - t_start) * 1e3
        check(all(np.isfinite(v).all() for v in (s["R"], s["t"])),
              "non-finite pose")
        check(out.kp_slot.shape == (st.cfg.padded_capacity(),),
              f"kp_slot shape {tuple(out.kp_slot.shape)}")
        pos_err, rot_err = pose_errors(s["R"], s["t"], R_gt, t_gt)
        rows.append(dict(step_ms=step_ms, R=s["R"].tolist(),
                         t=s["t"].tolist(), n_inliers=s["n_inliers"],
                         n_matched=s["n_matched"],
                         n_inliers_bird=s["n_inliers_bird"], n_kp=s["n_kp"],
                         pos_err_m=pos_err, rot_err_deg=rot_err))
        R_last, t_last = out.R, out.t
        R_pred, t_pred = out.R_pred_next, out.t_pred_next
        vis, found = out.vis_acc, out.found_acc
    return rows


def summarize(rows):
    steps = [r["step_ms"] for r in rows[1:]]   # frame 1 pays the warm-up
    return dict(
        frames=len(rows), median_step_ms=float(np.median(steps)),
        first_step_ms=rows[0]["step_ms"],
        min_front_inliers=min(r["n_inliers"] for r in rows),
        median_front_inliers=float(np.median([r["n_inliers"] for r in rows])),
        min_bird_inliers=min(r["n_inliers_bird"] for r in rows),
        median_bird_inliers=float(np.median([r["n_inliers_bird"]
                                             for r in rows])),
        max_pos_err_m=max(r["pos_err_m"] for r in rows),
        max_rot_err_deg=max(r["rot_err_deg"] for r in rows))


def render_frames(frame, n_frames):
    """[frame(i) for i in range(n_frames)], rendered on a pool of host
    threads (numpy releases the GIL in the large array operations)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(frame, range(n_frames)))


def render_drive(n_frames=N_FRAMES + 1, scale=1.0, features=2000,
                 **motion):
    """The drive every phase runs on: camera, BEV camera, extractor
    configurations, the rendered frames with their ground truth, the BEV
    footprint mask. `scale` cuts the images (and `features` the budgets)
    for runs on a CPU; `motion` overrides BirdSequence's speed, yaw rate
    and room (the loop phase's circle, `CIRCLE`)."""
    from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera
    from orbslam_birdview_tpu_torch.utils import synth

    cam = front_camera(scale)
    bv = BirdviewCamera(pixel2meter=0.03984 * 1.7 / scale,
                        width=round(BEV * scale), height=round(BEV * scale))
    cfg, bcfg = configs(features, features)
    t0 = time.perf_counter()
    seq = synth.BirdSequence(cam, bv, n_frames=n_frames, **motion)
    frames = render_frames(seq.frame, n_frames)
    mask = synth.footprint_mask(bv)
    return dict(cam=cam, bv=bv, cfg=cfg, bcfg=bcfg, seq=seq, frames=frames,
                mask=mask, render_s=time.perf_counter() - t0)


def slice_phase(drive, dev):
    from orbslam_birdview_tpu_torch.frontend import patch_kernel

    cam, bv, cfg, bcfg, seq, frames, mask, render_s = (
        drive[k] for k in ("cam", "bv", "cfg", "bcfg", "seq", "frames",
                           "mask", "render_s"))
    st = seed_state(seq, frames[0][0], frames[0][1], mask, cfg, bcfg, P, PB,
                    dev)
    check(int(st.lm.valid.sum()) >= cfg.n_features // 2
          and int(st.bird_lm.valid.sum()) >= bcfg.n_features // 4,
          "seeding produced too few landmarks")

    kernel = kernel_phase(frames[1][0], frames[1][1], mask, cfg, bcfg, dev)

    patch_kernel.LAUNCHES = 0
    rows = run_drive(st, frames, cam, mask, True, dev)
    bird_launches = patch_kernel.LAUNCHES
    n = len(rows)
    # one launch per extraction: front and BEV
    check(bird_launches == 2 * n,
          f"patch kernel launched {bird_launches} times in {n} bird frames")
    kernel["launches_by_phase"] = dict(seeded_bird=bird_launches)

    patch_kernel.LAUNCHES = 0
    mono_rows = run_drive(st, frames[:N_MONO + 1], cam, None, False, dev)
    mono_launches = patch_kernel.LAUNCHES
    check(mono_launches == len(mono_rows),
          f"patch kernel launched {mono_launches} times in "
          f"{len(mono_rows)} mono frames")
    kernel["launches_by_phase"]["seeded_mono"] = mono_launches

    bird_sum, mono_sum = summarize(rows), summarize(mono_rows)
    slice_rec = dict(
        step="track_step_mono", front=f"{cam.width}x{cam.height}",
        bev=f"{bv.width}x{bv.height}", features=[cfg.n_features,
                                                 bcfg.n_features],
        P=P, Pb=PB, render_s=render_s, bird=bird_sum, mono=mono_sum,
        kernel_launches_per_bird_frame=bird_launches / n,
        kernel_launches_per_mono_frame=mono_launches / len(mono_rows),
        floors=dict(front=MIN_FRONT_INLIERS, bird=MIN_BIRD_INLIERS,
                    mono=MIN_MONO_INLIERS, pos_m=MAX_POS_ERR_M,
                    rot_deg=MAX_ROT_ERR_DEG))
    return kernel, slice_rec, dict(bird=rows, mono=mono_rows), st


PROFILE_RANGES = ("front_extract", "bev_extract", "pose_lm")


@contextlib.contextmanager
def labelled_entry_points():
    """While active, the step's calls of `extract_orb` and `optimize_pose`
    run inside profiler ranges named in PROFILE_RANGES. The ranges are
    opened here, around the entry points; the package's code has none."""
    from torch.profiler import record_function

    from orbslam_birdview_tpu_torch.frontend import orb
    from orbslam_birdview_tpu_torch.graph import pose_opt

    extract, solve = orb.extract_orb, pose_opt.optimize_pose

    def extract_in_range(img, cfg, mask=None, **kw):
        name = "front_extract" if mask is None else "bev_extract"
        with record_function(name):
            return extract(img, cfg, mask=mask, **kw)

    def solve_in_range(*args, **kw):
        with record_function("pose_lm"):
            return solve(*args, **kw)

    orb.extract_orb, pose_opt.optimize_pose = extract_in_range, solve_in_range
    try:
        yield
    finally:
        orb.extract_orb, pose_opt.optimize_pose = extract, solve


def launched_under(event):
    """(count, device µs) of the kernels launched by a host-side profiler
    event and everything it called."""
    n = len(event.kernels)
    us = sum(k.duration for k in event.kernels)
    for child in event.cpu_children:
        cn, cus = launched_under(child)
        n, us = n + cn, us + cus
    return n, us


def profile_step(st, frames, cam, mask, dev, median_step_ms):
    """One bird frame under torch.profiler: the kernels it runs on the
    device, their busy time, their attribution to the two extractions, the
    pose LM (both solves) and the rest of the step (matching, gates,
    state), and the device's idle share of the unprofiled median step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_drive(st, frames[:2], cam, mask, True, dev)    # warm
    with labelled_entry_points(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rows = run_drive(st, frames[:2], cam, mask, True, dev)
    kernels = []
    for avg in prof.key_averages():
        # device-side rows only: an op's row repeats its kernels' time, and
        # a range's device-side twin spans its kernels
        if avg.device_type != DeviceType.CUDA or avg.key in PROFILE_RANGES:
            continue
        dev_us = getattr(avg, "self_device_time_total",
                         getattr(avg, "self_cuda_time_total", 0.0))
        kernels.append((dev_us, avg.count, avg.key))
    busy_ms = sum(k[0] for k in kernels) / 1e3
    n_kernels = sum(k[1] for k in kernels)
    kernels.sort(reverse=True)

    by_layer = {name: dict(calls=0, kernels=0, device_ms=0.0)
                for name in PROFILE_RANGES}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in by_layer:
            n, us = launched_under(ev)
            layer = by_layer[ev.name]
            layer["calls"] += 1
            layer["kernels"] += n
            layer["device_ms"] += us / 1e3
    check([by_layer[name]["calls"] for name in PROFILE_RANGES] == [1, 1, 2],
          f"profiler ranges seen: {by_layer}")
    check(all(layer["kernels"] > 0 for layer in by_layer.values()),
          f"a profiler range shows no device kernel: {by_layer}")
    by_layer["rest"] = dict(
        kernels=n_kernels - sum(v["kernels"] for v in by_layer.values()),
        device_ms=busy_ms - sum(v["device_ms"] for v in by_layer.values()))
    check(by_layer["rest"]["kernels"] >= 0,
          f"ranges hold more kernels than the frame ran: {by_layer}")
    return dict(
        profiled_wall_ms=rows[0]["step_ms"], device_busy_ms=busy_ms,
        idle_share=(1.0 - busy_ms / median_step_ms) if busy_ms > 0 else None,
        device_kernels=n_kernels, by_layer=by_layer,
        top=[dict(ms=k[0] / 1e3, count=k[1], name=k[2][:90])
             for k in kernels[:12]])


# ---------------------------------------------------------------------------
# initialization, and tracking from the initialized map
# ---------------------------------------------------------------------------

def slam_config(drive, point_cap=P, bird_cap=PB):
    """The `SlamConfig` of the drive: mono+bird, the drive's extrinsics."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core import lie

    seq = drive["seq"]
    cfg = SlamConfig(camera=drive["cam"], orb=drive["cfg"],
                     bird_orb=drive["bcfg"], birdview=drive["bv"],
                     sensor="mono_bird")
    cfg.tbc_quat = tuple(lie.rot_to_quat(torch.as_tensor(seq.R_bc)).tolist())
    cfg.tbc_t = tuple(seq.t_bc.tolist())
    cfg.tracking.fused_point_cap = point_cap
    cfg.tracking.fused_bird_cap = bird_cap
    return cfg


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_launches(launches, n_frames, dev):
    """One patch-gather launch per extraction, two per bird frame, on the
    card; none on the CPU, where the wrapper takes its plain version."""
    want = 2 * n_frames if dev.type == "cuda" else 0
    check(launches == want, f"patch kernel launched {launches} times in "
          f"{n_frames} bird frames on {dev.type}, expected {want}")


@contextlib.contextmanager
def library_det_calls(devices):
    """While active, every `torch.linalg.det` call appends its tensor's
    device type to `devices`."""
    real = torch.linalg.det

    def counted(X, *args, **kw):
        devices.append(X.device.type)
        return real(X, *args, **kw)

    torch.linalg.det = counted
    try:
        yield
    finally:
        torch.linalg.det = real


def det_sign_check(dev):
    """`det_small` on the card (its closed form) against `torch.linalg.det`
    on the CPU on the matrices of the solvers' det sites
    (tests/small_linalg_cases.py `det_inputs`): the same sign on every
    matrix, with no host sync."""
    from orbslam_birdview_tpu_torch.core import linalg

    out = {}
    for name, X in linalg_cases().det_inputs().items():
        got = sync_free(linalg.det_small, torch.from_numpy(X).to(dev)).cpu()
        want = torch.linalg.det(torch.from_numpy(X))
        agree = int((torch.sign(got) == torch.sign(want)).sum())
        check(agree == len(X), f"det_small's sign is not the library's at "
              f"{name}: {agree} of {len(X)} agree")
        out[name] = dict(matrices=len(X),
                         max_abs_diff=float((got - want).abs().max()))
    return out


@contextlib.contextmanager
def observed_init(dev, seen):
    """While active, `extract_orb` is timed (host clock around a sync) into
    seen["extract_ms"], and the arguments and result of `bundle_adjust` are
    kept in seen["ba"]. Both are wrapped here; the package has no hooks."""
    from orbslam_birdview_tpu_torch.frontend import orb
    from orbslam_birdview_tpu_torch.graph import ba

    extract, solve = orb.extract_orb, ba.bundle_adjust

    def timed_extract(*args, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = extract(*args, **kw)
        sync(dev)
        seen["extract_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def kept_solve(*args, **kw):
        res = solve(*args, **kw)
        seen["ba"] = (args, kw, res)
        return res

    orb.extract_orb, ba.bundle_adjust = timed_extract, kept_solve
    try:
        yield
    finally:
        orb.extract_orb, ba.bundle_adjust = extract, solve


def ba_costs(seen, dev):
    """Cost of the BA's first and of its last state over ALL its edges (the
    BA's own final cost leaves out what it reclassified as outliers)."""
    from orbslam_birdview_tpu_torch.graph import ba

    args, kw, res = seen["ba"]
    cam_R, cam_t, _, _, points, _, mono, stereo, bird, fx, fy, cx, cy = args
    sets = [(k, ba._edges_on(es, dev))
            for k, es in (("mono", mono), ("stereo", stereo), ("bird", bird))]
    intr = (fx, fy, cx, cy, kw.get("bf", 0.0))
    first = float(ba._cost_only(cam_R, cam_t, points, sets, intr, True))
    last = float(ba._cost_only(res.cam_R, res.cam_t, res.points, sets, intr,
                               True))
    return dict(cost_first=first, cost_last=last,
                cost_inliers_only=float(res.cost), cameras=cam_R.shape[0],
                points=points.shape[0],
                edges=[int(es.valid.shape[0]) for _, es in sets],
                valid_edges=[int(es.valid.sum()) for _, es in sets],
                inliers=[int(m.sum()) for m in (res.inl_mono, res.inl_stereo,
                                                res.inl_bird)])


def relative_pose(pose, ref):
    """`pose` (world→camera) re-expressed with the camera frame of `ref` as
    the world."""
    (R, t), (R_ref, t_ref) = pose, ref
    Rn = R @ R_ref.T
    return Rn, t - Rn @ t_ref


def reprojection_px(store, cam, kf):
    """Median reprojection error (px) of a keyframe's map points."""
    obs = store.kf_kp_mp[kf]
    k = np.nonzero(obs >= 0)[0]
    Xc = store.mp_pos[obs[k]] @ store.kf_R[kf].T + store.kf_t[kf]
    uv = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                   cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], 1)
    return float(np.median(np.linalg.norm(uv - store.kf_kp_xy[kf, k], axis=1)))


def init_phase(drive, dev, floors=True):
    """Feed the drive through `Tracker.process` until it has initialized;
    hold the map against ground truth. Returns (tracker, record)."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.mapping.mapstore import MapStore
    from orbslam_birdview_tpu_torch.pipeline import local_mapping, tracking

    seq, frames, mask, cam = (drive[k] for k in ("seq", "frames", "mask",
                                                 "cam"))
    cfg = slam_config(drive, drive.get("P", P), drive.get("PB", PB))
    store = MapStore(kp_cap=cfg.orb.padded_capacity(),
                     bird_cap=cfg.effective_bird_orb().padded_capacity())
    mapper = local_mapping.LocalMapper(cfg, store, device=dev)
    tracker = tracking.Tracker(cfg, store, mapper, device=dev)

    patch_kernel.LAUNCHES = 0
    linalg_launches(reset=True)
    attempts, fed = [], 0
    seen = dict(extract_ms=0.0, ba=None)
    for i, (img, bev, _) in enumerate(frames[:MAX_INIT_FRAMES]):
        seen["extract_ms"] = 0.0
        tracker.timer.reset()
        sync(dev)
        t0 = time.perf_counter()
        with observed_init(dev, seen):
            fd = tracker.process(img, float(i), bev, mask)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        fed += 1
        stages = {k: sum(v) * 1e3 for k, v in tracker.timer.samples.items()}
        if tracker.init_stats.get("attempted"):
            attempts.append(dict(tracker.init_stats, wall_ms=wall_ms,
                                 extract_ms=seen["extract_ms"],
                                 match_ms=stages.get("init.match", 0.0),
                                 two_view_ms=stages.get("init.two_view", 0.0)))
        if tracker.state == tracking.OK:
            break
    launches = patch_kernel.LAUNCHES
    solver_launches = linalg_launches()
    check(tracker.state == tracking.OK,
          f"not initialized after {fed} frames: {attempts}")
    check_launches(launches, fed, dev)
    check_linalg_launches(solver_launches, [SVD_KERNEL], "init")
    # early failures are the 0.3 m veto at work, not faults
    last = attempts[-1]
    check(last["ok"] and last["icp_ok"], f"initialized without the ICP: {last}")

    kf1, kf2 = 0, 1
    ref_pose = seq.gt_cam_pose(int(store.kf_frame_id[kf1]))
    R_gt, t_gt = relative_pose(seq.gt_cam_pose(int(store.kf_frame_id[kf2])),
                               ref_pose)
    R, t = store.kf_R[kf2], store.kf_t[kf2]
    _, rot_err = pose_errors(R, t, R_gt, t_gt)
    base, base_gt = float(np.linalg.norm(t)), float(np.linalg.norm(t_gt))
    dir_err = math.degrees(math.acos(min(1.0, float(t @ t_gt)
                                         / (base * base_gt))))
    used = [store.kf_R[:2], store.kf_t[:2], store.mp_pos[:store.n_mp],
            store.mp_normal[:store.n_mp], store.mp_min_dist[:store.n_mp],
            store.mp_max_dist[:store.n_mp], store.bmp_pos[:store.n_bmp], fd.R,
            fd.t]
    check(all(np.isfinite(a).all() for a in used), "non-finite map")
    ba_rec = ba_costs(seen, dev)
    map_ms = stages["init.map"] - stages["init.ba"]
    rec = dict(
        frames_fed=fed, attempts=len(attempts),
        used_homography=last["used_homography"], icp_ok=last["icp_ok"],
        matches_front=last["n_matches"], matches_bev=last["n_bird_matches"],
        icp_inliers=last["n_icp_inliers"],
        triangulated=last["n_triangulated"], keyframes=int(store.n_kf),
        keyframe_frames=store.kf_frame_id[:2].tolist(),
        map_points=int(store.n_mp), bird_landmarks=int(store.n_bmp),
        baseline_m=base, baseline_gt_m=base_gt, scale_ratio=base / base_gt,
        rot_err_deg=rot_err, dir_err_deg=dir_err,
        median_reproj_px=[reprojection_px(store, cam, kf1),
                          reprojection_px(store, cam, kf2)],
        ba=ba_rec,
        successful_attempt_ms=dict(
            wall=last["wall_ms"], extraction=last["extract_ms"],
            matching=last["match_ms"], initialize_two_view=last["two_view_ms"],
            map_construction=map_ms, ba=stages["init.ba"]),
        failed_attempts_ms=[dict(wall=a["wall_ms"], extraction=a["extract_ms"],
                                 matching=a["match_ms"],
                                 initialize_two_view=a["two_view_ms"])
                            for a in attempts[:-1]],
        first_initialize_two_view_ms=attempts[0]["two_view_ms"],
        patch_gather_launches=launches, small_linalg_launches=solver_launches)
    if floors:
        check(abs(rec["scale_ratio"] - 1.0) <= MAX_BASELINE_REL_ERR,
              f"baseline {base} m against {base_gt} m")
        check(rot_err <= MAX_INIT_ROT_ERR_DEG, f"T21 rotation {rot_err} deg")
        check(dir_err <= MAX_INIT_DIR_ERR_DEG, f"T21 direction {dir_err} deg")
        check(rec["map_points"] >= MIN_MAP_POINTS,
              f"{rec['map_points']} map points")
        check(rec["bird_landmarks"] >= MIN_BIRD_LANDMARKS,
              f"{rec['bird_landmarks']} bird landmarks")
        check(max(rec["median_reproj_px"]) <= MAX_MEDIAN_REPROJ_PX,
              f"median reprojection {rec['median_reproj_px']} px")
        check(ba_rec["cost_last"] <= ba_rec["cost_first"],
              f"the BA raised its cost: {ba_rec}")
    return tracker, rec


def tracked_from_init_phase(tracker, drive, dev):
    """The drive's remaining frames through `track_step_mono`, from the
    bundles `_refresh_local_map` builds out of the store and the second
    keyframe's pose. Ground truth is expressed in the reference keyframe's
    camera frame (the map's world); nothing is aligned."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.pipeline import state

    seq, frames, mask, cam = (drive[k] for k in ("seq", "frames", "mask",
                                                 "cam"))
    store = tracker.store
    tracker._refresh_local_map()
    check(tracker._lm_bundle is not None and tracker._bird_bundle is not None,
          "no bundles after initialization")
    check(tracker._lm_n == store.n_mp and tracker._bird_n == store.n_bmp,
          f"bundles hold {tracker._lm_n}/{tracker._bird_n} of "
          f"{store.n_mp}/{store.n_bmp} landmarks")
    st = state.TrackState(
        lm=tracker._lm_bundle, scale_factors=tracker._sf_dev,
        inv_sigma2=tracker._isig_dev, cfg=tracker.cfg.orb,
        bird_lm=tracker._bird_bundle,
        bird_cfg=tracker.cfg.effective_bird_orb(), bv=tracker.cfg.birdview,
        R_bc=tracker._R_bc_dev, t_bc=tracker._t_bc_dev)
    ref_pose = seq.gt_cam_pose(int(store.kf_frame_id[0]))
    first = int(store.kf_frame_id[1])
    rest = [(img, bev, relative_pose(pose, ref_pose))
            for img, bev, pose in frames[first:]]
    patch_kernel.LAUNCHES = 0
    rows = run_drive(st, rest, cam, mask, True, dev,
                     start=(tracker.last_frame.R, tracker.last_frame.t))
    launches = patch_kernel.LAUNCHES
    check_launches(launches, len(rows), dev)
    rec = summarize(rows)
    rec.update(first_frame=first + 1, patch_gather_launches=launches,
               bundle_points=tracker._lm_n, bundle_bird=tracker._bird_n)
    return rec, rows


def check_tracked_from_init(rec):
    check(rec["min_front_inliers"] >= MIN_INIT_FRONT_INLIERS,
          f"from init: front inliers {rec['min_front_inliers']}")
    check(rec["min_bird_inliers"] >= MIN_INIT_BIRD_INLIERS,
          f"from init: bird inliers {rec['min_bird_inliers']}")
    check(rec["max_pos_err_m"] <= MAX_INIT_POS_ERR_M,
          f"from init: position error {rec['max_pos_err_m']} m")
    check(rec["max_rot_err_deg"] <= MAX_INIT_ROT_ERR_DEG_TRACKED,
          f"from init: rotation error {rec['max_rot_err_deg']} deg")


def check_floors(slice_rec):
    bird, mono = slice_rec["bird"], slice_rec["mono"]
    check(bird["min_front_inliers"] >= MIN_FRONT_INLIERS,
          f"front inliers {bird['min_front_inliers']} < {MIN_FRONT_INLIERS}")
    check(bird["min_bird_inliers"] >= MIN_BIRD_INLIERS,
          f"bird inliers {bird['min_bird_inliers']} < {MIN_BIRD_INLIERS}")
    check(mono["min_front_inliers"] >= MIN_MONO_INLIERS,
          f"mono inliers {mono['min_front_inliers']} < {MIN_MONO_INLIERS}")
    for name, s in (("bird", bird), ("mono", mono)):
        check(s["max_pos_err_m"] <= MAX_POS_ERR_M,
              f"{name} position error {s['max_pos_err_m']} m")
        check(s["max_rot_err_deg"] <= MAX_ROT_ERR_DEG,
              f"{name} rotation error {s['max_rot_err_deg']} deg")


def whole_image_orb_reference(dev, img, cfg):
    """The whole-image ORB API (`gaussian_blur7`, `ic_angle`,
    `brief_descriptors`) on the GPU against the CPU, on a full-width front
    frame and its extracted keypoints (level-0 pixels, rounded): blur
    within WHOLE_BLUR_TOL, angles within WHOLE_ANGLE_TOL rad (the moments
    are exact integers; atan2 may differ by an ulp), and the descriptors
    from the same angle bit-equal except where the two blurs round to
    different integers inside the keypoint's window (a blur on either side
    of a .5 boundary): such bits are counted. On the card `ic_angle` runs
    the patch-gather kernel (launches not counted: this is a comparison)."""
    from orbslam_birdview_tpu_torch.frontend import orb

    cpu = torch.device("cpu")
    kp = orb.extract_orb(img, cfg, device="cpu")
    valid = kp.valid.numpy()
    xy = np.round(kp.xy.numpy()[valid]).astype(np.int32)
    h, w = img.shape
    inside = ((xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0)
              & (xy[:, 1] < h))
    xs, ys = xy[inside, 0], xy[inside, 1]
    out = {}
    for d in (cpu, dev):
        im = torch.as_tensor(img, device=d).float()
        y_, x_ = torch.as_tensor(ys, device=d), torch.as_tensor(xs, device=d)
        blur = orb.gaussian_blur7(im)
        ang = orb.ic_angle(im, y_, x_)
        out[d.type] = (blur, ang, y_, x_)
    (cb, ca, cy, cx), (gb, ga, gy, gx) = out["cpu"], out[dev.type]
    blur_err = float((gb.cpu() - cb).abs().max())
    ang_d = (ga.cpu() - ca).abs()
    ang_err = float(torch.minimum(ang_d, 2 * math.pi - ang_d).max())
    check(blur_err <= WHOLE_BLUR_TOL,
          f"gaussian_blur7: gpu and cpu differ by {blur_err}")
    check(ang_err <= WHOLE_ANGLE_TOL,
          f"ic_angle: gpu and cpu differ by {ang_err} rad")
    # the same angles (the GPU's) on both sides: only the blur differs
    dg = orb.brief_descriptors(gb, gy, gx, ga)
    dc = orb.brief_descriptors(cb, cy, cx, ga.cpu())
    diff_bits = np.unpackbits(dg.cpu().numpy() ^ dc.numpy(), axis=1).sum(1)
    rounds_apart = (torch.round(gb.cpu()) != torch.round(cb)).numpy()
    S = orb.BLUR_PATCH
    pad = np.pad(rounds_apart, S // 2, mode="edge")
    explained = np.array([pad[y:y + S, x:x + S].any()
                          for y, x in zip(ys, xs)])
    unexplained = int(((diff_bits > 0) & ~explained).sum())
    check(unexplained == 0,
          f"brief_descriptors: {unexplained} keypoints' bits differ with no "
          "blur rounding apart in their window")
    return dict(image=f"{w}x{h}", keypoints=int(len(xs)),
                max_blur_err=blur_err, max_angle_err_rad=ang_err,
                blur_pixels_rounded_apart=int(rounds_apart.sum()),
                descriptor_bits_differing=int(diff_bits.sum()),
                keypoints_with_bits_differing=int((diff_bits > 0).sum()),
                tolerances=dict(blur=WHOLE_BLUR_TOL,
                                angle_rad=WHOLE_ANGLE_TOL))


def reference_phase(dev, front_img):
    """The step on a small input, on the CPU (plain versions) and on the
    GPU (kernels): the two must agree. Then `initialize_two_view` and
    `bundle_adjust`, likewise; and the whole-image ORB API on the slice's
    full-width front frame (`whole_image_orb_reference`)."""
    from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera
    from orbslam_birdview_tpu_torch.utils import synth

    cam = front_camera(scale=224 / 950)
    bv = BirdviewCamera(width=128, height=128)
    cfg, bcfg = configs(300, 300)
    cfg = cfg._replace(n_levels=4)
    seq = synth.BirdSequence(cam, bv, n_frames=4)
    frames = [seq.frame(i) for i in range(4)]
    mask = synth.footprint_mask(bv)
    # one bundle, seeded on the CPU, for both runs
    st = seed_state(seq, frames[0][0], frames[0][1], mask, cfg, bcfg, 512,
                    384, torch.device("cpu"))
    cpu_rows, gpu_rows = (run_drive(st.to(d), frames, cam, mask, True, d)
                          for d in (torch.device("cpu"), dev))
    for rc, rg in zip(cpu_rows, gpu_rows):
        for k in ("n_inliers", "n_matched", "n_inliers_bird", "n_kp"):
            check(abs(rc[k] - rg[k]) <= SMALL_COUNT_TOL,
                  f"small input: {k} cpu {rc[k]} gpu {rg[k]}")
        for k in ("R", "t"):
            check(np.abs(np.subtract(rc[k], rg[k])).max() <= SMALL_POSE_TOL,
                  f"small input: cpu and gpu {k} differ")
    return dict(frames=len(cpu_rows),
                cpu_inliers=[r["n_inliers"] for r in cpu_rows],
                gpu_inliers=[r["n_inliers"] for r in gpu_rows],
                initialize_two_view=small_init_reference(dev),
                bundle_adjust=small_ba_reference(dev),
                pnp_ransac=small_pnp_reference(dev),
                mapping_ops=small_mapping_ops_reference(dev),
                whole_image_orb=whole_image_orb_reference(dev, front_img,
                                                          configs()[0]))


def small_two_view(rng, n=300, nb=150):
    """A planar vehicle motion (yaw 0.1 rad, 0.92 m) seen by a camera whose
    frame is the base frame: matched pixels of two views with 5 % outliers
    and matched BEV ground points, from a seed."""
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    c, s_ = math.cos(0.1), math.sin(0.1)
    R2d = np.array([[c, -s_], [s_, c]], np.float32)
    tb = np.array([0.9, 0.2], np.float32)
    g2 = rng.uniform(-6, 6, (nb, 2)).astype(np.float32)
    g1 = (g2 @ R2d.T + tb + rng.normal(0, 0.01, (nb, 2))).astype(np.float32)
    R21 = np.eye(3, dtype=np.float32)
    R21[:2, :2] = R2d.T
    t21 = -R21 @ np.array([tb[0], tb[1], 0.0], np.float32)
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 12, n)], 1).astype(np.float32)

    def pixels(Xc):
        uv = Xc @ K.T
        return (uv[:, :2] / uv[:, 2:3]
                + rng.normal(0, 0.3, (n, 2))).astype(np.float32)

    x1, x2 = pixels(X), pixels(X @ R21.T + t21)
    x2[: n // 20] = rng.uniform(0, 640, (n // 20, 2))
    return K, x1, x2, g1, g2, R21, t21


def small_init_reference(dev):
    """`initialize_two_view` with the bird arguments on the CPU and on the
    GPU from the same draws: same flags, same motion, same points."""
    from orbslam_birdview_tpu_torch.solvers import initializer

    K, x1, x2, g1, g2, R21, t21 = small_two_view(np.random.default_rng(0))
    draws = initializer.draw_init(torch.Generator().manual_seed(0), 256,
                                  "cpu")
    out = []
    for d in (torch.device("cpu"), dev):
        res = initializer.initialize_two_view(
            draws, x1, x2, np.ones(len(x1), bool), K, sigma=1.0, bird_xy1=g1,
            bird_xy2=g2, bird_valid=np.ones(len(g1), bool), bird_sigma=0.05,
            R_bc=np.eye(3, dtype=np.float32), t_bc=np.zeros(3, np.float32),
            device=d)
        check(res.R21.device.type == d.type, "result on the wrong device")
        out.append(initializer.fetch_result(res))
    c, g = out
    check(bool(c.ok) and bool(g.ok) and bool(c.icp_ok) and bool(g.icp_ok),
          f"small init: ok cpu {c.ok} gpu {g.ok}, icp {c.icp_ok} {g.icp_ok}")
    check(bool(c.used_homography) == bool(g.used_homography),
          "small init: model choice differs")
    check(np.abs(c.R21 - g.R21).max() <= SMALL_INIT_TOL
          and np.abs(c.t21 - g.t21).max() <= SMALL_INIT_TOL,
          f"small init: motion differs: {c.t21} {g.t21}")
    check(int((c.good != g.good).sum()) <= SMALL_MASK_TOL
          and int((c.bird_inliers != g.bird_inliers).sum()) <= SMALL_MASK_TOL,
          "small init: masks differ")
    both = c.good & g.good
    rel = (np.abs(c.points3d[both] - g.points3d[both])
           / np.maximum(np.abs(c.points3d[both]), 1.0))
    check(rel.max() <= 5 * SMALL_INIT_TOL, f"small init: points {rel.max()}")
    check(abs(np.linalg.norm(g.t21) / np.linalg.norm(t21) - 1.0) < 0.02,
          "small init: not metric")
    return dict(ok=True, used_homography=bool(g.used_homography),
                triangulated=int(g.good.sum()),
                max_motion_diff=float(max(np.abs(c.R21 - g.R21).max(),
                                          np.abs(c.t21 - g.t21).max())),
                max_point_rel_diff=float(rel.max()))


def small_ba_reference(dev):
    """`bundle_adjust` on `small_ba_problem` on the CPU once and on the
    GPU SMALL_BA_GPU_RUNS times. The GPU sums in another order: every GPU
    run's cost agrees to 1e-3 relative, its poses to 1e-3, its inlier
    edges' reprojections to SMALL_BA_REPROJ_TOL pixels and its points to
    SMALL_BA_POINT_MAX; the result holds the worst of the runs. The
    scatter sums are deterministic: the GPU runs must agree bit for bit."""
    from orbslam_birdview_tpu_torch.graph import ba

    prob = small_ba_problem()
    args, reproj = prob["args"], prob["reproj"]
    cam_t, n = prob["cam_t"], prob["n"]

    def run(d):
        res = ba.bundle_adjust(*args, device=d)
        check(res.points.device.type == d.type, "result on the wrong device")
        return [f.cpu().numpy() for f in res]

    c = run(torch.device("cpu"))
    worst = dict(cost_rel_diff=0.0, max_pose_diff=0.0, p99_point_diff=0.0,
                 max_point_diff=0.0, max_ground_point_diff=0.0,
                 max_reproj_diff_px=0.0, mask_flips=0)
    gpu_runs = []
    for _ in range(SMALL_BA_GPU_RUNS):
        g = run(dev)
        gpu_runs.append(g)
        cost_rel = abs(g[6] / c[6] - 1.0)
        check(cost_rel <= SMALL_BA_TOL,
              f"small BA: cost cpu {c[6]} gpu {g[6]}")
        for i, name in ((0, "cam_R"), (1, "cam_t"), (2, "points")):
            check(np.isfinite(g[i]).all(), f"small BA: non-finite {name}")
        for i, name in ((0, "cam_R"), (1, "cam_t")):
            check(np.abs(c[i] - g[i]).max() <= SMALL_BA_TOL,
                  f"small BA: {name} differ by {np.abs(c[i] - g[i]).max()}")
        point_diff = np.abs(c[2] - g[2]).max(axis=1)
        check(point_diff.max() <= SMALL_BA_POINT_MAX,
              f"small BA: points differ by {point_diff.max()}")
        both = c[3] & g[3]
        du = np.abs(reproj(c) - reproj(g)).max(axis=1)[both]
        check(du.max() <= SMALL_BA_REPROJ_TOL,
              f"small BA: reprojections differ by {du.max()} px")
        flips = [int((c[i] != g[i]).sum()) for i in (3, 4, 5)]
        check(max(flips) <= SMALL_MASK_TOL, "small BA: inlier masks differ")
        check(np.abs(g[1] - cam_t).max() < 0.03,
              "small BA: poses not recovered")
        check(g[3][::17].mean() < 0.2 and g[3].mean() > 0.85,
              "small BA: outliers not separated")
        for k, v in (("cost_rel_diff", cost_rel),
                     ("max_pose_diff", max(np.abs(c[0] - g[0]).max(),
                                           np.abs(c[1] - g[1]).max())),
                     ("p99_point_diff", np.quantile(point_diff, 0.99)),
                     ("max_point_diff", point_diff.max()),
                     ("max_ground_point_diff", point_diff[n:].max()),
                     ("max_reproj_diff_px", du.max()),
                     ("mask_flips", sum(flips))):
            worst[k] = max(worst[k], type(worst[k])(v))
    # the scatter sums' layouts sort the edges by target (graph/segsum.py):
    # every GPU run then gives the same bits
    identical = all(all(np.array_equal(a, b) for a, b in zip(gpu_runs[0], r))
                    for r in gpu_runs[1:])
    check(identical, "small BA: GPU runs differ with deterministic sums")
    return dict(gpu_runs=SMALL_BA_GPU_RUNS, cost_cpu=float(c[6]),
                gpu_runs_bit_identical=identical, **worst)


def small_ba_problem():
    """A synthetic BA problem (4 cameras, 200 points, 40 ground points;
    mono and bird edges, every 17th mono observation 40 px off, an
    all-invalid stereo set): bundle_adjust's arguments, the true poses and
    a function of a result giving the mono edges' reprojections."""
    from orbslam_birdview_tpu_torch.core import lie
    from orbslam_birdview_tpu_torch.graph import ba

    rng = np.random.default_rng(1)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    C, n, nb = 4, 200, 40
    X = np.stack([rng.uniform(-5, 5, n), rng.uniform(-4, 4, n),
                  rng.uniform(6, 14, n)], 1).astype(np.float32)
    Xb = np.stack([rng.uniform(-6, 6, nb), rng.uniform(-6, 6, nb),
                   np.zeros(nb)], 1).astype(np.float32)
    pts = np.concatenate([X, Xb])
    xi = torch.tensor([[0.3 * c, 0.02 * c, 0.01 * c, 0.0, -0.02 * c, 0.0]
                       for c in range(C)])
    cam_R, cam_t = (a.numpy() for a in lie.se3_exp(xi))
    e_cam = np.repeat(np.arange(C), n).astype(np.int32)
    e_pt = np.tile(np.arange(n), C).astype(np.int32)
    Xc = np.einsum("eij,ej->ei", cam_R[e_cam], X[e_pt]) + cam_t[e_cam]
    obs = (np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                     fy * Xc[:, 1] / Xc[:, 2] + cy], 1)
           + rng.normal(0, 0.5, (C * n, 2))).astype(np.float32)
    obs[::17] += 40.0                                     # outliers
    b_cam = np.repeat(np.arange(C), nb).astype(np.int32)
    b_pt = (np.tile(np.arange(nb), C) + n).astype(np.int32)
    b_obs = (np.einsum("eij,ej->ei", cam_R[b_cam], pts[b_pt]) + cam_t[b_cam]
             + rng.normal(0, 0.01, (C * nb, 3))).astype(np.float32)
    pert = torch.from_numpy(rng.normal(0, 0.01, (C, 6)).astype(np.float32))
    pert[0] = 0.0
    Rp, tp = lie.se3_update_left(torch.from_numpy(cam_R),
                                 torch.from_numpy(cam_t), pert)
    Xp = (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)

    def edges(cam, pt, o, info, valid=True):
        E = len(cam)
        return ba.EdgeSet(torch.from_numpy(cam), torch.from_numpy(pt),
                          torch.from_numpy(o), torch.full((E,), info),
                          torch.full((E,), valid))

    sets = (edges(e_cam, e_pt, obs, 1.0),
            edges(e_cam[:64], e_pt[:64], np.zeros((64, 3), np.float32), 1.0,
                  valid=False),
            edges(b_cam, b_pt, b_obs, 400.0))

    def reproj(r):
        Xc = np.einsum("eij,ej->ei", r[0][e_cam], r[2][e_pt]) + r[1][e_cam]
        return np.stack([fx * Xc[:, 0] / Xc[:, 2],
                         fy * Xc[:, 1] / Xc[:, 2]], 1)

    args = (Rp, tp, np.arange(C) < 1, np.ones(C, bool), Xp,
            np.ones(len(Xp), bool), *sets, fx, fy, cx, cy)
    return dict(args=args, reproj=reproj, cam_t=cam_t, n=n)


# ---------------------------------------------------------------------------
# the SLAM loop through System: tracking, keyframes, local mapping
# ---------------------------------------------------------------------------

SYSTEM_STAGES = ("fused.dispatch", "fused.retire", "kf.mapper",
                 "kf.bundle_refresh", "map.tri_dispatch", "map.tri_apply",
                 "map.fuse_dispatch", "map.fuse_apply", "map.ba_dispatch",
                 "map.kf_cull", "map.loop")


def make_system(cfg, dev):
    """`System(cfg)` as a user builds it: loop closing on, the packaged
    vocabulary loaded."""
    from orbslam_birdview_tpu_torch.api.system import System
    system = System(cfg, device=dev)
    check(system.loop_closer is not None and system.loop_closer.voc
          is not None, "System built without its vocabulary")
    return system


def stage_counts(system):
    """Sample counts of the tracker's and the mapper's stage timers."""
    from orbslam_birdview_tpu_torch.utils.profiling import GLOBAL_TIMER
    out = {k: len(v) for k, v in system.tracker.timer.samples.items()}
    out.update({k: len(v) for k, v in GLOBAL_TIMER.samples.items()})
    return out


def wall_stats(ms):
    if not ms:
        return dict(n=0)
    a = np.asarray(ms)
    return dict(n=len(a), median=float(np.median(a)),
                p90=float(np.percentile(a, 90)), max=float(a.max()))


def trajectory_errors(fds, gts):
    """ATE (rigid alignment, no scale), path-length ratio and largest
    position / rotation errors of the pose_ok frames against ground truth
    in the map's frame."""
    from orbslam_birdview_tpu_torch.utils.synth import ate_rmse

    est, gt, pos_errs, rot_errs = [], [], [], []
    for fd, (R_gt, t_gt) in zip(fds, gts):
        if not fd.pose_ok:
            continue
        est.append(-fd.R.T @ fd.t)
        gt.append(-R_gt.T @ t_gt)
        p, r = pose_errors(fd.R, fd.t, R_gt, t_gt)
        pos_errs.append(p)
        rot_errs.append(r)
    est, gt = np.array(est), np.array(gt)
    d_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    d_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    return dict(ate_m=ate_rmse(est, gt, with_scale=False),
                ate_unaligned_m=ate_rmse(est, gt, align=False),
                scale_ratio=float(d_est / d_gt),
                max_pos_err_m=max(pos_errs), max_rot_err_deg=max(rot_errs))


def keyframe_ate(store, seq):
    """Metric ATE of the keyframe centres against ground truth, rigid
    alignment and no scale (tests/test_loop_closing.py's measure)."""
    from orbslam_birdview_tpu_torch.utils.synth import ate_rmse

    est, gt = [], []
    for k in store.valid_kf_ids():
        R_g, t_g = seq.gt_cam_pose(int(store.kf_frame_id[k]))
        est.append(-store.kf_R[k].T @ store.kf_t[k])
        gt.append(-R_g.T @ t_g)
    return ate_rmse(np.array(est), np.array(gt), with_scale=False)


def watch_loop(system, seq):
    """Record, on a System of either package, each loop correction's
    keyframe pair and Sim3 scale, the keyframe ATE just before the first
    GBA round lands and the GBA rounds landed. Returns the dict it fills."""
    obs = dict(loops=[], gba_landed=0)
    lc, mapper = system.loop_closer, system.mapper
    correct, finalize = lc._correct_loop, mapper.finalize_gba

    def correct_loop(kf, cand, S, loop_points):
        obs["loops"].append(dict(kf=int(kf), cand=int(cand),
                                 scale=float(S[2])))
        return correct(kf, cand, S, loop_points)

    def finalize_gba(block=False, start_fetch_only=False):
        landing = (block and not start_fetch_only
                   and mapper._gba_pending is not None)
        if landing and "ate_before_gba_m" not in obs:
            obs["ate_before_gba_m"] = keyframe_ate(system.store, seq)
        landed = finalize(block=block, start_fetch_only=start_fetch_only)
        obs["gba_landed"] += int(bool(landed))
        return landed

    lc._correct_loop = correct_loop
    mapper.finalize_gba = finalize_gba
    return obs


def system_phase(drive, dev):
    """The drive through `System.track_monocular_with_birdview` at full
    width, then `_flush`. Ground truth is expressed in the first keyframe's
    camera frame (the map's world); nothing is aligned in scale."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.pipeline import tracking
    from orbslam_birdview_tpu_torch.utils.profiling import GLOBAL_TIMER

    seq, frames, mask = drive["seq"], drive["frames"], drive["mask"]
    cfg = slam_config(drive, drive.get("P", P), drive.get("PB", PB))
    system = make_system(cfg, dev)
    sync(dev)
    t0 = time.perf_counter()
    n_warm = system.prewarm()
    sync(dev)
    prewarm_s = time.perf_counter() - t0
    GLOBAL_TIMER.reset()
    patch_kernel.LAUNCHES = 0
    fds, call_ms, mapping_call = [], [], []
    for i, (img, bev, _) in enumerate(frames):
        before = stage_counts(system)
        n_kf = system.store.n_kf
        sync(dev)
        t_call = time.perf_counter()
        fds.append(system.track_monocular_with_birdview(img, bev, mask,
                                                        i / 25.0))
        sync(dev)
        call_ms.append((time.perf_counter() - t_call) * 1e3)
        after = stage_counts(system)
        mapping_call.append(system.store.n_kf != n_kf or any(
            after.get(k, 0) != before.get(k, 0) for k in after
            if k.startswith(("kf.", "map."))))
    sync(dev)
    t_flush = time.perf_counter()
    system._flush()
    flush_ms = (time.perf_counter() - t_flush) * 1e3
    launches = patch_kernel.LAUNCHES
    check_launches(launches, len(frames), dev)
    store, mapper, tracker = system.store, system.mapper, system.tracker
    ok = [fd.pose_ok for fd in fds]
    check(any(ok), "the system never initialized")
    first = ok.index(True)
    kf0 = int(store.kf_frame_id[0])
    ref_pose = seq.gt_cam_pose(kf0)
    gts = [relative_pose(seq.gt_cam_pose(i), ref_pose)
           for i in range(len(frames))]
    err = trajectory_errors(fds[first:], gts[first:])
    after_init = ok[first:]
    timer = dict(tracker.timer.samples)
    timer.update(GLOBAL_TIMER.samples)
    stages = {k: dict(n=len(timer.get(k, [])),
                      total_ms=float(np.sum(timer.get(k, [0.0])) * 1e3),
                      median_ms=(float(np.median(timer[k]) * 1e3)
                                 if timer.get(k) else None))
              for k in SYSTEM_STAGES}
    counters = dict(tracker.timer.counters)
    rec = dict(
        front=f"{cfg.camera.width}x{cfg.camera.height}",
        bev=f"{cfg.birdview.width}x{cfg.birdview.height}",
        features=[cfg.orb.n_features, cfg.effective_bird_orb().n_features],
        frames_fed=len(frames), init_frame=first,
        tracked=int(sum(ok)), lost=int(len(ok) - sum(ok)),
        tracked_share_after_init=float(np.mean(after_init)),
        keyframes_minted=int(store.n_kf),
        keyframes_culled=mapper.stats["kf_culled"],
        keyframes_alive=int(store.kf_valid.sum()),
        keyframe_frames=store.kf_frame_id[:store.n_kf].tolist(),
        map_points=int(store.mp_valid.sum()),
        bird_landmarks=int(store.bmp_valid.sum()),
        local_ba=dict(dispatched=mapper.stats["ba_dispatched"],
                      landed=mapper.stats["ba_landed"],
                      dropped=mapper.stats["ba_dropped"]),
        stages_applied=dict(triangulate=mapper.stats["tri_applied"],
                            fuse=mapper.stats["fuse_applied"]),
        points_culled=mapper.stats["points_culled"],
        compact_overflows=mapper.compact_overflows,
        fused_frames=counters.get("track.fused", 0),
        slow_path_frames=counters.get("track.slow", 0),
        fallback_frames=counters.get("track.fallback", 0),
        relocalizations=counters.get("reloc.ok", 0),
        realized_summary_batches=tracker.batch_stats,
        forced_retire_s=tracker.forced_block_s,
        **err,
        call_ms=dict(
            note="host clock around each track_* call with a device sync "
                 "after it; the lag queue returns before a frame's pose "
                 "exists, so a call carries the retirement of an earlier "
                 "frame. keyframe_frames: calls that minted a keyframe or "
                 "ran a keyframe / mapping stage",
            first_call=call_ms[0],
            keyframe_frames=wall_stats([m for m, k in zip(call_ms[1:],
                                                          mapping_call[1:])
                                        if k]),
            other_frames=wall_stats([m for m, k in zip(call_ms[1:],
                                                       mapping_call[1:])
                                     if not k]),
            flush=flush_ms),
        stages=stages, prewarm=dict(problems=n_warm, wall_s=prewarm_s),
        vocab_load_ms=system.vocab_load_ms,
        loops_closed=system.loop_closer.n_loops_closed,
        kfdb_registered=len(system.loop_closer.kfdb.registered),
        patch_gather_launches=launches,
        final_state_ok=bool(tracker.state == tracking.OK),
        floors=dict(init_frames=MAX_INIT_FRAMES,
                    tracked_share=MIN_SYSTEM_TRACKED_SHARE,
                    ate_m=MAX_SYSTEM_ATE_M, scale_rel=MAX_BASELINE_REL_ERR,
                    keyframes=MIN_SYSTEM_KEYFRAMES,
                    ba_landed=MIN_SYSTEM_BA_LANDED,
                    bird_landmarks=MIN_SYSTEM_BIRD_LANDMARKS))
    return system, rec


def profile_region(fn, dev, host_ops=True):
    """Run fn() under torch.profiler, then a device sync: the device
    kernels it ran, their busy time, the host-clock time of the call with
    its sync, and the device's idle share of that time. Without
    `host_ops` only the device is traced (a region of ~10⁵ launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    activities = ([ProfilerActivity.CPU] if host_ops else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, n = 0.0, 0
    for avg in prof.key_averages():
        if avg.device_type != DeviceType.CUDA:
            continue
        busy_us += getattr(avg, "self_device_time_total",
                           getattr(avg, "self_cuda_time_total", 0.0))
        n += avg.count
    busy_ms = busy_us / 1e3
    return dict(device_kernels=n, device_busy_ms=busy_ms, wall_ms=wall_ms,
                idle_share=1.0 - busy_ms / wall_ms)


def profile_mapping(system, dev):
    """One local BA (the newest keyframe's window) and one GBA round on the
    system's map, each dispatched and synced under the profiler; both
    results are dropped, the map stays as it was."""
    mapper, store = system.mapper, system.store
    kf = int(store.valid_kf_ids()[-1])
    system._flush()

    def local():
        mapper.local_ba(kf, async_dispatch=True)
        mapper._ba_pending["res"].cost.cpu()

    def gba():
        mapper.global_ba(iters=mapper._gba_iters, async_dispatch=True)
        mapper._gba_pending["res"].cost.cpu()

    out = {}
    for name, fn in (("local_ba", local), ("gba_round", gba)):
        fn()        # warm: the problem's shapes and workspaces
        mapper._ba_pending = mapper._gba_pending = None
        out[name] = profile_region(fn, dev)
        mapper._ba_pending = mapper._gba_pending = None
    out["gba_problem"] = dict(mapper.last_gba)
    return out


def run_circle(system, frames, mask, seq, dt):
    """The circle through `track_monocular_with_birdview`, then `_flush`;
    the loop's record."""
    from orbslam_birdview_tpu_torch.utils.profiling import GLOBAL_TIMER

    obs = watch_loop(system, seq)
    GLOBAL_TIMER.reset()
    t0 = time.perf_counter()
    fds = [system.track_monocular_with_birdview(img, bev, mask, i * dt)
           for i, (img, bev, _) in enumerate(frames)]
    system._flush()
    wall_s = time.perf_counter() - t0
    lc, store = system.loop_closer, system.store
    stages = {k: dict(n=len(v), median_ms=float(np.median(v) * 1e3),
                      total_ms=float(np.sum(v) * 1e3))
              for k, v in GLOBAL_TIMER.samples.items()
              if k in ("map.loop", "map.gba_dispatch", "map.gba_apply")}
    return dict(frames=len(frames), tracked=int(sum(fd.pose_ok for fd in fds)),
                keyframes_alive=int(store.kf_valid.sum()),
                loops_closed=lc.n_loops_closed,
                loop_edges=[list(map(int, e)) for e in store.loop_edges],
                loops=[{k: (float(v) if isinstance(v, (float, np.floating))
                            else v) for k, v in r.items()}
                       for r in lc.loop_log],
                ate_before_gba_m=obs.get("ate_before_gba_m"),
                ate_m=keyframe_ate(store, seq),
                gba=dict(problem=dict(system.mapper.last_gba),
                         rounds_landed=obs["gba_landed"],
                         dispatched=system.mapper.stats["gba_dispatched"],
                         dropped=system.mapper.stats["gba_dropped"]),
                stages=stages, wall_s=wall_s)


def loop_phase(dev, drive):
    """The circle of tests/test_loop_closing.py (CIRCLE, LOOP_FRAMES; the
    drive rendered by the caller) at full width with the fisheye rig
    through `System(cfg)`: at least one loop closed and the keyframes'
    metric ATE under MAX_LOOP_ATE_M with no scale alignment after the loop
    and the GBA. Then one local BA and one GBA round on its map under the
    profiler."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel

    cfg = slam_config(drive)
    system = make_system(cfg, dev)
    patch_kernel.LAUNCHES = 0
    linalg_launches(reset=True)
    rec = run_circle(system, drive["frames"], drive["mask"], drive["seq"],
                     1 / 25.0)
    rec["small_linalg_launches"] = linalg_launches()
    rec.update(front=f"{cfg.camera.width}x{cfg.camera.height}",
               bev=f"{cfg.birdview.width}x{cfg.birdview.height}",
               features=[cfg.orb.n_features,
                         cfg.effective_bird_orb().n_features],
               render_s=drive["render_s"],
               patch_gather_launches=patch_kernel.LAUNCHES,
               floors=dict(loops=1, ate_m=MAX_LOOP_ATE_M))
    check_launches(rec["patch_gather_launches"], LOOP_FRAMES, dev)
    # the drive's initialization launches the SVD kernel, never eigh: the
    # loop's own kernel is Sim3's eigh
    check_linalg_launches(rec["small_linalg_launches"], [EIGH_KERNEL], "loop")
    rec["profile"] = profile_mapping(system, dev)
    return rec


def loop_phase_checks(rec):
    check(rec["loops_closed"] >= 1, f"circle: no loop closed ({rec['loops']})")
    check(rec["ate_m"] < MAX_LOOP_ATE_M,
          f"circle: metric ATE {rec['ate_m']} m after the loop and the GBA")
    check(rec["gba"]["rounds_landed"] >= 2,
          f"circle: {rec['gba']['rounds_landed']} GBA rounds landed")


def system_phase_checks(rec):
    """The system phase's acceptance, on its record."""
    check(rec["init_frame"] < MAX_INIT_FRAMES,
          f"initialized at frame {rec['init_frame']}")
    check(rec["tracked_share_after_init"] >= MIN_SYSTEM_TRACKED_SHARE,
          f"tracked {rec['tracked_share_after_init']} of the frames "
          "after initialization")
    check(rec["ate_m"] < MAX_SYSTEM_ATE_M, f"metric ATE {rec['ate_m']} m")
    check(abs(rec["scale_ratio"] - 1.0) <= MAX_BASELINE_REL_ERR,
          f"path-length ratio {rec['scale_ratio']}")
    check(rec["bird_landmarks"] > MIN_SYSTEM_BIRD_LANDMARKS,
          f"{rec['bird_landmarks']} bird landmarks")
    check(rec["keyframes_minted"] >= MIN_SYSTEM_KEYFRAMES,
          f"{rec['keyframes_minted']} keyframes")
    check(rec["local_ba"]["landed"] >= MIN_SYSTEM_BA_LANDED,
          f"local BAs: {rec['local_ba']}")
    # every keyframe minted after initialization ran both stages (one
    # culled before its turn would skip them)
    minted = rec["keyframes_minted"] - 2
    tri, fuse = (rec["stages_applied"][k] for k in ("triangulate", "fuse"))
    check(tri == fuse and minted - rec["keyframes_culled"] <= tri <= minted,
          f"{minted} keyframes minted after initialization, stages applied "
          f"{rec['stages_applied']}, culled {rec['keyframes_culled']}")
    check(rec["compact_overflows"] == 0,
          f"{rec['compact_overflows']} compaction overflows")
    check(rec["final_state_ok"], "the run ended LOST")
    # a straight drive revisits nothing: no loop may close on it
    check(rec["loops_closed"] == 0, f"{rec['loops_closed']} loops closed "
          "on a straight drive")
    check(rec["kfdb_registered"] == rec["stages"]["map.loop"]["n"] > 0,
          f"{rec['kfdb_registered']} keyframes registered, "
          f"{rec['stages']['map.loop']['n']} loop stages")


# The e2e tests of the reference package (tests/test_e2e.py), on the port
# and its own renders, with their own configurations and bars.
E2E_CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


def _run_sequence(system, frames, mode):
    gt, est = [], []
    for i, item in enumerate(frames):
        if mode == "mono":
            img, (R_cw, t_cw) = item
            fd = system.track_monocular(img, i / 30.0)
        else:
            img, bev, (R_cw, t_cw) = item
            fd = system.track_monocular_with_birdview(img, bev, None, i / 25.0)
        if fd.pose_ok:
            est.append(-fd.R.T @ fd.t)
            gt.append(-R_cw.T @ t_cw)
    return np.array(gt), np.array(est)


def e2e_monocular_wall_sequence(dev):
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence, ate_rmse

    cam = PinholeCamera(**E2E_CAM)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000), sensor="mono")
    seq = WallSequence(cam, n_frames=30, step=0.03)
    system = make_system(cfg, dev)
    gt, est = _run_sequence(system, (seq.frame(i) for i in range(30)), "mono")
    ate = ate_rmse(est, gt, with_scale=True)  # mono scale is free
    rec = dict(tracked=len(est), ate_m=ate, keyframes=system.n_keyframes(),
               map_points=system.n_map_points())
    check(len(est) >= 24, f"wall: tracked only {len(est)} frames")
    check(ate < 0.02, f"wall: ATE {ate}")
    check(rec["keyframes"] >= 3, f"wall: {rec['keyframes']} keyframes")
    check(rec["map_points"] > 300, f"wall: {rec['map_points']} map points")
    return rec


def e2e_birdview_metric_scale(dev):
    """The fork's core capability: a METRIC trajectory, no scale
    alignment."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core import lie
    from orbslam_birdview_tpu_torch.core.camera import (BirdviewCamera,
                                                        PinholeCamera)
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    from orbslam_birdview_tpu_torch.utils.synth import BirdSequence, ate_rmse

    cam = PinholeCamera(**E2E_CAM)
    bv = BirdviewCamera(width=384, height=384)
    seq = BirdSequence(cam, bv, n_frames=35, speed=0.12, yaw_rate=0.004)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                     sensor="mono_bird", birdview=bv)
    cfg.tbc_quat = tuple(lie.rot_to_quat(torch.as_tensor(seq.R_bc)).tolist())
    cfg.tbc_t = tuple(seq.t_bc.tolist())
    system = make_system(cfg, dev)
    gt, est = _run_sequence(system, render_frames(seq.frame, 35), "bird")
    ate = ate_rmse(est, gt, with_scale=False)
    d_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    d_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    rec = dict(tracked=len(est), ate_m=ate, scale_ratio=float(d_est / d_gt),
               bird_landmarks=int(system.store.bmp_valid.sum()))
    check(len(est) >= 28, f"bird: tracked only {len(est)} frames")
    check(ate < 0.05, f"bird: metric ATE {ate}")
    check(abs(rec["scale_ratio"] - 1.0) < 0.02,
          f"bird: scale {rec['scale_ratio']}")
    check(rec["bird_landmarks"] > 200,
          f"bird: {rec['bird_landmarks']} bird landmarks")
    return rec


def e2e_reset_and_localization_mode(dev):
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence

    cam = PinholeCamera(**E2E_CAM)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=800), sensor="mono")
    seq = WallSequence(cam, n_frames=20, step=0.03)
    system = make_system(cfg, dev)
    _run_sequence(system, (seq.frame(i) for i in range(20)), "mono")
    system._flush()   # settle any in-flight deferred keyframe mint
    n_kf = system.n_keyframes()
    check(n_kf >= 2, f"reset: {n_kf} keyframes")
    # localization only: no new keyframes
    system.activate_localization_mode()
    for i in range(20, 25):
        system.track_monocular(seq.frame(i)[0], i / 30.0)
    check(system.n_keyframes() == n_kf, "localization mode added keyframes")
    system.deactivate_localization_mode()
    system.reset()
    check(system.n_keyframes() == 0 and system.get_tracking_state() == 0,
          "reset left a map")
    return dict(keyframes_before_reset=n_kf)


def e2e_trajectory_savers(dev, out_dir):
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence

    cam = PinholeCamera(**E2E_CAM)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=800), sensor="mono")
    seq = WallSequence(cam, n_frames=15, step=0.03)
    system = make_system(cfg, dev)
    _run_sequence(system, (seq.frame(i) for i in range(15)), "mono")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [out_dir / n for n in ("traj.txt", "kf.txt", "kitti.txt",
                                   "odom.txt")]
    system.save_trajectory_tum(str(paths[0]))
    system.save_keyframe_trajectory_tum(str(paths[1]))
    system.save_trajectory_kitti(str(paths[2]))
    system.save_keyframe_trajectory_odom_tum(str(paths[3]))
    lines = paths[0].read_text().strip().split("\n")
    check(len(lines) >= 10, f"savers: {len(lines)} TUM lines")
    check(all(len(l.split()) == 8 for l in lines), "savers: TUM format")
    klines = paths[2].read_text().strip().split("\n")
    check(all(len(l.split()) == 12 for l in klines), "savers: KITTI format")
    q = np.array([float(x) for x in lines[0].split()[4:8]])
    check(abs(np.linalg.norm(q) - 1.0) <= 1e-5, "savers: quaternion norm")
    return dict(tum_lines=len(lines), kitti_lines=len(klines))


def e2e_circular_loop_closure(dev):
    """tests/test_loop_closing.py::test_circular_loop_closure: its circle,
    640×480, 1000 features, BEV 384×384 without a mask, through
    `System(cfg)`: at least one loop, keyframe ATE < 0.05 m with no scale
    alignment."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core import lie
    from orbslam_birdview_tpu_torch.core.camera import (BirdviewCamera,
                                                        PinholeCamera)
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    from orbslam_birdview_tpu_torch.utils.synth import BirdSequence

    cam = PinholeCamera(**E2E_CAM)
    bv = BirdviewCamera(width=384, height=384)
    seq = BirdSequence(cam, bv, n_frames=LOOP_FRAMES, **CIRCLE)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                     sensor="mono_bird", birdview=bv)
    cfg.tbc_quat = tuple(lie.rot_to_quat(torch.as_tensor(seq.R_bc)).tolist())
    cfg.tbc_t = tuple(seq.t_bc.tolist())
    frames = render_frames(seq.frame, LOOP_FRAMES)
    patch_kernel.LAUNCHES = 0
    rec = run_circle(make_system(cfg, dev), frames, None, seq, 1 / 25.0)
    rec["patch_gather_launches"] = patch_kernel.LAUNCHES
    check(rec["loops_closed"] >= 1, "e2e circle: no loop closed")
    check(rec["ate_m"] < 0.05, f"e2e circle: post-loop ATE {rec['ate_m']}")
    return rec


E2E_BASELINE_M = 0.08   # the depth tests' 8 cm stereo baseline


def e2e_depth_config(sensor):
    """The depth tests' configuration: E2E_CAM with bf = fx·0.08, 1000
    features, ThDepth·b = 40 m."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig

    cam = PinholeCamera(**E2E_CAM, bf=E2E_CAM["fx"] * E2E_BASELINE_M)
    return SlamConfig(camera=cam, orb=ORBConfig(n_features=1000),
                      sensor=sensor, depth_threshold=40.0)


def _centres(fds_gts):
    est = np.array([-fd.R.T @ fd.t for fd, _ in fds_gts])
    gt = np.array([-R.T @ t for _, (R, t) in fds_gts])
    return est, gt


def right_view(seq, i, baseline):
    """The right camera's render of frame i of a WallSequence: the left
    camera moved `baseline` metres along its own x axis."""
    from orbslam_birdview_tpu_torch.utils.synth import render_wall_view

    R_cw, t_cw = seq.gt_pose(i)
    return render_wall_view(seq.cam, seq.tex, R_cw.astype(np.float64),
                            t_cw.astype(np.float64)
                            - np.array([baseline, 0.0, 0.0]), seq.wall_z)


def e2e_rgbd_wall_sequence(dev):
    """tests/test_e2e.py::test_rgbd_wall_sequence: depth makes the
    trajectory metric, no scale alignment."""
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence, ate_rmse

    cfg = e2e_depth_config("rgbd")
    seq = WallSequence(cfg.camera, n_frames=25, step=0.03)
    system = make_system(cfg, dev)
    tracked = []
    for i in range(25):
        img, gt = seq.frame(i)
        fd = system.track_rgbd(img, seq.depth(i), i / 30.0)
        if fd.pose_ok:
            tracked.append((fd, gt))
    check(len(tracked) >= 20, f"rgbd: tracked only {len(tracked)} frames")
    est, gt = _centres(tracked)
    ate = ate_rmse(est, gt, with_scale=False)
    check(ate < 0.03, f"rgbd: metric ATE {ate}")
    return dict(tracked=len(est), ate_m=ate, keyframes=system.n_keyframes(),
                map_points=system.n_map_points())


def e2e_stereo_wall_sequence(dev):
    """tests/test_e2e.py::test_stereo_wall_sequence: the right view
    rendered at an 8 cm baseline; disparity depth with the subpixel
    refinement must give a metric trajectory."""
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence, ate_rmse

    cfg = e2e_depth_config("stereo")
    seq = WallSequence(cfg.camera, n_frames=18, step=0.03)
    system = make_system(cfg, dev)
    tracked = []
    for i in range(18):
        img, gt = seq.frame(i)
        fd = system.track_stereo(img, right_view(seq, i, E2E_BASELINE_M),
                                 i / 30.0)
        if fd.pose_ok:
            tracked.append((fd, gt))
    check(len(tracked) >= 14, f"stereo: tracked only {len(tracked)} frames")
    est, gt = _centres(tracked)
    ate = ate_rmse(est, gt, with_scale=False)
    check(ate < 0.03, f"stereo: metric ATE {ate}")
    return dict(tracked=len(est), ate_m=ate, keyframes=system.n_keyframes(),
                map_points=system.n_map_points())


def e2e_localization_mode_vo_fallback(dev):
    """tests/test_e2e.py::test_localization_mode_vo_fallback: in
    localization mode an RGB-D camera that leaves the mapped region keeps
    tracking on temporal visual-odometry points; no keyframe is added."""
    from orbslam_birdview_tpu_torch.pipeline import tracking
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence, ate_rmse

    cfg = e2e_depth_config("rgbd")
    n_map, n_total = 12, 30
    seq = WallSequence(cfg.camera, n_frames=n_total, step=0.03)
    system = make_system(cfg, dev)
    for i in range(n_map):
        system.track_rgbd(seq.frame(i)[0], seq.depth(i), i / 30.0)
    check(system.get_tracking_state() == tracking.OK,
          "vo: not tracking after the mapping frames")
    n_kf = system.n_keyframes()
    system.activate_localization_mode()
    tracked = []
    for i in range(n_map, n_total):
        img, gt = seq.frame(i)
        fd = system.track_rgbd(img, seq.depth(i), i / 30.0)
        if fd.pose_ok:
            tracked.append((fd, gt))
    check(system.n_keyframes() == n_kf, "vo: localization mode added "
          "keyframes")
    check(len(tracked) >= (n_total - n_map) - 2,
          f"vo: tracked only {len(tracked)}")
    est, gt = _centres(tracked)
    ate = ate_rmse(est, gt, with_scale=False)
    vo_set = system.tracker.last_frame.kp_vo is not None
    check(ate < 0.05, f"vo: metric ATE {ate}")
    check(vo_set, "vo: the VO fallback never engaged")
    return dict(tracked=len(est), of=n_total - n_map, ate_m=ate,
                keyframes=n_kf, kp_vo_set=vo_set)


def e2e_relocalization_after_lost(dev):
    """tests/test_e2e.py::test_relocalization_after_lost: RGB-D with dense
    keyframes, 3 featureless frames (LOST), then frame 5 again, which must
    relocalize within 0.02 m of its first pass."""
    from orbslam_birdview_tpu_torch.pipeline import tracking
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence

    cfg = e2e_depth_config("rgbd")
    cfg.tracking.max_frames_between_kf = 2
    n = 30
    seq = WallSequence(cfg.camera, n_frames=n, step=0.03)
    system = make_system(cfg, dev)
    first_pass = {}
    for i in range(n):
        fd = system.track_rgbd(seq.frame(i)[0], seq.depth(i), i / 30.0)
        if fd.pose_ok:
            first_pass[i] = (fd.R.copy(), fd.t.copy())
    n_kf = system.n_keyframes()
    check(n_kf > 5, f"rgbd reloc: only {n_kf} keyframes")
    cam = cfg.camera
    blank = np.zeros((cam.height, cam.width), np.float32)
    far = np.full((cam.height, cam.width), 5.0, np.float32)
    for j in range(3):
        fd = system.track_rgbd(blank, far, (n + j) / 30.0)
        check(not fd.pose_ok, "rgbd reloc: a blank frame tracked")
    check(system.get_tracking_state() == tracking.LOST,
          "rgbd reloc: not LOST after the blank frames")
    fd = system.track_rgbd(seq.frame(5)[0], seq.depth(5), (n + 5) / 30.0)
    check(fd.pose_ok, "rgbd reloc: relocalization failed")
    check(system.tracker.last_reloc_frame_id == fd.frame_id,
          "rgbd reloc: the pose did not come from relocalization")
    R1, t1 = first_pass[5]
    dist = float(np.linalg.norm(-fd.R.T @ fd.t + R1.T @ t1))
    check(dist < RELOC_MAX_M, f"rgbd reloc: {dist} m from the first pass")
    return dict(keyframes=n_kf, recovered=True, centre_diff_m=dist)


def e2e_phase(dev):
    """The mono / mono+bird tests of tests/test_e2e.py, then its four
    stereo and RGB-D tests, with loop closing on as the reference's tests
    run them; the patch-gather launches of each group."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel

    patch_kernel.LAUNCHES = 0
    rec = dict(
        monocular_wall_sequence=e2e_monocular_wall_sequence(dev),
        birdview_metric_scale=e2e_birdview_metric_scale(dev),
        reset_and_localization_mode=e2e_reset_and_localization_mode(dev),
        trajectory_savers=e2e_trajectory_savers(
            dev, ROOT / "chiprun_out" / "trajectories"))
    rec["patch_gather_launches"] = patch_kernel.LAUNCHES
    patch_kernel.LAUNCHES = 0
    rec.update(
        rgbd_wall_sequence=e2e_rgbd_wall_sequence(dev),
        stereo_wall_sequence=e2e_stereo_wall_sequence(dev),
        localization_mode_vo_fallback=e2e_localization_mode_vo_fallback(dev),
        relocalization_after_lost=e2e_relocalization_after_lost(dev))
    rec["depth_patch_gather_launches"] = patch_kernel.LAUNCHES
    return rec


def timed_ms(fn, dev):
    """Host-clock ms of fn() between two device syncs."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3


def library_det_ms(dev):
    """Two `torch.linalg.det` calls on 256 3×3 matrices on the card, the
    library call that `core/linalg.det_small` takes for CPU tensors only;
    in a process that has not called it yet the first carries the
    library's set-up."""
    X = torch.randn((256, 3, 3),
                    generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    return [timed_ms(lambda: torch.linalg.det(X), dev) for _ in range(2)]


def reloc_split(pnp_calls, dev):
    """What the recovering call's time is made of: its first `pnp_ransac`
    call (timed inside the call) and a second call on the same inputs (the
    generator restored to its state before the first), then the process's
    first and second `torch.linalg.svd` and `eigh` on the card (256 3×3
    matrices; a yardstick the port never calls), whose first calls carry
    the library's set-up, and two `torch.linalg.det` calls (not the
    process's first: the init record's came first)."""
    from orbslam_birdview_tpu_torch.solvers import pnp

    first = pnp_calls[0]
    source = first["source"]
    if first["state"] is not None:
        source = torch.Generator(device=source.device)
        source.set_state(first["state"])
    second_ms = timed_ms(lambda: pnp.pnp_ransac(source, *first["args"],
                                                **first["kw"]), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((256, 3, 3), generator=gen, device=dev)
    S = X + X.transpose(-1, -2)
    return dict(pnp_calls_ms=[c["ms"] for c in pnp_calls],
                pnp_second_call_ms=second_ms,
                library_svd_ms=[timed_ms(lambda: torch.linalg.svd(X), dev)
                                for _ in range(2)],
                library_eigh_ms=[timed_ms(lambda: torch.linalg.eigh(S), dev)
                                 for _ in range(2)],
                library_det_ms=library_det_ms(dev))


def reloc_phase(drive, dev, n_first=RELOC_FRAMES, revisit=5):
    """Lost and found: dense keyframes over the first frames of the drive,
    3 blank front and BEV frames (LOST, no reset), then frame `revisit`
    again, which must relocalize within RELOC_MAX_M of its first pass.
    The recovering call's `Tracker._relocalize` and `pnp_ransac` calls are
    timed (a device sync around each, inside the call's own time) and
    split by `reloc_split`. The solver kernels' counts are those of the
    recovering call alone."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.pipeline import tracking
    from orbslam_birdview_tpu_torch.solvers import pnp

    frames, mask = drive["frames"], drive["mask"]
    cfg = slam_config(drive, drive.get("P", P), drive.get("PB", PB))
    cfg.tracking.max_frames_between_kf = 2
    system = make_system(cfg, dev)
    patch_kernel.LAUNCHES = 0
    first_pass = {}
    for i, (img, bev, _) in enumerate(frames[:n_first]):
        fd = system.track_monocular_with_birdview(img, bev, mask, i / 25.0)
        if fd.pose_ok:
            first_pass[i] = (fd.R.copy(), fd.t.copy())
    n_kf = system.n_keyframes()
    store = system.store
    check(n_kf > 5, f"reloc: only {n_kf} keyframes")
    check(revisit in first_pass, "reloc: the revisited frame was not tracked")
    blank = np.zeros_like(frames[0][0])
    blank_bev = np.zeros_like(frames[0][1])
    for j in range(3):
        fd = system.track_monocular_with_birdview(blank, blank_bev, mask,
                                                  (n_first + j) / 25.0)
        check(not fd.pose_ok, "reloc: a blank frame tracked")
    check(system.get_tracking_state() == tracking.LOST,
          "reloc: not LOST after the blank frames")
    check(system.store is store and system.n_keyframes() > 5,
          "reloc: the map was reset")
    img, bev, _ = frames[revisit]
    pnp_calls, pnp_ransac = [], pnp.pnp_ransac

    def timed_pnp(source, *args, **kw):
        state = (source.get_state() if isinstance(source, torch.Generator)
                 else None)
        out = []
        ms = timed_ms(lambda: out.append(pnp_ransac(source, *args, **kw)),
                      dev)
        pnp_calls.append(dict(ms=ms, source=source, state=state, args=args,
                              kw=kw))
        return out[0]

    tracker, relocalize_ms = system.tracker, []

    def timed_relocalize(*args, **kw):
        out = []
        relocalize_ms.append(timed_ms(
            lambda: out.append(type(tracker)._relocalize(tracker, *args,
                                                         **kw)), dev))
        return out[0]

    pnp.pnp_ransac, tracker._relocalize = timed_pnp, timed_relocalize
    linalg_launches(reset=True)
    try:
        sync(dev)
        t0 = time.perf_counter()
        fd = system.track_monocular_with_birdview(img, bev, mask,
                                                  (n_first + 5) / 25.0)
        ok = fd.pose_ok
        sync(dev)
        reloc_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pnp.pnp_ransac = pnp_ransac
        del tracker._relocalize
    solver_launches = linalg_launches()
    check(ok, "reloc: relocalization failed")
    check(system.tracker.last_reloc_frame_id == fd.frame_id,
          "reloc: the pose did not come from relocalization")
    R1, t1 = first_pass[revisit]
    dist = float(np.linalg.norm(-fd.R.T @ fd.t + R1.T @ t1))
    check(dist < RELOC_MAX_M, f"reloc: {dist} m from the first pass")
    check(pnp_calls, "reloc: the recovering call made no pnp_ransac call")
    check_linalg_launches(solver_launches, [SVD_KERNEL, EIGH_KERNEL],
                          "relocalization")
    counters = system.tracker.timer.counters
    return dict(frames=n_first, keyframes=n_kf, recovered=True,
                centre_diff_m=dist, reloc_call_ms=reloc_ms,
                pnp_calls=counters.get("reloc.pnp", 0),
                kfdb_candidates=counters.get("reloc.kfdb_candidates", 0),
                fallback_used=counters.get("reloc.fallback", 0),
                patch_gather_launches=patch_kernel.LAUNCHES,
                small_linalg_launches=solver_launches,
                relocalize_calls_ms=relocalize_ms,
                **reloc_split(pnp_calls, dev))


# ---------------------------------------------------------------------------
# depth: stereo and RGB-D through System at the reference's configurations
# ---------------------------------------------------------------------------

def depth_config(name):
    """The KITTI stereo or the TUM1 RGB-D `SlamConfig`, from the repo's
    configuration files."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig

    if name == "stereo":
        return SlamConfig.from_yaml(str(ROOT / "configs" /
                                        "kitti00-02_stereo.yaml"),
                                    sensor="stereo")
    cfg = SlamConfig.from_yaml(str(ROOT / "configs" / "tum1_rgbd.yaml"),
                               sensor="rgbd")
    cfg.camera = cfg.camera._replace(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    return cfg


def render_depth_drive(name, cfg, n_frames, wall):
    """The wall seen by the configuration's camera: frames of (left image,
    right image or depth map, ground truth). Stereo images are 8-bit, as
    KITTI's; the right camera sits bf/fx to the right. `coverage` is the
    share of the last frame's pixels that see the wall's texture."""
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence

    t0 = time.perf_counter()
    seq = WallSequence(cfg.camera, n_frames=n_frames, **wall)
    baseline = cfg.camera.bf / cfg.camera.fx
    frames = []
    for i in range(n_frames):
        img, gt = seq.frame(i)
        if name == "stereo":
            right = right_view(seq, i, baseline)
            frames.append((np.clip(img, 0, 255).astype(np.uint8),
                           np.clip(right, 0, 255).astype(np.uint8), gt))
        else:
            frames.append((img, seq.depth(i), gt))
    coverage = [float((f[0] > 0).mean()) for f in frames]
    # the leading frames that see the whole textured wall: its share of
    # the image grows as the camera closes in until the wall starts to
    # leave the view
    wall_in_view = next((i for i, c in enumerate(coverage)
                         if c < coverage[0]), n_frames)
    return seq, frames, dict(render_s=time.perf_counter() - t0,
                             baseline_m=baseline,
                             texture_coverage_first=coverage[0],
                             texture_coverage_last=coverage[-1],
                             texture_coverage_min=min(coverage),
                             frames_wall_in_view=wall_in_view)


def launch_rule(system, launches, n_frames, per_fused, per_slow, dev, name):
    """The gather's launches against the path rule: per_fused a fused
    frame, per_slow a slow-path one; 0 on a CPU (the plain version)."""
    counters = dict(system.tracker.timer.counters)
    fused, slow = counters.get("track.fused", 0), counters.get("track.slow",
                                                               0)
    check(fused + slow == n_frames,
          f"{name}: {fused} fused + {slow} slow of {n_frames} frames")
    want = per_fused * fused + per_slow * slow if dev.type == "cuda" else 0
    check(launches == want, f"{name}: patch kernel launched {launches} "
          f"times, expected {want} ({fused} fused, {slow} slow frames)")
    return dict(patch_gather_launches=launches, fused_frames=fused,
                slow_path_frames=slow,
                launches_per_frame=dict(fused=per_fused, slow=per_slow))


def depth_drive(name, dev):
    """One depth drive through `System` (loop closing on) after one
    `prewarm`, then `_flush`; held to the depth bars and the exact
    patch-gather count. Ground truth in the first keyframe's camera frame
    (the map's world)."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.utils.profiling import GLOBAL_TIMER

    cfg = depth_config(name)
    n_frames, wall = ((STEREO_FRAMES, STEREO_WALL) if name == "stereo"
                      else (RGBD_FRAMES, RGBD_WALL))
    seq, frames, render = render_depth_drive(name, cfg, n_frames, wall)
    system = make_system(cfg, dev)
    system.prewarm()
    GLOBAL_TIMER.reset()
    patch_kernel.LAUNCHES = 0
    fds, call_ms = [], []
    dt = 1.0 / cfg.fps
    for i, (img, second, _) in enumerate(frames):
        sync(dev)
        t_call = time.perf_counter()
        if name == "stereo":
            fds.append(system.track_stereo(img, second, i * dt))
        else:
            fds.append(system.track_rgbd(img, second, i * dt))
        sync(dev)
        call_ms.append((time.perf_counter() - t_call) * 1e3)
    system._flush()
    launches = patch_kernel.LAUNCHES
    store, mapper, tracker = system.store, system.mapper, system.tracker
    counters = dict(tracker.timer.counters)
    per = (2, 3) if name == "stereo" else (1, 1)
    rule = launch_rule(system, launches, n_frames, *per, dev, name)
    ok = [fd.pose_ok for fd in fds]
    check(any(ok), f"{name}: the system never initialized")
    first = ok.index(True)
    ref_pose = seq.gt_pose(int(store.kf_frame_id[0]))
    gts = [relative_pose(seq.gt_pose(i), ref_pose) for i in range(n_frames)]
    err = trajectory_errors(fds[first:], gts[first:])
    n_view = render["frames_wall_in_view"]
    check(n_view - first >= 10, f"{name}: the wall leaves the view at "
          f"frame {n_view}")
    err_view = trajectory_errors(fds[first:n_view], gts[first:n_view])
    cam = cfg.camera
    return dict(
        config=("configs/kitti00-02_stereo.yaml" if name == "stereo"
                else "configs/tum1_rgbd.yaml (distortion zeroed)"),
        image=f"{cam.width}x{cam.height}", features=cfg.orb.n_features,
        levels=cfg.orb.n_levels, bf=cam.bf,
        depth_threshold_m=cfg.depth_threshold, wall=wall, **render,
        frames_fed=n_frames, init_frame=first, tracked=int(sum(ok)),
        tracked_share=float(np.mean(ok)),
        keyframes_minted=int(store.n_kf),
        keyframe_frames=store.kf_frame_id[:store.n_kf].tolist(),
        keyframes_alive=int(store.kf_valid.sum()),
        map_points=int(store.mp_valid.sum()),
        local_ba=dict(dispatched=mapper.stats["ba_dispatched"],
                      landed=mapper.stats["ba_landed"],
                      stereo_edges=mapper.stats["ba_stereo_edges"]),
        fallback_frames=counters.get("track.fallback", 0),
        loops_closed=system.loop_closer.n_loops_closed, **err,
        wall_in_view={k: err_view[k] for k in ("ate_m", "scale_ratio",
                                               "max_pos_err_m",
                                               "max_rot_err_deg")},
        call_ms=dict(first_call=call_ms[0], all=wall_stats(call_ms[1:]),
                     note="host clock around each track_* call with a "
                          "device sync after it; frame 0 pays the "
                          "initialization"),
        **rule,
        floors=dict(init_frame=0, tracked_share=MIN_DEPTH_TRACKED_SHARE,
                    ate_m_wall_in_view=MAX_DEPTH_ATE_M))


def render_rgbd_circle(cam, n_frames=RGBD_CIRCLE_FRAMES):
    """The RGB-D revisit seen by `cam` with the port's `synth`: frames of
    (image, exact depth in metres (camera z of the nearest wall, 0 where
    none is hit), ground truth) and the `BirdSequence` of its poses."""
    from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera
    from orbslam_birdview_tpu_torch.utils import synth

    seq = synth.BirdSequence(cam, BirdviewCamera(width=64, height=64),
                             n_frames=n_frames, **RGBD_CIRCLE)
    us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    def frame(i):
        R_cw, t_cw = seq.gt_cam_pose(i)
        img = synth.render_box_view(cam, seq.wall, R_cw, t_cw,
                                    box_half=seq.wall_x)
        R64 = R_cw.astype(np.float64)
        t, wall = synth.cast_box_rays(-R64.T @ t_cw.astype(np.float64),
                                      synth._camera_rays(cam, R64, us, vs),
                                      seq.wall_x)
        return img, np.where(wall >= 0, t, 0.0).astype(np.float32), (R_cw,
                                                                     t_cw)

    return seq, render_frames(frame, n_frames)


def rgbd_circle_drive(dev, cfg=None, n_frames=RGBD_CIRCLE_FRAMES,
                      read_poses=True):
    """Fixed-scale loop closing end to end: the RGB-D revisit at TUM1's
    configuration through `System.track_rgbd` (loop closing on) after one
    `prewarm`, then `_flush`. The loop's keyframe pair, Sim3 scale, solvers
    and `_correct_loop` ms, the GBA dispatch ms, the call ms, the gather's
    launches (1 a frame) and the solver kernels' (eigh from `sim3_ransac`);
    the keyframes' metric ATE after the loop and the GBA, no scale.
    `read_poses=False` leaves each frame's pose unread until the drive
    ends (tools/rgbd_circle_variants.py)."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.utils.profiling import GLOBAL_TIMER

    if cfg is None:
        cfg = depth_config("rgbd")
        cfg.tracking.max_frames_between_kf = RGBD_CIRCLE_MAX_FRAMES_BETWEEN_KF
    t0 = time.perf_counter()
    seq, frames = render_rgbd_circle(cfg.camera, n_frames)
    render_s = time.perf_counter() - t0
    system = make_system(cfg, dev)
    system.prewarm()
    obs = watch_loop(system, seq)
    GLOBAL_TIMER.reset()
    patch_kernel.LAUNCHES = 0
    linalg_launches(reset=True)
    fds, call_ms = [], []
    dt = 1.0 / cfg.fps
    for i, (img, depth, _) in enumerate(frames):
        sync(dev)
        t_call = time.perf_counter()
        fds.append(system.track_rgbd(img, depth, i * dt))
        if read_poses:
            # each frame's pose read as the call returns it, as
            # tests/test_e2e.py's run_sequence does (it finalizes the frame)
            fds[-1].pose_ok
        sync(dev)
        call_ms.append((time.perf_counter() - t_call) * 1e3)
    system._flush()
    ok = [fd.pose_ok for fd in fds]
    launches = patch_kernel.LAUNCHES
    small_linalg = linalg_launches()
    rule = launch_rule(system, launches, n_frames, 1, 1, dev, "rgbd_circle")
    lc, store, mapper = system.loop_closer, system.store, system.mapper
    loops = [{k: (float(v) if isinstance(v, (float, np.floating)) else v)
              for k, v in r.items()} for r in lc.loop_log]
    gba_ms = GLOBAL_TIMER.samples.get("map.gba_dispatch", [])
    cam = cfg.camera
    return dict(
        config="configs/tum1_rgbd.yaml (distortion zeroed), a keyframe at "
               "least every 3 frames",
        image=f"{cam.width}x{cam.height}", features=cfg.orb.n_features,
        depth_threshold_m=cfg.depth_threshold,
        max_frames_between_kf=cfg.tracking.max_frames_between_kf,
        poses_read_per_frame=read_poses,
        circle=dict(RGBD_CIRCLE, frames=n_frames), render_s=render_s,
        frames_fed=n_frames, init_frame=ok.index(True) if any(ok) else None,
        tracked=int(sum(ok)), tracked_share=float(np.mean(ok)),
        keyframes_minted=int(store.n_kf),
        keyframes_alive=int(store.kf_valid.sum()),
        loops_closed=lc.n_loops_closed, loops=loops,
        loop_frames=[[int(store.kf_frame_id[r[k]]) for k in ("kf", "cand")]
                     for r in loops],
        loop_edges=[list(map(int, e)) for e in store.loop_edges],
        gba=dict(problem=dict(mapper.last_gba),
                 rounds_landed=obs["gba_landed"],
                 dispatched=mapper.stats["gba_dispatched"],
                 dropped=mapper.stats["gba_dropped"],
                 dispatch_ms=[float(x * 1e3) for x in gba_ms]),
        ate_before_gba_m=obs.get("ate_before_gba_m"),
        ate_m=keyframe_ate(store, seq),
        call_ms=dict(first_call=call_ms[0], all=wall_stats(call_ms[1:]),
                     slowest_frame=int(np.argmax(call_ms)),
                     note="host clock around each track_rgbd call and the "
                          "read of its pose, with a device sync after it; "
                          "frame 0 pays the initialization"),
        small_linalg_launches=small_linalg, **rule,
        floors=dict(init_frame=0, tracked_share=MIN_DEPTH_TRACKED_SHARE,
                    loops=1, scale=1.0, ate_m=MAX_RGBD_LOOP_ATE_M))


def rgbd_circle_checks(r, dev):
    check(r["init_frame"] == 0, f"rgbd_circle: OK at frame {r['init_frame']}")
    check(r["tracked_share"] >= MIN_DEPTH_TRACKED_SHARE,
          f"rgbd_circle: tracked {r['tracked']} of {r['frames_fed']}")
    check(r["loops_closed"] >= 1,
          f"rgbd_circle: no loop closed ({r['loops']})")
    check(all(lp["scale"] == 1.0 for lp in r["loops"]),
          f"rgbd_circle: a loop's Sim3 scale is not 1: {r['loops']}")
    check(r["gba"]["rounds_landed"] >= 1,
          f"rgbd_circle: {r['gba']['rounds_landed']} GBA rounds landed")
    check(r["ate_m"] < MAX_RGBD_LOOP_ATE_M,
          f"rgbd_circle: metric ATE {r['ate_m']} m after the loop and the "
          "GBA")
    if dev.type == "cuda":
        # the RGB-D initialization runs no two-view solver: the path's
        # solver kernel is Sim3's eigh
        check_linalg_launches(r["small_linalg_launches"], [EIGH_KERNEL],
                              "rgbd_circle")


def depth_phase_checks(rec, dev):
    rgbd_circle_checks(rec["rgbd_circle"], dev)
    for name in ("stereo", "rgbd"):
        r = rec[name]
        check(r["init_frame"] == 0, f"{name}: OK at frame {r['init_frame']}")
        check(r["tracked_share"] >= MIN_DEPTH_TRACKED_SHARE,
              f"{name}: tracked {r['tracked']} of {r['frames_fed']}")
        check(r["wall_in_view"]["ate_m"] < MAX_DEPTH_ATE_M,
              f"{name}: metric ATE {r['wall_in_view']['ate_m']} m over the "
              f"{r['frames_wall_in_view']} frames that see the whole wall")


def small_stereo_reference(dev):
    """`stereo_match` and `refine_stereo_subpixel` on a 320×240 8-bit
    stereo pair of the wall (16 cm baseline at 4 m), the same keypoints on
    the CPU and on the GPU: the same match indices, uR within
    SMALL_STEREO_UR_TOL."""
    from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
    from orbslam_birdview_tpu_torch.frontend import orb, stereo
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence

    cam = PinholeCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320,
                        height=240, bf=40.0)
    seq = WallSequence(cam, n_frames=2, step=0.03)
    left = np.clip(np.round(seq.frame(1)[0]), 0, 255).astype(np.uint8)
    right = np.clip(np.round(right_view(seq, 1, 0.16)), 0, 255).astype(
        np.uint8)
    cfg = ORBConfig(n_features=500)
    kl = orb.extract_orb(left, cfg, device="cpu")
    kr = orb.extract_orb(right, cfg, device="cpu")
    out = {}
    for d in (torch.device("cpu"), dev):
        l_, r_ = (torch.as_tensor(x, device=d).float() for x in (left, right))
        kl_d = type(kl)(*(f.to(d) for f in kl))
        kr_d = type(kr)(*(f.to(d) for f in kr))
        idx, disp = stereo.stereo_match(kl_d, kr_d)
        ridx, rdisp, ur = stereo.refine_stereo_subpixel(l_, r_, kl_d, kr_d,
                                                        idx, disp)
        out[d.type] = [x.cpu().numpy() for x in (idx, ridx, ur)]
    c, g = out["cpu"], out[dev.type]
    check(np.array_equal(c[0], g[0]) and np.array_equal(c[1], g[1]),
          "small stereo: match indices differ between cpu and gpu")
    ur_diff = float(np.abs(c[2] - g[2]).max())
    check(ur_diff <= SMALL_STEREO_UR_TOL,
          f"small stereo: uR differs by {ur_diff} px")
    return dict(matches=int((c[0] >= 0).sum()),
                refined_kept=int((c[1] >= 0).sum()), max_ur_diff_px=ur_diff)


def depth_phase(dev):
    """The two depth drives, the gather at the KITTI stereo frame's shapes,
    and the CPU-against-GPU stereo check."""
    rec = dict(stereo=depth_drive("stereo", dev), rgbd=depth_drive("rgbd",
                                                                  dev),
               rgbd_circle=rgbd_circle_drive(dev))
    if dev.type == "cuda":
        cfg = depth_config("stereo")
        seq, frames, _ = render_depth_drive("stereo", cfg, 2, STEREO_WALL)
        left, right = frames[1][:2]
        rec["gather_kitti_stereo"] = dict(
            note="one fused stereo frame's 2 gathers (left and right, 8 "
                 "levels each) at 1241x376, 2000 features",
            **gather_measure([(left, cfg.orb, None),
                              (right, cfg.orb, None)], dev))
    rec["small_reference"] = small_stereo_reference(dev)
    return rec


def small_pnp_scene():
    """300 points seen at a known pose with 20 % outliers, from a seed:
    (`pnp_ransac`'s arguments with 256 EPnP draws, R, t)."""
    from orbslam_birdview_tpu_torch.solvers import ransac

    rng = np.random.default_rng(2)
    n = 300
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    a = 0.1
    R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                  [-math.sin(a), 0, math.cos(a)]], np.float32)
    t = np.array([0.2, -0.1, 0.3], np.float32)
    Xc = X @ R.T + t
    xy = (Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (n, 2))).astype(
        np.float32)
    xy[: n // 5] = rng.uniform(-1, 1, (n // 5, 2))
    chi2 = np.full(n, 5.991 / 500.0 ** 2, np.float32)
    draws = ransac.draw(torch.Generator().manual_seed(0), 256, 4, "cpu")
    return (draws, X, xy, np.ones(n, bool), chi2), R, t


def small_pnp_reference(dev):
    """`pnp_ransac` on a synthetic scene (300 points, 20 % outliers) on the
    CPU and on the GPU from the same draws: same `ok`, same inlier count
    within SMALL_MASK_TOL, R and t within SMALL_PNP_TOL."""
    from orbslam_birdview_tpu_torch.solvers import pnp

    args, R, t = small_pnp_scene()
    out = [pnp.fetch_result(pnp.pnp_ransac(*args, device=d))
           for d in (torch.device("cpu"), dev)]
    c, g = out
    check(c.ok and g.ok, f"small pnp: ok cpu {c.ok} gpu {g.ok}")
    check(abs(c.n_inliers - g.n_inliers) <= SMALL_MASK_TOL,
          f"small pnp: inliers cpu {c.n_inliers} gpu {g.n_inliers}")
    diff = float(max(np.abs(c.R - g.R).max(), np.abs(c.t - g.t).max()))
    check(diff <= SMALL_PNP_TOL, f"small pnp: pose differs by {diff}")
    check(np.abs(g.R - R).max() < 0.01 and np.abs(g.t - t).max() < 0.01,
          "small pnp: pose not recovered")
    return dict(inliers_cpu=c.n_inliers, inliers_gpu=g.n_inliers,
                max_pose_diff=diff)


# ---------------------------------------------------------------------------
# small_linalg: the solvers' SVD and eigh kernels
# ---------------------------------------------------------------------------

F32_FLOP_PER_S = 67e12   # H100 SXM f32 outside the tensor cores, data sheet
SVD_KERNEL, EIGH_KERNEL = "jacobi_svd_f32", "jacobi_eigh_f32"
SYNC_WARNING = "called a synchronizing CUDA operation"


def linalg_launches(reset=False):
    """The solver kernels' launch counts (a copy); zeroed after the read
    with `reset`."""
    from orbslam_birdview_tpu_torch.core import linalg

    counts = dict(linalg.LAUNCHES)
    if reset:
        linalg.LAUNCHES.update(dict.fromkeys(linalg.LAUNCHES, 0))
    return counts


def check_linalg_launches(counts, kernels, path):
    check(all(counts[k] > 0 for k in kernels),
          f"{path}: a solver kernel of the path never launched: {counts}")


def linalg_cases():
    """tests/small_linalg_cases.py: the sites, inputs and invariants."""
    sys.path.insert(0, str(ROOT / "tests"))
    import small_linalg_cases
    return small_linalg_cases


def _np(x):
    return None if x is None else x.cpu().numpy()


def sync_free(fn, *args, **kw):
    """fn(*args, **kw) under sync debug mode "error"; fails the phase if it
    synchronises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args, **kw)
    except RuntimeError as e:
        raise SmokeFailure(f"{getattr(fn, '__name__', fn)} synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def hold_decomposition(kind, A, full_matrices, name):
    """One wrapper call on the card (one launch, no sync) against its plain
    version on the same input, through the invariants of
    tests/small_linalg_cases.py: the report, whose errors are in units of
    each matrix's |A|₂, and the largest raw |σ − σ_plain| or
    |λ − λ_plain| over the finite matrices."""
    from orbslam_birdview_tpu_torch.core import linalg

    cases = linalg_cases()
    kernel = SVD_KERNEL if kind == "svd" else EIGH_KERNEL
    before = linalg.LAUNCHES[kernel]
    if kind == "svd":
        got = sync_free(linalg.svd_small, A, full_matrices)
        ref = linalg.svd_small_plain(A, full_matrices)
        vals, ref_vals = got[1], ref[1]
    else:
        got = sync_free(linalg.eigh_small, A)
        ref = linalg.eigh_small_plain(A)
        vals, ref_vals = got[0], ref[0]
    check(linalg.LAUNCHES[kernel] == before + 1,
          f"{name}: {linalg.LAUNCHES[kernel] - before} launches, not 1")
    try:
        hold = cases.check_svd if kind == "svd" else cases.check_eigh
        rep = hold(_np(A), *map(_np, got), [_np(r) for r in ref], name)
    except AssertionError as e:
        raise SmokeFailure(f"{kernel} against its plain version: {e}")
    diff = (vals - ref_vals).abs()
    err = float(diff[torch.isfinite(diff)].max()) if rep.n_finite else 0.0
    return rep._asdict(), err


def solver_runs(dev):
    """`initialize_two_view`, `pnp_ransac` and `sim3_ransac` on the card on
    the reference phase's small scenes (256 hypotheses each), each under
    sync debug mode "warn": the sync warnings each still gives (a reading,
    not a bar), and the inputs their `svd_small` / `eigh_small` calls were
    given, as (kind, A, full_matrices, caller)."""
    import warnings

    from orbslam_birdview_tpu_torch.core import linalg
    from orbslam_birdview_tpu_torch.solvers import initializer, pnp, sim3

    K, x1, x2, g1, g2, _, _ = small_two_view(np.random.default_rng(0))
    init_draws = initializer.draw_init(torch.Generator().manual_seed(0), 256,
                                       "cpu")
    pnp_args = small_pnp_scene()[0]
    sim3_args = small_sim3_scene()[0]
    runs = dict(
        initialize_two_view=lambda: initializer.initialize_two_view(
            init_draws, x1, x2, np.ones(len(x1), bool), K, sigma=1.0,
            bird_xy1=g1, bird_xy2=g2, bird_valid=np.ones(len(g1), bool),
            bird_sigma=0.05, R_bc=np.eye(3, dtype=np.float32),
            t_bc=np.zeros(3, np.float32), device=dev),
        pnp_ransac=lambda: pnp.pnp_ransac(*pnp_args, device=dev),
        sim3_ransac=lambda: sim3.sim3_ransac(*sim3_args, device=dev))
    calls, warned = [], {}
    svd, eigh = linalg.svd_small, linalg.eigh_small
    caller = [None]

    def record_svd(A, full_matrices=False):
        calls.append(("svd", A.clone(), full_matrices, caller[0]))
        return svd(A, full_matrices)

    def record_eigh(S):
        calls.append(("eigh", S.clone(), False, caller[0]))
        return eigh(S)

    linalg.svd_small, linalg.eigh_small = record_svd, record_eigh
    try:
        for name, run in runs.items():
            caller[0] = name
            sync(dev)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            sync(dev)
            warned[name] = sum(SYNC_WARNING in str(w.message) for w in caught)
    finally:
        linalg.svd_small, linalg.eigh_small = svd, eigh
    return calls, warned


def decomposition_work(kind, A):
    """(bytes, flops) of one wrapper call on A, independent of the
    algorithm: each input read and each output written once; the
    operation counts of the Golub-Kahan SVD and the symmetric QR
    algorithm (Golub and Van Loan, Matrix Computations) for the matrices
    that have to be decomposed, the finite ones: an SVD with U and V of a
    p×q matrix, p ≥ q, 4p²q + 8pq² + 9q³ flops, with V alone (more than
    MAX_M rows) 4pq² + 8q³; a symmetric eigen-decomposition with its
    vectors 9n³."""
    from orbslam_birdview_tpu_torch.core import linalg

    m, n = A.shape[-2:]
    X = A.reshape(-1, m, n)
    B = X.shape[0]
    finite = int(torch.isfinite(X).all(-1).all(-1).sum())
    if kind == "svd":
        k, p, q = min(m, n), max(m, n), min(m, n)
        if m <= linalg.MAX_M:
            n_bytes = 4 * B * (m * n + k + m * m + n * n)
            flops = 4 * p * p * q + 8 * p * q * q + 9 * q ** 3
        else:
            n_bytes = 4 * B * (m * n + k + n * n)
            flops = 4 * p * q * q + 8 * q ** 3
    else:
        n_bytes = 4 * B * (2 * n * n + n)
        flops = 9 * n ** 3
    return n_bytes, float(finite * flops)


def small_linalg_phase(dev):
    """Both kernels against their plain versions at every site of
    tests/small_linalg_cases.py (rank-deficient E, F and Kabsch matrices,
    repeated eigenvalues, NaN and ±inf entries) and on the inputs the three
    solvers built on the card, each wrapper call one launch under sync
    debug mode "error"; then each kernel timed over the solvers' calls
    (one each, as the solvers made them) beside its plain version,
    torch.linalg (a yardstick the port never calls, on the inputs with
    their non-finite matrices zeroed) and its bound."""
    from orbslam_birdview_tpu_torch.core import linalg

    cases = linalg_cases()
    sites, by_caller = {}, {}
    errs = {k: 0.0 for k in (SVD_KERNEL, EIGH_KERNEL)}
    raw = dict(errs)

    def hold(kind, A, full, name):
        kernel = SVD_KERNEL if kind == "svd" else EIGH_KERNEL
        rep, err = hold_decomposition(kind, A, full, name)
        errs[kernel] = max(errs[kernel], rep["value"], rep["reconstruction"])
        raw[kernel] = max(raw[kernel], err)
        return kernel, rep

    for kind, site_list in (("svd", cases.SVD_SITES),
                            ("eigh", cases.EIGH_SITES)):
        for site in site_list:
            A = torch.from_numpy(cases.make_input(site)).to(dev)
            sites[site.name] = hold(kind, A, getattr(site, "full_matrices",
                                                     False), site.name)[1]
    calls, warned = solver_runs(dev)
    for kind, A, full, caller in calls:
        kernel, rep = hold(kind, A, full, f"{caller} {tuple(A.shape)}")
        by_caller.setdefault(caller, []).append(
            dict(kernel=kernel, shape=list(A.shape), full_matrices=full,
                 **{k: rep[k] for k in ("value", "reconstruction",
                                        "orthogonality", "n_nonfinite")}))
    out = {}
    for kind, kernel, wrapper, plain, library in (
            ("svd", SVD_KERNEL,
             lambda A, f: linalg.svd_small(A, f),
             lambda A, f: linalg.svd_small_plain(A, f),
             lambda A, f: torch.linalg.svd(A, full_matrices=f)),
            ("eigh", EIGH_KERNEL,
             lambda A, f: linalg.eigh_small(A),
             lambda A, f: linalg.eigh_small_plain(A),
             lambda A, f: torch.linalg.eigh(A))):
        mine = [(A, f) for k, A, f, _ in calls if k == kind]
        check(mine, f"the solvers made no {kind} call")
        clean = [(linalg.finite_or(A, 0.0)[0], f) for A, f in mine]
        work = [decomposition_work(kind, A) for A, _ in mine]
        n_bytes, flops = sum(w[0] for w in work), sum(w[1] for w in work)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        out[kernel] = dict(
            max_abs_err=errs[kernel], max_value_abs_err=raw[kernel],
            ms=cuda_ms(lambda: [wrapper(A, f) for A, f in mine]),
            plain_ms=cuda_ms(lambda: [plain(A, f) for A, f in mine]),
            library_ms=cuda_ms(lambda: [library(A, f) for A, f in clean]),
            host_bound_ms=cuda_ms(lambda: [wrapper(A, f) for A, f in mine],
                                  saturate=False),
            launch_floor_ms=launch_floor_ms(len(mine), dev),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=n_bytes, flops=flops,
            calls=[dict(shape=list(A.shape), full_matrices=f)
                   for A, f in mine],
            note="max_abs_err: the largest value or reconstruction error "
                 "against the plain version, in units of each matrix's "
                 "|A|_2, over the sites and the solvers' calls "
                 "(max_value_abs_err unscaled); ms, plain_ms, library_ms, "
                 "bound_ms and launch_floor_ms: one replay of the solvers' "
                 "calls")
    return dict(sites=sites, solver_calls=by_caller, sync_warnings=warned,
                kernels=out)


SOLVER_KERNEL_SITES = {
    SVD_KERNEL: "jnp.linalg.svd in orbslam_birdview_tpu/solvers/: "
                "twoview.py:54,64,66,249,273, icp.py:43, epnp.py:129, "
                "pnp.py:41,45",
    EIGH_KERNEL: "jnp.linalg.eigh in orbslam_birdview_tpu/solvers/: "
                 "epnp.py:29,156, sim3.py:48"}


def solver_kernel_lines(measured, **by_phase):
    """The `kernels` line entries of the two solver kernels: the phase's
    measurements and the launches counted on the paths (`by_phase`, each
    path's counts zeroed just before it)."""
    lines = []
    for name, m in measured.items():
        launches = {path: counts[name] for path, counts in by_phase.items()}
        lines.append(dict(
            m, name=name, route="cuda",
            source="orbslam_birdview_tpu_torch/csrc/small_linalg.cu",
            replaces=f"no Pallas kernel; stands for {SOLVER_KERNEL_SITES[name]}",
            launches=sum(launches.values()), launches_by_phase=launches))
    return lines


def ring_graph(K=64, g=8):
    """tests/test_graph.py's Sim3 ring: truth on a 5 m circle, estimates
    with accumulated drift, exact chain, skip-4 and seam measurements; the
    dense arguments and the banded (band, long) groups."""
    theta = 2 * np.pi * np.arange(K) / K
    c, sn = np.cos(theta), np.sin(theta)
    R = np.zeros((K, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, sn, -sn, c
    R[:, 2, 2] = 1.0
    centers = np.stack([5 * c, 5 * sn, np.zeros(K)], 1)
    t_gt = -np.einsum("kij,kj->ki", R, centers).astype(np.float32)
    vt = (t_gt + np.linspace(0, 1, K)[:, None]
          * np.array([0.15, -0.1, 0.05])).astype(np.float32)
    ei = np.concatenate([np.arange(K - 1), np.arange(K - 4), [K - 1]])
    ej = np.concatenate([np.arange(1, K), np.arange(4, K), [0]])
    mR = np.einsum("eab,ecb->eac", R[ej], R[ei]).astype(np.float32)
    mt = (t_gt[ej] - np.einsum("eab,eb->ea", mR, t_gt[ei])).astype(np.float32)
    E = len(ei)
    fixed = np.arange(K) == 0
    ones = np.ones(K, np.float32)
    dense = (R, vt, ones, fixed, ei, ej, mR, mt, np.ones(E, np.float32),
             np.ones(E, np.float32), np.ones(E, bool))
    swap = ei > ej
    i2, j2 = np.where(swap, ej, ei), np.where(swap, ei, ej)
    Rt = np.swapaxes(mR, 1, 2)
    mR2 = np.where(swap[:, None, None], Rt, mR)
    mt2 = np.where(swap[:, None], -np.einsum("nij,nj->ni", Rt, mt), mt)
    band = (j2 - i2) <= g

    def grp(m):
        n = int(m.sum())
        return (i2[m], j2[m], mR2[m], mt2[m].astype(np.float32),
                np.ones(n, np.float32), np.ones(n, np.float32),
                np.ones(n, bool))

    return dense, (R, vt, ones, fixed, *grp(band), *grp(~band))


def small_sim3_scene():
    """400 point pairs under a known Sim3 (scale 1.3) with 60 outliers, from
    a seed: (`sim3_ransac`'s arguments with 256 draws, (uv1, uv2))."""
    from orbslam_birdview_tpu_torch.core import lie
    from orbslam_birdview_tpu_torch.solvers import ransac

    rng = np.random.default_rng(4)
    n = 400
    p2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 9, n)], 1).astype(np.float32)
    R, t, s = (x.numpy() for x in lie.sim3_exp(torch.tensor(
        [0.1, -0.05, 0.2, 0.02, 0.05, -0.03, math.log(1.3)])))
    p1 = (s * p2 @ R.T + t).astype(np.float32)
    p1[:60] += rng.normal(0, 1.0, (60, 3)).astype(np.float32)
    intr = (500.0, 500.0, 320.0, 240.0)
    uv1 = np.stack([500 * p1[:, 0] / p1[:, 2] + 320,
                    500 * p1[:, 1] / p1[:, 2] + 240], 1).astype(np.float32)
    uv2 = np.stack([500 * p2[:, 0] / p2[:, 2] + 320,
                    500 * p2[:, 1] / p2[:, 2] + 240], 1).astype(np.float32)
    uv1 += rng.normal(0, 0.5, uv1.shape).astype(np.float32)
    valid = np.ones(n, bool)
    err = np.full(n, 9.21, np.float32)
    draws = ransac.draw(torch.Generator().manual_seed(7), 256, 3, "cpu")
    return (draws, p1, p2, valid, err, err, *intr, *intr), (uv1, uv2)


def small_loop_reference(dev):
    """The loop-closing solvers on small inputs on the CPU and on the GPU:
    `sim3_ransac` from the same draws (the same inlier mask; R, t and s
    within SMALL_SIM3_TOL), `optimize_sim3_two_frame` (the same inliers,
    the Sim3 within SMALL_SIM3_TOL), the dense, PCG and banded pose graphs
    on a 64-vertex drift ring (scales within SMALL_GRAPH_S_TOL,
    translations within SMALL_GRAPH_T_TOL) and `bundle_adjust_large` on the
    small BA problem (poses within SMALL_BA_TOL, reprojections within
    SMALL_BA_REPROJ_TOL)."""
    from orbslam_birdview_tpu_torch.graph import ba_large, pose_graph
    from orbslam_birdview_tpu_torch.graph.sim3_opt import \
        optimize_sim3_two_frame
    from orbslam_birdview_tpu_torch.solvers import sim3

    cpu = torch.device("cpu")
    args, (uv1, uv2) = small_sim3_scene()
    p1, p2, valid, intr = args[1], args[2], args[3], args[6:10]
    n = len(p1)
    out = {}
    res = {d.type: sim3.fetch_result(sim3.sim3_ransac(*args, device=d))
           for d in (cpu, dev)}
    c, g = res["cpu"], res[dev.type]
    check(c.ok and g.ok and np.array_equal(c.inliers, g.inliers),
          f"small sim3_ransac: cpu {c.n_inliers} gpu {g.n_inliers} inliers")
    diff = float(max(np.abs(c.R - g.R).max(), np.abs(c.t - g.t).max(),
                     abs(c.s - g.s)))
    check(diff <= SMALL_SIM3_TOL, f"small sim3_ransac: Sim3 differs by {diff}")
    out["sim3_ransac"] = dict(inliers=c.n_inliers, scale=c.s, max_diff=diff)
    info = np.ones(n, np.float32)
    opt = {d.type: [x.cpu().numpy() for x in optimize_sim3_two_frame(
        c.R, c.t, c.s, p1, p2, uv1, uv2, info, info, valid, *intr, iters=12,
        device=d)] for d in (cpu, dev)}
    c, g = opt["cpu"], opt[dev.type]
    check(np.array_equal(c[3], g[3]), "small optimize_sim3_two_frame: "
          f"inliers differ in {int((c[3] != g[3]).sum())}")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(c[:3], g[:3]))
    check(diff <= SMALL_SIM3_TOL,
          f"small optimize_sim3_two_frame: Sim3 differs by {diff}")
    out["optimize_sim3_two_frame"] = dict(inliers=int(c[4]),
                                          scale=float(c[2]), max_diff=diff)
    dense, banded = ring_graph()
    for name, fn, args, kw in (
            ("dense", pose_graph.optimize_sim3_graph, dense, dict(n_iters=15)),
            ("pcg", pose_graph.optimize_sim3_graph_pcg, dense,
             dict(n_iters=30)),
            ("banded", pose_graph.optimize_sim3_graph_banded, banded,
             dict(g=8, n_iters=15))):
        c, g = ([x.cpu().numpy() for x in fn(*args, device=d, **kw)]
                for d in (cpu, dev))
        ds, dt = float(np.abs(c[2] - g[2]).max()), float(
            np.abs(c[1] - g[1]).max())
        check(ds <= SMALL_GRAPH_S_TOL and dt <= SMALL_GRAPH_T_TOL,
              f"small pose graph {name}: s differs by {ds}, t by {dt}")
        check(np.isfinite(g[3]) and g[3] <= 1.01 * c[3] + 1e-6,
              f"small pose graph {name}: cost cpu {c[3]} gpu {g[3]}")
        out[f"pose_graph_{name}"] = dict(cost_cpu=float(c[3]),
                                         cost_gpu=float(g[3]), max_s_diff=ds,
                                         max_t_diff=dt)
    prob = small_ba_problem()
    c, g = ([f.cpu().numpy() for f in ba_large.bundle_adjust_large(
        *prob["args"], device=d)] for d in (cpu, dev))
    dp = max(np.abs(c[0] - g[0]).max(), np.abs(c[1] - g[1]).max())
    check(dp <= SMALL_BA_TOL, f"small bundle_adjust_large: poses differ by "
          f"{dp}")
    both = c[3] & g[3]
    du = np.abs(prob["reproj"](c) - prob["reproj"](g)).max(axis=1)[both]
    check(du.max() <= SMALL_BA_REPROJ_TOL,
          f"small bundle_adjust_large: reprojections differ by {du.max()} px")
    check(int((c[3] != g[3]).sum()) <= SMALL_MASK_TOL,
          "small bundle_adjust_large: inlier masks differ")
    out["bundle_adjust_large"] = dict(cost_cpu=float(c[6]),
                                      cost_gpu=float(g[6]),
                                      max_pose_diff=float(dp),
                                      max_reproj_diff_px=float(du.max()))
    return out


def small_mapping_ops_reference(dev):
    """`epipolar_triangulate_batch` and `fuse_project_batch2_fr` on
    synthetic keyframes, on the CPU and on the GPU: the compacted index
    lists equal in order, X within SMALL_TRI_RTOL relative."""
    from orbslam_birdview_tpu_torch.pipeline import device_ops

    rng = np.random.default_rng(3)
    n, N = 600, 3
    K = np.array([[300, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)

    def pose(yaw, tx):
        c, s_ = math.cos(yaw), math.sin(yaw)
        return (np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32),
                np.array([tx, 0, 0], np.float32))

    def view(R, t, perm):
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:] * 300 + np.array([160, 120])
        uv = uv + rng.normal(0, 0.3, uv.shape)
        d = desc.copy()
        d[rng.random((n, 32)) < 0.01] ^= 1
        return uv[perm].astype(np.float32), d[perm]

    R1, t1 = pose(0.0, 0.0)
    xy1, d1 = view(R1, t1, np.arange(n))
    poses = [pose(0.02 * (j + 1), -0.3 * (j + 1)) for j in range(N)]
    views = [view(R, t, rng.permutation(n)) for R, t in poses]
    R2s = np.stack([p[0] for p in poses])
    t2s = np.stack([p[1] for p in poses])
    xy2 = np.stack([v[0] for v in views])
    d2 = np.stack([v[1] for v in views])
    oct0 = np.zeros(n, np.int32)
    nb_ok = np.array([True, True, False])
    ls = np.array([1.2 ** (2 * l) for l in range(8)], np.float32)
    tri_args = (R1, t1, R2s, t2s, nb_ok, K, xy1, oct0, np.ones(n, bool), d1,
                xy2, np.zeros((N, n), np.int32), np.ones((N, n), bool), d2, ls)
    # the duplicate-target table is sized by the landmark count, as the
    # reference's: P must not be below the keypoint count
    P = n
    pos = X
    fuse_args = (np.concatenate([R2s, R1[None]]),
                 np.concatenate([t2s, t1[None]]),
                 np.array([True, True, True, True]), pos, np.ones(P, bool),
                 desc[:P], pos[::-1].copy(), np.ones(P, bool),
                 desc[:P][::-1].copy(),
                 np.concatenate([xy2, xy1[None]]),
                 np.zeros((N + 1, n), np.int32), np.ones((N + 1, n), bool),
                 np.concatenate([d2, d1[None]]))
    intr = (300.0, 300.0, 160.0, 120.0, 320, 240)
    outs = []
    for d in (torch.device("cpu"), dev):
        def on(a):
            return torch.as_tensor(a, device=d)
        tri = device_ops.epipolar_triangulate_batch(*map(on, tri_args))
        fuse = device_ops.fuse_project_batch2_fr(
            *map(on, fuse_args), *intr, torch.full((P,), 3.0, device=d))
        outs.append(([x.cpu().numpy() for x in tri],
                     [x.cpu().numpy() for x in fuse]))
    (ct, cf), (gt, gf) = outs
    for i in (0, 1, 2, 4, 5):
        check(np.array_equal(ct[i], gt[i]),
              f"small triangulate: field {i} differs between cpu and gpu "
              f"in {int((ct[i] != gt[i]).sum())} entries")
    v = ct[4]
    check(v.sum() > 100, f"small triangulate: {v.sum()} accepted")
    rel = float((np.abs(ct[3][v] - gt[3][v])
                 / np.maximum(np.abs(ct[3][v]), 1.0)).max())
    check(rel <= SMALL_TRI_RTOL, f"small triangulate: X differs by {rel}")
    for i in range(5):
        check(np.array_equal(cf[i], gf[i]),
              f"small fuse: field {i} differs between cpu and gpu")
    check(int(cf[4]) > 100, f"small fuse: {int(cf[4])} matches")
    return dict(triangulated=int(v.sum()), max_X_rel_diff=rel,
                fuse_matches=int(cf[4]))


# ---------------------------------------------------------------------------
# cli: the dataset CLI, the scorer, the synthetic runner, the live viewer
# and the native loader, on datasets written with the port's PNG writer
# ---------------------------------------------------------------------------

def run_cli(main_fn, argv):
    """`main_fn(argv)` with its printing caught: (its result, its last
    printed lines, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    return result, buf.getvalue().splitlines()[-3:], time.perf_counter() - t0


def cli_config(src, dst, scale=1.0, zero_distortion=False):
    """The repo's configuration file, or a copy with the distortion zeroed
    and (for a rehearsal on a CPU) the camera scaled by `scale`."""
    if scale == 1.0 and not zero_distortion:
        return str(src)
    scaled = ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy", "Camera.bf")
    lines = []
    for line in Path(src).read_text().splitlines():
        key, _, val = line.partition(":")
        key = key.strip()
        if zero_distortion and key in ("Camera.k1", "Camera.k2", "Camera.p1",
                                       "Camera.p2", "Camera.k3"):
            line = f"{key}: 0.0"
        elif key in scaled:
            line = f"{key}: {float(val) * scale}"
        elif key in ("Camera.width", "Camera.height"):
            line = f"{key}: {round(float(val) * scale)}"
        elif key == "ORBextractor.nFeatures" and scale != 1.0:
            line = f"{key}: {max(1000, round(float(val) * scale))}"
        lines.append(line)
    Path(dst).write_text("\n".join(lines) + "\n")
    return str(dst)


def gray8(img):
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_tum_poses(path, stamps, poses):
    """World→camera poses as TUM lines (camera centre, its rotation)."""
    from orbslam_birdview_tpu_torch.core import lie
    with open(path, "w") as f:
        for ts, (R, t) in zip(stamps, poses):
            R = np.asarray(R, np.float64)
            c = -R.T @ np.asarray(t, np.float64)
            q = lie.rot_to_quat(torch.as_tensor(R.T.copy())).numpy()
            f.write(f"{ts:.6f} {c[0]:.9f} {c[1]:.9f} {c[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


def cli_kitti(tmp, dev, scale, n_frames):
    """KITTI stereo layout of the depth phase's 12 m wall drive through
    `run_slam --dataset kitti_stereo`; the KITTI file scored with
    `eval_traj` against the written ground truth, SE3 alignment, no
    scale."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.cli import eval_traj, run_slam
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.utils import imageio

    cfg_path = cli_config(ROOT / "configs" / "kitti00-02_stereo.yaml",
                          tmp / "kitti.yaml", scale)
    cfg = SlamConfig.from_yaml(cfg_path, sensor="stereo")
    seq, frames, render = render_depth_drive("stereo", cfg, n_frames,
                                             STEREO_WALL)
    root = tmp / "kitti"
    for d in ("image_0", "image_1"):
        (root / d).mkdir(parents=True)
    t0 = time.perf_counter()
    for i, (left, right, _) in enumerate(frames):
        imageio.imwrite(root / "image_0" / f"{i:06d}.png", left)
        imageio.imwrite(root / "image_1" / f"{i:06d}.png", right)
    write_s = time.perf_counter() - t0
    (root / "times.txt").write_text(
        "".join(f"{i / cfg.fps:e}\n" for i in range(n_frames)))
    out, out_kf = tmp / "kitti_traj.txt", tmp / "kitti_kf.txt"
    patch_kernel.LAUNCHES = 0
    res, tail, secs = run_cli(run_slam.main, [
        "--dataset", "kitti_stereo", "--root", str(root), "--config",
        cfg_path, "--out", str(out), "--out-kf", str(out_kf),
        "--device", dev.type])
    launches = patch_kernel.LAUNCHES
    rec = dict(config=("configs/kitti00-02_stereo.yaml" if scale == 1.0
                       else f"kitti00-02_stereo.yaml at scale {scale}"),
               image=f"{cfg.camera.width}x{cfg.camera.height}",
               features=cfg.orb.n_features, frames_read=res["frames"],
               png_write_s=write_s, run_s=secs, printed=tail,
               call_ms=wall_stats([t * 1e3 for t in res["times_s"][1:]]),
               **launch_rule(res["system"], launches, n_frames, 2, 3, dev,
                             "kitti_stereo"))
    check(res["frames"] == n_frames, f"cli kitti: read {res['frames']} of "
          f"{n_frames} frames")
    rows = np.loadtxt(out, ndmin=2)
    check(rows.shape == (n_frames, 12),
          f"cli kitti: the KITTI file holds {rows.shape}")
    stamps = [float(x) for x in (root / "times.txt").read_text().split()]
    # KITTI rows are camera→world [R | c]: back to world→camera
    poses = [(T[:, :3].T, -T[:, :3].T @ T[:, 3])
             for T in rows.reshape(-1, 3, 4)]
    write_tum_poses(tmp / "kitti_est_tum.txt", stamps, poses)
    write_tum_poses(tmp / "kitti_gt_tum.txt", stamps,
                    [seq.gt_pose(i) for i in range(n_frames)])
    m = eval_traj.evaluate(str(tmp / "kitti_gt_tum.txt"),
                           str(tmp / "kitti_est_tum.txt"), with_scale=False)
    rec.update(ate_m=m["ate_rmse"], rpe_trans_m=m["rpe_trans_rmse"],
               rpe_rot_deg=m["rpe_rot_rmse_deg"], pairs=m["n_pairs"],
               keyframes=len(np.loadtxt(out_kf, ndmin=2)),
               frames_wall_in_view=render["frames_wall_in_view"])
    check(m["n_pairs"] == n_frames and m["ate_rmse"] < MAX_CLI_ATE_M,
          f"cli kitti: ATE {m['ate_rmse']} m over {m['n_pairs']} pairs")
    return rec


def cli_tum(tmp, dev, scale, n_frames):
    """TUM RGB-D layout of the depth phase's 2 m wall (3-channel PNGs,
    16-bit depth at factor 5000, depth stamps 5 ms later) through
    `run_slam --dataset tum_rgbd --viz-every 10`."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.cli import eval_traj, run_slam
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.utils import imageio

    cfg_path = cli_config(ROOT / "configs" / "tum1_rgbd.yaml",
                          tmp / "tum1_rgbd.yaml", scale, zero_distortion=True)
    cfg = SlamConfig.from_yaml(cfg_path, sensor="rgbd")
    seq, frames, _ = render_depth_drive("rgbd", cfg, n_frames, RGBD_WALL)
    root = tmp / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb, depth, stamps = ["# color images"], ["# depth maps"], []
    t0 = time.perf_counter()
    for i, (img, d, _) in enumerate(frames):
        ts = 1305031102.0 + i / cfg.fps
        stamps.append(ts)
        imageio.imwrite(root / "rgb" / f"{ts:.6f}.png",
                        np.repeat(gray8(img)[..., None], 3, -1))
        imageio.imwrite(root / "depth" / f"{ts + 0.005:.6f}.png",
                        np.rint(d * cfg.depth_map_factor).astype(np.uint16))
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth.append(f"{ts + 0.005:.6f} depth/{ts + 0.005:.6f}.png")
    write_s = time.perf_counter() - t0
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(depth) + "\n")
    out, viz_dir = tmp / "tum_traj.txt", tmp / "tum_viz"
    patch_kernel.LAUNCHES = 0
    res, tail, secs = run_cli(run_slam.main, [
        "--dataset", "tum_rgbd", "--root", str(root), "--config", cfg_path,
        "--out", str(out), "--viz-every", "10", "--viz-dir", str(viz_dir),
        "--device", dev.type])
    launches = patch_kernel.LAUNCHES
    rec = dict(config=("configs/tum1_rgbd.yaml (distortion zeroed)"
                       if scale == 1.0 else f"tum1_rgbd.yaml at {scale}"),
               image=f"{cfg.camera.width}x{cfg.camera.height}",
               features=cfg.orb.n_features, frames_read=res["frames"],
               png_write_s=write_s, run_s=secs, printed=tail,
               call_ms=wall_stats([t * 1e3 for t in res["times_s"][1:]]),
               **launch_rule(res["system"], launches, n_frames, 1, 1, dev,
                             "cli tum_rgbd"))
    check(res["frames"] == n_frames, f"cli tum: read {res['frames']} of "
          f"{n_frames} frames")
    write_tum_poses(tmp / "tum_gt.txt", stamps,
                    [seq.gt_pose(i) for i in range(n_frames)])
    m = eval_traj.evaluate(str(tmp / "tum_gt.txt"), str(out),
                           with_scale=False)
    rec.update(ate_m=m["ate_rmse"], pairs=m["n_pairs"])
    check(m["n_pairs"] == n_frames and m["ate_rmse"] < MAX_CLI_ATE_M,
          f"cli tum: ATE {m['ate_rmse']} m over {m['n_pairs']} pairs")
    shapes = {}
    for name in sorted(p.name for p in viz_dir.iterdir()):
        shapes[name] = list(imageio.imread(viz_dir / name).shape)
    want = [f"{kind}_{n:06d}.png" for kind in ("frame", "map")
            for n in range(10, n_frames + 1, 10)]
    check(sorted(shapes) == sorted(want), f"cli tum: viz files {shapes}")
    check(all(v == [cfg.camera.height, cfg.camera.width, 3]
              for k, v in shapes.items() if k.startswith("frame")) and
          all(v == [480, 640, 3] for k, v in shapes.items()
              if k.startswith("map")), f"cli tum: viz shapes {shapes}")
    rec["viz"] = shapes
    return rec


def cli_fisheye(tmp, dev, seq, frames, mask, cfg_path):
    """The fork's layout (five-field associate.txt; image/ holding each
    front render repeated 2× along both axes inside a larger canvas, so the
    loader's origin crop and 0.5× resize give it back; birdview/; colour
    mask/; a global front mask over one band): every `FrameRecord` equal
    to the render bit for bit, then `run_slam --dataset fisheye_bird`."""
    from orbslam_birdview_tpu_torch.cli import datasets, run_slam
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.utils import imageio

    root = tmp / "fisheye"
    for d in ("image", "birdview", "mask"):
        (root / d).mkdir(parents=True)
    h, w = frames[0][0].shape
    margin = 20 if (w, h) == (950, 400) else 0   # the loader crops 1900×800
    band = slice(h // 10, h // 10 + 20)         # masked rows, half size
    fm = np.zeros((2 * h + margin, 2 * w + margin, 3), np.uint8)
    fm[2 * band.start:2 * band.stop, :, 1] = 255
    fm[:, :, 2] = 250
    imageio.imwrite(root / "mask_new_front.png", fm)
    rng = np.random.default_rng(0)
    lines, want = [], []
    t0 = time.perf_counter()
    for i, (img, bev, _) in enumerate(frames):
        name = f"{i:06d}.png"
        front = gray8(img)
        canvas = np.full((2 * h + margin, 2 * w + margin), 255, np.uint8)
        canvas[:2 * h, :2 * w] = np.repeat(np.repeat(front, 2, 0), 2, 1)
        imageio.imwrite(root / "image" / name, canvas)
        imageio.imwrite(root / "birdview" / name, gray8(bev))
        m = rng.integers(0, 256, mask.shape + (3,)).astype(np.uint8)
        m[..., 1] = np.where(mask > 0, rng.integers(20, 256, mask.shape),
                             rng.integers(0, 20, mask.shape))
        imageio.imwrite(root / "mask" / name, m)
        x, y, th = seq.gt_pose2d(i)
        x, y, th = float(x), float(y), float(th)   # repr() round-trips
        lines.append(f"{1535697686.0 + i / 25.0:.6f} {x!r} {y!r} {th!r} "
                     f"{name}")
        expect = front.astype(np.float32)
        expect[band] = 0.0
        want.append((expect, gray8(bev).astype(np.float32),
                     mask.astype(np.float32),
                     np.array([x, y, th])))
    write_s = time.perf_counter() - t0
    (root / "associate.txt").write_text("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    recs = list(datasets.load_fisheye_birdview(str(root)))
    load_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    check(len(recs) == len(frames), f"cli fisheye: {len(recs)} records")
    for i, (r, (front, bird, bmask, odom)) in enumerate(zip(recs, want)):
        for name, got, exp in (("front", r.img, front), ("bird", r.bird, bird),
                               ("bird mask", r.bird_mask, bmask),
                               ("odom", r.odom_pose, odom)):
            check(got.dtype == exp.dtype and got.shape == exp.shape
                  and np.array_equal(got, exp),
                  f"cli fisheye: frame {i}'s {name} differs from the render")
    out, out_kf = tmp / "fisheye_traj.txt", tmp / "fisheye_kf.txt"
    patch_kernel.LAUNCHES = 0
    res, tail, secs = run_cli(run_slam.main, [
        "--dataset", "fisheye_bird", "--root", str(root), "--config",
        cfg_path, "--out", str(out), "--out-kf", str(out_kf),
        "--device", dev.type])
    launches = patch_kernel.LAUNCHES
    n = len(frames)
    check(res["frames"] == n, f"cli fisheye: read {res['frames']} of {n}")
    # 2 a bird frame fed, whatever its path (a reset restarts the
    # tracker's counters, so the frames are counted here)
    check_launches(launches, n, dev)
    odom = tmp / "fisheye_kf_odom.txt"
    written = {p.name: len(p.read_text().splitlines())
               for p in (out, out_kf, odom) if p.exists()}
    check(len(written) == 3, f"cli fisheye: files written {written}")
    return dict(front=f"{2 * w + margin}x{2 * h + margin} canvas -> "
                      f"{w}x{h}", records_equal_render=len(recs),
                loader_ms_per_frame=load_ms, png_write_s=write_s,
                frames_read=res["frames"], run_s=secs, printed=tail,
                lines_written=written,
                tracked_frames=written.get(out.name, 0),
                note="tracking not held: the CLI applies the reference's "
                     "hard-coded camera-to-base extrinsics, which the "
                     "synthetic drive's forward camera does not match",
                patch_gather_launches=launches, launches_per_frame=2)


def cli_synthetic(dev, n_frames):
    """`run_synthetic --mode bird` (640×480, 1000 features, the sequence's
    own extrinsics): the printed metric ATE under MAX_CLI_ATE_M."""
    from orbslam_birdview_tpu_torch.cli import run_synthetic
    from orbslam_birdview_tpu_torch.frontend import patch_kernel

    patch_kernel.LAUNCHES = 0
    res, tail, secs = run_cli(run_synthetic.main, [
        "--mode", "bird", "--frames", str(n_frames), "--device", dev.type])
    launches = patch_kernel.LAUNCHES
    want = 2 * n_frames if dev.type == "cuda" else 0
    check(launches == want, f"cli run_synthetic: patch kernel launched "
          f"{launches} times, expected {want}")
    check(any("METRIC ATE" in line for line in tail),
          f"cli run_synthetic printed {tail}")
    check(res["ate_m"] < MAX_CLI_ATE_M,
          f"cli run_synthetic: METRIC ATE {res['ate_m']} m")
    return dict(res, run_s=secs, printed=tail,
                patch_gather_launches=launches, launches_per_frame=2)


def cli_viewer(system, img):
    """`LiveViewer` on a running System: /state counts its map points,
    /frame serves a PNG that decodes after `update_frame`."""
    import urllib.request

    from orbslam_birdview_tpu_torch.utils import imageio
    from orbslam_birdview_tpu_torch.utils.live_viewer import LiveViewer

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    viewer = LiveViewer(system, host="127.0.0.1", port=0).start()
    try:
        t0 = time.perf_counter()
        state_status, body = get(viewer.url + "state")
        state_ms = (time.perf_counter() - t0) * 1e3
        snap = json.loads(body)
        check(state_status == 200 and snap["n_mp"] == system.n_map_points(),
              f"cli viewer: /state {state_status}, {snap.get('n_mp')} "
              f"points of {system.n_map_points()}")
        first, _ = get(viewer.url + "frame")
        t0 = time.perf_counter()
        viewer.update_frame(img, system.tracker.last_frame)
        update_ms = (time.perf_counter() - t0) * 1e3
        st, png = get(viewer.url + "frame")
        check(st == 200, f"cli viewer: /frame {st} after update_frame")
        decoded = imageio.decode_png(png)[0]
        check(decoded.shape == img.shape + (3,),
              f"cli viewer: /frame decodes at {decoded.shape}")
        page, _ = get(viewer.url)
    finally:
        viewer.stop()
    return dict(state_status=state_status, n_mp=snap["n_mp"],
                n_kf=snap["n_kf"],
                state_ms=state_ms, first_frame_status=first,
                update_frame_ms=update_ms, frame_png_bytes=len(png),
                frame_shape=list(decoded.shape), page_status=page)


def cli_native(tmp):
    """The native prefetching loader over the KITTI left PNGs against the
    port's decoder, where the library loads."""
    from orbslam_birdview_tpu_torch.utils import imageio, native_loader

    ok = native_loader.native_available()
    rec = dict(native_available=ok)
    if ok:
        paths = sorted((tmp / "kitti" / "image_0").iterdir())
        t0 = time.perf_counter()
        frames = list(native_loader.PrefetchLoader(paths))
        rec["prefetch_ms_per_frame"] = ((time.perf_counter() - t0) * 1e3
                                        / len(paths))
        for p, f in zip(paths, frames):
            check(np.array_equal(f, imageio.imread(p, 0).astype(np.float32)),
                  f"cli native: {p.name} differs from the port's decode")
        rec["frames_equal"] = len(frames)
    return rec


def cli_phase(dev, system, drive, scale=1.0, frames=None):
    """The outer surface on the card: see the module docstring (12.).
    `scale` and `frames` cut the sizes for a rehearsal on a CPU."""
    import tempfile

    from orbslam_birdview_tpu_torch.utils import imageio

    n = dict(CLI_FRAMES, **(frames or {}))
    t_phase = time.perf_counter()
    rec = {}
    with tempfile.TemporaryDirectory(prefix="cli_", dir=ROOT /
                                     "chiprun_out") as d:
        tmp = Path(d)
        rec["kitti_stereo"] = cli_kitti(tmp, dev, scale, n["kitti"])
        rec["tum_rgbd"] = cli_tum(tmp, dev, scale, n["tum"])
        fisheye_cfg = cli_config(ROOT / "configs" / "fisheye_birdview.yaml",
                                 tmp / "fisheye.yaml", scale)
        rec["fisheye_bird"] = cli_fisheye(
            tmp, dev, drive["seq"], drive["frames"][:n["fisheye"]],
            drive["mask"], fisheye_cfg)
        rec["run_synthetic"] = cli_synthetic(dev, n["synthetic"])
        rec["live_viewer"] = cli_viewer(system, drive["frames"][0][0])
        rec["native_loader"] = cli_native(tmp)
        path = tmp / "kitti" / "image_0" / "000000.png"
        t0 = time.perf_counter()
        for _ in range(5):
            imageio.imread(path, imageio.IMREAD_GRAYSCALE)
        rec["png_decode_ms"] = dict(
            ms=(time.perf_counter() - t0) * 1e3 / 5, file=path.name,
            note="a KITTI left frame as the port's writer stores it (every "
                 "row Sub-filtered: the row-at-a-time path)")
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["floors"] = dict(ate_m=MAX_CLI_ATE_M)
    return rec


# ---------------------------------------------------------------------------
# 13. parallel: the multi-device layer on shards of the one card
# ---------------------------------------------------------------------------

PARALLEL_SHARDS = 4
GLOO_PROCESSES = 2            # each with PARALLEL_SHARDS // 2 shards
GLOO_PROBLEM = dict(n_cams=64, n_points=8192)
WORKER_TIMEOUT_S = 300
# test_parallel.py::test_sharded_global_ba_all_edge_types' agreement with
# the one-device solve, and test_sharded_matches_single_device's between
# meshes
MAX_GBA_POSE_DIFF = 1e-3
MAX_GBA_POINT_MEDIAN_M = 2e-3
MAX_MESH_T_DIFF, MAX_MESH_COST_REL = 1e-3, 1e-2
# the dry run's pose graph does not converge in 10 GN x 128 CG steps, so
# its f32 solution moves with the order of the sums: the sharded solve is
# held to the spread that the one-device solve shows under permutations of
# its edges, measured in the same run against the f64 solve
PG_PERMUTATIONS = 3
PG_SPREAD_FACTOR = 2.0


def event_ms(fn, dev):
    """fn() between two CUDA events (the host enqueues while the device
    runs; the solvers wait on nothing), and its result."""
    sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def rot_diff(Ra, Rb):
    """Largest rotation angle (the skew part) of Ra·Rbᵀ over the batch."""
    D = np.einsum("kij,klj->kil", Ra, Rb)
    return float(np.abs((D - np.swapaxes(D, 1, 2)) / 2).max())


def pose_graph_spread(dev, pgp, sharded, single, n_iters=10, cg_iters=128):
    """The sharded PCG pose graph against the f32 spread from summation
    order alone: the one-device PCG in f64 as the reference, the
    one-device f32 PCG on the edges as given and on PG_PERMUTATIONS
    permutations of them. Returns each solve's largest translation and
    scale difference from the f64 one."""
    from orbslam_birdview_tpu_torch.graph import pose_graph
    from orbslam_birdview_tpu_torch.parallel import dryrun, runtime

    def on(k, dtype):
        return torch.as_tensor(pgp[k], device=dev).to(dtype)

    f64 = pose_graph.solve_pcg(
        runtime.Mesh([dev]), on("R_gt", torch.float64),
        on("t0", torch.float64), on("s0", torch.float64),
        on("fixed", torch.bool),
        [pose_graph._shard(on("e_i", torch.long), on("e_j", torch.long),
                           *(on(k, torch.float64)
                             for k in ("mR", "mt", "ms", "e_w")),
                           on("e_valid", torch.bool))], n_iters, cg_iters)
    t64, s64 = (x.cpu().numpy() for x in f64[1:3])

    def off(out):
        t, s = (x.double().cpu().numpy() for x in out[1:3])
        return [float(np.abs(t - t64).max()), float(np.abs(s - s64).max())]

    rng = np.random.default_rng(7)
    edges = dryrun.pose_graph_edges(pgp)
    spread = [off(single)]
    for _ in range(PG_PERMUTATIONS):
        perm = rng.permutation(len(pgp["e_i"]))
        spread.append(off(pose_graph.optimize_sim3_graph_pcg(
            pgp["R_gt"], pgp["t0"], pgp["s0"], pgp["fixed"],
            *(np.asarray(e)[perm] for e in edges), n_iters=n_iters,
            cg_iters=cg_iters, device=dev)))
    rec = dict(f64_drift_after_m=dryrun.mean_drift(
        pgp, *(x.cpu().numpy() for x in f64[:3])),
        sharded_vs_f64=off(sharded), one_device_vs_f64=spread,
        factor=PG_SPREAD_FACTOR)
    worst = np.max(np.array(spread), axis=0)
    check(all(a <= PG_SPREAD_FACTOR * b for a, b in
              zip(rec["sharded_vs_f64"], worst)),
          f"parallel: the sharded pose graph is {rec['sharded_vs_f64']} "
          f"(t, s) from the f64 solve, the one-device f32 solves at most "
          f"{worst.tolist()}")
    return rec


def parallel_solvers(dev, mesh):
    """(a): the dry run's sharded GBA and sharded PCG pose graph at full
    scale, timed beside the one-device solvers on the same problems, each
    also profiled for its kernel count; the sharded GBA twice, bit for
    bit."""
    from orbslam_birdview_tpu_torch.graph import ba_large, pose_graph
    from orbslam_birdview_tpu_torch.parallel import dryrun

    prob = dryrun.gba_problem()
    sharded = lambda: dryrun.run_sharded_gba(mesh, prob)   # noqa: E731

    def single():
        res = ba_large.bundle_adjust_large(
            prob["R"], prob["t"], prob["fixed"], prob["valid"], prob["X"],
            np.ones(len(prob["X"]), bool), prob["mono"], prob["stereo"],
            prob["bird"], dryrun.FX, dryrun.FY, dryrun.CX, dryrun.CY,
            bf=dryrun.BF, iters_phase1=2, iters_phase2=2, cg_iters=24,
            device=dev)
        return res.cam_R, res.cam_t, res.points, res.inl_mono, res.cost

    sharded()                                      # warm: workspaces
    ms_a, out_a = event_ms(sharded, dev)
    ms_b, out_b = event_ms(sharded, dev)
    check(all(torch.equal(x, y) for x, y in zip(out_a, out_b)),
          "parallel: two sharded GBA runs differ")
    single()
    ms_1, out_1 = event_ms(single, dev)
    R_s, t_s, X_s = (x.cpu().numpy() for x in out_a[:3])
    R_1, t_1, X_1 = (x.cpu().numpy() for x in out_1[:3])
    gba = dict(C=len(prob["R"]), P=len(prob["X"]), E=prob["edges"],
               shards=mesh.n_shards, sharded_ms=[ms_a, ms_b], single_ms=ms_1,
               cost=float(out_a[4]), single_cost=float(out_1[4]),
               mono_inlier_share=float(out_a[3].float().mean()),
               bit_identical=True,
               max_t_diff=float(np.abs(t_s - t_1).max()),
               max_rot_diff=rot_diff(R_s, R_1),
               median_point_diff_m=float(np.median(
                   np.linalg.norm(X_s - X_1, axis=1))))
    gba["sharded_profile"] = profile_region(sharded, dev, host_ops=False)
    gba["single_profile"] = profile_region(single, dev, host_ops=False)

    pgp = dryrun.pose_graph_problem()
    sharded_pg = lambda: dryrun.run_sharded_pose_graph(mesh, pgp)  # noqa

    def single_pg():
        return pose_graph.optimize_sim3_graph_pcg(
            pgp["R_gt"], pgp["t0"], pgp["s0"], pgp["fixed"],
            *dryrun.pose_graph_edges(pgp), n_iters=10, cg_iters=128,
            device=dev)

    ms_pg, out_pg = event_ms(sharded_pg, dev)
    ms_pg1, out_pg1 = event_ms(single_pg, dev)
    Rs, ts, ss = (x.cpu().numpy() for x in out_pg[:3])
    R1, t1, s1 = (x.cpu().numpy() for x in out_pg1[:3])
    pg = dict(K=len(pgp["s0"]), E=len(pgp["e_i"]), shards=mesh.n_shards,
              sharded_ms=ms_pg, single_ms=ms_pg1, cost=float(out_pg[3]),
              single_cost=float(out_pg1[3]),
              drift_before_m=dryrun.mean_drift(pgp, pgp["R_gt"], pgp["t0"],
                                               pgp["s0"]),
              drift_after_m=dryrun.mean_drift(pgp, Rs, ts, ss),
              single_drift_after_m=dryrun.mean_drift(pgp, R1, t1, s1),
              max_t_diff=float(np.abs(ts - t1).max()),
              max_s_diff=float(np.abs(ss - s1).max()),
              max_rot_diff=rot_diff(Rs, R1))
    pg["spread"] = pose_graph_spread(dev, pgp, out_pg, out_pg1)
    pg["sharded_profile"] = profile_region(sharded_pg, dev, host_ops=False)
    pg["single_profile"] = profile_region(single_pg, dev, host_ops=False)
    return gba, pg


def parallel_circle(dev, mesh, drive, one_device):
    """(b): the loop phase's full-width circle through
    `System(cfg, device, mesh)` on the 4-shard mesh: the essential graph
    and the full-map BA take the sharded branches."""
    from orbslam_birdview_tpu_torch.api.system import System
    from orbslam_birdview_tpu_torch.frontend import patch_kernel

    cfg = slam_config(drive)
    system = System(cfg, device=dev, mesh=mesh)
    patch_kernel.LAUNCHES = 0
    rec = run_circle(system, drive["frames"], drive["mask"], drive["seq"],
                     1 / 25.0)
    rec["patch_gather_launches"] = patch_kernel.LAUNCHES
    rec["shards"] = mesh.n_shards
    check_launches(rec["patch_gather_launches"], len(drive["frames"]), dev)
    check(rec["loops_closed"] >= 1, f"parallel circle: no loop closed")
    pair = lambda r: (r["loops"][0]["kf"], r["loops"][0]["cand"])  # noqa
    check(pair(rec) == pair(one_device),
          f"parallel circle: loop at {pair(rec)}, one device at "
          f"{pair(one_device)}")
    solvers = (rec["loops"][-1]["solver"], rec["gba"]["problem"]["solver"])
    check(solvers == ("sharded-dense", "sharded-implicit"),
          f"parallel circle: solvers {solvers}")
    check(rec["ate_m"] < MAX_LOOP_ATE_M,
          f"parallel circle: keyframe ATE {rec['ate_m']} m")
    rec["one_device"] = dict(loop=pair(one_device),
                             ate_before_gba_m=one_device["ate_before_gba_m"],
                             ate_m=one_device["ate_m"])
    return rec


def gloo_problem():
    from orbslam_birdview_tpu_torch.parallel import dryrun
    return dryrun.gba_problem(**GLOO_PROBLEM)


def gloo_worker(rank, world, store, out, device="cuda:0"):
    """One process of (c): PARALLEL_SHARDS // world shards on `device` over
    a gloo group, the sharded GBA on GLOO_PROBLEM."""
    import torch.distributed as dist

    from orbslam_birdview_tpu_torch.parallel import dryrun, runtime

    got = runtime.init_distributed(f"file://{store}", world, rank,
                                   backend="gloo")
    check(got == (world, rank), f"gloo worker: group {got}")
    mesh = runtime.Mesh([device] * (PARALLEL_SHARDS // world),
                        group=dist.group.WORLD)
    R, t, X, _, cost = dryrun.run_sharded_gba(mesh, gloo_problem())
    np.savez(out, R=R.cpu().numpy(), t=t.cpu().numpy(), X=X.cpu().numpy(),
             cost=cost.cpu().numpy(), first_shard=mesh.first_shard)
    dist.destroy_process_group()
    return 0


def parallel_gloo(dev, out_dir, world1_backend="nccl"):
    """(c): GLOO_PROCESSES processes, each with two shards on the card,
    their reductions through gloo on CUDA tensors, against this process's
    4-shard mesh; then an NCCL group of world size 1."""
    import torch.distributed as dist

    from orbslam_birdview_tpu_torch.parallel import dryrun, runtime

    work = out_dir / "parallel_gloo"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-worker",
         str(r), str(GLOO_PROCESSES), str(work / "store"),
         str(work / f"rank{r}.npz"), str(dev)], cwd=ROOT,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(GLOO_PROCESSES)]
    errors = []
    try:
        for r, proc in enumerate(procs):
            try:
                _, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
                errors.append(f"rank {r} timed out")
            if proc.returncode != 0:
                errors.append(f"rank {r} exited {proc.returncode}: "
                              f"{err[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(not errors, "parallel gloo: " + "; ".join(errors))
    rec = dict(processes=GLOO_PROCESSES, shards=PARALLEL_SHARDS,
               problem=GLOO_PROBLEM, wall_s=time.perf_counter() - t0)
    mesh = runtime.Mesh([dev] * PARALLEL_SHARDS)
    R, t, X, _, cost = dryrun.run_sharded_gba(mesh, gloo_problem())
    t, X, cost = t.cpu().numpy(), X.cpu().numpy(), float(cost)
    per = X.shape[0] // GLOO_PROCESSES
    rec["ranks"] = []
    for r in range(GLOO_PROCESSES):
        o = np.load(work / f"rank{r}.npz")
        d = dict(first_shard=int(o["first_shard"]),
                 max_t_diff=float(np.abs(o["t"] - t).max()),
                 cost_rel_diff=abs(float(o["cost"]) - cost) / abs(cost),
                 max_point_diff_m=float(np.abs(
                     o["X"] - X[r * per:(r + 1) * per]).max()))
        rec["ranks"].append(d)
        check(d["max_t_diff"] < MAX_MESH_T_DIFF
              and d["cost_rel_diff"] < MAX_MESH_COST_REL,
              f"parallel gloo: rank {r} differs from the in-process mesh "
              f"({d})")
    # NCCL at world size 1: a mesh's reduction through the group
    got = runtime.init_distributed(f"file://{work / 'nccl_store'}", 1, 0,
                                   backend=world1_backend)
    try:
        m = runtime.Mesh([dev] * 2, group=dist.group.WORLD)
        parts = [torch.arange(4, dtype=torch.float32, device=dev) * (i + 1)
                 for i in range(2)]
        total = m.psum(parts)
        check(got == (1, 0) and torch.equal(total, parts[0] + parts[1]),
              f"parallel nccl: group {got}, sum {total.tolist()}")
        rec["world1"] = dict(backend=dist.get_backend(), world=got[0])
    finally:
        dist.destroy_process_group()
    return rec


def parallel_jpeg():
    """(d): the committed JPEG fixtures through the port's decoder, against
    the cv2.imread arrays stored beside them (this machine has no cv2)."""
    from orbslam_birdview_tpu_torch.utils import imageio

    rec = {}
    for path in sorted((ROOT / "tests" / "data" / "jpeg").glob("*.jpg")):
        want = np.load(path.with_suffix(".npz"))
        t0 = time.perf_counter()
        gray = imageio.imread(path, imageio.IMREAD_GRAYSCALE)
        colour = imageio.imread(path, imageio.IMREAD_COLOR)
        ms = (time.perf_counter() - t0) * 1e3
        equal = (np.array_equal(gray, want["gray"])
                 and np.array_equal(colour, want["color"]))
        check(equal, f"parallel jpeg: {path.name} differs from its cv2 "
              "decode")
        rec[path.name] = dict(shape=list(colour.shape), equal=True,
                              ms=ms)
    check(len(rec) >= 4, f"parallel jpeg: {len(rec)} fixtures found")
    return rec


def parallel_phase(dev, loop_drive, one_device_circle):
    """The multi-device layer on shards of the one card: (a) the dry run
    at full scale with the one-device solvers beside it, (b) the circle
    through System on the 4-shard mesh, (c) the cross-process reduction,
    (d) the JPEG fixtures. Shards on one card run one after another: these
    are not multi-GPU speeds."""
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.parallel import dryrun, runtime

    t_phase = time.perf_counter()
    mesh = runtime.Mesh([dev] * PARALLEL_SHARDS)
    rec = {}
    patch_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    rec["dryrun"] = dryrun.dryrun_multichip(PARALLEL_SHARDS, mesh=mesh)
    rec["dryrun"]["wall_s"] = time.perf_counter() - t0
    rec["dryrun"]["patch_gather_launches"] = patch_kernel.LAUNCHES
    check(patch_kernel.LAUNCHES == PARALLEL_SHARDS,
          f"parallel dry run: {patch_kernel.LAUNCHES} gather launches")
    t0 = time.perf_counter()
    rec["gba"], rec["pose_graph"] = parallel_solvers(dev, mesh)
    rec["solvers_s"] = time.perf_counter() - t0
    g = rec["gba"]
    check(g["max_t_diff"] < MAX_GBA_POSE_DIFF
          and g["max_rot_diff"] < MAX_GBA_POSE_DIFF
          and g["median_point_diff_m"] < MAX_GBA_POINT_MEDIAN_M,
          f"parallel: the sharded GBA differs from the one-device solve "
          f"({g['max_t_diff']}, {g['max_rot_diff']}, "
          f"{g['median_point_diff_m']})")
    rec["circle"] = parallel_circle(dev, mesh, loop_drive, one_device_circle)
    rec["gloo"] = parallel_gloo(dev, ROOT / "chiprun_out")
    rec["jpeg"] = parallel_jpeg()
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["note"] = ("shards on one card run one after another: the times are "
                   "not multi-GPU speeds")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from orbslam_birdview_tpu_torch.core import linalg
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.utils import build

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    # csrc/patch_gather.cu and csrc/small_linalg.cu, one nvcc each, together
    build.build_libraries([patch_kernel.LIBRARY, linalg.LIBRARY])
    patch_kernel._kernel(), linalg._kernels()
    build_s = time.perf_counter() - t0
    drive = render_drive(SYSTEM_FRAMES)
    seeded_drive = dict(drive, frames=drive["frames"][:N_FRAMES + 1])
    init_drive = dict(drive, frames=drive["frames"][:N_INIT_DRIVE])
    kernel, slice_rec, rows, seeded = slice_phase(seeded_drive, dev)
    slice_rec.update(build_s=build_s, card=card)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record = out_dir / "chip_smoke.json"
    full = dict(card=card, kernels=[kernel], slice=slice_rec, frames=rows)

    def write_record():
        # written before each set of acceptance checks, so a failing run
        # leaves its numbers
        record.write_text(json.dumps(full, indent=1))

    write_record()
    check_floors(slice_rec)

    # initialization with no library det on the card (`det_small` takes
    # its closed form there); the library's first call is timed after it
    det_devices = []
    with library_det_calls(det_devices):
        tracker, init_rec = init_phase(init_drive, dev)
    init_rec.update(card=card, library_det_calls=det_devices)
    check("cuda" not in det_devices,
          f"initialization called torch.linalg.det on the card: "
          f"{det_devices}")
    init_rec.update(library_det_ms=library_det_ms(dev),
                    det_small=det_sign_check(dev))
    full["init"] = init_rec
    write_record()
    tracked_rec, tracked_rows = tracked_from_init_phase(tracker, init_drive,
                                                        dev)
    init_rec["tracked_from_init"] = tracked_rec
    full["frames"]["from_init"] = tracked_rows
    init_rec["floors"] = dict(
        max_frames=MAX_INIT_FRAMES, baseline_rel=MAX_BASELINE_REL_ERR,
        rot_deg=MAX_INIT_ROT_ERR_DEG, dir_deg=MAX_INIT_DIR_ERR_DEG,
        map_points=MIN_MAP_POINTS, bird_landmarks=MIN_BIRD_LANDMARKS,
        median_reproj_px=MAX_MEDIAN_REPROJ_PX,
        tracked=dict(front=MIN_INIT_FRONT_INLIERS, bird=MIN_INIT_BIRD_INLIERS,
                     pos_m=MAX_INIT_POS_ERR_M,
                     rot_deg=MAX_INIT_ROT_ERR_DEG_TRACKED))
    write_record()
    check_tracked_from_init(tracked_rec)
    by_phase = kernel["launches_by_phase"]
    by_phase.update(init=init_rec["patch_gather_launches"],
                    from_init=tracked_rec["patch_gather_launches"])

    # the SLAM loop through System: the drive, the e2e tests, lost and found
    system_rec = dict(card=card)
    full["system"] = system_rec
    try:
        system, system_rec["drive"] = system_phase(drive, dev)
    finally:
        write_record()
    system_phase_checks(system_rec["drive"])
    loop_rec = dict(card=card)
    full["loop"] = loop_rec
    loop_drive = render_drive(LOOP_FRAMES, **CIRCLE)
    try:
        loop_rec["circle"] = loop_phase(dev, loop_drive)
    finally:
        write_record()
    loop_phase_checks(loop_rec["circle"])
    system_rec["e2e"] = e2e_phase(dev)
    write_record()
    loop_rec["e2e_circle"] = e2e_circular_loop_closure(dev)
    write_record()
    system_rec["relocalization"] = reloc_phase(drive, dev)
    write_record()
    # stereo and RGB-D through System at the KITTI and TUM configurations
    depth_rec = dict(card=card)
    full["depth"] = depth_rec
    try:
        depth_rec.update(depth_phase(dev))
    finally:
        write_record()
    depth_phase_checks(depth_rec, dev)
    # the outer surface: dataset CLI, scorer, synthetic runner, viewer
    cli_rec = dict(card=card)
    full["cli"] = cli_rec
    try:
        cli_rec.update(cli_phase(dev, system, drive))
    finally:
        write_record()
    del system
    # the multi-device layer on shards of the card, and the JPEG reader
    parallel_rec = dict(card=card)
    full["parallel"] = parallel_rec
    try:
        parallel_rec.update(parallel_phase(dev, loop_drive,
                                           loop_rec["circle"]))
    finally:
        write_record()
    del loop_drive
    kitti = depth_rec["gather_kitti_stereo"]
    kernel["kitti_stereo"] = {k: kitti[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "host_bound_ms",
        "launch_floor_ms", "bytes", "max_abs_err", "note")}
    kernel["max_abs_err"] = max(kernel["max_abs_err"], kitti["max_abs_err"])
    by_phase.update(system=system_rec["drive"]["patch_gather_launches"],
                    loop=loop_rec["circle"]["patch_gather_launches"],
                    e2e_bird=system_rec["e2e"]["patch_gather_launches"],
                    e2e_loop=loop_rec["e2e_circle"]["patch_gather_launches"],
                    relocalization=system_rec["relocalization"][
                        "patch_gather_launches"],
                    depth_stereo=depth_rec["stereo"]["patch_gather_launches"],
                    depth_rgbd=depth_rec["rgbd"]["patch_gather_launches"],
                    depth_rgbd_circle=depth_rec["rgbd_circle"][
                        "patch_gather_launches"],
                    e2e_depth=system_rec["e2e"][
                        "depth_patch_gather_launches"],
                    **{f"cli_{k}": cli_rec[k]["patch_gather_launches"]
                       for k in ("kitti_stereo", "tum_rgbd", "fisheye_bird",
                                 "run_synthetic")},
                    parallel_dryrun=parallel_rec["dryrun"][
                        "patch_gather_launches"],
                    parallel_circle=parallel_rec["circle"][
                        "patch_gather_launches"])
    check(all(n > 0 for n in by_phase.values()),
          f"a path never launched the patch gather: {by_phase}")
    kernel["launches"] = sum(by_phase.values())

    # the profiled frame comes after every timed drive: once a profiler
    # session has run, each launch of the process costs more host time
    prof = profile_step(seeded, drive["frames"], drive["cam"], drive["mask"],
                        dev, slice_rec["bird"]["median_step_ms"])
    slice_rec["profile"] = {k: v for k, v in prof.items() if k != "top"}
    full["frames"]["profile_top"] = prof["top"]
    slice_rec["small_reference"] = reference_phase(dev,
                                                   drive["frames"][0][0])
    loop_rec["small_reference"] = small_loop_reference(dev)
    # the solvers' SVD and eigh kernels against their plain versions
    small_rec = dict(card=card)
    full["small_linalg"] = small_rec
    try:
        small_rec.update(small_linalg_phase(dev))
    finally:
        write_record()
    solver_kernels = solver_kernel_lines(
        small_rec["kernels"], init=init_rec["small_linalg_launches"],
        relocalization=system_rec["relocalization"]["small_linalg_launches"],
        loop=loop_rec["circle"]["small_linalg_launches"],
        rgbd_circle=depth_rec["rgbd_circle"]["small_linalg_launches"])
    loop_rec["script_s"] = time.perf_counter() - t_start
    write_record()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "host_bound_ms", "launch_floor_ms", "launches_by_phase")
    kernels_line = {"kernels": [
        {k: kernel[k] for k in (*keys, "kitti_stereo")},
        *({k: line[k] for k in keys} for line in solver_kernels)]}
    full["kernels_line"] = kernels_line["kernels"]
    write_record()
    print(json.dumps({"slice": slice_rec}))
    print(json.dumps({"init": init_rec}))
    print(json.dumps({"system": system_rec}))
    print(json.dumps({"loop": {k: v for k, v in loop_rec.items()}}))
    print(json.dumps({"depth": depth_rec}))
    print(json.dumps({"cli": cli_rec}))
    print(json.dumps({"parallel": parallel_rec}))
    print(json.dumps({"small_linalg": {
        k: v for k, v in small_rec.items()
        if k not in ("sites", "solver_calls")}}))
    # last but one, so that the end of a long output still holds it
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--gloo-worker"]:
            sys.exit(gloo_worker(int(sys.argv[2]), int(sys.argv[3]),
                                 *sys.argv[4:7]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(2)
