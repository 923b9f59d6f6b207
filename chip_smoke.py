#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. setup: a CUDA device is required; prints the card's name and power
   limit and builds the CUDA kernels from the sources in the checkout;
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
   0's ground truth — over a rendered drive, chained on the device pose
   chain; then a shorter mono-only run. The kernel counts are zeroed before
   each run and read after it. One more frame runs under torch.profiler
   (after phase 5, so that no timed drive follows a profiler session),
   which attributes its device kernels to the two extractions, the pose LM
   and the rest of the step;
4. init: a `Tracker` with a `LocalMapper` and a `MapStore` is fed the
   drive's frames through `Tracker.process` until it has initialized: ORB
   on both streams, frame-to-frame matching, two-view initialization with
   the BEV ICP's metric scale, the initial map and its bundle adjustment.
   The drive moves 0.12 m a frame and the ICP vetoes baselines under
   0.3 m, so the first attempts fail by design. The result is held against
   the drive's ground truth expressed in the reference keyframe's camera
   frame, with no scale alignment;
5. tracked from init: `_refresh_local_map` turns the store into the step's
   bundles, and the drive's remaining frames go through `track_step_mono`
   from the second keyframe's pose, against the same ground truth;
6. reference: the same step, `initialize_two_view` and `bundle_adjust` on
   small inputs on the CPU and on the GPU, which must agree.

Prints the card line, a `kernels` JSON line, a `slice` JSON line, an `init`
JSON line and, last, `{"ok": true, "device": {...}}`. Writes the full
record to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_FRAMES = 30            # bird frames after the seed frame
N_MONO = 10              # mono-only frames
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
# The GPU's scatter-adds sum in an order that changes from run to run. A
# point 10 m away over a 1 m baseline has a weakly observed depth, and one
# whose edge sits on a chi² gate can be reclassified between the phases: 99 %
# of the points agree to 5 mm, every point to 5 cm (four runs of the same
# code read a largest difference of 0.8, 1.2, 2.0 and 9.3 mm).
SMALL_BA_POINT_TOL, SMALL_BA_POINT_MAX = 5e-3, 5e-2


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
    """Hold the patch gather against its plain version on the inputs the
    extractor gives it for one front and one BEV frame (2 calls over 12
    level shapes) and on starts outside the image, and time the frame's 2
    gathers."""
    from orbslam_birdview_tpu_torch.frontend import orb, patch_kernel

    calls = []
    launch = patch_kernel.gather_patches_levels

    def record(padded_levels, ys_levels, xs_levels, size):
        calls.append((padded_levels, ys_levels, xs_levels, size))
        return launch(padded_levels, ys_levels, xs_levels, size)

    patch_kernel.gather_patches_levels = record
    try:
        orb.extract_orb(img, cfg, device=dev)
        orb.extract_orb(bev, bcfg, mask=mask, device=dev)
    finally:
        patch_kernel.gather_patches_levels = launch
    check([len(c[0]) for c in calls] == [cfg.n_levels, bcfg.n_levels],
          f"expected one gather of {cfg.n_levels} levels and one of "
          f"{bcfg.n_levels}, got {[len(c[0]) for c in calls]}")
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
    return dict(
        name="patch_gather", route="cuda",
        source="orbslam_birdview_tpu_torch/csrc/patch_gather.cu",
        replaces="orbslam_birdview_tpu/frontend/patch_kernel.py:110",
        launches=None, max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms, host_bound_ms=kernel_host_ms, bytes=n_bytes,
        level_shapes=shapes,
        note="per frame: one front + one BEV extraction, 12 levels; ms is "
             "the kernel's 2 launches (one per extraction), plain_ms and "
             "library_ms their 12 per-level calls, all with the device "
             "queue full; host_bound_ms the 2 launches as the step issues "
             "them")


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


def render_drive(n_frames=N_FRAMES + 1, scale=1.0, features=2000):
    """The drive every phase runs on: camera, BEV camera, extractor
    configurations, the rendered frames with their ground truth, the BEV
    footprint mask. `scale` cuts the images (and `features` the budgets)
    for runs on a CPU."""
    from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera
    from orbslam_birdview_tpu_torch.utils import synth

    cam = front_camera(scale)
    bv = BirdviewCamera(pixel2meter=0.03984 * 1.7 / scale,
                        width=round(BEV * scale), height=round(BEV * scale))
    cfg, bcfg = configs(features, features)
    t0 = time.perf_counter()
    seq = synth.BirdSequence(cam, bv, n_frames=n_frames)
    frames = [seq.frame(i) for i in range(n_frames)]
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
    check(tracker.state == tracking.OK,
          f"not initialized after {fed} frames: {attempts}")
    check_launches(launches, fed, dev)
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
        patch_gather_launches=launches)
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


def reference_phase(dev):
    """The step on a small input, on the CPU (plain versions) and on the
    GPU (kernels): the two must agree. Then `initialize_two_view` and
    `bundle_adjust`, likewise."""
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
                bundle_adjust=small_ba_reference(dev))


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
    """`bundle_adjust` on a synthetic problem (4 cameras, 200 points, 40
    ground points; mono and bird edges, an all-invalid stereo set) on the
    CPU and on the GPU. The scatter-adds sum in another order on the GPU:
    costs agree to 1e-3 relative, poses to 1e-3, 99 % of the points to
    5e-3."""
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
    out = []
    for d in (torch.device("cpu"), dev):
        res = ba.bundle_adjust(Rp, tp, np.arange(C) < 1, np.ones(C, bool), Xp,
                               np.ones(len(Xp), bool), *sets, fx, fy, cx, cy,
                               device=d)
        check(res.points.device.type == d.type, "result on the wrong device")
        out.append([f.cpu().numpy() for f in res])
    c, g = out
    check(abs(g[6] / c[6] - 1.0) <= SMALL_BA_TOL,
          f"small BA: cost cpu {c[6]} gpu {g[6]}")
    for i, name in ((0, "cam_R"), (1, "cam_t"), (2, "points")):
        check(np.isfinite(g[i]).all(), f"small BA: non-finite {name}")
    for i, name in ((0, "cam_R"), (1, "cam_t")):
        check(np.abs(c[i] - g[i]).max() <= SMALL_BA_TOL,
              f"small BA: {name} differ by {np.abs(c[i] - g[i]).max()}")
    point_diff = np.abs(c[2] - g[2]).max(axis=1)
    check(np.quantile(point_diff, 0.99) <= SMALL_BA_POINT_TOL
          and point_diff.max() <= SMALL_BA_POINT_MAX,
          f"small BA: points differ by {np.quantile(point_diff, 0.99)} at "
          f"the 99th percentile, {point_diff.max()} at most")
    for i in (3, 4, 5):
        check(int((c[i] != g[i]).sum()) <= SMALL_MASK_TOL,
              "small BA: inlier masks differ")
    check(np.abs(g[1] - cam_t).max() < 0.03, "small BA: poses not recovered")
    check(g[3][::17].mean() < 0.2 and g[3].mean() > 0.85,
          "small BA: outliers not separated")
    return dict(cost_cpu=float(c[6]), cost_gpu=float(g[6]),
                max_pose_diff=float(max(np.abs(c[0] - g[0]).max(),
                                        np.abs(c[1] - g[1]).max())),
                p99_point_diff=float(np.quantile(point_diff, 0.99)),
                max_point_diff=float(point_diff.max()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from orbslam_birdview_tpu_torch.frontend import patch_kernel

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    patch_kernel._kernel()   # builds csrc/patch_gather.cu with nvcc
    build_s = time.perf_counter() - t0

    drive = render_drive()
    kernel, slice_rec, rows, seeded = slice_phase(drive, dev)
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

    tracker, init_rec = init_phase(drive, dev)
    init_rec["card"] = card
    full["init"] = init_rec
    write_record()
    tracked_rec, tracked_rows = tracked_from_init_phase(tracker, drive, dev)
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
    check(all(n > 0 for n in by_phase.values()),
          f"a path never launched the patch gather: {by_phase}")
    kernel["launches"] = sum(by_phase.values())

    # the profiled frame comes after every timed drive: once a profiler
    # session has run, each launch of the process costs more host time
    prof = profile_step(seeded, drive["frames"], drive["cam"], drive["mask"],
                        dev, slice_rec["bird"]["median_step_ms"])
    slice_rec["profile"] = {k: v for k, v in prof.items() if k != "top"}
    full["frames"]["profile_top"] = prof["top"]
    slice_rec["small_reference"] = reference_phase(dev)
    write_record()

    kernels_line = {"kernels": [{k: kernel[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "host_bound_ms", "launches_by_phase")}]}
    print(json.dumps(kernels_line))
    print(json.dumps({"slice": slice_rec}))
    print(json.dumps({"init": init_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(2)
