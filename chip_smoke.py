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
   each run and read after it. One more frame runs under torch.profiler,
   which attributes its device kernels to the two extractions, the pose LM
   and the rest of the step;
4. reference: the same step on a small input on the CPU and on the GPU,
   which must agree.

Prints the card line, a `kernels` JSON line, a `slice` JSON line and, last,
`{"ok": true, "device": {...}}`. Writes the full record to
chiprun_out/chip_smoke.json.
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


def run_drive(st, frames, cam, mask, bird, dev):
    """Chain the step over frames[1:] on the device pose chain, starting
    from frame 0's ground-truth pose; per-frame records."""
    from orbslam_birdview_tpu_torch.pipeline import fused_track

    R0, t0 = (torch.as_tensor(a, device=dev) for a in frames[0][2])
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


def slice_phase(dev):
    from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera
    from orbslam_birdview_tpu_torch.frontend import patch_kernel
    from orbslam_birdview_tpu_torch.utils import synth

    cam = front_camera()
    bv = BirdviewCamera(width=BEV, height=BEV)
    cfg, bcfg = configs()
    t0 = time.perf_counter()
    seq = synth.BirdSequence(cam, bv, n_frames=N_FRAMES + 1)
    frames = [seq.frame(i) for i in range(N_FRAMES + 1)]
    mask = synth.footprint_mask(bv)
    render_s = time.perf_counter() - t0
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
    kernel["launches"] = bird_launches

    patch_kernel.LAUNCHES = 0
    mono_rows = run_drive(st, frames[:N_MONO + 1], cam, None, False, dev)
    mono_launches = patch_kernel.LAUNCHES
    check(mono_launches == len(mono_rows),
          f"patch kernel launched {mono_launches} times in "
          f"{len(mono_rows)} mono frames")

    bird_sum, mono_sum = summarize(rows), summarize(mono_rows)
    prof = profile_step(st, frames, cam, mask, dev,
                        bird_sum["median_step_ms"])
    slice_rec = dict(
        step="track_step_mono", front=f"{cam.width}x{cam.height}",
        bev=f"{bv.width}x{bv.height}", features=[cfg.n_features,
                                                 bcfg.n_features],
        P=P, Pb=PB, render_s=render_s, bird=bird_sum, mono=mono_sum,
        kernel_launches_per_bird_frame=bird_launches / n,
        kernel_launches_per_mono_frame=mono_launches / len(mono_rows),
        profile={k: v for k, v in prof.items() if k != "top"},
        floors=dict(front=MIN_FRONT_INLIERS, bird=MIN_BIRD_INLIERS,
                    mono=MIN_MONO_INLIERS, pos_m=MAX_POS_ERR_M,
                    rot_deg=MAX_ROT_ERR_DEG))
    return kernel, slice_rec, dict(bird=rows, mono=mono_rows,
                                   profile_top=prof["top"])


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
    GPU (kernels): the two must agree."""
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
                gpu_inliers=[r["n_inliers"] for r in gpu_rows])


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

    kernel, slice_rec, rows = slice_phase(dev)
    slice_rec.update(build_s=build_s, card=card)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record = out_dir / "chip_smoke.json"
    # written before the acceptance checks, so a failing run leaves its numbers
    record.write_text(json.dumps(dict(card=card, kernels=[kernel],
                                      slice=slice_rec, frames=rows), indent=1))
    check_floors(slice_rec)
    slice_rec["small_reference"] = reference_phase(dev)
    record.write_text(json.dumps(dict(card=card, kernels=[kernel],
                                      slice=slice_rec, frames=rows), indent=1))

    kernels_line = {"kernels": [{k: kernel[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "host_bound_ms")}]}
    print(json.dumps(kernels_line))
    print(json.dumps({"slice": slice_rec}))
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
