"""Run the JAX package and the PyTorch port on the same rendered drive, on
the CPU, and print what each did.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tools/port_reference.py [PART ...]

With no PART every part runs; otherwise the named ones (seeded, init,
system, wall, circle, depth).

The drive is chip_smoke.py's (BirdSequence, speed 0.12 m and yaw 0.004 rad
per frame, 30 frames after the first), cut to half size so that it runs on
a small CPU: front 475×200 with the fisheye rig's intrinsics halved and
1000 features on 8 levels; BEV 192×192 at twice the metres per pixel (the
same ground coverage) with 1000 features on 4 levels; P=3072, Pb=1024.

Four parts, each for both packages:
- seeded: the fused step over the drive from bundles seeded from frame 0's
  ground truth, with and without the bird stream;
- init: `Tracker.process` until the tracker has initialized (two-view
  initialization with the BEV ICP's metric scale, the initial map, its
  BA), then the fused step over the rest of the drive from the bundles
  `_refresh_local_map` builds, against ground truth in the reference
  keyframe's frame with no scale alignment;
- system: `System.track_monocular_with_birdview` over the drive rendered
  to 60 frames (loop closing off in both), flushed, against ground truth in
  the first keyframe's frame with no scale alignment;
- wall: `System.track_monocular` over the e2e test's wall sequence (30
  frames, 640×480, 1000 features), ATE with scale alignment;
- circle: `System.track_monocular_with_birdview` with loop closing on over
  the loop phase's circle (`chip_smoke.CIRCLE`, 142 frames) at the same
  half size: the loops closed, each one's keyframe pair and Sim3 scale, the
  keyframe ATE (rigid, no scale) just before the first GBA round lands and
  at the end, the GBA rounds landed;
- depth: `System.track_stereo` and `System.track_rgbd` (loop closing off)
  over chip_smoke.py's depth drives cut to half size: the KITTI stereo
  configuration at 620×188 with 1000 features over 16 frames, TUM1's RGB-D
  one at 320×240 with 600 features (the depth initialization needs 500
  depth-valid keypoints) over 30 frames; ATE against ground truth in the
  first keyframe's frame with no scale alignment.

Each package extracts its own keypoints from the same images. Prints one
JSON object with both packages' summaries.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from orbslam_birdview_tpu.api.config import SlamConfig as JSlamConfig  # noqa: E402
from orbslam_birdview_tpu.core import camera as jcam  # noqa: E402
from orbslam_birdview_tpu.frontend import orb as jorb  # noqa: E402
from orbslam_birdview_tpu.mapping.mapstore import MapStore as JMapStore  # noqa: E402
from orbslam_birdview_tpu.pipeline import fused_track as jft  # noqa: E402
from orbslam_birdview_tpu.pipeline import local_mapping as jlm  # noqa: E402
from orbslam_birdview_tpu.pipeline import tracking as jtr  # noqa: E402

N_FRAMES = 30
N_SYSTEM = 60
N_WALL = 30
SCALE = 0.5
P, PB = 3072, 1024


def jax_drive(frames, cam, mask, lm, blm, cfg, bcfg, jbv, sf, isig, R_bc,
              t_bc, bird, start=None):
    """The reference's step chained over frames[1:] as chip_smoke chains
    the port's, from `start` or frame 0's ground-truth pose."""
    R0, t0 = (jnp.asarray(a) for a in (frames[0][2] if start is None
                                       else start))
    R_pred, t_pred, R_last, t_last = R0, t0, R0, t0
    vis = found = None
    rows = []
    for img, bev, (R_gt, t_gt) in frames[1:]:
        kw = {}
        if bird:
            kw = dict(bird_img=jnp.asarray(bev), bird_mask=jnp.asarray(mask),
                      bird_lm=blm, bird_cfg=bcfg, bv=jbv,
                      R_bc=jnp.asarray(R_bc), t_bc=jnp.asarray(t_bc))
        t_start = time.perf_counter()
        out = jft.track_step_mono(
            jnp.asarray(img), R_pred, t_pred, lm, sf, isig, cfg, cam.fx,
            cam.fy, cam.cx, cam.cy, cam.width, cam.height, R_last=R_last,
            t_last=t_last, vis_acc=vis, found_acc=found, **kw)
        s = jft.unpack_summary(np.asarray(out.summary))
        pos, rot = smoke.pose_errors(s["R"], s["t"], R_gt, t_gt)
        rows.append(dict(step_ms=(time.perf_counter() - t_start) * 1e3,
                         n_inliers=s["n_inliers"], n_matched=s["n_matched"],
                         n_inliers_bird=s["n_inliers_bird"], n_kp=s["n_kp"],
                         pos_err_m=pos, rot_err_deg=rot))
        R_last, t_last = out.R, out.t
        R_pred, t_pred = out.R_pred_next, out.t_pred_next
        vis, found = out.vis_acc, out.found_acc
    return rows


def jax_seeded(drive, st, bird):
    """The JAX step from the port's seeded state, carried back as numpy."""
    return jax_drive(
        drive["frames"], drive["cam"], drive["mask"],
        jft.LocalMapDevice(*(jnp.asarray(f.numpy()) for f in st.lm)),
        jft.BirdMapDevice(*(jnp.asarray(f.numpy()) for f in st.bird_lm)),
        jorb.ORBConfig(**st.cfg._asdict()),
        jorb.ORBConfig(**st.bird_cfg._asdict()),
        jcam.BirdviewCamera(**st.bv._asdict()),
        jnp.asarray(st.scale_factors.numpy()),
        jnp.asarray(st.inv_sigma2.numpy()), drive["seq"].R_bc,
        drive["seq"].t_bc, bird)


def jax_init(drive):
    """The JAX tracker through `Tracker.process` until it has initialized,
    then its fused step over the rest of the drive; the same record as
    chip_smoke's init and tracked-from-init phases, without the timings."""
    seq, frames, mask, cam = (drive[k] for k in ("seq", "frames", "mask",
                                                 "cam"))
    cfg = jax_config(drive)
    store = JMapStore(kp_cap=cfg.orb.padded_capacity(),
                      bird_cap=cfg.effective_bird_orb().padded_capacity())
    tracker = jtr.Tracker(cfg, store, jlm.LocalMapper(cfg, store))
    fed = 0
    for i, (img, bev, _) in enumerate(frames[:smoke.MAX_INIT_FRAMES]):
        tracker.process(img, float(i), bev, mask)
        fed += 1
        if tracker.state == jtr.OK:
            break
    tracker.flush()
    smoke.check(tracker.state == jtr.OK, "the JAX tracker did not initialize")
    ref_pose = seq.gt_cam_pose(int(store.kf_frame_id[0]))
    R_gt, t_gt = smoke.relative_pose(
        seq.gt_cam_pose(int(store.kf_frame_id[1])), ref_pose)
    R, t = store.kf_R[1], store.kf_t[1]
    base, base_gt = float(np.linalg.norm(t)), float(np.linalg.norm(t_gt))
    rec = dict(frames_fed=fed, keyframe_frames=store.kf_frame_id[:2].tolist(),
               map_points=int(store.n_mp), bird_landmarks=int(store.n_bmp),
               baseline_m=base, baseline_gt_m=base_gt,
               scale_ratio=base / base_gt,
               rot_err_deg=smoke.pose_errors(R, t, R_gt, t_gt)[1],
               median_reproj_px=[smoke.reprojection_px(store, cam, 0),
                                 smoke.reprojection_px(store, cam, 1)])
    tracker._refresh_local_map()
    first = int(store.kf_frame_id[1])
    rest = [(img, bev, smoke.relative_pose(pose, ref_pose))
            for img, bev, pose in frames[first:]]
    rows = jax_drive(rest, cam, mask, tracker._lm_bundle,
                     tracker._bird_bundle, cfg.orb, cfg.effective_bird_orb(),
                     cfg.birdview, tracker._sf_dev, tracker._isig_dev,
                     tracker.R_bc, tracker.t_bc, True,
                     start=(tracker.last_frame.R, tracker.last_frame.t))
    rec["tracked_from_init"] = smoke.summarize(rows)
    return rec


def systems(drive):
    """Both packages' System over the drive, fed without reading any pose
    in between (the lag queue stays full), then flushed."""
    from orbslam_birdview_tpu.api.system import System as JSystem
    from orbslam_birdview_tpu_torch.api.system import System

    seq, frames, mask = drive["seq"], drive["frames"], drive["mask"]
    pcfg = smoke.slam_config(drive, P, PB)
    jcfg = jax_config(drive)
    out = {}
    for name, system in (("jax", JSystem(jcfg, enable_loop_closing=False)),
                         ("port_cpu", System(pcfg, enable_loop_closing=False,
                                             device="cpu"))):
        t0 = time.perf_counter()
        fds = [system.track_monocular_with_birdview(img, bev, mask, i / 25.0)
               for i, (img, bev, _) in enumerate(frames)]
        system._flush()
        ok = [fd.pose_ok for fd in fds]
        first = ok.index(True)
        store = system.store
        ref = seq.gt_cam_pose(int(store.kf_frame_id[0]))
        gts = [smoke.relative_pose(seq.gt_cam_pose(i), ref)
               for i in range(len(frames))]
        rec = dict(frames=len(frames), init_frame=first,
                   tracked_after_init=int(sum(ok[first:])),
                   keyframe_frames=store.kf_frame_id[:store.n_kf].tolist(),
                   keyframes_alive=int(store.kf_valid.sum()),
                   map_points=int(store.mp_valid.sum()),
                   bird_landmarks=int(store.bmp_valid.sum()),
                   wall_s=time.perf_counter() - t0,
                   **smoke.trajectory_errors(fds[first:], gts[first:]))
        if name == "port_cpu":
            rec["mapper"] = dict(system.mapper.stats)
        out[name] = rec
    return out


def circles():
    """Both packages' System, loop closing on, over the circle."""
    from orbslam_birdview_tpu.api.system import System as JSystem
    from orbslam_birdview_tpu_torch.api.system import System

    drive = smoke.render_drive(smoke.LOOP_FRAMES, SCALE, 1000, **smoke.CIRCLE)
    seq, mask = drive["seq"], drive["mask"]
    out = {}
    for name, make in (("jax", lambda: JSystem(jax_config(drive))),
                       ("port_cpu", lambda: System(
                           smoke.slam_config(drive, P, PB), device="cpu"))):
        system = make()
        obs = smoke.watch_loop(system, seq)
        t0 = time.perf_counter()
        fds = [system.track_monocular_with_birdview(img, bev, mask, i / 25.0)
               for i, (img, bev, _) in enumerate(drive["frames"])]
        system._flush()
        store = system.store
        out[name] = dict(
            n_loops_closed=system.loop_closer.n_loops_closed,
            loop_edges=[list(map(int, e)) for e in store.loop_edges],
            tracked=int(sum(fd.pose_ok for fd in fds)),
            keyframes_alive=int(store.kf_valid.sum()),
            ate_m=smoke.keyframe_ate(store, seq),
            wall_s=time.perf_counter() - t0, **obs)
    return out


def walls():
    """Both packages' System over the e2e wall sequence (mono)."""
    from orbslam_birdview_tpu.api.system import System as JSystem
    from orbslam_birdview_tpu.frontend.orb import ORBConfig as JORBConfig
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.api.system import System
    from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence, ate_rmse

    seq = WallSequence(PinholeCamera(**smoke.E2E_CAM), n_frames=N_WALL,
                       step=0.03)
    frames = [seq.frame(i) for i in range(N_WALL)]
    out = {}
    for name, system in (
            ("jax", JSystem(JSlamConfig(
                camera=jcam.PinholeCamera(**smoke.E2E_CAM),
                orb=JORBConfig(n_features=1000), sensor="mono"),
                enable_loop_closing=False)),
            ("port_cpu", System(SlamConfig(
                camera=PinholeCamera(**smoke.E2E_CAM),
                orb=ORBConfig(n_features=1000), sensor="mono"),
                enable_loop_closing=False, device="cpu"))):
        fds = [system.track_monocular(img, i / 30.0)
               for i, (img, _) in enumerate(frames)]
        system._flush()
        est = np.array([-fd.R.T @ fd.t for fd in fds if fd.pose_ok])
        gt = np.array([-R.T @ t for fd, (_, (R, t)) in zip(fds, frames)
                       if fd.pose_ok])
        store = system.store
        out[name] = dict(
            frames=N_WALL, tracked=len(est),
            ate_with_scale=ate_rmse(est, gt, with_scale=True),
            keyframe_frames=store.kf_frame_id[:store.n_kf].tolist(),
            map_points=int(store.mp_valid.sum()))
    return out


N_DEPTH = dict(stereo=16, rgbd=30)
DEPTH_FEATURES = dict(stereo=1000, rgbd=600)


def half_depth_config(cls, name):
    """chip_smoke.py's depth configuration for either package (`cls` its
    SlamConfig), the camera cut to half size."""
    path = str(smoke.ROOT / "configs" / ("kitti00-02_stereo.yaml"
                                         if name == "stereo"
                                         else "tum1_rgbd.yaml"))
    cfg = cls.from_yaml(path, sensor=name)
    c = cfg.camera
    cfg.camera = c._replace(
        fx=c.fx * SCALE, fy=c.fy * SCALE, cx=c.cx * SCALE, cy=c.cy * SCALE,
        width=round(c.width * SCALE), height=round(c.height * SCALE),
        bf=c.bf * SCALE, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    cfg.orb = cfg.orb._replace(n_features=DEPTH_FEATURES[name])
    return cfg


def depths():
    """Both packages' System over the two depth drives at half size."""
    from orbslam_birdview_tpu.api.system import System as JSystem
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.api.system import System

    out = {}
    for name in ("stereo", "rgbd"):
        pcfg = half_depth_config(SlamConfig, name)
        wall = smoke.STEREO_WALL if name == "stereo" else smoke.RGBD_WALL
        seq, frames, render = smoke.render_depth_drive(
            name, pcfg, N_DEPTH[name], wall)
        out[name] = dict(image=f"{pcfg.camera.width}x{pcfg.camera.height}",
                         features=pcfg.orb.n_features, **render)
        for pkg, system in (
                ("jax", JSystem(half_depth_config(JSlamConfig, name),
                                enable_loop_closing=False)),
                ("port_cpu", System(pcfg, enable_loop_closing=False,
                                    device="cpu"))):
            t0 = time.perf_counter()
            track = (system.track_stereo if name == "stereo"
                     else system.track_rgbd)
            fds = [track(img, second, i / pcfg.fps)
                   for i, (img, second, _) in enumerate(frames)]
            system._flush()
            ok = [fd.pose_ok for fd in fds]
            first = ok.index(True)
            store = system.store
            ref = seq.gt_pose(int(store.kf_frame_id[0]))
            gts = [smoke.relative_pose(seq.gt_pose(i), ref)
                   for i in range(len(frames))]
            out[name][pkg] = dict(
                init_frame=first, tracked=int(sum(ok)),
                keyframe_frames=store.kf_frame_id[:store.n_kf].tolist(),
                map_points=int(store.mp_valid.sum()),
                wall_s=time.perf_counter() - t0,
                **smoke.trajectory_errors(fds[first:], gts[first:]))
    return out


def jax_config(drive):
    """The JAX package's configuration of the drive, as `slam_config`."""
    pcfg = smoke.slam_config(drive, P, PB)
    cfg = JSlamConfig(
        camera=jcam.PinholeCamera(**drive["cam"]._asdict()),
        orb=jorb.ORBConfig(**drive["cfg"]._asdict()),
        bird_orb=jorb.ORBConfig(**drive["bcfg"]._asdict()),
        birdview=jcam.BirdviewCamera(**drive["bv"]._asdict()),
        sensor="mono_bird")
    cfg.tbc_quat, cfg.tbc_t = pcfg.tbc_quat, pcfg.tbc_t
    cfg.tracking.fused_point_cap, cfg.tracking.fused_bird_cap = P, PB
    return cfg


PARTS = ("circle", "system", "wall", "seeded", "init", "depth")


def main():
    parts = sys.argv[1:] or PARTS
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise SystemExit(f"unknown parts {sorted(unknown)}; parts: {PARTS}")
    out = {}
    drive = smoke.render_drive(N_SYSTEM, SCALE, 1000)
    drive.update(P=P, PB=PB)
    if "circle" in parts:
        out["circle"] = circles()
    if "system" in parts:
        out["system"] = systems(drive)
    if "wall" in parts:
        out["wall"] = walls()
    if "depth" in parts:
        out["depth"] = depths()
    drive = dict(drive, frames=drive["frames"][:N_FRAMES + 1])
    cpu = torch.device("cpu")
    st = smoke.seed_state(drive["seq"], drive["frames"][0][0],
                          drive["frames"][0][1], drive["mask"], drive["cfg"],
                          drive["bcfg"], P, PB, cpu)
    if "seeded" in parts:
        for bird in (True, False):
            name = "bird" if bird else "mono"
            out[name] = dict(
                jax=smoke.summarize(jax_seeded(drive, st, bird)),
                port_cpu=smoke.summarize(smoke.run_drive(
                    st, drive["frames"], drive["cam"],
                    drive["mask"] if bird else None, bird, cpu)))
    if "init" in parts:
        tracker, init_rec = smoke.init_phase(drive, cpu, floors=False)
        init_rec["tracked_from_init"], _ = smoke.tracked_from_init_phase(
            tracker, drive, cpu)
        out["init"] = dict(jax=jax_init(drive), port_cpu=init_rec)
    cam, bv = drive["cam"], drive["bv"]
    out["config"] = dict(front=f"{cam.width}x{cam.height}",
                         bev=f"{bv.width}x{bv.height}", features=[1000, 1000],
                         P=P, Pb=PB, frames=N_FRAMES,
                         seeded_landmarks=[int(st.lm.valid.sum()),
                                           int(st.bird_lm.valid.sum())])
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
