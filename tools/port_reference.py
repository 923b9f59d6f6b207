"""Run the JAX package and the PyTorch port on the same rendered drive, on
the CPU, and print what each did.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tools/port_reference.py

The drive is chip_smoke.py's (BirdSequence, speed 0.12 m and yaw 0.004 rad
per frame, 30 frames after the first), cut to half size so that it runs on
a small CPU: front 475×200 with the fisheye rig's intrinsics halved and
1000 features on 8 levels; BEV 192×192 at twice the metres per pixel (the
same ground coverage) with 1000 features on 4 levels; P=3072, Pb=1024.

Two parts, each for both packages:
- seeded: the fused step over the drive from bundles seeded from frame 0's
  ground truth, with and without the bird stream;
- init: `Tracker.process` until the tracker has initialized (two-view
  initialization with the BEV ICP's metric scale, the initial map, its
  BA), then the fused step over the rest of the drive from the bundles
  `_refresh_local_map` builds, against ground truth in the reference
  keyframe's frame with no scale alignment.

Prints one JSON object with both packages' summaries.
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
    pcfg = smoke.slam_config(drive, P, PB)
    cfg = JSlamConfig(
        camera=jcam.PinholeCamera(**cam._asdict()),
        orb=jorb.ORBConfig(**drive["cfg"]._asdict()),
        bird_orb=jorb.ORBConfig(**drive["bcfg"]._asdict()),
        birdview=jcam.BirdviewCamera(**drive["bv"]._asdict()),
        sensor="mono_bird")
    cfg.tbc_quat, cfg.tbc_t = pcfg.tbc_quat, pcfg.tbc_t
    cfg.tracking.fused_point_cap, cfg.tracking.fused_bird_cap = P, PB
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


def main():
    drive = smoke.render_drive(N_FRAMES + 1, SCALE, 1000)
    drive.update(P=P, PB=PB)
    cpu = torch.device("cpu")
    st = smoke.seed_state(drive["seq"], drive["frames"][0][0],
                          drive["frames"][0][1], drive["mask"], drive["cfg"],
                          drive["bcfg"], P, PB, cpu)
    out = {}
    for bird in (True, False):
        name = "bird" if bird else "mono"
        out[name] = dict(
            jax=smoke.summarize(jax_seeded(drive, st, bird)),
            port_cpu=smoke.summarize(smoke.run_drive(
                st, drive["frames"], drive["cam"],
                drive["mask"] if bird else None, bird, cpu)))
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
