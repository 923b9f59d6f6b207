"""Run the JAX package and the PyTorch port on the same rendered drive, on
the CPU, and print what each tracked: inliers and pose error per frame.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tools/port_reference.py

The drive is chip_smoke.py's (BirdSequence, speed 0.12 m and yaw 0.004 rad
per frame, 30 frames after the seed frame, bundles seeded from frame 0's
ground truth), cut to half size so that it runs on a small CPU: front
475×200 with the fisheye rig's intrinsics halved and 1000 features on 8
levels; BEV 192×192 at twice the metres per pixel (the same ground
coverage) with 1000 features on 4 levels; P=3072, Pb=1024. Prints one JSON
object with both packages' summaries.
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
from orbslam_birdview_tpu.core import camera as jcam  # noqa: E402
from orbslam_birdview_tpu.frontend import orb as jorb  # noqa: E402
from orbslam_birdview_tpu.pipeline import fused_track as jft  # noqa: E402
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera  # noqa: E402
from orbslam_birdview_tpu_torch.utils import synth  # noqa: E402

N_FRAMES = 30
SCALE = 0.5
P, PB = 3072, 1024


def jax_drive(seq, frames, cam, mask, st, bird):
    """The reference's step chained over frames[1:] as chip_smoke chains
    the port's."""
    jbv = jcam.BirdviewCamera(**st.bv._asdict())
    lm = jft.LocalMapDevice(*(jnp.asarray(f.numpy()) for f in st.lm))
    blm = jft.BirdMapDevice(*(jnp.asarray(f.numpy()) for f in st.bird_lm))
    cfg = jorb.ORBConfig(**st.cfg._asdict())
    bcfg = jorb.ORBConfig(**st.bird_cfg._asdict())
    sf, isig = jnp.asarray(st.scale_factors.numpy()), jnp.asarray(
        st.inv_sigma2.numpy())
    R0, t0 = (jnp.asarray(a) for a in frames[0][2])
    R_pred, t_pred, R_last, t_last = R0, t0, R0, t0
    vis = found = None
    rows = []
    for img, bev, (R_gt, t_gt) in frames[1:]:
        kw = {}
        if bird:
            kw = dict(bird_img=jnp.asarray(bev), bird_mask=jnp.asarray(mask),
                      bird_lm=blm, bird_cfg=bcfg, bv=jbv,
                      R_bc=jnp.asarray(seq.R_bc), t_bc=jnp.asarray(seq.t_bc))
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


def main():
    cam = smoke.front_camera(SCALE)
    bv = BirdviewCamera(pixel2meter=0.03984 * 1.7 / SCALE,
                        width=round(384 * SCALE), height=round(384 * SCALE))
    cfg, bcfg = smoke.configs(1000, 1000)
    seq = synth.BirdSequence(cam, bv, n_frames=N_FRAMES + 1)
    frames = [seq.frame(i) for i in range(N_FRAMES + 1)]
    mask = synth.footprint_mask(bv)
    cpu = torch.device("cpu")
    st = smoke.seed_state(seq, frames[0][0], frames[0][1], mask, cfg, bcfg,
                          P, PB, cpu)
    out = {}
    for bird in (True, False):
        name = "bird" if bird else "mono"
        out[name] = dict(
            jax=smoke.summarize(jax_drive(seq, frames, cam, mask, st, bird)),
            port_cpu=smoke.summarize(smoke.run_drive(st, frames, cam, mask,
                                                     bird, cpu)))
    out["config"] = dict(front=f"{cam.width}x{cam.height}",
                         bev=f"{bv.width}x{bv.height}", features=[1000, 1000],
                         P=P, Pb=PB, frames=N_FRAMES,
                         seeded_landmarks=[int(st.lm.valid.sum()),
                                           int(st.bird_lm.valid.sum())])
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
