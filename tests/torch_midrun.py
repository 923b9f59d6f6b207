"""Shared set-up of the port's mid-run parity tests: the half-size bird
drive of `test_torch_init_map.py` and a small RGB-D / stereo wall drive in
both packages' configurations, a port `System` run on the CPU to a chosen
moment, and the port's store carried into the JAX package's `MapStore`
(the other direction of `state.map_store`), so that both packages compute
on the same map. The stores' per-keypoint depth and right-image u
(`kf_kp_depth`, `kf_kp_ur`) travel with the other arrays.
"""
import copy

import jax.numpy as jnp
import numpy as np
import torch

from orbslam_birdview_tpu.api.config import SlamConfig as JSlamConfig
from orbslam_birdview_tpu.api.system import System as JSystem
from orbslam_birdview_tpu.core import camera as jcam
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.frontend import orb as jorb
from orbslam_birdview_tpu.mapping.mapstore import MapStore as JMapStore
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera, PinholeCamera
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.pipeline import state
from orbslam_birdview_tpu_torch.utils import synth

SCALE = 0.5
CAM = PinholeCamera(fx=348.5 * SCALE, fy=347.0 * SCALE, cx=480.0 * SCALE,
                    cy=302.0 * SCALE, width=475, height=200)
BV = BirdviewCamera(pixel2meter=0.03984 * 1.7 / SCALE, width=192, height=192)
ORB = dict(n_features=1000, n_levels=4, min_threshold=5.0)
BIRD_ORB = dict(n_features=1000, n_levels=4)
# a smaller local-BA window than the default 32 + 16 keeps the CPU tests
# quick; both packages get the same value
BA_WINDOW, BA_FIXED = 8, 4


def one_torch_thread():
    """Generator for a module-scoped fixture: torch computes on one thread
    while the module runs. These tests run many small eager ops, which the
    intra-op pool only slows down when several test processes share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make_cfgs(seq):
    """(JAX config, port config) of the drive, field for field equal."""
    quat = tuple(np.asarray(jlie.rot_to_quat(jnp.asarray(seq.R_bc))).tolist())
    out = []
    for cfg_cls, cam, orb_cls, bv in (
            (JSlamConfig, jcam.PinholeCamera(**CAM._asdict()), jorb.ORBConfig,
             jcam.BirdviewCamera(**BV._asdict())),
            (SlamConfig, CAM, ORBConfig, BV)):
        cfg = cfg_cls(camera=cam, orb=orb_cls(**ORB),
                      bird_orb=orb_cls(**BIRD_ORB), sensor="mono_bird",
                      birdview=bv)
        cfg.tbc_quat, cfg.tbc_t = quat, tuple(seq.t_bc.tolist())
        cfg.mapping.local_ba_window = BA_WINDOW
        cfg.mapping.local_ba_fixed = BA_FIXED
        out.append(cfg)
    return tuple(out)


def drive(n_frames):
    seq = synth.BirdSequence(CAM, BV, n_frames=n_frames)
    frames = [seq.frame(i) for i in range(n_frames)]
    return seq, frames, synth.footprint_mask(BV)


# the depth drive: the e2e depth tests' camera at half size (8 cm baseline)
DEPTH_CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320,
                 height=240)
DEPTH_BASELINE = 0.08


def make_depth_cfgs(sensor, n_features, max_frames_between_kf=3):
    """(JAX config, port config) of the depth drive, field for field equal:
    bf = fx·DEPTH_BASELINE, ThDepth·b = 40 m, the small local-BA window, and
    a keyframe at least every `max_frames_between_kf` frames."""
    bf = DEPTH_CAM["fx"] * DEPTH_BASELINE
    out = []
    for cfg_cls, cam, orb_cls in (
            (JSlamConfig, jcam.PinholeCamera(**DEPTH_CAM, bf=bf),
             jorb.ORBConfig),
            (SlamConfig, PinholeCamera(**DEPTH_CAM, bf=bf), ORBConfig)):
        cfg = cfg_cls(camera=cam, orb=orb_cls(n_features=n_features),
                      sensor=sensor, depth_threshold=40.0)
        cfg.mapping.local_ba_window = BA_WINDOW
        cfg.mapping.local_ba_fixed = BA_FIXED
        cfg.tracking.max_frames_between_kf = max_frames_between_kf
        out.append(cfg)
    return tuple(out)


def depth_drive(sensor, n_frames, step=0.03):
    """The wall seen by the depth camera: (seq, frames) with frames
    [(left image, depth map or right image, (R_cw, t_cw))]."""
    bf = DEPTH_CAM["fx"] * DEPTH_BASELINE
    seq = synth.WallSequence(PinholeCamera(**DEPTH_CAM, bf=bf),
                             n_frames=n_frames, step=step)
    frames = []
    for i in range(n_frames):
        img, gt = seq.frame(i)
        if sensor == "rgbd":
            second = seq.depth(i)
        else:
            second = synth.render_wall_view(
                seq.cam, seq.tex, gt[0].astype(np.float64),
                gt[1].astype(np.float64)
                - np.array([DEPTH_BASELINE, 0.0, 0.0]), seq.wall_z)
        frames.append((img, second, gt))
    return seq, frames


def track_depth(system, img, second, timestamp):
    """One frame of the depth drive through a System of either package."""
    if system.cfg.sensor == "rgbd":
        return system.track_rgbd(img, second, timestamp)
    return system.track_stereo(img, second, timestamp)


def run_port(cfg, frames, mask, stop, loop_closing=False):
    """A port System fed the frames on the CPU until `stop(system)` holds
    after a frame; returns (system, index of the last frame fed)."""
    system = System(cfg, enable_loop_closing=loop_closing, device="cpu")
    for i, (img, second, _) in enumerate(frames):
        if cfg.sensor == "mono_bird":
            system.track_monocular_with_birdview(img, second, mask, i / 25.0)
        else:
            track_depth(system, img, second, i / 30.0)
        if stop(system):
            return system, i
    raise AssertionError("the drive ended before the moment was reached")


def copy_store(store):
    """An independent copy of a port store."""
    return state.map_store(copy.deepcopy(vars(store)))


def jax_store(store):
    """The JAX package's `MapStore` holding a copy of a port store's
    arrays, counters and loop edges."""
    js = JMapStore(**{k: int(getattr(store, k)) for k in
                      ("max_kf", "max_mp", "max_bmp", "kp_cap", "bird_cap")})
    for k, v in vars(store).items():
        if isinstance(v, np.ndarray):
            setattr(js, k, v.copy())
        elif k in type(store)._SCALARS:
            setattr(js, k, int(v))
    js.loop_edges = list(store.loop_edges)
    return js


def assert_stores_agree(ps, js, pos_tol=1e-3, exact=True):
    """Every array of the two stores: equal, or for positions, poses, and
    keypoint depths and right-image u within pos_tol (metres, rotation
    entries, pixels)."""
    close = ("kf_R", "kf_t", "mp_pos", "bmp_pos", "mp_normal", "mp_min_dist",
             "mp_max_dist", "kf_kp_depth", "kf_kp_ur")
    assert (ps.n_kf, ps.n_mp, ps.n_bmp) == (js.n_kf, js.n_mp, js.n_bmp)
    for name, v in vars(js).items():
        if not isinstance(v, np.ndarray):
            continue
        got = getattr(ps, name)
        assert got.shape == v.shape, name
        if name in close:
            tol = pos_tol * (10 if "dist" in name else 1)
            np.testing.assert_allclose(got, v, atol=tol, rtol=3e-3,
                                       err_msg=name)
        elif exact:
            np.testing.assert_array_equal(got, v, err_msg=name)


RUN_TOL = 2e-3   # centres (m) and rotation entries over a whole run


def system_runs(sensor, n_features, n_frames):
    """Both packages' System (loop closing off) fed the same raw frames of
    the depth drive; per frame (pose_ok, state, centre, R, map points)."""
    seq, frames = depth_drive(sensor, n_frames)
    jcfg, cfg = make_depth_cfgs(sensor, n_features)
    out = {}
    for name, system in (("jax", JSystem(jcfg, enable_loop_closing=False)),
                         ("port", System(cfg, enable_loop_closing=False,
                                         device="cpu"))):
        rows = []
        for i, (img, second, _) in enumerate(frames):
            fd = track_depth(system, img, second, i / 30.0)
            rows.append((fd.pose_ok, system.tracker.state, -fd.R.T @ fd.t,
                         np.array(fd.R), system.n_map_points()))
        system._flush()
        out[name] = (system, rows)
    return frames, out


def check_depth_runs(frames, out, min_keyframes):
    """Per frame the same pose_ok and state, tracked from frame 0 on (the
    depth initialization); the same keyframe frames and map-point counts;
    centres and rotation entries within RUN_TOL; both metric ATEs (no
    scale) under the e2e bar of 0.03 m; the port's local BAs carried stereo
    edges and its fused step ran."""
    (js, jrows), (ps, prows) = out["jax"], out["port"]
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    assert all(r[0] for r in prows)
    jkf = js.store.kf_frame_id[:js.store.n_kf].tolist()
    pkf = ps.store.kf_frame_id[:ps.store.n_kf].tolist()
    assert pkf == jkf and pkf[0] == 0 and len(pkf) >= min_keyframes
    assert [r[4] for r in prows] == [r[4] for r in jrows]
    for (_, _, jc, jR, _), (_, _, pc, pR, _) in zip(jrows, prows):
        assert np.abs(pc - jc).max() < RUN_TOL
        assert np.abs(pR - jR).max() < RUN_TOL
    gt = np.array([-R.T @ t for _, _, (R, t) in frames])
    for rows in (jrows, prows):
        est = np.array([r[2] for r in rows])
        assert synth.ate_rmse(est, gt, with_scale=False) < 0.03
    assert ps.mapper.stats["ba_landed"] >= 1
    assert ps.mapper.stats["ba_stereo_edges"] > 0
    assert ps.tracker.timer.counters.get("track.fused", 0) > 0
