"""The slice as a whole: from frame pairs to a bundle-adjusted metric map
and the bundles the fused step tracks from, JAX package against the port,
on the CPU.

Half-size drive (front 475×200 with halved intrinsics, 1000 features on 4
levels; BEV 192×192 at twice the metres per pixel, 1000 features on 4
levels). The JAX tracker extracts every frame; its keypoints are carried
across as numpy (`state.frame_from_numpy`), so both trackers match,
initialize, build the map, bundle-adjust and refresh the bundles from the
SAME keypoints, and with the SAME hypothesis sets: each attempt's draws are
computed with `jax.random` from the key the JAX tracker is about to split.

Tolerances: the matchers are exact integer arithmetic, so matches, the
counts and every index array are equal. The ICP, the two-view fit and 20
LM iterations sum in another order: poses agree to 1e-3 (rotation entries,
metres), map points to 1 cm per coordinate (the scene is 10 m away over
a 0.36 m baseline), their scale bands to 4 cm + 0.3 %.
A second test drives the port alone from the raw images through
`Tracker.process` and holds the outcome against ground truth.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.api.config import SlamConfig as JSlamConfig
from orbslam_birdview_tpu.core import camera as jcam
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.frontend import orb as jorb
from orbslam_birdview_tpu.graph import ba as jba
from orbslam_birdview_tpu.mapping.mapstore import MapStore as JMapStore
from orbslam_birdview_tpu.pipeline import local_mapping as jlm
from orbslam_birdview_tpu.pipeline import tracking as jtr
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera, PinholeCamera
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.graph import ba
from orbslam_birdview_tpu_torch.mapping.mapstore import MapStore
from orbslam_birdview_tpu_torch.pipeline import local_mapping, state, tracking
from orbslam_birdview_tpu_torch.solvers import initializer
from orbslam_birdview_tpu_torch.utils import synth

SCALE = 0.5
CAM = PinholeCamera(fx=348.5 * SCALE, fy=347.0 * SCALE, cx=480.0 * SCALE,
                    cy=302.0 * SCALE, width=475, height=200)
BV = BirdviewCamera(pixel2meter=0.03984 * 1.7 / SCALE, width=192, height=192)
ORB = dict(n_features=1000, n_levels=4, min_threshold=5.0)
BIRD_ORB = dict(n_features=1000, n_levels=4)
N_FRAMES = 5
POSE_TOL, POINT_TOL = 1e-3, 1e-2
# the scale band is a point's distance (three coordinates' error) times a
# pyramid scale of up to 1.2³
DIST_TOL = 4 * POINT_TOL
DIST_RTOL = 3e-3    # and depth error grows with depth: the far wall is 30 m off
INT32_MAX = int(jnp.iinfo(jnp.int32).max)


def make_cfg(cfg_cls, cam, orb_cls, bv, seq, quat):
    cfg = cfg_cls(camera=cam, orb=orb_cls(**ORB), bird_orb=orb_cls(**BIRD_ORB),
                  sensor="mono_bird", birdview=bv)
    cfg.tbc_quat, cfg.tbc_t = quat, tuple(seq.t_bc.tolist())
    return cfg


def attempt_draws(rng_key, n_hyp=256):
    """The draws the JAX tracker's next attempt makes: `_next_key` splits
    the tracker key, `initialize_two_view` splits the result three ways."""
    _, k = jax.random.split(rng_key)
    kH, kF, kI = jax.random.split(k, 3)
    return initializer.InitDraws(*(
        torch.from_numpy(np.array(jax.random.randint(kk, (n_hyp, n), 0,
                                                     INT32_MAX)))
        for kk, n in ((kH, 4), (kF, 8), (kI, 2))))


def kp_numpy(kp):
    return {k: np.asarray(v) for k, v in kp._asdict().items()}


@pytest.fixture(scope="module")
def drive():
    seq = synth.BirdSequence(CAM, BV, n_frames=N_FRAMES)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    mask = synth.footprint_mask(BV)
    quat = tuple(np.asarray(jlie.rot_to_quat(jnp.asarray(seq.R_bc))).tolist())
    return seq, frames, mask, quat


@pytest.fixture(scope="module")
def both(drive):
    """Both trackers fed the same keypoints and draws until they
    initialize."""
    seq, frames, mask, quat = drive
    jcfg = make_cfg(JSlamConfig, jcam.PinholeCamera(**CAM._asdict()),
                    jorb.ORBConfig, jcam.BirdviewCamera(**BV._asdict()), seq,
                    quat)
    cfg = make_cfg(SlamConfig, CAM, ORBConfig, BV, seq, quat)
    caps = dict(kp_cap=cfg.orb.padded_capacity(),
                bird_cap=cfg.effective_bird_orb().padded_capacity())
    jstore, store = JMapStore(**caps), MapStore(**caps)
    jt = jtr.Tracker(jcfg, jstore, jlm.LocalMapper(jcfg, jstore))
    pt = tracking.Tracker(cfg, store,
                          local_mapping.LocalMapper(cfg, store, device="cpu"),
                          device="cpu")
    log = []
    for i, (img, bev, _) in enumerate(frames):
        jfd = jt.make_frame(img, float(i), bev, mask)
        pfd = state.frame_from_numpy(
            jfd.frame_id, jfd.timestamp, kp_numpy(jfd.kp),
            kp_numpy(jfd.bird_kp), jfd.bird_base_xyz, device="cpu")
        pt.frame_id += 1
        key_before = jt.rng_key
        jt._try_initialize(jfd)
        consumed = not np.array_equal(np.asarray(jt.rng_key),
                                      np.asarray(key_before))
        pt._try_initialize(pfd, draws=attempt_draws(key_before))
        for t, fd in ((jt, jfd), (pt, pfd)):
            t._record_trajectory(fd)
            t.last_frame = fd
        log.append(dict(consumed=consumed, stats=dict(pt.init_stats),
                        jstate=jt.state, pstate=pt.state))
        if jt.state == jtr.OK or pt.state == tracking.OK:
            break
    return jt, pt, log, (jfd, pfd)


def test_same_attempts_same_state(both):
    jt, pt, log, _ = both
    for row in log:
        assert row["jstate"] == row["pstate"], log
        assert row["stats"]["attempted"] == row["consumed"], log
    assert jt.state == jtr.OK and pt.state == tracking.OK
    # the drive moves 0.12 m a frame: the 0.3 m veto holds the first
    # attempts back, and the reference frame stays the first
    assert [r["stats"].get("icp_ok") for r in log] == [None, False, False, True]
    assert jt.init_ref.frame_id == pt.init_ref.frame_id == 0
    last = log[-1]["stats"]
    assert last["ok"] and last["n_matches"] >= 100
    assert last["n_bird_matches"] >= 50 and last["n_icp_inliers"] >= 50
    assert jt.ref_kf == pt.ref_kf == 1
    assert jt.last_kf_frame_id == pt.last_kf_frame_id


def test_store_arrays_agree(both, drive):
    jt, pt, _, _ = both
    js, ps = jt.store, pt.store
    assert (js.n_kf, js.n_mp, js.n_bmp) == (ps.n_kf, ps.n_mp, ps.n_bmp)
    assert ps.n_kf == 2 and ps.n_mp >= 150 and ps.n_bmp >= 100
    close = dict(kf_R=POSE_TOL, kf_t=POSE_TOL, mp_pos=POINT_TOL,
                 bmp_pos=POINT_TOL, mp_normal=1e-3, mp_min_dist=DIST_TOL,
                 mp_max_dist=DIST_TOL)
    for name, v in vars(js).items():
        if not isinstance(v, np.ndarray):
            continue
        got = getattr(ps, name)
        assert got.shape == v.shape and got.dtype == v.dtype, name
        if name in close:
            np.testing.assert_allclose(got, v, atol=close[name],
                                       rtol=DIST_RTOL if "dist" in name else 0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, v, err_msg=name)
    # metric: the baseline is the ground truth's to 2 %, with no alignment
    seq = drive[0]
    R0, t0 = seq.gt_cam_pose(int(ps.kf_frame_id[0]))
    R1, t1 = seq.gt_cam_pose(int(ps.kf_frame_id[1]))
    t21 = t1 - (R1 @ R0.T) @ t0
    base = np.linalg.norm(ps.kf_t[1])
    assert base == pytest.approx(np.linalg.norm(t21), rel=0.02)
    assert np.dot(ps.kf_t[1], t21) / (base * np.linalg.norm(t21)) > 0.999


def test_frames_and_trajectories_agree(both):
    jt, pt, _, (jfd, pfd) = both
    assert pfd.pose_ok and jfd.pose_ok
    np.testing.assert_allclose(pfd.R, jfd.R, atol=POSE_TOL)
    np.testing.assert_allclose(pfd.t, jfd.t, atol=POSE_TOL)
    np.testing.assert_array_equal(pfd.kp_mp, jfd.kp_mp)
    np.testing.assert_array_equal(pfd.bird_mp, jfd.bird_mp)
    assert len(pt.trajectory) == len(jt.trajectory) == 1
    a, b = pt.trajectory[0], jt.trajectory[0]
    assert (a.ref_kf, a.lost, a.frame_id) == (b.ref_kf, b.lost, b.frame_id)
    np.testing.assert_allclose(a.T_rel, b.T_rel, atol=POSE_TOL)


def test_refreshed_bundles_agree(both):
    jt, pt, _, _ = both
    jt._refresh_local_map()
    pt._refresh_local_map()
    assert pt._lm_n == jt._lm_n == pt.store.n_mp
    assert pt._bird_n == jt._bird_n == pt.store.n_bmp
    np.testing.assert_array_equal(pt._lm_ids, jt._lm_ids)
    np.testing.assert_array_equal(pt._bird_ids, jt._bird_ids)
    cap = pt.cfg.tracking.fused_point_cap
    assert pt._lm_bundle.capacity == cap == jt._lm_bundle.pos.shape[0]
    tol = dict(pos=POINT_TOL, normal=1e-3, min_dist=DIST_TOL,
               max_dist=DIST_TOL)
    for name in pt._lm_bundle._fields:
        a = getattr(pt._lm_bundle, name).numpy()
        b = np.asarray(getattr(jt._lm_bundle, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, atol=tol.get(name, 0),
                                   rtol=DIST_RTOL if "dist" in name else 0,
                                   err_msg=name)
    for name in pt._bird_bundle._fields:
        a = getattr(pt._bird_bundle, name).numpy()
        b = np.asarray(getattr(jt._bird_bundle, name))
        np.testing.assert_allclose(a, b, atol=POINT_TOL if name == "pos" else 0,
                                   err_msg=name)
    assert pt._acc[0].shape == (cap,) and int(pt._acc[0].sum()) == 0
    # a second refresh retires the first epoch's counters; they land in the
    # statistics at their tick
    pt._acc = (pt._acc[0] + 1, pt._acc[1] + 2)
    pt._refresh_local_map()
    assert len(pt._acc_pending) == 1
    ids = pt._lm_ids[:pt._lm_n]
    before = pt.store.mp_visible[ids].copy()
    pt._apply_landed_acc(block=True)
    assert not pt._acc_pending
    np.testing.assert_array_equal(pt.store.mp_visible[ids], before + 1)


def test_gathered_ba_problem_agrees_and_carries_across(both):
    jt, pt, _, _ = both
    window, none = np.array([0, 1], np.int64), np.zeros(0, np.int64)
    jp = jt.mapper._gather_ba_problem(window, none)
    pp = pt.mapper._gather_ba_problem(window, none)

    def flat(problem):
        out = []
        for x in problem:
            out += list(x) if isinstance(x, (ba.EdgeSet, jba.EdgeSet)) else [x]
        return [np.asarray(x) for x in out]

    for a, b in zip(flat(pp), flat(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=POINT_TOL)
        else:
            np.testing.assert_array_equal(a, b)
    # the stereo set is present, padded and all-invalid, also in bird mode
    assert pp[8].valid.shape[0] >= 1024 and not bool(pp[8].valid.any())
    assert int(pp[9].valid.sum()) == 2 * pt.store.n_bmp

    # the reference's problem carried across, through both BAs
    carried = state.ba_problem(
        tuple(tuple(np.asarray(f) for f in x) if isinstance(x, jba.EdgeSet)
              else (np.asarray(x) if hasattr(x, "shape") else x) for x in jp),
        device="cpu")
    cam = pt.cfg.camera
    fixed = np.array([True, False])
    jres = jba.bundle_adjust(jp[1], jp[2], jnp.asarray(fixed), *jp[4:10],
                             cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf,
                             iters_phase1=10, iters_phase2=10)
    tres = ba.bundle_adjust(carried[1], carried[2], fixed, *carried[4:10],
                            cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf,
                            iters_phase1=10, iters_phase2=10, device="cpu")
    assert float(tres.cost) == pytest.approx(float(jres.cost), rel=1e-3)
    np.testing.assert_allclose(tres.cam_t.numpy(), np.asarray(jres.cam_t),
                               atol=1e-4)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points),
                               atol=1e-3)
    for a, b in ((tres.inl_mono, jres.inl_mono), (tres.inl_bird, jres.inl_bird)):
        assert int((a.numpy() != np.asarray(b)).sum()) <= 3
    # re-optimizing an optimized map moves it little and does not raise the
    # cost of its start
    start = ba._cost_only(*(carried[i] for i in (1, 2, 5)),
                          [("mono", ba._edges_on(carried[7], "cpu")),
                           ("bird", ba._edges_on(carried[9], "cpu"))],
                          (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf), True)
    assert float(tres.cost) <= float(start) * (1 + 1e-5)


def test_port_from_raw_images_through_process(drive):
    """`Tracker.process` on the rendered frames, the port alone: it
    initializes on the fourth frame with a metric baseline; a depth image
    gives the keypoints depth, and an RGB-D tracker initializes on its
    first frame with depth."""
    seq, frames, mask, quat = drive
    cfg = make_cfg(SlamConfig, CAM, ORBConfig, BV, seq, quat)
    store = MapStore(kp_cap=cfg.orb.padded_capacity(),
                     bird_cap=cfg.effective_bird_orb().padded_capacity())
    mapper = local_mapping.LocalMapper(cfg, store, device="cpu")
    tr = tracking.Tracker(cfg, store, mapper, device="cpu")
    probe = tracking.Tracker(cfg, MapStore(kp_cap=store.kp_cap,
                                           bird_cap=store.bird_cap),
                             device="cpu")
    fd = probe.make_frame(frames[0][0], 0.0,
                          depth_img=np.full((200, 475), 2.0, np.float32))
    valid = probe._kp_host(fd).valid
    np.testing.assert_array_equal(fd.kp_depth, np.where(valid, 2.0, -1.0))
    np.testing.assert_allclose(
        fd.kp_ur, np.where(valid, fd.kp_host.xy[:, 0] - CAM.bf / 2.0, -1.0))
    states = []
    for i, (img, bev, _) in enumerate(frames):
        fd = tr.process(img, float(i), bev, mask)
        states.append(tr.state)
        if tr.state == tracking.OK:
            break
    assert states == [0, 0, 0, 1]
    assert fd.pose_ok and fd.frame_id == 3 and tr.ref_kf == 1
    assert mapper._frame_tick == 4 and len(tr.trajectory) == 1
    s = tr.init_stats
    assert s["ok"] and s["icp_ok"] and s["n_matches"] >= 200
    assert store.n_kf == 2 and store.n_mp >= 150 and store.n_bmp >= 100
    R0, t0 = seq.gt_cam_pose(0)
    R3, t3 = seq.gt_cam_pose(3)
    R21, t21 = R3 @ R0.T, t3 - (R3 @ R0.T) @ t0
    assert np.linalg.norm(fd.t) == pytest.approx(np.linalg.norm(t21), rel=0.02)
    np.testing.assert_allclose(fd.R, R21, atol=5e-3)
    np.testing.assert_allclose(fd.t, t21, atol=0.02)
    # the map points reproject onto their keypoints in both keyframes
    for kf in (0, 1):
        obs = store.kf_kp_mp[kf]
        k = np.nonzero(obs >= 0)[0]
        Xc = store.mp_pos[obs[k]] @ store.kf_R[kf].T + store.kf_t[kf]
        uv = np.stack([CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx,
                       CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy], 1)
        err = np.linalg.norm(uv - store.kf_kp_xy[kf, k], axis=1)
        assert np.median(err) < 1.0 and (Xc[:, 2] > 0).all()
    for name in ("init.match", "init.two_view", "init.map", "init.ba"):
        assert tr.timer.samples[name], name
    # the next frame is tracked from the map (the slow path: the velocity
    # is not known yet); the full-map BA runs on it
    fd = tr.process(frames[4][0], 4.0, frames[4][1], mask)
    assert tr.state == tracking.OK and fd.pose_ok and tr.velocity is not None
    R4, t4 = seq.gt_cam_pose(4)
    R40, t40 = R4 @ R0.T, t4 - (R4 @ R0.T) @ t0
    np.testing.assert_allclose(fd.t, t40, atol=0.02)
    assert not hasattr(local_mapping, "_UNPORTED")
    n_kf = int(store.kf_valid.sum())
    pose0 = store.kf_R[0].copy(), store.kf_t[0].copy()
    mapper.global_ba(iters=(2, 2))       # dispatched and landed at once
    assert mapper.stats["gba_landed"] == 1 and mapper._gba_pending is None
    assert mapper.last_gba["n_kf"] == n_kf
    assert mapper.last_gba["solver"] == "dense-W"
    np.testing.assert_array_equal(store.kf_R[0], pose0[0])   # kf 0 fixed
    np.testing.assert_array_equal(store.kf_t[0], pose0[1])
    np.testing.assert_allclose(store.kf_t[1], t21, atol=0.02)
    cfg.sensor = "rgbd"
    fresh = tracking.Tracker(cfg, MapStore(kp_cap=store.kp_cap,
                                           bird_cap=store.bird_cap),
                             device="cpu")
    fresh.process(frames[0][0], 0.0)            # no depth: no map
    assert fresh.state == tracking.NOT_INITIALIZED and fresh.store.n_kf == 0
    fd = fresh.process(frames[1][0], 1.0,
                       depth_img=np.full((200, 475), 2.0, np.float32))
    assert fresh.state == tracking.OK and fd.pose_ok
    assert fresh.store.n_kf == 1 and fresh.ref_kf == 0
    assert fresh.store.n_mp == int((fd.kp_depth > 0).sum()) >= 500


def test_tracker_needs_a_device_or_cpu(drive):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")
    seq, _, _, quat = drive
    cfg = make_cfg(SlamConfig, CAM, ORBConfig, BV, seq, quat)
    store = MapStore()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tracking.Tracker(cfg, store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        local_mapping.LocalMapper(cfg, store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state.frame_from_numpy(0, 0.0, {})
