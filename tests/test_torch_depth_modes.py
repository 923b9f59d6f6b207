"""The tracker's and the mapper's depth branches, the JAX package against
the port, on the CPU, on a small RGB-D drive (`torch_midrun.depth_drive`:
a textured wall 4 m away, 320×240, 500 features, a keyframe at least every
3 frames).

The state: the port's `System` fed the drive until its third keyframe has
just been minted with its triangulation dispatched; the store is copied
into both packages at that moment (for the mapping tests), then the
System is flushed and its tracker carried across (for the tracking
tests). Then both packages run: the depth sampling of `make_frame`,
`_initialize_with_depth`, `_seed_depth_points` and keyframe creation, the
local BA's stereo edges and the BA on them, and the full-map BA; the
loop closer's two Sim3 solvers with the scale fixed, as the depth modes
call them; and the whole `System.track_rgbd` over 15 frames, with its
trajectory savers.

Tolerances, and why:
- depth sampling and unprojection are the same numpy code on the same f32
  inputs: equal, map points within 1e-5 m;
- the matchers are exact integer arithmetic, so associations and edge sets
  are equal;
- the fixed-scale Sim3 solvers: as test_torch_sim3.py, the same inliers
  and R, t within 1e-4, and s exactly 1;
- the BA on one gathered problem: poses within 1e-4, as test_torch_ba.py
  (the scatter sums and the Schur product sum in another order); after a
  mapper's writeback or a whole run, within 1e-3 / 2e-3 as
  test_torch_local_mapping.py and test_torch_system_mono.py.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid
from test_torch_loop_closing import share_draws
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.frontend.keypoints import Keypoints as JKeypoints
from orbslam_birdview_tpu.graph import ba as jba
from orbslam_birdview_tpu.graph import sim3_opt as jsim3_opt
from orbslam_birdview_tpu.mapping.mapstore import MapStore as JMapStore
from orbslam_birdview_tpu.pipeline import local_mapping as jlm
from orbslam_birdview_tpu.pipeline import loop_closing as jlc
from orbslam_birdview_tpu.pipeline import tracking as jtr
from orbslam_birdview_tpu.pipeline.frame import FrameData as JFrameData
from orbslam_birdview_tpu.solvers import sim3 as jsim3
from orbslam_birdview_tpu_torch.frontend import keypoints as pkeypoints
from orbslam_birdview_tpu_torch.graph import ba, sim3_opt
from orbslam_birdview_tpu_torch.mapping.mapstore import MapStore
from orbslam_birdview_tpu_torch.parallel import runtime
from orbslam_birdview_tpu_torch.pipeline import local_mapping as lm
from orbslam_birdview_tpu_torch.pipeline import loop_closing as lc
from orbslam_birdview_tpu_torch.pipeline import state, tracking
from orbslam_birdview_tpu_torch.solvers import sim3

N_FEATURES = 500
POINT_TOL = 1e-5
BA_POSE_TOL, MAP_POSE_TOL = 1e-4, 1e-3
# the full-map BA on 8 shards against the JAX package's sharded one:
# poses within 2e-4, points within 5e-5 m at the median and 1e-2 m at
# worst (measured 9.2e-5, 9.0e-6 and 7.7e-3 on the CPU; the one-device
# solve reads 1.3e-4, 1.2e-5 and 1.1e-2 against the same reference)
SHARDED_POSE_TOL, SHARDED_PT_MEDIAN_TOL, SHARDED_PT_MAX_TOL = 2e-4, 5e-5, 1e-2
N_SYSTEM_FRAMES = 15


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


def kp_numpy(kp):
    return pkeypoints.to_host(kp)._asdict()


def frame_record(fd):
    """A port frame as numpy (see `jax_frame`, `port_frame`)."""
    return dict(frame_id=fd.frame_id, timestamp=fd.timestamp,
                kp=kp_numpy(fd.kp), kp_mp=fd.kp_mp.copy(), R=fd.R.copy(),
                t=fd.t.copy(), pose_ok=fd.pose_ok,
                kp_depth=np.array(fd.kp_depth), kp_ur=np.array(fd.kp_ur))


def jax_frame(f):
    fd = JFrameData(frame_id=f["frame_id"], timestamp=f["timestamp"],
                    kp=JKeypoints(*(jnp.asarray(f["kp"][k])
                                    for k in JKeypoints._fields)),
                    R=np.array(f["R"], np.float32),
                    t=np.array(f["t"], np.float32),
                    kp_mp=np.array(f["kp_mp"], np.int64))
    fd.kp_depth = f["kp_depth"].copy()
    fd.kp_ur = f["kp_ur"].copy()
    fd.pose_ok = f["pose_ok"]
    return fd


def port_frame(f):
    return state.frame_from_numpy(
        f["frame_id"], f["timestamp"], f["kp"], device="cpu",
        kp_mp=f["kp_mp"], R=f["R"], t=f["t"], pose_ok=f["pose_ok"],
        kp_depth=f["kp_depth"], kp_ur=f["kp_ur"])


@pytest.fixture(scope="module")
def moment():
    seq, frames = mid.depth_drive("rgbd", 24)
    jcfg, cfg = mid.make_depth_cfgs("rgbd", N_FEATURES)

    def fresh_triangulation(system):
        st = system.mapper._kf_stage
        return (system.store.n_kf >= 3 and st is not None
                and st[0] == "triangulate" and st[2] is not None)

    system, i = mid.run_port(cfg, frames, None, fresh_triangulation)
    out = dict(seq=seq, frames=frames, jcfg=jcfg, cfg=cfg,
               map_store=mid.copy_store(system.store),
               kf=system.mapper._kf_stage[1],
               recent=list(system.mapper.recent_mp))
    system._flush()
    tr = system.tracker
    last = tr.last_frame
    tr.resolve_associations(last)
    tr._land_depth(last)
    img, depth, _ = frames[i + 1]
    nxt = tr.make_frame(img, (i + 1) / 30.0, depth_img=depth)
    nxt_rec = frame_record(nxt)
    nxt_rec["kp_mp"][:] = -1
    out.update(store=mid.copy_store(system.store),
               mapper=copy.deepcopy(system.mapper),
               fields=state.tracker_fields(tr),
               trajectory=list(tr.trajectory), last=frame_record(last),
               next=nxt_rec)
    return out


def trackers(m, with_mapper=True):
    """A JAX and a port Tracker in the carried-across state, each on its
    own copy of the map, and the next frame for each."""
    js, ps = mid.jax_store(m["store"]), mid.copy_store(m["store"])
    jt = jtr.Tracker(m["jcfg"], js,
                     jlm.LocalMapper(m["jcfg"], js) if with_mapper else None)
    pt = tracking.Tracker(m["cfg"], ps,
                          lm.LocalMapper(m["cfg"], ps, device="cpu")
                          if with_mapper else None, device="cpu")
    state.set_tracker_state(pt, m["fields"], port_frame(m["last"]),
                            m["trajectory"])
    for k, v in m["fields"].items():
        setattr(jt, k, None if v is None else (
            np.array(v, np.float32) if k == "velocity" else int(v)))
    jt.last_frame = jax_frame(m["last"])
    jt.trajectory = [jtr.TrajectoryEntry(e.timestamp, e.ref_kf, e.T_rel.copy(),
                                         e.lost, e.frame_id)
                     for e in m["trajectory"]]
    if with_mapper:
        for mapper in (jt.mapper, pt.mapper):
            state.set_mapper_state(mapper, m["mapper"])
    return jt, pt, jax_frame(m["next"]), port_frame(m["next"])


def fresh_trackers(m):
    jt = jtr.Tracker(m["jcfg"], JMapStore(kp_cap=m["store"].kp_cap))
    pt = tracking.Tracker(m["cfg"], MapStore(kp_cap=m["store"].kp_cap),
                          device="cpu")
    return jt, pt


def test_make_frame_samples_depth(moment):
    """Each package extracts its own keypoints (the extractors round a few
    pixels apart) and samples the depth image at the truncated keypoint:
    equal wherever the keypoints are."""
    jt, pt = fresh_trackers(moment)
    img, depth, _ = moment["frames"][0]
    jfd = jt.make_frame(img, 0.0, depth_img=depth)
    pfd = pt.make_frame(img, 0.0, depth_img=depth)
    same = np.all(pfd.kp_host.xy == np.asarray(jfd.kp.xy), axis=1)
    assert same.mean() >= 0.98
    np.testing.assert_array_equal(pfd.kp_depth[same], jfd.kp_depth[same])
    np.testing.assert_array_equal(pfd.kp_ur[same], jfd.kp_ur[same])
    assert pfd.kp_depth.dtype == pfd.kp_ur.dtype == np.float32
    valid = pfd.kp_host.valid
    assert (pfd.kp_depth[valid] > 3.9).all() and (pfd.kp_depth[~valid] == -1).all()


def test_initialize_with_depth(moment):
    """The first frame with >= 500 depth-valid keypoints: a keyframe at the
    identity and a map point per depth-valid keypoint, in both packages
    from the same frame."""
    jt, pt = fresh_trackers(moment)
    img, depth, _ = moment["frames"][0]
    f = frame_record(pt.make_frame(img, 0.0, depth_img=depth))
    jfd, pfd = jax_frame(f), port_frame(f)
    jt._try_initialize(jfd)
    pt._try_initialize(pfd)
    assert pt.state == jt.state == tracking.OK
    assert pt.ref_kf == jt.ref_kf == 0 and pfd.pose_ok and jfd.pose_ok
    ps, js = pt.store, jt.store
    assert ps.n_mp == js.n_mp == int((f["kp_depth"] > 0).sum()) >= 500
    np.testing.assert_array_equal(pfd.kp_mp, jfd.kp_mp)
    np.testing.assert_allclose(ps.mp_pos, js.mp_pos, atol=POINT_TOL, rtol=0)
    mid.assert_stores_agree(ps, js, pos_tol=POINT_TOL)
    np.testing.assert_array_equal(ps.kf_kp_depth[0], f["kp_depth"])


def test_seed_depth_points(moment):
    """A keyframe from the next frame with the same pose and associations
    in both packages: the same close, landmark-free keypoints become map
    points at the same places (no mapper, so nothing else moves)."""
    _, pt0, _, tracked = trackers(moment, with_mapper=False)
    assert pt0._track_motion_model(tracked) and pt0._track_local_map(tracked)
    jt, pt, jfd, pfd = trackers(moment, with_mapper=False)
    for fd in (jfd, pfd):
        fd.kp_mp = tracked.kp_mp.copy()
        fd.R, fd.t = tracked.R.copy(), tracked.t.copy()
    n_mp = pt.store.n_mp
    for t_, fd in ((jt, jfd), (pt, pfd)):
        t_._create_keyframe(fd)
    ps, js = pt.store, jt.store
    seeded = ps.n_mp - n_mp
    assert seeded > 20, seeded
    np.testing.assert_array_equal(pfd.kp_mp, jfd.kp_mp)
    np.testing.assert_allclose(ps.mp_pos, js.mp_pos, atol=POINT_TOL, rtol=0)
    mid.assert_stores_agree(ps, js, pos_tol=POINT_TOL)
    # the seeded points lie on the wall, 4 m along the camera's z
    new = np.arange(n_mp, ps.n_mp)
    assert np.abs(ps.mp_pos[new, 2] - 4.0).max() < 0.05


def test_track_and_create_keyframe(moment):
    """The slow path on the next frame in both packages (motion model,
    local map), then a keyframe with its depth seeding and the mapper's
    dispatch."""
    jt, pt, jfd, pfd = trackers(moment)
    assert jt._track_motion_model(jfd) and pt._track_motion_model(pfd)
    assert jt._track_local_map(jfd) and pt._track_local_map(pfd)
    np.testing.assert_array_equal(pfd.kp_mp, jfd.kp_mp)
    np.testing.assert_allclose(pfd.R, jfd.R, atol=MAP_POSE_TOL)
    np.testing.assert_allclose(pfd.t, jfd.t, atol=MAP_POSE_TOL)
    for t_, fd in ((jt, jfd), (pt, pfd)):
        t_._create_keyframe(fd)
    ps, js = pt.store, jt.store
    assert ps.n_kf == js.n_kf == moment["store"].n_kf + 1
    assert ps.n_mp == js.n_mp > moment["store"].n_mp
    assert pt.mapper._kf_stage[0] == jt.mapper._kf_stage[0] == "triangulate"
    mid.assert_stores_agree(ps, js)


def mappers(m, shards=1):
    """A JAX and a port mapper after the moment's triangulation and fuse;
    the port's on a mesh of `shards` CPU shards."""
    ps, js = mid.copy_store(m["map_store"]), mid.jax_store(m["map_store"])
    jm = jlm.LocalMapper(m["jcfg"], js)
    pm = lm.LocalMapper(m["cfg"], ps, device="cpu",
                        mesh=runtime.Mesh(["cpu"] * shards))
    kf = m["kf"]
    for mapper in (jm, pm):
        mapper.recent_mp = list(m["recent"])
        meta, fetch = mapper._dispatch_triangulate(kf)
        mapper._apply_triangulate(kf, meta, fetch.get())
        mapper.store.update_covisibility(kf)
        meta, fetch = mapper._dispatch_fuse(kf)
        mapper._apply_fuse(kf, meta, fetch.get())
    mid.assert_stores_agree(pm.store, js)
    return jm, pm


def test_local_ba_stereo_edges(moment):
    """The local BA's problem on the RGB-D map carries stereo edges (u, v,
    uR) for every depth-valid observation: the same edge sets in both
    packages; the BA on them gives the same poses."""
    jm, pm = mappers(moment)
    kf, store = moment["kf"], pm.store
    window = store.covisible_kfs(kf, min_weight=15, top_n=mid.BA_WINDOW - 1)
    window = np.concatenate([[kf], window]).astype(np.int64)
    pad = mid.BA_WINDOW + mid.BA_FIXED
    jprob = jm._gather_ba_problem(window, np.zeros(0, np.int64), pad_to=pad)
    pprob = pm._gather_ba_problem(window, np.zeros(0, np.int64), pad_to=pad)
    n_st = pm.last_ba_edges["stereo"]
    assert n_st > 500
    for jes, pes in zip(jprob[7:10], pprob[7:10]):
        for a, b in zip(jes, pes):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(pprob[8].valid.sum()) == n_st
    cam = pm.cfg.camera
    jres = jba.bundle_adjust(*jprob[1:10], cam.fx, cam.fy, cam.cx, cam.cy,
                             bf=cam.bf, iters_phase1=5, iters_phase2=10)
    pres = ba.bundle_adjust(*pprob[1:10], cam.fx, cam.fy, cam.cx, cam.cy,
                            bf=cam.bf, iters_phase1=5, iters_phase2=10,
                            device="cpu")
    np.testing.assert_allclose(pres.cam_R.numpy(), np.asarray(jres.cam_R),
                               atol=BA_POSE_TOL)
    np.testing.assert_allclose(pres.cam_t.numpy(), np.asarray(jres.cam_t),
                               atol=BA_POSE_TOL)
    np.testing.assert_array_equal(pres.inl_stereo.numpy(),
                                  np.asarray(jres.inl_stereo))
    # and through the mapper, with its writeback
    R_before = store.kf_R[:store.n_kf].copy()
    for mapper in (jm, pm):
        mapper.local_ba(kf)
    assert pm.stats["ba_stereo_edges"] == n_st
    ps, js = pm.store, jm.store
    assert np.abs(ps.kf_R[:ps.n_kf] - R_before).max() > 1e-7
    np.testing.assert_allclose(ps.kf_R[:ps.n_kf], js.kf_R[:js.n_kf],
                               atol=MAP_POSE_TOL)
    np.testing.assert_allclose(ps.kf_t[:ps.n_kf], js.kf_t[:js.n_kf],
                               atol=MAP_POSE_TOL)


@pytest.mark.parametrize("shards", [1, 8], ids=["one-device", "8-shards"])
def test_full_map_ba_stereo_edges(moment, shards):
    """The full-map BA with the map's stereo edges. The JAX package's
    tests run its full-map BA sharded over the 8 virtual CPU devices (the
    implicit-Schur PCG). On one device the port runs the dense-W Schur
    solve: poses within 1e-3, points within 1e-3 m at the median and
    2e-2 m at worst, as test_torch_local_mapping.py's full-map BA. On 8
    shards it runs the same sharded solver as the JAX package: poses
    within SHARDED_POSE_TOL, points within SHARDED_PT_MEDIAN_TOL at the
    median and SHARDED_PT_MAX_TOL at worst."""
    jm, pm = mappers(moment, shards)
    for mapper in (jm, pm):
        mapper.global_ba(iters=(3, 3))
    ps, js = pm.store, jm.store
    assert pm.last_ba_edges["stereo"] > 500
    assert pm.stats["gba_landed"] == 1
    assert pm.last_gba["solver"] == (
        "dense-W" if shards == 1 else "sharded-implicit")
    pose_tol = MAP_POSE_TOL if shards == 1 else SHARDED_POSE_TOL
    np.testing.assert_allclose(ps.kf_R[:ps.n_kf], js.kf_R[:js.n_kf],
                               atol=pose_tol)
    np.testing.assert_allclose(ps.kf_t[:ps.n_kf], js.kf_t[:js.n_kf],
                               atol=pose_tol)
    live = ps.mp_valid[:ps.n_mp]
    diff = np.abs(ps.mp_pos[:ps.n_mp][live] - js.mp_pos[:js.n_mp][live])
    if shards == 1:
        assert np.median(diff) < MAP_POSE_TOL and diff.max() < 2e-2
    else:
        assert np.median(diff) < SHARDED_PT_MEDIAN_TOL
        assert diff.max() < SHARDED_PT_MAX_TOL


INTR = (250.0, 250.0, 160.0, 120.0)


def metric_matches(rng, n=160, outliers=30):
    """Frame-2 points and their frame-1 images under a rigid motion (the
    depth modes' loops have scale 1), with outliers; and their pixels."""
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 6, n)], 1).astype(np.float32)
    R, t, _ = (np.asarray(x) for x in jlie.sim3_exp(jnp.asarray(
        [0.1, -0.05, 0.2, 0.02, 0.05, -0.03, 0.0], jnp.float32)))
    p1 = (p2 @ R.T + t + rng.normal(0, 0.002, (n, 3))).astype(np.float32)
    p1[:outliers] += rng.normal(0, 1.0, (outliers, 3)).astype(np.float32)
    fx, fy, cx, cy = INTR

    def proj(p):
        return np.stack([fx * p[:, 0] / p[:, 2] + cx,
                         fy * p[:, 1] / p[:, 2] + cy], 1).astype(np.float32)

    return p1, p2, proj(p1), proj(p2), (R, t)


def test_loop_sim3_solvers_fixed_scale():
    """`sim3_ransac` (with the JAX package's own draws) and
    `optimize_sim3_two_frame` with `fix_scale`, as the loop closer calls
    them for a stereo or RGB-D map: the same inliers in both packages, R
    and t within 1e-4, the scale 1."""
    rng = np.random.default_rng(6)
    p1, p2, uv1, uv2, (R_gt, t_gt) = metric_matches(rng)
    valid = np.ones(len(p1), bool)
    err1 = np.full(len(p1), 9.21, np.float32)
    err2 = np.full(len(p1), 9.21 * 1.44, np.float32)
    key = jax.random.PRNGKey(3)
    ref = jsim3.sim3_ransac(key, jnp.asarray(p1), jnp.asarray(p2),
                            jnp.asarray(valid), jnp.asarray(err1),
                            jnp.asarray(err2), *INTR, *INTR, fix_scale=True)
    draws = torch.from_numpy(np.array(jax.random.randint(
        key, (256, 3), 0, jnp.iinfo(jnp.int32).max)))
    got = sim3.fetch_result(sim3.sim3_ransac(
        draws, p1, p2, valid, err1, err2, *INTR, *INTR, fix_scale=True,
        device="cpu"))
    assert got.ok and bool(ref.ok)
    np.testing.assert_array_equal(got.inliers, np.asarray(ref.inliers))
    np.testing.assert_allclose(got.R, np.asarray(ref.R), atol=BA_POSE_TOL)
    np.testing.assert_allclose(got.t, np.asarray(ref.t), atol=BA_POSE_TOL)
    assert got.s == float(ref.s) == 1.0
    np.testing.assert_allclose(got.t, t_gt, atol=0.02)
    # refined from a start 2 cm and 0.6 degrees off, the scale held at 1
    R0, t0, _ = jlie.sim3_mul(*jlie.sim3_exp(jnp.asarray(
        [0.02, 0.0, -0.01, 0.01, -0.005, 0.002, 0.0], jnp.float32)),
        jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.float32(1.0))
    info1 = np.ones(len(p1), np.float32)
    info2 = np.full(len(p1), 1 / 1.44, np.float32)
    s0 = jnp.float32(1.0)
    ref = jsim3_opt.optimize_sim3_two_frame(
        R0, t0, s0, p1, p2, uv1, uv2, info1, info2, valid, *INTR,
        fix_scale=True, iters=12)
    got = sim3_opt.optimize_sim3_two_frame(
        np.asarray(R0), np.asarray(t0), np.asarray(s0), p1, p2, uv1, uv2,
        info1, info2, valid, *INTR, fix_scale=True, iters=12, device="cpu")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4]) >= 120
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=BA_POSE_TOL)
    assert float(got[2]) == float(ref[2]) == 1.0
    np.testing.assert_allclose(got[1].numpy(), t_gt, atol=0.01)


def depth_closers(m):
    """A JAX and a port LoopCloser on the RGB-D moment's map after the
    flush, each on its own copy, the port's RANSAC given the JAX
    closer's draws (`test_torch_loop_closing.share_draws`). No
    vocabulary: the Sim3 and the correction do not query the database."""
    ps, js = mid.copy_store(m["store"]), mid.jax_store(m["store"])
    jl = jlc.LoopCloser(m["jcfg"], js, jlm.LocalMapper(m["jcfg"], js))
    pl = lc.LoopCloser(m["cfg"], ps, lm.LocalMapper(m["cfg"], ps,
                                                    device="cpu"))
    share_draws(jl, pl)
    return jl, pl


def fixed_scale_loop(jl, pl):
    """The newest keyframe's Sim3 to the oldest keyframe it shares points
    with, in both packages: the same accept or reject for every candidate
    tried, oldest first."""
    store = jl.store
    kf = int(store.valid_kf_ids()[-1])
    for cand in sorted(int(c) for c in store.covisible_kfs(kf, min_weight=1)):
        jr, pr = jl._compute_sim3(kf, cand), pl._compute_sim3(kf, cand)
        assert (jr is None) == (pr is None), cand
        if jr is not None:
            return kf, cand, jr, pr
    raise AssertionError("no Sim3 found to any covisible keyframe")


def test_loop_compute_sim3_fixed_scale(moment):
    """`_compute_sim3` on the RGB-D map, where the closer fixes the
    scale: the same loop points, R and t within 1e-4, s exactly 1."""
    jl, pl = depth_closers(moment)
    kf, cand, (jS, jpts), (pS, ppts) = fixed_scale_loop(jl, pl)
    assert cand < kf
    np.testing.assert_allclose(pS[0], np.asarray(jS[0]), atol=BA_POSE_TOL)
    np.testing.assert_allclose(pS[1], np.asarray(jS[1]), atol=BA_POSE_TOL)
    assert pS[2] == float(jS[2]) == 1.0
    np.testing.assert_array_equal(ppts, jpts)
    assert pl._last_sim3["scale"] == 1.0 and len(ppts) >= 40


@pytest.mark.parametrize("offset", [0.0, 0.1], ids=["as-found", "shifted"])
def test_loop_correct_fixed_scale(moment, offset):
    """`_correct_loop` from the JAX package's fixed-scale Sim3 (and from
    it with 0.1 m more translation, so the map really moves): poses within
    1e-3, points within 1e-3 m, the same fused observations; the port's
    one-device dense graph against the JAX package's sharded one, as
    test_torch_loop_closing.py's `test_correct_loop`."""
    jl, pl = depth_closers(moment)
    kf, cand, (jS, jpts), _ = fixed_scale_loop(jl, pl)
    S = (np.asarray(jS[0]), (np.asarray(jS[1])
                             + np.float32([offset, 0, 0])).astype(np.float32),
         float(jS[2]))
    gba = []
    for closer in (jl, pl):
        closer._global_ba = lambda k, gba=gba: gba.append(k)
        closer._correct_loop(kf, cand, S, jpts)
    assert gba == [kf, kf]
    ps, js = pl.store, jl.store
    assert ps.loop_edges == js.loop_edges == [(cand, kf)]
    np.testing.assert_array_equal(ps.kf_kp_mp, js.kf_kp_mp)
    np.testing.assert_allclose(ps.kf_R, js.kf_R, atol=MAP_POSE_TOL)
    np.testing.assert_allclose(ps.kf_t, js.kf_t, atol=MAP_POSE_TOL)
    live = js.mp_valid
    np.testing.assert_array_equal(ps.mp_valid, live)
    np.testing.assert_allclose(ps.mp_pos[live], js.mp_pos[live],
                               atol=MAP_POSE_TOL, rtol=0)
    rec = pl.loop_log[-1]
    assert rec["solver"] == "dense" and rec["scale"] == 1.0
    assert rec["cost_after"] <= rec["cost_before"]
    if offset:
        before = moment["store"]
        assert np.abs(ps.kf_t[kf] - before.kf_t[kf]).max() > 0.02


@pytest.fixture(scope="module")
def runs():
    return mid.system_runs("rgbd", N_FEATURES, N_SYSTEM_FRAMES)


def test_system_rgbd(runs):
    """Both packages' System over 15 RGB-D frames: see
    `torch_midrun.check_depth_runs`."""
    frames, out = runs
    mid.check_depth_runs(frames, out, min_keyframes=3)


def test_system_rgbd_savers(runs, tmp_path):
    """The four trajectory savers on both packages' RGB-D runs: the same
    lines, timestamps equal, positions and rotations within RUN_TOL
    (quaternions up to sign), the KITTI rows' 12 entries alike."""
    _, out = runs
    savers = ("save_trajectory_tum", "save_keyframe_trajectory_tum",
              "save_trajectory_kitti", "save_keyframe_trajectory_odom_tum")
    for saver in savers:
        got = {}
        for name in ("jax", "port"):
            path = tmp_path / f"{name}_{saver}.txt"
            getattr(out[name][0], saver)(str(path))
            got[name] = np.loadtxt(path, ndmin=2)
        a, b = got["port"], got["jax"]
        assert a.shape == b.shape and len(a) >= 3, saver
        if saver == "save_trajectory_kitti":
            assert a.shape[1] == 12
            np.testing.assert_allclose(a, b, atol=mid.RUN_TOL, err_msg=saver)
            continue
        assert a.shape[1] == 8
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=mid.RUN_TOL,
                                   err_msg=saver)
        sign = np.sign((a[:, 4:] * b[:, 4:]).sum(1))[:, None]
        np.testing.assert_allclose(a[:, 4:] * sign, b[:, 4:],
                                   atol=mid.RUN_TOL, err_msg=saver)
