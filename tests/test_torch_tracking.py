"""The tracker after initialization, the JAX package against the port, on
the CPU, from the same state carried across.

The state: the port's `System` fed the half-size bird drive past its third
keyframe and flushed (nothing in flight). Its map, the tracker's fields,
its last frame (keypoints, associations, pose) and its trajectory go into
a JAX and a port `Tracker`; the next frame's keypoints are extracted once
and handed to both. Then the slow path runs in both: the motion model, the
reference keyframe, the local map with the BEV landmark search, the BEV
frame-to-frame matching, the keyframe policy on both sides of its ratio,
keyframe creation, and relocalization by EPnP-RANSAC with the JAX
package's own draws.

Tolerances: the matchers are exact integer arithmetic, so associations and
inlier counts are equal; poses agree to 1e-3 (rotation entries, metres):
two LM runs of four rounds sum in another order, and the relocalized pose
goes through RANSAC, Gauss-Newton and two LM runs.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid
from orbslam_birdview_tpu.frontend.keypoints import Keypoints as JKeypoints
from orbslam_birdview_tpu.pipeline import local_mapping as jlm
from orbslam_birdview_tpu.pipeline import tracking as jtr
from orbslam_birdview_tpu.pipeline.frame import FrameData as JFrameData
from orbslam_birdview_tpu_torch.frontend import keypoints as pkeypoints
from orbslam_birdview_tpu_torch.pipeline import local_mapping as lm
from orbslam_birdview_tpu_torch.pipeline import state, tracking

POSE_TOL = 1e-3
INT32_MAX = int(jnp.iinfo(jnp.int32).max)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()



def kp_numpy(kp):
    return pkeypoints.to_host(kp)._asdict()


@pytest.fixture(scope="module")
def moment():
    seq, frames, mask = mid.drive(20)
    jcfg, cfg = mid.make_cfgs(seq)
    system, i = mid.run_port(cfg, frames, mask, lambda s: s.store.n_kf >= 4)
    system._flush()
    tr = system.tracker
    last = tr.last_frame
    tr.resolve_associations(last)
    # the next frame's keypoints, extracted once for both packages
    nxt = tr.make_frame(frames[i + 1][0], (i + 1) / 25.0, frames[i + 1][1],
                        mask)
    return dict(
        jcfg=jcfg, cfg=cfg, store=mid.copy_store(system.store),
        mapper=copy.deepcopy(system.mapper),
        fields=state.tracker_fields(tr), trajectory=list(tr.trajectory),
        last=dict(frame_id=last.frame_id, timestamp=last.timestamp,
                  kp=kp_numpy(last.kp), bird_kp=kp_numpy(last.bird_kp),
                  bird_base_xyz=np.asarray(last.bird_base_xyz),
                  kp_mp=last.kp_mp.copy(), bird_mp=last.bird_mp.copy(),
                  R=last.R.copy(), t=last.t.copy(), pose_ok=last.pose_ok),
        next=dict(frame_id=nxt.frame_id, timestamp=nxt.timestamp,
                  kp=kp_numpy(nxt.kp), bird_kp=kp_numpy(nxt.bird_kp),
                  bird_base_xyz=np.asarray(nxt.bird_base_xyz)))


def jax_frame(f):
    """The JAX package's FrameData of a frame record (see `moment`)."""
    def kps(d):
        return JKeypoints(*(jnp.asarray(d[k]) for k in JKeypoints._fields))

    fd = JFrameData(frame_id=f["frame_id"], timestamp=f["timestamp"],
                    kp=kps(f["kp"]), R=np.array(f.get("R", np.eye(3)),
                                                np.float32),
                    t=np.array(f.get("t", np.zeros(3)), np.float32),
                    kp_mp=np.array(f.get("kp_mp", np.full(
                        len(f["kp"]["xy"]), -1)), np.int64))
    fd.bird_kp = kps(f["bird_kp"])
    fd.bird_base_xyz = f["bird_base_xyz"].copy()
    fd.bird_mp = np.array(f.get("bird_mp", np.full(
        len(f["bird_kp"]["xy"]), -1)), np.int64)
    fd.pose_ok = f.get("pose_ok", False)
    return fd


def port_frame(f):
    return state.frame_from_numpy(
        f["frame_id"], f["timestamp"], f["kp"], f["bird_kp"],
        f["bird_base_xyz"], device="cpu", kp_mp=f.get("kp_mp"),
        bird_mp=f.get("bird_mp"), R=f.get("R"), t=f.get("t"),
        pose_ok=f.get("pose_ok", False))


def trackers(m, with_mapper=True):
    """A JAX and a port Tracker in the carried-across state, each on its own
    copy of the map."""
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
        # the mapper's ticks, queue and recent points, into both mappers
        for mapper in (jt.mapper, pt.mapper):
            state.set_mapper_state(mapper, m["mapper"])
    return jt, pt, jax_frame(m["next"]), port_frame(m["next"])


def assert_frames_agree(pfd, jfd, tol=POSE_TOL):
    np.testing.assert_array_equal(pfd.kp_mp, jfd.kp_mp)
    np.testing.assert_array_equal(pfd.bird_mp, jfd.bird_mp)
    np.testing.assert_allclose(pfd.R, jfd.R, atol=tol)
    np.testing.assert_allclose(pfd.t, jfd.t, atol=tol)


def test_motion_model_then_local_map(moment):
    jt, pt, jfd, pfd = trackers(moment)
    assert pt.velocity is not None and pt.state == tracking.OK
    ok_j, ok_p = jt._track_motion_model(jfd), pt._track_motion_model(pfd)
    assert ok_p == ok_j is True
    assert_frames_agree(pfd, jfd)
    assert (pfd.kp_mp >= 0).sum() > 50 and (pfd.bird_mp >= 0).sum() > 100
    ok_j, ok_p = jt._track_local_map(jfd), pt._track_local_map(pfd)
    assert ok_p == ok_j is True
    assert pt._n_last_inliers == jt._n_last_inliers
    assert pt.ref_kf == jt.ref_kf
    assert_frames_agree(pfd, jfd)
    for name in ("mp_visible", "mp_found", "bmp_valid", "bmp_pos"):
        np.testing.assert_allclose(getattr(pt.store, name),
                                   getattr(jt.store, name), atol=1e-5,
                                   err_msg=name)


def test_reference_keyframe_and_bird_matching(moment):
    jt, pt, jfd, pfd = trackers(moment)
    ok_j, ok_p = jt._track_reference_kf(jfd), pt._track_reference_kf(pfd)
    assert ok_p == ok_j is True
    assert_frames_agree(pfd, jfd)
    # BEV frame-to-frame matching alone, from the last frame: its landmark
    # ids propagate; matches without one mint new landmarks, the same ids in
    # both (the last frame drops a third of its ids for that)
    for half in (False, True):
        jt2, pt2, jfd2, pfd2 = trackers(moment)
        if half:
            for t_ in (jt2, pt2):
                t_.last_frame.bird_mp[::3] = -1
        n_bmp = pt2.store.n_bmp
        jt2._match_bird_from_last(jfd2)
        pt2._match_bird_from_last(pfd2)
        np.testing.assert_array_equal(pfd2.bird_mp, jfd2.bird_mp)
        assert (pfd2.bird_mp >= 0).sum() > 100
        assert pt2.store.n_bmp == jt2.store.n_bmp >= n_bmp + 10 * half
        np.testing.assert_allclose(pt2.store.bmp_pos, jt2.store.bmp_pos,
                                   atol=1e-5)


def test_search_bird_local(moment):
    jt, pt, jfd, pfd = trackers(moment)
    last = moment["last"]
    for fd in (jfd, pfd):
        fd.R, fd.t = last["R"].copy(), last["t"].copy()
    kfs = moment["store"].valid_kf_ids()
    jt._search_bird_local(jfd, kfs)
    pt._search_bird_local(pfd, kfs)
    assert (pfd.bird_mp >= 0).sum() > 100
    np.testing.assert_array_equal(pfd.bird_mp, jfd.bird_mp)


def test_keyframe_policy_both_sides_of_the_ratio(moment):
    jt, pt, jfd, pfd = trackers(moment, with_mapper=False)
    store = pt.store
    ref_mp = store.kf_kp_mp[pt.ref_kf]
    attached = (ref_mp >= 0) & store.kf_kp_valid[pt.ref_kf]
    ref_tracked = int((store.mp_n_obs[ref_mp.clip(0)][attached] >= 3).sum())
    thresh = pt.cfg.tracking.ref_ratio * ref_tracked
    decisions = []
    for tracked in (int(thresh) - 5, int(thresh) + 5, 10):
        for fd in (jfd, pfd):
            fd._n_tracked = tracked
        d = (jt._need_new_keyframe(jfd), pt._need_new_keyframe(pfd))
        assert d[0] == d[1], tracked
        decisions.append(d[1])
    assert decisions == [True, False, False]   # under, over, <= 15 tracked
    # the timeout mints whatever the ratio
    for t_ in (jt, pt):
        t_.last_kf_frame_id = pfd.frame_id - t_.cfg.tracking.max_frames_between_kf
    for fd in (jfd, pfd):
        fd._n_tracked = int(thresh) + 5
    assert jt._need_new_keyframe(jfd) is pt._need_new_keyframe(pfd) is True


def test_create_keyframe(moment):
    jt, pt, jfd, pfd = trackers(moment)
    assert jt._track_motion_model(jfd) and pt._track_motion_model(pfd)
    assert jt._track_local_map(jfd) and pt._track_local_map(pfd)
    for t_, fd in ((jt, jfd), (pt, pfd)):
        t_._create_keyframe(fd)
    ps, js = pt.store, jt.store
    assert ps.n_kf == js.n_kf == moment["store"].n_kf + 1
    assert pt.ref_kf == jt.ref_kf == ps.n_kf - 1
    assert pt.last_kf_frame_id == jt.last_kf_frame_id == pfd.frame_id
    # the mapper got the keyframe and dispatched its triangulation, at the
    # tick carried across
    assert pt.mapper._kf_stage[0] == jt.mapper._kf_stage[0] == "triangulate"
    assert pt.mapper._stage_tick == jt.mapper._stage_tick == moment[
        "mapper"]._frame_tick > 0
    assert pt.mapper.recent_mp == jt.mapper.recent_mp
    mid.assert_stores_agree(ps, js)
    np.testing.assert_allclose(pfd.R, jfd.R, atol=POSE_TOL)


def jax_key_draws(key):
    """The draws the JAX tracker's PnP attempts make, one set per attempt:
    `_next_key` splits the tracker key, the sampler draws from the half."""
    while True:
        key, k = jax.random.split(key)
        yield torch.from_numpy(np.array(jax.random.randint(
            k, (256, 4), 0, INT32_MAX)))


def test_relocalize_with_shared_draws(moment):
    jt, pt, jfd, pfd = trackers(moment, with_mapper=False)
    for t_ in (jt, pt):
        t_.state = tracking.LOST
        t_.velocity = None
    draws = jax_key_draws(copy.deepcopy(jt.rng_key))
    ok_j = jt._relocalize(jfd)
    ok_p = pt._relocalize(pfd, draws=draws)
    assert ok_p == ok_j is True
    assert pt.last_reloc_frame_id == jt.last_reloc_frame_id == pfd.frame_id
    assert pt.ref_kf == jt.ref_kf
    assert_frames_agree(pfd, jfd)
    assert (pfd.kp_mp >= 0).sum() >= 50


def test_summary_block_batches_and_seals_early():
    """Rows batch into one fetch per block; a row asked for before the
    block is full seals it early, and the realized sizes are recorded, as
    the reference's block does."""
    rows = [np.arange(16, dtype=np.float32) + 100 * i for i in range(5)]
    jstats, pstats = [], []
    jb, pb = jtr._SummaryBlock(stats=jstats), tracking._SummaryBlock(
        stats=pstats)
    jrefs = [jb.append(jnp.asarray(r)) for r in rows[:3]]
    prefs = [pb.append(torch.from_numpy(r)) for r in rows[:3]]
    assert pb.fetch is None and not prefs[0].done()
    np.testing.assert_array_equal(prefs[1].get(), jrefs[1].get())  # early seal
    assert pstats == jstats == [3] and pb.rows == [] and prefs[2].done()
    for r, ref in zip(rows[:3], prefs):
        np.testing.assert_array_equal(ref.get(), r)
    full = tracking._SummaryBlock(stats=pstats)
    refs = [full.append(torch.from_numpy(r)) for r in rows[3:]]
    full.seal()
    assert pstats == [3, 2]
    np.testing.assert_array_equal(refs[1].get(), rows[4])
