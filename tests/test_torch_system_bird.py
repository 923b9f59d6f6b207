"""The slice as a whole in mono+bird mode: both packages' `System` fed the
same raw images of the half-size bird drive (`torch_midrun`), on the CPU,
with loop closing off on both sides. The local-BA window is cut to 8 + 4
keyframes in both (`torch_midrun.BA_WINDOW`) to keep the file inside its
time budget; the default 32 + 16 window (C = 48) is held against the
reference by `test_torch_system_mono.py`, and in bird mode at full width
only against ground truth, by the `system` phase of `chip_smoke.py`.

Each package extracts its own keypoints, so the inputs differ by the
extractors' rounding (a few pixels of the pyramid, an ulp of an angle; see
`test_torch_orb.py`). Held: per frame, the same `pose_ok` and the same
state; keyframes minted at the same frame ids; camera centres within 1 cm
(the ATE itself is ~5 mm) and rotation entries within 2e-3 of each other
(both maps are metric);
both metric ATEs (rigid alignment, no scale) under the e2e bar of 0.05 m
and path lengths within 2 % of ground truth; a map saved by one package
loads in the other.
"""
import copy

import numpy as np
import pytest

import torch_midrun as mid
from orbslam_birdview_tpu.api.system import System as JSystem
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.mapping.mapstore import MapStore
from orbslam_birdview_tpu_torch.pipeline import tracking
from orbslam_birdview_tpu_torch.utils.synth import ate_rmse

N_FRAMES = 14
CENTRE_TOL, ROT_TOL = 1e-2, 2e-3

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()



@pytest.fixture(scope="module")
def runs():
    seq, frames, mask = mid.drive(N_FRAMES)
    jcfg, cfg = mid.make_cfgs(seq)
    out = {}
    for name, system in (("jax", JSystem(jcfg, enable_loop_closing=False)),
                         ("port", System(cfg, enable_loop_closing=False,
                                         device="cpu"))):
        rows = []
        for i, (img, bev, _) in enumerate(frames):
            fd = system.track_monocular_with_birdview(img, bev, mask, i / 25.0)
            rows.append((fd.pose_ok, system.tracker.state,
                         -fd.R.T @ fd.t, fd.R.copy()))
        system._flush()
        out[name] = (system, rows)
    return seq, frames, out


def test_same_states_keyframes_and_poses(runs):
    _, _, out = runs
    (js, jrows), (ps, prows) = out["jax"], out["port"]
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    assert prows[3][:2] == (True, tracking.OK)
    assert all(r[0] for r in prows[3:])
    jk = js.store.kf_frame_id[:js.store.n_kf].tolist()
    pk = ps.store.kf_frame_id[:ps.store.n_kf].tolist()
    assert pk == jk and len(pk) >= 4
    for (_, _, jc, jR), (ok, _, pc, pR) in zip(jrows, prows):
        if ok:
            assert np.abs(pc - jc).max() < CENTRE_TOL
            assert np.abs(pR - jR).max() < ROT_TOL
    assert ps.n_map_points() == pytest.approx(js.n_map_points(), rel=0.02)
    assert int(ps.store.bmp_valid.sum()) == pytest.approx(
        int(js.store.bmp_valid.sum()), rel=0.02)
    st = ps.mapper.stats
    assert st["ba_landed"] >= 1 and st["tri_applied"] == st["fuse_applied"]
    # the summary blocks batch as the reference's do
    assert ps.tracker.batch_stats == js.tracker.batch_stats


def test_metric_trajectories_against_ground_truth(runs):
    seq, _, out = runs
    kf0 = int(out["port"][0].store.kf_frame_id[0])
    R0, t0 = seq.gt_cam_pose(kf0)
    for name in ("jax", "port"):
        system, rows = out[name]
        est, gt = [], []
        for i, (ok, _, c, _) in enumerate(rows):
            if ok:
                R, t = seq.gt_cam_pose(i)
                Rn = R @ R0.T                       # in the first keyframe's
                gt.append(-Rn.T @ (t - Rn @ t0))    # camera frame
                est.append(c)
        est, gt = np.array(est), np.array(gt)
        assert ate_rmse(est, gt, with_scale=False) < 0.05, name
        d_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
        d_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
        assert abs(d_est / d_gt - 1.0) < 0.02, (name, d_est / d_gt)
        assert int(system.store.bmp_valid.sum()) > 200


def test_saved_maps_load_across_packages(runs, tmp_path):
    _, frames, out = runs
    js, ps = out["jax"][0], out["port"][0]
    js.save_map(str(tmp_path / "jax.npz"))
    ps.save_map(str(tmp_path / "port.npz"))
    # the port loads the reference's map and relocalizes against it
    fresh = System(ps.cfg, enable_loop_closing=False, device="cpu")
    fresh.load_map(str(tmp_path / "jax.npz"))
    assert fresh.tracker.state == tracking.LOST
    assert fresh.n_keyframes() == js.n_keyframes()
    for name, v in vars(js.store).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(fresh.store, name), v,
                                          err_msg=name)
    img, bev, _ = frames[10]
    fd = fresh.track_monocular_with_birdview(
        img, bev, mid.synth.footprint_mask(mid.BV), 10 / 25.0)
    assert fd.pose_ok and fresh.tracker.last_reloc_frame_id == fd.frame_id
    # and the reference loads the port's
    again = JSystem(js.cfg, enable_loop_closing=False)
    again.load_map(str(tmp_path / "port.npz"))
    assert again.n_keyframes() == ps.n_keyframes()
    np.testing.assert_array_equal(again.store.kf_kp_mp, ps.store.kf_kp_mp)
    assert isinstance(MapStore.load(str(tmp_path / "port.npz")), MapStore)


def test_what_is_not_ported_raises(runs):
    _, frames, out = runs
    cfg = out["port"][0].cfg
    # loop closing is on by default and ported: the System builds with the
    # packaged vocabulary, its database empty until keyframes come
    system = System(cfg, device="cpu")
    assert system.loop_closer.voc.n_words == 100000
    assert system.loop_closer.kfdb.registered == set()
    # the depth modes are ported: an RGB-D and a stereo System initialize
    # on their first frame, at the identity
    img = frames[0][0]
    for sensor in ("rgbd", "stereo"):
        dcfg = copy.deepcopy(cfg)
        dcfg.sensor = sensor
        dcfg.camera = dcfg.camera._replace(bf=dcfg.camera.fx * 0.5)
        system = System(dcfg, enable_loop_closing=False, device="cpu")
        if sensor == "rgbd":
            fd = system.track_rgbd(img, np.full_like(img, 4.0), 0.0)
        else:   # every point 4 px of disparity away
            fd = system.track_stereo(img, np.roll(img, -4, axis=1), 0.0)
        assert fd.pose_ok and system.n_keyframes() == 1, sensor
        np.testing.assert_array_equal(fd.R, np.eye(3))
        assert system.n_map_points() >= 500
