"""The slice as a whole in mono mode: both packages' `System` fed the same
raw images of a small wall sequence (the e2e test's camera, 640×480, 1000
features), on the CPU, with loop closing off on both sides and the default
local-BA window (32 + 16 keyframes, padded to C = 48).

Each package extracts its own keypoints, so the inputs differ by the
extractors' rounding (see `test_torch_orb.py`), and a keyframe decided by
the reference-ratio test can move: on this sequence the fourth keyframe
comes at frame 17 in the reference and frame 20 in the port, because frame
17 tracks 565 map points in one and 568 in the other against thresholds of
565.2 and 562.5 (ROADMAP Queue 3). The sequence runs through that
divergence, past the third keyframe's local BA and the point and keyframe
culling passes of the fourth. Held: per frame, the same `pose_ok` and the
same state; the same keyframe frame ids through frame 16, then exactly one
more keyframe each at frames 17 and 20; camera centres within 2e-3 and
rotation entries within 2e-3 on every frame, before the divergence and
after it (map units: the mono map's scale is set by its median depth at
initialization); map-point counts within 2 % on every frame through 16 and
within 5 % at the end, where each map holds its own fourth keyframe's
triangulations; both ATEs (with scale, mono) under the e2e bar of 0.02;
the TUM trajectories of both packages agree line for line.
"""
import numpy as np
import pytest

import torch_midrun as mid

from orbslam_birdview_tpu.api.config import SlamConfig as JSlamConfig
from orbslam_birdview_tpu.api.system import System as JSystem
from orbslam_birdview_tpu.core import camera as jcam
from orbslam_birdview_tpu.frontend.orb import ORBConfig as JORBConfig
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.pipeline import tracking
from orbslam_birdview_tpu_torch.utils.synth import WallSequence, ate_rmse

CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
N_FRAMES = 22
KF_DIVERGES = 17   # first frame at which the keyframe ids may differ
CENTRE_TOL, ROT_TOL = 2e-3, 2e-3

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()



@pytest.fixture(scope="module")
def runs():
    seq = WallSequence(PinholeCamera(**CAM), n_frames=N_FRAMES, step=0.03)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    cfgs = (JSlamConfig(camera=jcam.PinholeCamera(**CAM),
                        orb=JORBConfig(n_features=1000), sensor="mono"),
            SlamConfig(camera=PinholeCamera(**CAM),
                       orb=ORBConfig(n_features=1000), sensor="mono"))
    systems = (("jax", JSystem(cfgs[0], enable_loop_closing=False)),
               ("port", System(cfgs[1], enable_loop_closing=False,
                               device="cpu")))
    out = {}
    for name, system in systems:
        rows = []
        for i, (img, _) in enumerate(frames):
            fd = system.track_monocular(img, i / 30.0)
            rows.append((fd.pose_ok, system.tracker.state,
                         -fd.R.T @ fd.t, fd.R.copy(), system.n_map_points()))
        system._flush()
        out[name] = (system, rows)
    return frames, out


def test_same_states_keyframes_and_poses(runs):
    _, out = runs
    (js, jrows), (ps, prows) = out["jax"], out["port"]
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    assert prows[3][:2] == (True, tracking.OK)
    assert all(r[0] for r in prows[3:])
    jkf = js.store.kf_frame_id[:js.store.n_kf].tolist()
    pkf = ps.store.kf_frame_id[:ps.store.n_kf].tolist()
    assert [f for f in jkf if f < KF_DIVERGES] == [0, 3, 4]
    assert [f for f in pkf if f < KF_DIVERGES] == [0, 3, 4]
    assert (jkf[3:], pkf[3:]) == ([17], [20])
    assert ps.mapper.stats["ba_landed"] >= 2
    for (_, _, jc, jR, _), (ok, _, pc, pR, _) in zip(jrows, prows):
        if ok:
            assert np.abs(pc - jc).max() < CENTRE_TOL
            assert np.abs(pR - jR).max() < ROT_TOL
    # the maps agree while the keyframes do; after the divergence each
    # package has triangulated its fourth keyframe against another frame
    for j, p in zip(jrows[:KF_DIVERGES], prows[:KF_DIVERGES]):
        assert p[4] == pytest.approx(j[4], rel=0.02)
    assert ps.n_map_points() == pytest.approx(js.n_map_points(), rel=0.05)
    assert ps.n_map_points() > 300
    assert ps.tracker.batch_stats == js.tracker.batch_stats


def test_ate_against_ground_truth(runs):
    frames, out = runs
    for name in ("jax", "port"):
        _, rows = out[name]
        est = np.array([c for ok, _, c, _, _ in rows if ok])
        gt = np.array([-R.T @ t for (ok, *_), (_, (R, t)) in zip(rows, frames)
                       if ok])
        assert len(est) == N_FRAMES - 3         # all after initialization
        assert ate_rmse(est, gt, with_scale=True) < 0.02, name


def test_tum_trajectories_agree(runs, tmp_path):
    _, out = runs
    lines = {}
    for name in ("jax", "port"):
        path = tmp_path / f"{name}.txt"
        out[name][0].save_trajectory_tum(str(path))
        lines[name] = np.loadtxt(path)
    a, b = lines["port"], lines["jax"]
    assert a.shape == b.shape and a.shape[1] == 8 and len(a) == N_FRAMES - 3
    np.testing.assert_array_equal(a[:, 0], b[:, 0])            # timestamps
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=CENTRE_TOL)
    # quaternions up to sign
    sign = np.sign((a[:, 4:] * b[:, 4:]).sum(1))[:, None]
    np.testing.assert_allclose(a[:, 4:] * sign, b[:, 4:], atol=ROT_TOL)
