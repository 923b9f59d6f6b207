"""The rest of the port's outer surface against the JAX package: the
hostile-imaging model and the orbiting sequence of `utils/synth.py`, the
AR overlay (`utils/ar.py`), the overlays and plots (`utils/viz.py`), the
ROS adapter (`api/ros_adapter.py`, with tests/test_ros_transport.py's
fake ROS modules) and the live viewer's HTTP endpoints
(`utils/live_viewer.py`).

Tolerances, and why:
- `degrade`: the same numpy and scipy operations (OpenCV's box blur is
  scipy's mirror-mode mean): bit-equal for the same seed;
- `CircleSequence`: poses equal; frames within RENDER_TOL grey levels (the
  port samples the walls with its own bilinear, OpenCV in fixed point);
- `detect_plane`: the same numpy draws and algebra: equal to 1e-12;
- `draw_frame`'s circles: `cv2.circle`'s pixels exactly;
- the cube: every drawn pixel within 2 px of a projected edge, every edge
  covered (the port's 2-pixel lines are not OpenCV's polygons);
- `decode_image_msg`: the same numpy code: equal, dtype included (the
  reference's quirks are matched, not fixed: `is_bigendian` is ignored,
  and bgr8 / rgb8 come back float32 where mono8 stays uint8); the
  published pose's quaternion within 1e-6 (float32 rot_to_quat in torch
  and in JAX).
"""
import json
import types
import urllib.error
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest

import test_ros_transport as rt
from orbslam_birdview_tpu.api import ros_adapter as jra
from orbslam_birdview_tpu.core.camera import PinholeCamera as JPinholeCamera
from orbslam_birdview_tpu.utils import ar as jar
from orbslam_birdview_tpu.utils import synth as jsynth
from orbslam_birdview_tpu.utils import viz as jviz
from orbslam_birdview_tpu_torch.api import ros_adapter as ra
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
from orbslam_birdview_tpu_torch.utils import ar, imageio, synth, viz
from orbslam_birdview_tpu_torch.utils.live_viewer import LiveViewer

REPO = Path(__file__).resolve().parents[1]
RENDER_TOL = 0.01
CAM = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120)

STRESSORS = {
    "noise_exposure": dict(noise_std=8.0, exposure_amp=0.3,
                           exposure_period=60),
    "blur": dict(blur_px=7),
    "occluders": dict(occluders=2, occluder_size=40),
    "blackout": dict(blackout=True),
}


@pytest.mark.parametrize("stressor", sorted(STRESSORS))
def test_degrade_equals_jax(rng, stressor):
    img = rng.uniform(0, 255, (60, 90)).astype(np.float32)
    for i in (0, 13, 47):
        got = synth.degrade(img, i, np.random.default_rng(7),
                            **STRESSORS[stressor])
        want = jsynth.degrade(img, i, np.random.default_rng(7),
                              **STRESSORS[stressor])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_circle_sequence_equals_jax():
    kw = dict(n_frames=40, speed=0.045, frames_per_rev=30, box_half=9.0)
    seq = synth.CircleSequence(PinholeCamera(**CAM), **kw)
    ref = jsynth.CircleSequence(JPinholeCamera(**CAM), **kw)
    for i in (0, 7, 19):
        img, (R, t) = seq.frame(i)
        want, (R_ref, t_ref) = ref.frame(i)
        np.testing.assert_array_equal(R, R_ref)
        np.testing.assert_array_equal(t, t_ref)
        assert img.dtype == want.dtype == np.float32
        assert np.abs(img - want).max() <= RENDER_TOL
    # one revolution closes the loop
    R0, t0 = seq.gt_pose(0)
    R30, t30 = seq.gt_pose(30)
    np.testing.assert_allclose(-R30.T @ t30, -R0.T @ t0, atol=1e-5)


def plane_points(rng, n=300):
    pts = np.c_[rng.uniform(-1, 1, n), np.full(n, 0.5), rng.uniform(2, 4, n)]
    pts += rng.normal(0, 0.002, pts.shape)
    clutter = rng.uniform(-1, 1, (60, 3)) + [0, -0.5, 3]
    return np.concatenate([pts, clutter])


def test_detect_plane_equals_jax(rng):
    pts = plane_points(rng)
    for seed in (0, 3):
        got, want = ar.detect_plane(pts, seed=seed), jar.detect_plane(
            pts, seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got.inliers, want.inliers)
        assert abs(abs(got.normal[1]) - 1) < 1e-3
    assert ar.detect_plane(pts[:10]) is None is jar.detect_plane(pts[:10])


def test_ar_plane_and_cube():
    """tests/test_e2e.py::test_ar_plane_and_cube on the port."""
    rng = np.random.default_rng(0)
    n_pl, n_out = 150, 30
    pts = np.concatenate([
        np.stack([rng.uniform(-2, 2, n_pl), np.full(n_pl, 1.5)
                  + rng.normal(0, 0.002, n_pl), rng.uniform(2, 6, n_pl)], 1),
        rng.uniform(-2, 6, (n_out, 3)),
    ])
    plane = ar.detect_plane(pts, seed=1)
    assert plane is not None
    assert abs(abs(plane.normal[1]) - 1.0) < 0.01
    assert plane.inliers.sum() >= n_pl * 0.9
    assert plane.inliers[:n_pl].mean() > 0.9
    img = np.zeros((480, 640), np.float32)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    out = ar.draw_virtual_cube(img, np.eye(3), np.zeros(3), K, plane, 0.2)
    assert out.shape == (480, 640, 3) and out.dtype == np.uint8
    assert out.max() > 0


def test_draw_virtual_cube_follows_projected_edges(rng):
    plane = ar.detect_plane(plane_points(rng))
    K = np.array([[130.0, 0, 80.0], [0, 130.0, 60.0], [0, 0, 1]])
    R, t = np.eye(3), np.zeros(3)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    out = ar.draw_virtual_cube(img, R, t, K, plane, size=0.3)
    drawn = np.argwhere(np.all(out == ar.CUBE_COLOR, -1))[:, ::-1]   # (x, y)
    X = ar.cube_vertices(plane, 0.3) @ R.T + t
    uv = X @ K.T
    uv = uv[:, :2] / uv[:, 2:]
    segs = [(uv[i], uv[j]) for i, j in ar._CUBE_EDGES]

    def dist(p, a, b):
        d = b - a
        s = np.clip(((p - a) @ d) / max(d @ d, 1e-12), 0, 1)
        return np.linalg.norm(p - (a + s[:, None] * d), axis=-1)

    dmin = np.min([dist(drawn.astype(float), a, b) for a, b in segs], 0)
    assert len(drawn) and dmin.max() <= 2.0
    for a, b in segs:                    # every edge's samples are drawn
        for s in np.linspace(0, 1, 9):
            p = a + s * (b - a)
            if 0 <= p[0] < 160 and 0 <= p[1] < 120:
                assert np.linalg.norm(drawn - p, axis=1).min() <= 2.0
    # the JAX package's cube (OpenCV's line) covers the same edges
    ref = jar.draw_virtual_cube(img, R, t, K, jar.Plane(*plane), size=0.3)
    ref_px = np.argwhere(np.all(ref == ar.CUBE_COLOR, -1))[:, ::-1]
    assert np.min([dist(ref_px.astype(float), a, b) for a, b in segs],
                  0).max() <= 2.0
    # behind the camera: the image untouched
    behind = ar.draw_virtual_cube(img, R, t - [0, 0, 10.0], K, plane)
    np.testing.assert_array_equal(behind, viz.gray_to_bgr(img))


def test_draw_frame_circles_equal_cv2(rng):
    img = rng.uniform(-20, 280, (120, 160)).astype(np.float32)
    xy = np.c_[rng.uniform(-3, 163, 500), rng.uniform(-3, 123, 500)]
    valid = rng.uniform(size=500) < 0.8
    tracked = rng.uniform(size=500) < 0.5
    for tr in (tracked, None):
        got = viz.draw_frame(img, xy.astype(np.float32), valid, tr)
        want = jviz.draw_frame(img, xy.astype(np.float32), valid, tr)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    banner = viz.draw_frame(img, xy, valid, tracked, state_text="frame 3")
    assert np.all(banner[6:21, 10:90] == 255, -1).sum() > 50


def fake_store(rng):
    kfs = np.arange(5)
    centres = np.c_[np.linspace(0, 2, 5), np.zeros(5), np.linspace(0, 1, 5)]
    covis = np.zeros((5, 5), np.int32)
    covis[0, 1] = covis[1, 0] = covis[2, 4] = covis[4, 2] = 150
    return types.SimpleNamespace(
        valid_mp_ids=lambda: np.arange(200),
        mp_pos=rng.uniform(-1, 3, (200, 3)),
        valid_bmp_ids=lambda: np.arange(50),
        bmp_pos=np.c_[rng.uniform(0, 2, (50, 2)), np.zeros(50)],
        valid_kf_ids=lambda: kfs, kf_center=lambda k: centres[k],
        covis=covis)


def test_plot_map_and_trajectories_write_pngs_cv2_reads(tmp_path, rng):
    store = fake_store(rng)
    viz.plot_map(store, str(tmp_path / "map.png"),
                 gt_centers=np.c_[np.linspace(0, 2, 5), np.linspace(0, 1, 5)])
    img = cv2.imread(str(tmp_path / "map.png"), cv2.IMREAD_UNCHANGED)
    assert img.shape == (480, 640, 3) and img.dtype == np.uint8
    for colour in (viz.GRAY, viz.BIRD, viz.BLUE, viz.CYAN, viz.RED):
        assert np.all(img == colour, -1).any(), colour
    np.testing.assert_array_equal(imageio.imread(tmp_path / "map.png"), img)
    t = np.linspace(0, 6, 50)
    est = np.c_[np.cos(t), np.sin(t), t]
    viz.plot_trajectories(est, est * 1.01, str(tmp_path / "traj.png"))
    img = cv2.imread(str(tmp_path / "traj.png"))
    assert img.shape == (480, 640, 3)
    assert np.all(img == viz.BLUE, -1).any() and np.all(img == viz.RED,
                                                        -1).any()


# ---------------------------------------------------------------------------
# ROS adapter
# ---------------------------------------------------------------------------

def test_decode_image_msg_equals_jax(rng):
    cases = {
        "mono8": rng.integers(0, 256, (5, 7), dtype=np.uint8),
        "8uc1": rng.integers(0, 256, (5, 7), dtype=np.uint8),
        "mono16": rng.integers(0, 65536, (5, 7), dtype=np.uint16),
        "16uc1": rng.integers(0, 65536, (5, 7), dtype=np.uint16),
        "bgr8": rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
        "rgb8": rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
        "32fc1": rng.uniform(0, 5, (5, 7)).astype(np.float32),
    }
    for enc, arr in cases.items():
        msg = rt.FakeImageMsg(arr, enc)
        got, want = ra.decode_image_msg(msg), jra.decode_image_msg(msg)
        assert got.dtype == want.dtype and got.shape == want.shape, enc
        np.testing.assert_array_equal(got, want, err_msg=enc)
    with pytest.raises(ValueError):
        ra.decode_image_msg(rt.FakeImageMsg(cases["mono8"], "yuv422"))


class BirdRecordingSystem(rt.RecordingSystem):
    def track_monocular_with_birdview(self, img, bird, mask, stamp):
        self.calls.append(("bird", img.shape, bird.shape,
                           None if mask is None else mask.shape, stamp))
        return self._fd()


def rotated_fd():
    th = 0.3
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, [1.0, 2.0, 3.0]
    return types.SimpleNamespace(pose_ok=True, Tcw=lambda: T)


def test_run_ros1_wiring_equals_jax():
    """Every node type through both adapters' `run_ros1` with the fake ROS
    modules: the same subscriptions, the same calls, the same poses."""
    img = rt.FakeImageMsg(np.zeros((48, 64), np.uint8), "mono8", stamp=2.5)
    depth = rt.FakeImageMsg(np.full((48, 64), 5000, np.uint16), "16uc1",
                            stamp=2.5)
    cases = [("MonoNode", "/cam", (img,)),
             ("StereoNode", ("/l", "/r"), (img, img)),
             ("RGBDNode", ("/rgb", "/depth"), (img, depth)),
             ("BirdviewNode", ("/front", "/bird"), (img, img)),
             ("BirdviewNode", ("/front", "/bird", "/mask"), (img, img, img))]
    for node_name, topics, msgs in cases:
        out = {}
        for mod in (ra, jra):
            ros = rt.make_fake_ros()
            system = BirdRecordingSystem()
            system._fd = rotated_fd
            pub = mod.run_ros1(getattr(mod, node_name)(system), topics,
                               ros=ros, spin=False)
            if node_name == "MonoNode":
                assert [t for t, _ in ros.rospy.subs] == [topics]
                ros.rospy.subs[0][1](*msgs)
            else:
                sync = rt.FakeSynchronizer.last
                assert [s.topic for s in sync.subs] == list(topics)
                sync.cb(*msgs)
            (msg,) = pub.msgs
            p, o = msg.pose.position, msg.pose.orientation
            out[mod] = (system.calls, [p.x, p.y, p.z], [o.w, o.x, o.y, o.z])
        assert out[ra][0] == out[jra][0], node_name
        np.testing.assert_allclose(out[ra][1], out[jra][1], atol=1e-6)
        np.testing.assert_allclose(out[ra][2], out[jra][2], atol=1e-6)


def test_stereo_node_rectifies():
    """StereoNode with a config path rectifies raw pairs before tracking
    (tests/test_datasets.py::test_stereo_node_rectifies on the port)."""
    calls = {}

    class FakeSystem:
        def track_stereo(self, left, right, stamp):
            calls["shapes"] = (left.shape, right.shape)
            calls["vals"] = (float(left[240, 376]), float(right[240, 376]))
            return types.SimpleNamespace(pose_ok=False)

    node = ra.StereoNode(FakeSystem(), config_path=str(
        REPO / "configs" / "euroc_stereo.yaml"))
    assert node.rectifier is not None
    node.callback(np.full((480, 752), 100, np.float32),
                  np.full((480, 752), 50, np.float32), 0.0)
    assert calls["shapes"] == ((480, 752), (480, 752))
    assert abs(calls["vals"][0] - 100.0) < 1e-3
    assert abs(calls["vals"][1] - 50.0) < 1e-3


# ---------------------------------------------------------------------------
# live viewer
# ---------------------------------------------------------------------------

def _request(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_live_viewer_endpoints_on_an_unfed_system(tmp_path):
    system = System(SlamConfig(camera=PinholeCamera(**CAM)),
                    enable_loop_closing=False, device="cpu")
    viewer = LiveViewer(system, port=0).start()
    try:
        st, body = _request(viewer.url)
        assert st == 200 and b"Follow Camera" in body
        st, body = _request(viewer.url + "state")
        snap = json.loads(body)
        assert st == 200 and snap["n_kf"] == 0 and snap["n_mp"] == 0
        assert snap["state"] == system.peek_tracking_state()
        # no client has asked for a frame yet: update_frame encodes nothing
        viewer.update_frame(np.zeros((120, 160), np.float32))
        assert _request(viewer.url + "frame")[0] == 404
        # a fetch marks the viewer active; the next update serves a PNG
        img = np.tile(np.arange(160, dtype=np.float32), (120, 1))
        viewer.update_frame(img)
        st, body = _request(viewer.url + "frame")
        assert st == 200 and body[:4] == b"\x89PNG"
        png = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(png, viz.gray_to_bgr(img))
        assert _request(viewer.url + "nowhere")[0] == 404
        st, body = _request(viewer.url + "cmd?action=localization_on",
                            "POST")
        assert st == 200 and json.loads(body)["ok"]
        assert json.loads(_request(viewer.url + "state")[1])["localization"]
        assert _request(viewer.url + "cmd?action=reset", "POST")[0] == 200
        assert system._reset_requested
        assert _request(viewer.url + "cmd?action=nonsense", "POST")[0] == 400
        assert _request(viewer.url + "elsewhere", "POST")[0] == 404
    finally:
        viewer.stop()
