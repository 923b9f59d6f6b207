"""The port's dataset CLI (`cli/run_slam.py`) on the CPU over small
dataset layouts written with the port's PNG writer: an 8-frame 320×240
TUM RGB-D layout (3-channel gray PNGs, 16-bit depth at factor 5000,
depth stamps 5 ms after the colour ones) and a 3-frame KITTI stereo one.

- The CLI adds nothing between the loader and `System`: its trajectory
  file equals, byte for byte, that of a port `System` fed the loader's
  records directly; the keyframe file, the overlays and map PNGs of
  `--viz-every` and the live viewer come along.
- `--max-frames` stops the run; KITTI datasets are saved in the KITTI
  format (12 numbers a line); `--profile-trace` writes a Chrome trace.
- Slow: the JAX package's `run_slam` over the same TUM layout, with the
  camera poses held to tests/test_torch_depth_modes.py's whole-run
  tolerance (`torch_midrun.RUN_TOL`, 2e-3 m and rotation entries).
"""
import json
import os

import numpy as np
import pytest

import torch_midrun as mid
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.cli import datasets, eval_traj, run_slam
from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
from orbslam_birdview_tpu_torch.utils import imageio, synth

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
BASELINE = 0.08
N_FRAMES = 8
T0 = 1305031102.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


def write_config(path, features=500):
    """ORB-SLAM2-style YAML of the drive; ThDepth puts the close-point
    depth at 40 m, as torch_midrun's depth configurations."""
    path.write_text(
        "%YAML:1.0\n" + "".join(f"Camera.{k}: {float(v)}\n"
                                for k, v in CAM.items())
        + f"Camera.bf: {CAM['fx'] * BASELINE}\nThDepth: {40.0 / BASELINE}\n"
        f"DepthMapFactor: 5000.0\nORBextractor.nFeatures: {features}\n")
    return str(path)


def gray8(img):
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    """TUM RGB-D layout of the wall drive; returns (root, config, ground
    truth TUM file)."""
    root = tmp_path_factory.mktemp("tum")
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    seq = synth.WallSequence(PinholeCamera(**CAM), n_frames=N_FRAMES,
                             step=0.03)
    rgb, depth, gt = ["# color images"], ["# depth maps"], []
    for i in range(N_FRAMES):
        img, (R, t) = seq.frame(i)
        ts = T0 + i / 30.0
        g = gray8(img)
        imageio.imwrite(root / "rgb" / f"{ts:.6f}.png",
                        np.repeat(g[..., None], 3, -1))
        d = np.rint(seq.depth(i) * 5000.0).astype(np.uint16)
        imageio.imwrite(root / "depth" / f"{ts + 0.005:.6f}.png", d)
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth.append(f"{ts + 0.005:.6f} depth/{ts + 0.005:.6f}.png")
        c = -R.T @ t
        gt.append(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} 0 0 0 1")
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(depth) + "\n")
    (root / "gt.txt").write_text("\n".join(gt) + "\n")
    return str(root), write_config(root / "cfg.yaml"), str(root / "gt.txt")


@pytest.fixture(scope="module")
def tum_cli_run(tum, tmp_path_factory):
    root, cfg, _ = tum
    out = tmp_path_factory.mktemp("cli")
    run_slam.main(["--dataset", "tum_rgbd", "--root", root, "--config", cfg,
                   "--out", str(out / "traj.txt"), "--out-kf",
                   str(out / "kf.txt"), "--no-loop-closing", "--timing",
                   "--viz-every", "4", "--viz-dir", str(out / "viz"),
                   "--live-viewer", "0", "--device", "cpu"])
    return out


def test_cli_trajectory_equals_system_fed_directly(tum, tum_cli_run):
    root, cfg_path, gt = tum
    cfg = SlamConfig.from_yaml(cfg_path, sensor="rgbd")
    system = System(cfg, enable_loop_closing=False, device="cpu")
    records = list(datasets.load_tum_rgbd(root,
                                          depth_factor=cfg.depth_map_factor))
    assert len(records) == N_FRAMES
    for rec in records:
        system.track_rgbd(rec.img, rec.depth, rec.timestamp)
    direct = tum_cli_run / "direct.txt"
    system.save_trajectory_tum(str(direct))
    got = (tum_cli_run / "traj.txt").read_text()
    assert got == direct.read_text()
    assert len(got.splitlines()) == N_FRAMES
    # the depth initialization makes the map metric: no scale alignment
    m = eval_traj.evaluate(gt, str(tum_cli_run / "traj.txt"))
    assert m["n_pairs"] == N_FRAMES and m["ate_rmse"] < 0.03


def test_cli_writes_keyframes_and_viz(tum_cli_run):
    kf = np.loadtxt(tum_cli_run / "kf.txt", ndmin=2)
    assert kf.shape[1] == 8 and len(kf) >= 1
    names = sorted(os.listdir(tum_cli_run / "viz"))
    assert names == ["frame_000004.png", "frame_000008.png",
                     "map_000004.png", "map_000008.png"]
    for name in names:
        img = imageio.imread(tum_cli_run / "viz" / name)
        assert img.shape == (240, 320, 3) if name.startswith("frame") \
            else img.shape == (480, 640, 3)


def test_cli_kitti_format_and_max_frames(tmp_path):
    """kitti_stereo over a 3-frame layout, stopped after 2 frames (1000
    features: the stereo initialization needs 500 with depth), under
    `--profile-trace`."""
    for d in ("image_0", "image_1"):
        os.makedirs(tmp_path / d)
    seq = synth.WallSequence(PinholeCamera(**CAM), n_frames=3, step=0.03)
    for i in range(3):
        img, (R, t) = seq.frame(i)
        right = synth.render_wall_view(
            seq.cam, seq.tex, R.astype(np.float64),
            t.astype(np.float64) - np.array([BASELINE, 0.0, 0.0]),
            seq.wall_z)
        imageio.imwrite(tmp_path / "image_0" / f"{i:06d}.png", gray8(img))
        imageio.imwrite(tmp_path / "image_1" / f"{i:06d}.png", gray8(right))
    (tmp_path / "times.txt").write_text(
        "".join(f"{i * 0.1038947:e}\n" for i in range(3)))
    out = tmp_path / "kitti.txt"
    run_slam.main(["--dataset", "kitti_stereo", "--root", str(tmp_path),
                   "--config", write_config(tmp_path / "cfg.yaml", 1000),
                   "--out", str(out), "--max-frames", "2",
                   "--no-loop-closing", "--device", "cpu",
                   "--profile-trace", str(tmp_path / "trace")])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape == (2, 12)
    np.testing.assert_allclose(rows[0].reshape(3, 4), np.eye(4)[:3],
                               atol=1e-6)     # the first frame is the origin


@pytest.mark.slow
def test_cli_poses_equal_jax_cli(tum, tum_cli_run, tmp_path):
    """Both packages' run_slam over the same layout (loop closing off):
    the same frames tracked, camera centres and rotations within
    RUN_TOL."""
    from orbslam_birdview_tpu.cli import run_slam as jrun_slam

    root, cfg, _ = tum
    jax_out = tmp_path / "jax.txt"
    jrun_slam.main(["--dataset", "tum_rgbd", "--root", root, "--config", cfg,
                    "--out", str(jax_out), "--no-loop-closing"])
    got = np.loadtxt(tum_cli_run / "traj.txt", ndmin=2)
    want = np.loadtxt(jax_out, ndmin=2)
    assert got.shape == want.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], atol=mid.RUN_TOL)
    sign = np.sign((got[:, 4:] * want[:, 4:]).sum(1))[:, None]
    np.testing.assert_allclose(got[:, 4:] * sign, want[:, 4:],
                               atol=mid.RUN_TOL)
