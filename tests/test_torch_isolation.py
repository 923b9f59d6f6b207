"""The port stands alone: it imports without JAX, the JAX package,
OpenCV or matplotlib, importing builds nothing, and its entry points
refuse to run without a GPU unless asked for the CPU.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import orbslam_birdview_tpu_torch as port
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera, PinholeCamera
from orbslam_birdview_tpu_torch.frontend import orb
from orbslam_birdview_tpu_torch.pipeline import fused_track, state
from orbslam_birdview_tpu_torch.utils import synth

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "orbslam_birdview_tpu_torch",
    "orbslam_birdview_tpu_torch.core.lie",
    "orbslam_birdview_tpu_torch.core.linalg",
    "orbslam_birdview_tpu_torch.core.robust",
    "orbslam_birdview_tpu_torch.core.camera",
    "orbslam_birdview_tpu_torch.frontend.keypoints",
    "orbslam_birdview_tpu_torch.frontend.patch_kernel",
    "orbslam_birdview_tpu_torch.frontend.detect_kernel",
    "orbslam_birdview_tpu_torch.frontend.orb",
    "orbslam_birdview_tpu_torch.frontend.matcher",
    "orbslam_birdview_tpu_torch.frontend.stereo",
    "orbslam_birdview_tpu_torch.graph.residuals",
    "orbslam_birdview_tpu_torch.graph.pose_opt",
    "orbslam_birdview_tpu_torch.graph.ba",
    "orbslam_birdview_tpu_torch.graph.ba_large",
    "orbslam_birdview_tpu_torch.graph.segsum",
    "orbslam_birdview_tpu_torch.graph.pose_graph",
    "orbslam_birdview_tpu_torch.graph.sim3_opt",
    "orbslam_birdview_tpu_torch.solvers.ransac",
    "orbslam_birdview_tpu_torch.solvers.icp",
    "orbslam_birdview_tpu_torch.solvers.twoview",
    "orbslam_birdview_tpu_torch.solvers.initializer",
    "orbslam_birdview_tpu_torch.solvers.epnp",
    "orbslam_birdview_tpu_torch.solvers.pnp",
    "orbslam_birdview_tpu_torch.solvers.sim3",
    "orbslam_birdview_tpu_torch.mapping.mapstore",
    "orbslam_birdview_tpu_torch.mapping.vocab",
    "orbslam_birdview_tpu_torch.mapping.kfdb",
    "orbslam_birdview_tpu_torch.api",
    "orbslam_birdview_tpu_torch.api.config",
    "orbslam_birdview_tpu_torch.api.system",
    "orbslam_birdview_tpu_torch.pipeline.device_ops",
    "orbslam_birdview_tpu_torch.pipeline.fused_track",
    "orbslam_birdview_tpu_torch.pipeline.frame",
    "orbslam_birdview_tpu_torch.pipeline.local_mapping",
    "orbslam_birdview_tpu_torch.pipeline.loop_closing",
    "orbslam_birdview_tpu_torch.pipeline.tracking",
    "orbslam_birdview_tpu_torch.pipeline.state",
    "orbslam_birdview_tpu_torch.utils.synth",
    "orbslam_birdview_tpu_torch.utils.build",
    "orbslam_birdview_tpu_torch.utils.profiling",
    "orbslam_birdview_tpu_torch.utils.async_fetch",
    # the outer surface: image files, loaders, scorer, runners, viewers
    "orbslam_birdview_tpu_torch.utils.imageio",
    "orbslam_birdview_tpu_torch.utils.native_loader",
    "orbslam_birdview_tpu_torch.utils.viz",
    "orbslam_birdview_tpu_torch.utils.ar",
    "orbslam_birdview_tpu_torch.utils.live_viewer",
    "orbslam_birdview_tpu_torch.api.ros_adapter",
    "orbslam_birdview_tpu_torch.cli.datasets",
    "orbslam_birdview_tpu_torch.cli.eval_traj",
    "orbslam_birdview_tpu_torch.cli.run_synthetic",
    "orbslam_birdview_tpu_torch.cli.run_slam",
    # the multi-device layer
    "orbslam_birdview_tpu_torch.parallel",
    "orbslam_birdview_tpu_torch.parallel.runtime",
    "orbslam_birdview_tpu_torch.parallel.sharded_ba",
    "orbslam_birdview_tpu_torch.parallel.sharded_pose_graph",
    "orbslam_birdview_tpu_torch.parallel.dryrun",
    "chip_smoke",
]


def test_imports_without_jax_reference_or_cv2(tmp_path):
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "orbslam_birdview_tpu", "cv2",
                     "matplotlib"):
            sys.modules[name] = None      # any import of these now fails
        for name in {MODULES!r}:
            importlib.import_module(name)
        from orbslam_birdview_tpu_torch.utils import build
        assert build.LOADED == {{}}, build.LOADED
        assert str(build.BUILD_DIR).startswith({str(tmp_path)!r})
        assert not build.LAUNCHES, build.LAUNCHES
        assert not any(m.split(".")[0] in ("jax", "orbslam_birdview_tpu",
                                           "cv2", "matplotlib")
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    # no compiler on the PATH, and a build directory of its own that must
    # not come to exist (the checkout's is shared with the tests that build
    # the JPEG decoder meanwhile)
    build_dir = tmp_path / "build"
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=str(REPO),
               ORBSLAM_TORCH_BUILD_DIR=str(build_dir))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert not build_dir.exists()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")


def test_resolve_device():
    assert port.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.resolve_device()
        with pytest.raises(RuntimeError):
            port.resolve_device("cuda")


def test_entry_points_raise_without_gpu():
    _no_gpu()
    img = np.zeros((64, 96), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orb.extract_orb(img)
    lm = state.local_map_device(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(4),
                                np.zeros(4), np.zeros(4, bool),
                                np.zeros((4, 32), np.uint8), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_track.track_step_mono(img, torch.eye(3), torch.zeros(3), lm,
                                    torch.ones(2), torch.ones(2),
                                    orb.ORBConfig(), 50.0, 50.0, 48.0, 32.0,
                                    96, 64)
    with pytest.raises(RuntimeError):
        state.local_map_device(*lm)


def test_system_and_pnp_raise_without_gpu():
    _no_gpu()
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.api.system import System
    from orbslam_birdview_tpu_torch.solvers import pnp

    for loop_closing in (True, False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            System(SlamConfig(), enable_loop_closing=loop_closing)
    X = np.zeros((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnp.pnp_ransac(torch.Generator(), X, X[:, :2], np.ones(8, bool),
                       np.ones(8, np.float32))
    assert System(SlamConfig(), enable_loop_closing=False,
                  device="cpu").tracker.device.type == "cpu"
    # loop closing is on by default, with the port's own vocabulary
    system = System(SlamConfig(), device="cpu")
    lc = system.loop_closer
    assert lc is system.mapper.loop_closer is system.tracker.loop_closer
    assert lc.device.type == "cpu" and lc.voc.n_words == 100000
    assert lc.kfdb is not None


def test_cli_raises_without_gpu(tmp_path):
    """run_slam and run_synthetic run on cuda unless --device cpu is
    given."""
    _no_gpu()
    from orbslam_birdview_tpu_torch.cli import run_slam, run_synthetic

    (tmp_path / "rgb.txt").write_text("")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_slam.main(["--dataset", "tum_mono", "--root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_synthetic.main(["--mode", "mono", "--frames", "2"])


def test_chip_smoke_refuses_without_gpu():
    _no_gpu()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_extract_orb_on_cpu_when_asked():
    img = np.round(synth.make_texture(2, size=256, n_blobs=200)[:96, :128])
    kp = orb.extract_orb(img, orb.ORBConfig(n_features=100, n_levels=2),
                         device="cpu")
    assert kp.xy.device.type == "cpu" and kp.capacity == 128
    assert int(kp.count()) > 20


def test_seeded_bundle_reprojects_onto_its_keypoints():
    cam = PinholeCamera(fx=82.2, fy=81.8, cx=113.2, cy=71.2, width=224,
                        height=160)
    bv = BirdviewCamera(width=128, height=128)
    seq = synth.BirdSequence(cam, bv, n_frames=2)
    img, bev, (R, t) = seq.frame(0)
    kp = synth.keypoints_numpy(orb.extract_orb(
        img, orb.ORBConfig(n_features=200, n_levels=3), device="cpu"))
    bkp = synth.keypoints_numpy(orb.extract_orb(
        bev, orb.ORBConfig(n_features=200, n_levels=3),
        mask=synth.footprint_mask(bv), device="cpu"))
    lm, bird = synth.seed_fields(seq, 0, kp, bkp, 3, 1.2, 256, 256)
    n = int(lm["valid"].sum())
    assert n == int(kp["valid"].sum())
    Xc = lm["pos"][:n] @ R.T + t
    uv = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                   cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)
    np.testing.assert_allclose(uv, kp["xy"][kp["valid"]], atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(lm["normal"][:n], axis=1), 1.0,
                               atol=1e-5)
    assert (lm["min_dist"][:n] < lm["max_dist"][:n]).all()
    nb = int(bird["valid"].sum())
    assert nb == int(bkp["valid"].sum()) and (bird["pos"][:nb, 2] == 0).all()
    # the ground points seen from the vehicle's base frame land on their
    # BEV keypoints again
    R_wb, t_wb = seq.gt_base_pose(0)
    base = (bird["pos"][:nb] - t_wb) @ R_wb
    uvb = bv.base_xy_to_pixel(torch.from_numpy(base[:, :2])).numpy()
    np.testing.assert_allclose(uvb, bkp["xy"][bkp["valid"]], atol=1e-3)


def test_every_module_of_the_port_is_listed():
    """A module added to the package must be added to MODULES, so that the
    isolation test imports it (empty `__init__.py` files aside)."""
    found = set()
    for path in (REPO / "orbslam_birdview_tpu_torch").rglob("*.py"):
        rel = path.relative_to(REPO).with_suffix("")
        if rel.name == "__init__":
            if path.stat().st_size == 0:
                continue
            rel = rel.parent
        found.add(".".join(rel.parts))
    assert not found - set(MODULES), sorted(found - set(MODULES))
