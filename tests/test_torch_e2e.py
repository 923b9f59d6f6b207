"""The mono, mono+bird, stereo and RGB-D tests of `tests/test_e2e.py`, the
circular loop closure of `tests/test_loop_closing.py` and the two budget
tests of `tests/test_reference_budget.py` on the port, on the CPU, with
their own configurations and bars, on the port's own renders and with loop
closing on, as the reference's tests run. The e2e and circle functions run
on the card in `chip_smoke.py`'s e2e phase. Marked slow, as the
reference's tests are.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.slow
def test_monocular_wall_sequence():
    rec = smoke.e2e_monocular_wall_sequence(CPU)
    assert rec["tracked"] >= 24 and rec["ate_m"] < 0.02


@pytest.mark.slow
def test_birdview_metric_scale():
    rec = smoke.e2e_birdview_metric_scale(CPU)
    assert rec["ate_m"] < 0.05 and abs(rec["scale_ratio"] - 1.0) < 0.02


@pytest.mark.slow
def test_reset_and_localization_mode():
    assert smoke.e2e_reset_and_localization_mode(CPU)[
        "keyframes_before_reset"] >= 2


@pytest.mark.slow
def test_trajectory_savers(tmp_path):
    assert smoke.e2e_trajectory_savers(CPU, tmp_path)["tum_lines"] >= 10


@pytest.mark.slow
def test_rgbd_wall_sequence():
    rec = smoke.e2e_rgbd_wall_sequence(CPU)
    assert rec["tracked"] >= 20 and rec["ate_m"] < 0.03


@pytest.mark.slow
def test_stereo_wall_sequence():
    rec = smoke.e2e_stereo_wall_sequence(CPU)
    assert rec["tracked"] >= 14 and rec["ate_m"] < 0.03


@pytest.mark.slow
def test_localization_mode_vo_fallback():
    rec = smoke.e2e_localization_mode_vo_fallback(CPU)
    assert rec["tracked"] >= rec["of"] - 2 and rec["ate_m"] < 0.05
    assert rec["kp_vo_set"]


@pytest.mark.slow
def test_relocalization_after_lost():
    rec = smoke.e2e_relocalization_after_lost(CPU)
    assert rec["recovered"] and rec["centre_diff_m"] < 0.02


@pytest.mark.slow
def test_circular_loop_closure():
    rec = smoke.e2e_circular_loop_closure(CPU)
    assert rec["loops_closed"] >= 1 and rec["ate_m"] < 0.05


CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.slow
def test_kitti_mono_config_runs_at_budget():
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.api.system import System
    from orbslam_birdview_tpu_torch.pipeline.tracking import OK
    from orbslam_birdview_tpu_torch.utils.synth import WallSequence

    cfg = SlamConfig.from_yaml(str(CONFIGS / "kitti00-02_mono.yaml"),
                               sensor="mono")
    assert cfg.orb.n_features == 2000
    system = System(cfg, device="cpu")
    assert system.store.kp_cap >= 2000
    seq = WallSequence(cfg.camera, n_frames=16, wall_z=12.0, step=0.25,
                       push=0.02)
    for i in range(16):
        img, _ = seq.frame(i)
        system.track_monocular(np.clip(img, 0, 255).astype(np.uint8),
                               i / 10.0)
    system._flush()
    assert system.tracker.state == OK
    assert system.n_keyframes() >= 2
    used = system.store.kf_kp_valid[: system.store.n_kf].sum(1)
    assert used.max() > 1024, f"max keypoints/KF {used.max()}"


@pytest.mark.slow
def test_fisheye_birdview_config_runs_at_budget():
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.api.system import System
    from orbslam_birdview_tpu_torch.core import lie
    from orbslam_birdview_tpu_torch.core.camera import (BirdviewCamera,
                                                        PinholeCamera)
    from orbslam_birdview_tpu_torch.pipeline.tracking import OK
    from orbslam_birdview_tpu_torch.utils.synth import BirdSequence

    cfg = SlamConfig.from_yaml(str(CONFIGS / "fisheye_birdview.yaml"),
                               sensor="mono_bird")
    assert cfg.orb.n_features == 2000
    bv = BirdviewCamera(width=384, height=384)
    cfg.birdview = bv
    cfg.camera = PinholeCamera(fx=348.5, fy=347.0, cx=240.0, cy=151.0,
                               width=480, height=300)
    seq = BirdSequence(cfg.camera, bv, n_frames=14, speed=0.06,
                       yaw_rate=0.002)
    cfg.tbc_quat = tuple(lie.rot_to_quat(torch.as_tensor(seq.R_bc)).tolist())
    cfg.tbc_t = tuple(seq.t_bc.tolist())
    system = System(cfg, device="cpu")
    assert system.store.kp_cap >= 2000 and system.store.bird_cap >= 2000
    for i in range(14):
        img, bev, _ = seq.frame(i)
        system.track_monocular_with_birdview(
            np.clip(img, 0, 255).astype(np.uint8),
            np.clip(bev, 0, 255).astype(np.uint8), None, i / 25.0)
    system._flush()
    assert system.tracker.state == OK
    assert system.n_keyframes() >= 2
    assert system.store.n_bmp > 0, "no BEV landmarks minted"
