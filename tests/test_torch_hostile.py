"""tests/test_hostile.py on the port: the port's `System` on the CPU
through each stressor class of `utils/synth.degrade` — photometric noise +
exposure drift, motion blur, dynamic occluders, and a blackout with
relocalization recovery — held to the same bars (tracked share, ATE with
scale alignment, LOST and recovered).

Marked slow: each test runs 100-130 frames through the port's `System` on
the CPU, minutes in all, which the tier-1 run has no room for; the JAX
package's own hostile tests stay in tier 1.
"""
import numpy as np
import pytest

import torch_midrun as mid
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.pipeline.tracking import LOST, OK
from orbslam_birdview_tpu_torch.utils.synth import (WallSequence, ate_rmse,
                                                    degrade)

pytestmark = pytest.mark.slow

CAM = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                    width=320, height=240)
N = 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


def _run(stressor, n=N, min_tracked=0.8, max_ate=0.05):
    cfg = SlamConfig(camera=CAM, orb=ORBConfig(n_features=600),
                     sensor="mono")
    seq = WallSequence(CAM, n_frames=n, wall_z=4.0, step=0.02, push=0.002)
    rng = np.random.default_rng(7)
    sys_ = System(cfg, device="cpu")
    gt = []
    for i in range(n):
        img, pose = seq.frame(i)
        img = degrade(img, i, rng, **stressor(i))
        sys_.track_monocular(np.clip(img, 0, 255).astype(np.uint8), i / 30.0)
        gt.append(pose)
    sys_._flush()
    est, gtp = [], []
    for (ts, Tcw), (R_cw, t_cw) in zip(sys_._frame_poses(), gt):
        if Tcw is None:
            continue
        est.append(-Tcw[:3, :3].T @ Tcw[:3, 3])
        gtp.append(-R_cw.T @ t_cw)
    assert len(est) >= min_tracked * n, \
        f"only {len(est)}/{n} frames tracked"
    ate = ate_rmse(np.array(est), np.array(gtp), with_scale=True)
    # trajectory spans ~2 m; degraded runs must stay a small fraction of it
    assert ate < max_ate, f"ATE {ate:.3f} m under stress"
    return sys_


def test_noise_and_exposure_drift():
    """Sensor noise + ±30% auto-exposure swing: stresses the FAST
    threshold fallback and BRIEF bit stability."""
    _run(lambda i: dict(noise_std=8.0, exposure_amp=0.3,
                        exposure_period=60), max_ate=0.05)


def test_motion_blur():
    """7-px horizontal box blur (fast pan): corner responses flatten and
    descriptors lose high-frequency bits."""
    _run(lambda i: dict(blur_px=7))


def test_dynamic_occluders():
    """Two textureless rectangles sweeping the view: landmarks vanish
    behind them and spurious corners appear at their edges (the JAX
    package's bar of 0.08 m, 4% of the 2 m trajectory span)."""
    _run(lambda i: dict(occluders=2, occluder_size=90), max_ate=0.08)


def test_blackout_relocalization():
    """10 black frames mid-run: tracking must go LOST, then relocalize
    against the keyframe database when imagery returns — the failure
    detection + recovery protocol end to end."""
    cfg = SlamConfig(camera=CAM, orb=ORBConfig(n_features=600),
                     sensor="mono")
    n = 130
    seq = WallSequence(CAM, n_frames=n, wall_z=4.0, step=0.02, push=0.002)
    rng = np.random.default_rng(7)
    sys_ = System(cfg, device="cpu")
    went_lost = False
    for i in range(n):
        if 80 <= i < 90:
            img = np.zeros((CAM.height, CAM.width), np.float32)
        else:
            img, _ = seq.frame(min(i, 85) if i >= 90 else i)
            # after the blackout, revisit an already-mapped pose so the
            # KFDB query has a true match
            img = degrade(img, i, rng, noise_std=3.0)
        sys_.track_monocular(np.clip(img, 0, 255).astype(np.uint8), i / 30.0)
        if 82 <= i < 90:
            sys_._flush()
            if sys_.peek_tracking_state() == LOST:
                went_lost = True
    sys_._flush()
    assert went_lost, "blackout did not trigger LOST"
    assert sys_.peek_tracking_state() == OK, \
        "no relocalization after blackout"
