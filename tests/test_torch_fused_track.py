"""The whole fused tracking step, JAX package against the port, on rendered
`BirdSequence` frames with a ground-truth-seeded bundle carried across by
`pipeline/state.py`.

Small sizes: front 160×224 on 4 levels with 300 features, BEV 128×128 on 4
levels with 300 features, P=512 and Pb=384 (P ≥ K, the reference's
contract for `resolve_duplicate_targets`).

Budgets, and why: the pyramid resize rounds about 1 pixel in 10^4 the
other way at these shapes (see test_torch_orb.py), which can reorder two
near-equal keypoints or move one, and the LM sums in another order. So
poses agree to 2e-3 (rotation entries, translation in m), counts to ±2,
and the per-keypoint / per-candidate vectors on all but 2% of entries.
The depth branches (a depth map; a right image extracted and matched in
the step) also give each keypoint's depth and right-image u: within 1e-4
relative on all but 2% of the keypoints.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.core import camera as jcam
from orbslam_birdview_tpu.frontend import orb as jorb
from orbslam_birdview_tpu.pipeline import fused_track as jft
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera, PinholeCamera
from orbslam_birdview_tpu_torch.pipeline import fused_track as tft
from orbslam_birdview_tpu_torch.pipeline import state
from orbslam_birdview_tpu_torch.utils import synth

W, H = 224, 160
CAM = PinholeCamera(fx=348.5 * W / 950, fy=347.0 * W / 950,
                    cx=480.0 * W / 950, cy=302.0 * W / 950, width=W, height=H)
P, PB = 512, 384
POSE_TOL, COUNT_TOL, VEC_BUDGET = 2e-3, 2, 0.02
DEPTH_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jbv = jcam.BirdviewCamera(width=128, height=128)
    seq = synth.BirdSequence(CAM, BirdviewCamera(width=128, height=128),
                             n_frames=4)
    frames = [seq.frame(i) for i in range(4)]
    mask = synth.footprint_mask(seq.bv)
    jcfg = jorb.ORBConfig(n_features=300, n_levels=4, min_threshold=5.0)
    jbcfg = jorb.ORBConfig(n_features=300, n_levels=4)
    img0, bev0, _ = frames[0]
    kp = synth.keypoints_numpy(jorb.extract_orb(jnp.asarray(img0), jcfg))
    bkp = synth.keypoints_numpy(jorb.extract_orb(jnp.asarray(bev0), jbcfg,
                                                 mask=jnp.asarray(mask)))
    lm, bird = synth.seed_fields(seq, 0, kp, bkp, jcfg.n_levels,
                                 jcfg.scale_factor, P, PB)
    sf = np.array([1.2 ** l for l in range(4)], np.float32)
    isig = (1.0 / sf ** 2).astype(np.float32)
    jlm = jft.LocalMapDevice(**{k: jnp.asarray(v) for k, v in lm.items()})
    jblm = jft.BirdMapDevice(**{k: jnp.asarray(v) for k, v in bird.items()})
    # the port's state is carried across from the reference's, as numpy
    st = state.carry_across(
        {k: np.asarray(v) for k, v in jlm._asdict().items()}, sf, isig,
        jcfg._asdict(), bird_lm={k: np.asarray(v)
                                 for k, v in jblm._asdict().items()},
        bird_cfg=jbcfg._asdict(), bv=jbv._asdict(), R_bc=seq.R_bc,
        t_bc=seq.t_bc, device="cpu")
    ref = dict(lm=jlm, sf=jnp.asarray(sf), isig=jnp.asarray(isig), cfg=jcfg,
               bird=dict(bird_lm=jblm, bird_cfg=jbcfg, bv=jbv,
                         R_bc=jnp.asarray(seq.R_bc), t_bc=jnp.asarray(seq.t_bc),
                         bird_mask=jnp.asarray(mask)))
    return seq, frames, mask, ref, st


def _ref_step(ref, img, bev, R_pred, t_pred, R_last, t_last, bird):
    kw = dict(bird_img=jnp.asarray(bev), **ref["bird"]) if bird else {}
    return jft.track_step_mono(
        jnp.asarray(img), jnp.asarray(R_pred), jnp.asarray(t_pred), ref["lm"],
        ref["sf"], ref["isig"], ref["cfg"], CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        W, H, R_last=jnp.asarray(R_last), t_last=jnp.asarray(t_last), **kw)


def _port_step(st, mask, img, bev, R_pred, t_pred, R_last, t_last, bird):
    kw = {}
    if bird:
        kw = dict(bird_img=bev, bird_mask=mask, bird_lm=st.bird_lm,
                  bird_cfg=st.bird_cfg, bv=st.bv, R_bc=st.R_bc, t_bc=st.t_bc)
    t = lambda x: torch.as_tensor(np.asarray(x))
    return tft.track_step_mono(
        img, t(R_pred), t(t_pred), st.lm, st.scale_factors, st.inv_sigma2,
        st.cfg, CAM.fx, CAM.fy, CAM.cx, CAM.cy, W, H, R_last=t(R_last),
        t_last=t(t_last), device="cpu", **kw)


def _agree(a, b, budget=VEC_BUDGET):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert (a != b).mean() <= budget, (a != b).mean()


def _compare(ref, out, bird):
    sr, so = (tft.unpack_summary(np.asarray(ref.summary)),
              tft.unpack_summary(out.summary.numpy()))
    np.testing.assert_allclose(so["R"], sr["R"], atol=POSE_TOL)
    np.testing.assert_allclose(so["t"], sr["t"], atol=POSE_TOL)
    for k in ("n_inliers", "n_matched", "n_inliers_bird", "n_kp"):
        assert abs(so[k] - sr[k]) <= COUNT_TOL, (k, so[k], sr[k])
    _agree(out.kp_slot.numpy(), ref.kp_slot)
    _agree(out.vis_acc.numpy(), ref.vis_acc)
    _agree(out.found_acc.numpy(), ref.found_acc)
    np.testing.assert_allclose(out.R_pred_next.numpy(),
                               np.asarray(ref.R_pred_next), atol=POSE_TOL)
    np.testing.assert_allclose(out.t_pred_next.numpy(),
                               np.asarray(ref.t_pred_next), atol=POSE_TOL)
    if bird:
        _agree(out.bird_slot.numpy(), ref.bird_slot)
        assert sr["n_inliers_bird"] > 30
    assert sr["n_inliers"] > 30
    return sr


@pytest.mark.parametrize("bird", [False, True], ids=["mono", "mono_bird"])
def test_fused_step_parity(setup, bird):
    seq, frames, mask, ref, st = setup
    img, bev, (R_gt, t_gt) = frames[1]
    R0, t0 = frames[0][2]
    jout = _ref_step(ref, img, bev, R0, t0, R0, t0, bird)
    tout = _port_step(st, mask, img, bev, R0, t0, R0, t0, bird)
    sr = _compare(jout, tout, bird)
    # the step found frame 1's pose from frame 0's
    np.testing.assert_allclose(sr["t"], t_gt, atol=0.02)


def test_fused_chain_three_frames(setup):
    """Frames 1..3, each package chained on its own R_pred_next/t_pred_next;
    the chains agree frame by frame."""
    seq, frames, mask, ref, st = setup
    R_last, t_last = frames[0][2]
    jp = (R_last, t_last)
    tp = (torch.as_tensor(R_last), torch.as_tensor(t_last))
    jl, tl = jp, tp
    for i in (1, 2, 3):
        img, bev, (R_gt, t_gt) = frames[i]
        jout = _ref_step(ref, img, bev, *jp, *jl, True)
        tout = _port_step(st, mask, img, bev, *tp, *tl, True)
        sr = _compare(jout, tout, True)
        np.testing.assert_allclose(sr["t"], t_gt, atol=0.02)
        jl, tl = (jout.R, jout.t), (tout.R, tout.t)
        jp = (jout.R_pred_next, jout.t_pred_next)
        tp = (tout.R_pred_next, tout.t_pred_next)


def _depth_inputs(seq, i, baseline):
    """Frame i's exact depth map (the box room ray-cast under the ground
    truth; camera z, since the rays have unit z) and the right view of a
    camera `baseline` metres to the right."""
    R_cw, t_cw = (np.asarray(a, np.float64) for a in seq.gt_cam_pose(i))
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    t, _ = synth.cast_box_rays(-R_cw.T @ t_cw,
                               synth._camera_rays(CAM, R_cw, us, vs),
                               seq.wall_x)
    depth = np.where(np.isfinite(t), t, 0.0).astype(np.float32)
    right = synth.render_box_view(CAM, seq.wall, R_cw,
                                  t_cw - np.array([baseline, 0.0, 0.0]),
                                  box_half=seq.wall_x)
    return depth, right


def test_depth_modes_wait_for_slice_4(setup):
    """The step's RGB-D and stereo branches (the depth modes) against the
    JAX package's: the pose as in the mono step; per-keypoint depth and
    right-image u within DEPTH_RTOL on all but VEC_BUDGET of the keypoints
    (the extractors' rounding can move a keypoint onto another depth
    pixel or another stereo match)."""
    seq, frames, mask, ref, st = setup
    img, _, (R_gt, t_gt) = frames[1]
    R0, t0 = frames[0][2]
    bf = CAM.fx * 0.5
    depth, right = _depth_inputs(seq, 1, 0.5)
    t = lambda x: torch.as_tensor(np.asarray(x))
    for kw in (dict(depth_map=depth), dict(img_right=right)):
        jout = jft.track_step_mono(
            jnp.asarray(img), jnp.asarray(R0), jnp.asarray(t0), ref["lm"],
            ref["sf"], ref["isig"], ref["cfg"], CAM.fx, CAM.fy, CAM.cx,
            CAM.cy, W, H, R_last=jnp.asarray(R0), t_last=jnp.asarray(t0),
            bf=bf, **{k: jnp.asarray(v) for k, v in kw.items()})
        tout = tft.track_step_mono(
            img, t(R0), t(t0), st.lm, st.scale_factors, st.inv_sigma2,
            st.cfg, CAM.fx, CAM.fy, CAM.cx, CAM.cy, W, H, R_last=t(R0),
            t_last=t(t0), bf=bf, device="cpu", **kw)
        sr = _compare(jout, tout, False)
        np.testing.assert_allclose(sr["t"], t_gt, atol=0.02)
        for name in ("kp_depth", "kp_ur"):
            a, b = getattr(tout, name).numpy(), np.asarray(getattr(jout,
                                                                   name))
            close = np.isclose(a, b, rtol=DEPTH_RTOL, atol=0)
            assert (~close).mean() <= VEC_BUDGET, (name, (~close).mean())
        d = np.asarray(jout.kp_depth)
        assert (d > 0).sum() > (200 if "depth_map" in kw else 50)
