"""The fused per-frame tracking step.

The OK-state frame path of the reference (`Tracking::TrackWithMotionModel`
+ `Tracking::TrackLocalMap`) as one function of tensors on one device:

  extract ORB → project local-map candidates under the motion-model pose →
  match (narrow, widen if <20) → motion-only LM → re-project under the
  refined pose → tight re-match → final LM with chi² reclassification

The (P × K) Hamming matrix is computed once per frame; every matching
stage is a masked min-reduction over it. With the bird arguments the step
also extracts BEV ORB, matches the ground-landmark bundle by projection
under each pose estimate, and adds bird point-to-point edges to both pose
optimizations. The step issues no host sync: the host reads the 16-float
`summary` when it wants it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..frontend import matcher, orb, stereo
from ..frontend.keypoints import Keypoints, unpack_bits_to_pm1
from ..graph import pose_opt
from . import device_ops


class LocalMapDevice(NamedTuple):
    """Padded device snapshot of the local-map candidates (front camera)."""

    pos: torch.Tensor        # (P,3) f32 world positions
    normal: torch.Tensor     # (P,3) f32 viewing normals
    min_dist: torch.Tensor   # (P,) f32 scale-band lower
    max_dist: torch.Tensor   # (P,) f32 scale-band upper
    valid: torch.Tensor      # (P,) bool
    desc_u8: torch.Tensor    # (P,32) u8 — unpacked to ±1 on the device

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


class BirdMapDevice(NamedTuple):
    """Padded device snapshot of BEV ground landmarks."""

    pos: torch.Tensor        # (Pb,3) f32 world positions
    valid: torch.Tensor      # (Pb,) bool
    desc_u8: torch.Tensor    # (Pb,32) u8

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


class FusedOutput(NamedTuple):
    kp: Keypoints                # full frame keypoints
    summary: torch.Tensor        # (16,) f32, layout below
    R: torch.Tensor = None       # (3,3) final pose
    t: torch.Tensor = None       # (3,)
    R_pred_next: torch.Tensor = None  # (3,3) motion-model prediction for t+1
    t_pred_next: torch.Tensor = None  # (3,)
    kp_slot: torch.Tensor = None      # (K,) int32 candidate slot, -1 = none
    vis_acc: torch.Tensor = None      # (P,) int32 running visible counters
    found_acc: torch.Tensor = None    # (P,) int32 running found counters
    bird_kp: Optional[Keypoints] = None
    bird_base_xyz: Optional[torch.Tensor] = None  # (Kb,3) base-frame points
    bird_slot: Optional[torch.Tensor] = None      # (Kb,) int32 bird slot
    kp_depth: Optional[torch.Tensor] = None       # (K,) f32 depth or -1
    kp_ur: Optional[torch.Tensor] = None          # (K,) f32 right u or -1

    # summary layout (f32):
    # [0:9] R row-major, [9:12] t, [12] n_inliers_front, [13] n_matched,
    # [14] n_inliers_bird, [15] n_kp


def _match_stage(ham, uv, ok, radius, pred_oct, kp_xy, kp_octave,
                 max_dist: int):
    """One masked min-reduction matching pass over the shared Hamming
    matrix (the window/eligibility mask is the only thing that varies)."""
    d2 = torch.sum((uv[:, None, :] - kp_xy[None, :, :]) ** 2, dim=-1)
    mask = ok[:, None] & (d2 <= (radius[:, None] ** 2))
    if pred_oct is not None:
        mask = mask & ((kp_octave[None, :] - pred_oct[:, None]).abs() <= 1)
    dist = torch.where(mask, ham, matcher.BIG_DIST)
    best, idx = matcher._packed_min(dist, axis=1)
    idx = torch.where(best <= max_dist, idx, matcher.INVALID)
    return matcher.resolve_duplicate_targets(idx, best, n_tgt=kp_xy.shape[0])


def _rematch_keep(idx_new, idx_old, keep_old, ham):
    """Stage-2 associations: the new match where there is one, else the
    stage-1 inlier; duplicates resolved by distance (`TrackLocalMap` only
    adds matches on top of the motion-model set)."""
    idx = torch.where(idx_new >= 0, idx_new,
                      torch.where(keep_old, idx_old, matcher.INVALID))
    score = (torch.where(idx >= 0, 0, matcher.BIG_DIST)
             + torch.gather(ham, 1, idx.clamp(min=0).long()[:, None])[:, 0])
    return matcher.resolve_duplicate_targets(idx, score, n_tgt=ham.shape[1])


def _slots(final, idx, K: int):
    """target -> source slot for the final associations; (K,) int32, -1 for
    none. Sources that are not final write into a K-th slot that is cut."""
    slot = torch.full((K + 1,), -1, dtype=torch.int32, device=idx.device)
    src = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    slot = slot.scatter(0, torch.where(final, idx, K).long(), src)
    return slot[:K]


def _over(num: float, x):
    """num / x as one f32 division (`num / x` on a tensor multiplies by
    the reciprocal, which rounds differently)."""
    return torch.full_like(x, num) / x


def _device_tensors(dev, *xs):
    return [None if x is None else torch.as_tensor(x, device=dev) for x in xs]


def track_step_mono(
    img,
    R_pred,
    t_pred,
    lm: LocalMapDevice,
    scale_factors,     # (L,) f32
    inv_sigma2,        # (L,) f32 = 1/level_sigma2
    cfg: orb.ORBConfig,
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    radius_mult_motion: float = 6.0,   # motion_search_radius / 2.5
    radius_mult_local: float = 1.2,    # local_search_radius / 2.5
    min_widen: int = 20,
    R_last=None,
    t_last=None,
    vis_acc=None,      # (P,) int32 running visible counters
    found_acc=None,    # (P,) int32 running found counters
    # ---- optional birdview stream (the fork's signature mode) ----------
    bird_img=None,     # (Hb,Wb) BEV image
    bird_mask=None,    # (Hb,Wb) f32 validity mask or None
    bird_lm: Optional[BirdMapDevice] = None,
    bird_cfg: Optional[orb.ORBConfig] = None,
    bv=None,           # BirdviewCamera
    R_bc=None, t_bc=None,    # (3,3),(3,) camera->base extrinsics
    bird_radius: float = 15.0,   # BEV search window (px)
    bird_info: float = 400.0,    # info weight per bird edge (1/sigma_m^2)
    # ---- depth modes ---------------------------------------------------
    depth_map=None,    # (H,W) RGB-D depth in metres (<= 0 invalid)
    img_right=None,    # (H,W) right stereo image
    bf: float = 0.0,   # stereo baseline·fx
    device=None,
) -> FusedOutput:
    """One fused tracking step on `device` (`cuda` unless given). When
    (R_last, t_last) are given, the step also emits the motion-model
    prediction for the NEXT frame (vel·T_cur with vel = T_cur·T_last⁻¹), so
    consecutive frames chain on the device with no host round trip.

    With `depth_map` the keypoints' depth is sampled from it at the rounded
    keypoint (round half to even); with `img_right` the right image is
    extracted in the step and row-matched against the tracking keypoints.
    Either way `kp_depth` / `kp_ur` stay on the device."""
    dev = resolve_device(device)
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    (R_pred, t_pred, scale_factors, inv_sigma2, R_last, t_last, vis_acc,
     found_acc) = _device_tensors(dev, R_pred, t_pred, scale_factors,
                                  inv_sigma2, R_last, t_last, vis_acc,
                                  found_acc)
    lm = LocalMapDevice(*_device_tensors(dev, *lm))

    kp = orb.extract_orb(img, cfg, device=dev)
    depth_out = {}
    if depth_map is not None:
        # RGB-D: nearest-sample the depth image at the keypoints
        # (`Frame::ComputeStereoFromRGBD`)
        dm = torch.as_tensor(depth_map, device=dev).to(torch.float32)
        H_, W_ = dm.shape
        xi = torch.round(kp.xy[:, 0]).long().clamp(0, W_ - 1)
        yi = torch.round(kp.xy[:, 1]).long().clamp(0, H_ - 1)
        d = dm[yi, xi]
        d = torch.where((d > 0) & kp.valid, d, -1.0)
        ur = torch.where(d > 0, kp.xy[:, 0] - _over(bf, d.clamp(min=1e-9)),
                         -1.0)
        depth_out = dict(kp_depth=d, kp_ur=ur)
    elif img_right is not None:
        # stereo: extract the right image in the step and match the
        # tracking keypoints against it (`Frame::ComputeStereoMatches`);
        # an 8-bit image is uploaded as it is and widened on the device
        img_right = torch.as_tensor(img_right, device=dev).to(torch.float32)
        kr = orb.extract_orb(img_right, cfg, device=dev)
        sidx, sdisp = stereo.stereo_match(kp, kr)
        sidx, sdisp, s_ur = stereo.refine_stereo_subpixel(
            img, img_right, kp, kr, sidx, sdisp)
        d = torch.where(sdisp > 0, _over(bf, sdisp.clamp(min=1e-6)), -1.0)
        depth_out = dict(kp_depth=d,
                         kp_ur=torch.where(sdisp > 0, s_ur, -1.0))
    P = lm.capacity
    K = kp.capacity
    n_levels = scale_factors.shape[0]
    log_scale = (torch.log(scale_factors[1]) if n_levels > 1
                 else torch.tensor(0.18, dtype=torch.float32, device=dev))

    ham = matcher.hamming_matrix(unpack_bits_to_pm1(lm.desc_u8), kp.desc_pm1,
                                 lm.valid, kp.valid)

    def gate(R, t):
        return device_ops.frustum_gate(
            R, t, lm.pos, lm.normal, lm.min_dist, lm.max_dist, lm.valid,
            fx, fy, cx, cy, width, height, n_levels, log_scale)

    # ---- birdview stream setup -----------------------------------------
    have_bird = bird_img is not None and bird_lm is not None
    bird_args1 = bird_args2 = {}
    if have_bird:
        bird_img = torch.as_tensor(bird_img, dtype=torch.float32, device=dev)
        if bird_mask is not None:
            bird_mask = torch.as_tensor(bird_mask, dtype=torch.float32,
                                        device=dev)
        R_bc, t_bc = _device_tensors(dev, R_bc, t_bc)
        bird_lm = BirdMapDevice(*_device_tensors(dev, *bird_lm))
        bkp = orb.extract_orb(bird_img, bird_cfg, mask=bird_mask, device=dev)
        base_xy = bv.pixel_to_base_xy(bkp.xy)
        base_xyz = torch.cat([base_xy, torch.zeros_like(base_xy[:, :1])], -1)
        R_cb = R_bc.T
        t_cb = -R_cb @ t_bc
        obs_pc = base_xyz @ R_cb.T + t_cb    # camera-frame observations
        bham = matcher.hamming_matrix(unpack_bits_to_pm1(bird_lm.desc_u8),
                                      bkp.desc_pm1, bird_lm.valid, bkp.valid)
        Pb = bird_lm.capacity
        rad_b = torch.full((Pb,), bird_radius, dtype=torch.float32, device=dev)
        info_b = torch.full((Pb,), bird_info, dtype=torch.float32, device=dev)

        def bird_match(R, t):
            # world -> vehicle base of the current pose: Tbc · Tcw
            Rbw = R_bc @ R
            tbw = R_bc @ t + t_bc
            pb = bird_lm.pos @ Rbw.T + tbw
            on_plane = pb[:, 2].abs() < 0.2
            buv = bv.base_xy_to_pixel(pb[:, :2])
            bok = on_plane & bv.in_image(buv) & bird_lm.valid
            return _match_stage(bham, buv, bok, rad_b, None,
                                bkp.xy, bkp.octave, matcher.TH_HIGH)

        def bird_lm_args(bidx):
            return dict(Xw_bird=bird_lm.pos,
                        obs_pc_bird=obs_pc[bidx.clamp(min=0).long()],
                        info_bird=info_b, valid_bird=bidx >= 0)

        bidx1 = bird_match(R_pred, t_pred)
        bird_args1 = bird_lm_args(bidx1)

    # ---- stage 1: motion-model match (narrow, widen when starved) ------
    uv1, oct1, radf1, ok1 = gate(R_pred, t_pred)
    sf1 = scale_factors[oct1.clamp(0, n_levels - 1).long()]
    r_narrow = radf1 * radius_mult_motion * sf1
    idx_n = _match_stage(ham, uv1, ok1, r_narrow, oct1, kp.xy, kp.octave,
                         matcher.TH_HIGH)
    n_narrow = (idx_n >= 0).sum(dtype=torch.int32)
    idx_w = _match_stage(ham, uv1, ok1, r_narrow * 2.0, oct1, kp.xy,
                         kp.octave, matcher.TH_HIGH)
    idx1 = torch.where(n_narrow >= min_widen, idx_n, idx_w)

    def info_of(idx):
        octv = kp.octave[idx.clamp(min=0).long()]
        return inv_sigma2[octv.clamp(0, n_levels - 1).long()]

    obs1 = kp.xy[idx1.clamp(min=0).long()]
    res1 = pose_opt.optimize_pose(
        R_pred, t_pred, lm.pos, obs1, info_of(idx1), idx1 >= 0,
        fx, fy, cx, cy, rounds=2, **bird_args1)

    # ---- stage 2: local-map re-match under the refined pose -------------
    uv2, oct2, radf2, ok2 = gate(res1.R, res1.t)
    sf2 = scale_factors[oct2.clamp(0, n_levels - 1).long()]
    r2 = radf2 * radius_mult_local * sf2
    idx2 = _match_stage(ham, uv2, ok2, r2, oct2, kp.xy, kp.octave,
                        matcher.TH_HIGH)
    idx2 = _rematch_keep(idx2, idx1, res1.inliers_mono, ham)
    obs2 = kp.xy[idx2.clamp(min=0).long()]
    if have_bird:
        bidx2 = _rematch_keep(bird_match(res1.R, res1.t), bidx1,
                              res1.inliers_bird, bham)
        bird_args2 = bird_lm_args(bidx2)
    res2 = pose_opt.optimize_pose(
        res1.R, res1.t, lm.pos, obs2, info_of(idx2), idx2 >= 0,
        fx, fy, cx, cy, rounds=4, **bird_args2)

    final_inl = res2.inliers_mono & (idx2 >= 0)
    visible = ok1 | ok2
    n_inl = final_inl.sum(dtype=torch.int32)
    n_matched = (idx2 >= 0).sum(dtype=torch.int32)
    kp_slot = _slots(final_inl, idx2, K)

    n_inl_bird = torch.zeros((), dtype=torch.float32, device=dev)
    bird_out = {}
    if have_bird:
        bfinal = res2.inliers_bird & bird_args2["valid_bird"]
        n_inl_bird = bfinal.sum(dtype=torch.int32).to(torch.float32)
        bird_out = dict(bird_kp=bkp, bird_base_xyz=base_xyz,
                        bird_slot=_slots(bfinal, bidx2, bkp.capacity))

    if vis_acc is None:
        vis_acc = torch.zeros((P,), dtype=torch.int32, device=dev)
    if found_acc is None:
        found_acc = torch.zeros((P,), dtype=torch.int32, device=dev)
    vis_acc = vis_acc + visible.to(torch.int32)
    found_acc = found_acc + final_inl.to(torch.int32)
    summary = torch.cat([
        res2.R.reshape(-1), res2.t,
        torch.stack([n_inl.to(torch.float32), n_matched.to(torch.float32),
                     n_inl_bird, kp.count().to(torch.float32)]),
    ])
    R_np, t_np = None, None
    if R_last is not None:
        # vel = T_cur · T_last⁻¹;  T_pred(next) = vel · T_cur
        Rv = res2.R @ R_last.T
        tv = res2.t - Rv @ t_last
        R_np = Rv @ res2.R
        t_np = Rv @ res2.t + tv
        # chained f32 rotation products drift off the manifold; two Newton
        # steps of the polar decomposition R ← 1.5R − 0.5·R·RᵀR restore it
        for _ in range(2):
            R_np = 1.5 * R_np - 0.5 * R_np @ (R_np.T @ R_np)
    return FusedOutput(kp=kp, summary=summary, R=res2.R, t=res2.t,
                       R_pred_next=R_np, t_pred_next=t_np,
                       kp_slot=kp_slot, vis_acc=vis_acc,
                       found_acc=found_acc, **bird_out, **depth_out)


def unpack_summary(summary_np):
    """Host-side view of the per-frame summary vector."""
    return dict(
        R=summary_np[0:9].reshape(3, 3).astype("float32"),
        t=summary_np[9:12].astype("float32"),
        n_inliers=int(summary_np[12]),
        n_matched=int(summary_np[13]),
        n_inliers_bird=int(summary_np[14]),
        n_kp=int(summary_np[15]),
    )
