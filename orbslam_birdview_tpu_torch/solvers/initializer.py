"""Monocular two-view initialization with optional BEV metric scale.

Fits H and F by batched RANSAC, selects by RH = SH/(SH+SF) > 0.40,
recovers motion and triangulates.

The fork's metric-scale path: 2D ICP on matched BEV ground points; reject
if the ICP translation is < 0.3 m; add the ICP rotation (lifted to the
camera frame via Tcb · T12b · Tbc) as an extra motion hypothesis; and
rescale the essential-matrix unit translation by projecting it onto the
metric ICP translation, t = (t̂ · t_icp) t̂.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import lie
from . import icp, ransac, twoview


class InitResult(NamedTuple):
    ok: torch.Tensor          # scalar bool
    used_homography: torch.Tensor
    R21: torch.Tensor         # (3,3) cam1→cam2
    t21: torch.Tensor         # (3,)
    points3d: torch.Tensor    # (N,3) in cam-1 frame
    good: torch.Tensor        # (N,) triangulated-ok mask
    bird_inliers: torch.Tensor  # (Nb,) BEV ICP inlier mask (empty if unused)
    icp_ok: torch.Tensor


class InitDraws(NamedTuple):
    """The three hypothesis-set draws of one initialization attempt."""

    homography: torch.Tensor   # (n_hyp, 4) int32
    fundamental: torch.Tensor  # (n_hyp, 8) int32
    icp: torch.Tensor          # (n_hyp, 2) int32


def draw_init(generator: torch.Generator, n_hyp: int, device) -> InitDraws:
    """One attempt's draws, taken from the generator in the order H, F,
    ICP."""
    return InitDraws(ransac.draw(generator, n_hyp, 4, device),
                     ransac.draw(generator, n_hyp, 8, device),
                     ransac.draw(generator, n_hyp, 2, device))


def initialize_two_view(
    source,
    xy1,
    xy2,
    match_valid,
    K,
    sigma: float = 1.0,
    bird_xy1=None,
    bird_xy2=None,
    bird_valid=None,
    bird_sigma: float = 0.07,
    R_bc=None,
    t_bc=None,
    min_icp_translation: float = 0.3,
    n_hyp: int = 256,
    min_parallax: float = 1.0,
    min_triangulated: int = 50,
    device=None,
) -> InitResult:
    """xy1/xy2: (N,2) matched undistorted pixels of frames 1,2 (padded);
    bird_xy1/2: (Nb,2+) matched BEV ground points in the vehicle base frame
    (meters). R_bc/t_bc: camera→base extrinsics. `source` is a
    `torch.Generator` or the attempt's `InitDraws`."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    xy1, xy2, K = f32(xy1), f32(xy2), f32(K)
    match_valid = torch.as_tensor(match_valid, dtype=torch.bool, device=dev)
    if isinstance(source, torch.Generator):
        source = draw_init(source, n_hyp, dev)
    fitH = twoview.fit_homography_ransac(source.homography, xy1, xy2,
                                         match_valid, sigma, n_hyp, device=dev)
    fitF = twoview.fit_fundamental_ransac(source.fundamental, xy1, xy2,
                                          match_valid, sigma, n_hyp,
                                          device=dev)

    SH, SF = fitH.score, fitF.score
    rh = SH / torch.clamp(SH + SF, min=1e-9)
    use_H = rh > 0.40

    RsH, tsH = twoview.motion_hypotheses_from_H(fitH.model, K)
    RsF, tsF = twoview.motion_hypotheses_from_F(fitF.model, K)
    # pad F hypotheses (4) to match H count (8) so the selected branch is
    # fixed-shape; pad with degenerate identity/zero-baseline poses that can
    # never triangulate (duplicating real ones would break the uniqueness
    # check in select_motion).
    RsF = torch.cat([RsF, torch.eye(3, device=dev).expand(4, 3, 3)], dim=0)
    tsF = torch.cat([tsF, torch.zeros((4, 3), device=dev)], dim=0)

    have_bird = bird_xy1 is not None
    icp_ok = torch.zeros((), dtype=torch.bool, device=dev)
    bird_inl = torch.zeros(bird_xy1.shape[0] if have_bird else 0,
                           dtype=torch.bool, device=dev)
    t_icp_cam = torch.zeros(3, device=dev)
    if have_bird:
        bird_xy1, bird_xy2, R_bc, t_bc = (f32(bird_xy1), f32(bird_xy2),
                                          f32(R_bc), f32(t_bc))
        bird_valid = torch.as_tensor(bird_valid, dtype=torch.bool, device=dev)
        res = icp.icp2d_ransac(source.icp, bird_xy1[:, :2], bird_xy2[:, :2],
                               bird_valid, bird_sigma, n_hyp=n_hyp,
                               min_inliers=10, device=dev)
        # ICP gives base-frame T12b (frame-2 ground points into frame 1);
        # camera-frame relative motion T21c = Tcb * T21b * Tbc with
        # T21b = inv(T12b).
        R12b, t12b = icp.rt2d_to_se3(res.R, res.t)
        R21b, t21b = lie.se3_inv(R12b, t12b)
        R_cb, t_cb = lie.se3_inv(R_bc, t_bc)
        Rtmp, ttmp = lie.se3_mul(R_cb, t_cb, R21b, t21b)
        R21c, t21c = lie.se3_mul(Rtmp, ttmp, R_bc, t_bc)
        trans_norm = torch.linalg.vector_norm(res.t)
        icp_ok = res.ok & (trans_norm >= min_icp_translation)
        bird_inl = res.inliers & icp_ok
        t_icp_cam = t21c
        # extra hypotheses: ICP rotation with ± unit ICP translation, in
        # rows 6 and 7
        t_unit = t21c / torch.clamp(torch.linalg.vector_norm(t21c), min=1e-9)
        RsF = torch.cat([RsF[:6], torch.stack([R21c, R21c])], dim=0)
        tsF = torch.cat([tsF[:6], torch.stack([t_unit, -t_unit])], dim=0)

    Rs = torch.where(use_H, RsH, RsF)
    ts = torch.where(use_H, tsH, tsF)
    model_inliers = torch.where(use_H, fitH.inliers, fitF.inliers)

    ok, R, t, X, good = twoview.select_motion(
        Rs, ts, xy1, xy2, model_inliers, K, sigma,
        min_parallax=min_parallax, min_triangulated=min_triangulated)

    if have_bird:
        # metric rescale: project the unit translation onto the metric ICP
        # translation
        t_hat = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-9)
        scale = torch.dot(t_hat, t_icp_cam)
        t = torch.where(icp_ok, t_hat * scale, t)
        X = torch.where(icp_ok, X * scale.abs(), X)
        ok = ok & icp_ok

        # ICP-pose fallback: the standard selection demands parallax and a
        # unique hypothesis, which fails for low-parallax ground-vehicle
        # motion (forward motion, far scene). The BEV ICP provides a full
        # METRIC relative pose (planar motion assumption); it is scored
        # directly and accepted when the model selection is indecisive.
        R_icp = RsF[6]
        n_icp, _, X_icp, good_icp = twoview.check_rt(
            R_icp, t_icp_cam, xy1, xy2, model_inliers, K, sigma)
        n_inl = model_inliers.sum(dtype=torch.int32)
        icp_accept = (icp_ok & (n_icp >= min_triangulated)
                      & (n_icp >= (0.5 * n_inl).to(torch.int32)))
        use_fallback = icp_accept & ~ok
        R = torch.where(use_fallback, R_icp, R)
        t = torch.where(use_fallback, t_icp_cam, t)  # already metric
        X = torch.where(use_fallback, X_icp, X)
        good = torch.where(use_fallback, good_icp, good)
        ok = ok | icp_accept

    return InitResult(ok, use_H, R, t, X, good, bird_inl, icp_ok)


def fetch_result(res: InitResult) -> InitResult:
    """The whole result on the host, as numpy, in ONE device-to-host
    transfer: the fields ride one flat f32 buffer (the masks and flags are
    exact in f32)."""
    flat = torch.cat([f.reshape(-1).to(torch.float32) for f in res]).cpu()
    out, at = [], 0
    for f in res:
        part = flat[at: at + f.numel()].reshape(f.shape).numpy()
        at += f.numel()
        out.append(part.astype(bool) if f.dtype == torch.bool else part)
    return InitResult(*out)
