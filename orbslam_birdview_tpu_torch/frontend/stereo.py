"""Stereo depth from row-constrained descriptor matching.

The reference's `Frame::ComputeStereoMatches` as tensor ops: both images'
ORB features are matched through one dense masked Hamming matrix (row band
and disparity range), then every match is refined at once — an 11×11 SAD
sweep over ±5 px with a parabola through the best three costs — and the
median-SAD outlier cut drops the worst refinements.

Parity with the JAX package: the matches are integer-exact; the SAD sweep
is one gather of all keypoints' patches and strips (the JAX package maps
`dynamic_slice` over keypoints), with the same clamped corners, so on
integer-valued images every cost is the same f32 integer; the median is
the midpoint one of `jnp.nanmedian` (`torch.nanmedian` takes the lower
middle value); minima go to the first index.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import matcher, orb


def stereo_match(kp_l, kp_r, max_row_diff: float = 2.0,
                 min_disp: float = 0.1, max_disp: float = 128.0):
    """Match left keypoints to right keypoints on (nearly) the same image
    row with positive disparity and octaves at most one apart. Returns
    (idx_r (Kl,) int32, disparity (Kl,) f32), −1 where unmatched."""
    dist = matcher.hamming_matrix(kp_l.desc_pm1, kp_r.desc_pm1,
                                  kp_l.valid, kp_r.valid)
    dv = (kp_l.xy[:, None, 1] - kp_r.xy[None, :, 1]).abs()
    disp = kp_l.xy[:, None, 0] - kp_r.xy[None, :, 0]
    lvl_ok = (kp_l.octave[:, None] - kp_r.octave[None, :]).abs() <= 1
    ok = ((dv <= max_row_diff) & (disp >= min_disp) & (disp <= max_disp)
          & lvl_ok)
    dist = torch.where(ok, dist, matcher.BIG_DIST)
    idx, _ = matcher.match_mutual(dist, max_dist=matcher.TH_HIGH, ratio=1.0)
    m = idx >= 0
    d = kp_l.xy[:, 0] - kp_r.xy[idx.clamp(min=0).long(), 0]
    return torch.where(m, idx, -1), torch.where(m, d, -1.0)


def _first_argmin(x):
    """Index of the FIRST minimum along the last axis (`jnp.argmin`'s tie
    rule), the same on every device."""
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    hit = x == x.min(dim=-1, keepdim=True).values
    return torch.where(hit, iota, n).min(dim=-1).values


def subpixel_disparity(img_l, img_r, xy_l, ur0, valid, w: int = 5, L: int = 5):
    """Batched SAD sliding-window subpixel refinement.

    For every left keypoint, its (2w+1)² patch (minus its centre value) is
    compared with 2L+1 horizontally shifted right-image windows around the
    integer match `ur0` (each minus its own centre value); a parabola
    through the best SAD and its neighbours gives the subpixel shift.
    Returns (refined uR (K,), SAD at the best shift (K,), ok (K,) bool)."""
    img_l = img_l.to(torch.float32)
    img_r = img_r.to(torch.float32)
    H, W = img_l.shape
    P = 2 * w + 1
    S = P + 2 * L  # right strip width
    dev = img_l.device

    ul = torch.round(xy_l[:, 0]).to(torch.int64)
    vl = torch.round(xy_l[:, 1]).to(torch.int64)
    ur = torch.round(ur0).to(torch.int64)
    # in-bounds guards (the reference `continue`s)
    ok = (valid & (ul - w >= 0) & (ul + w < W) & (vl - w >= 0) & (vl + w < H)
          & (ur - w - L >= 0) & (ur + w + L < W))
    ul_c = ul.clamp(w, W - w - 1)
    vl_c = vl.clamp(w, H - w - 1)
    ur_c = ur.clamp(w + L, W - w - L - 1)

    # one gather: patch rows and columns as index offsets from the corners
    rows = (vl_c - w)[:, None, None] + torch.arange(P, device=dev)[None, :,
                                                                  None]
    cols_l = (ul_c - w)[:, None, None] + torch.arange(P, device=dev)
    cols_r = (ur_c - w - L)[:, None, None] + torch.arange(S, device=dev)
    patch_l = img_l[rows, cols_l]                        # (K,P,P)
    patch_l = patch_l - patch_l[:, w, w][:, None, None]
    strip = img_r[rows, cols_r]                          # (K,P,S)
    wins = strip.unfold(2, P, 1).permute(0, 2, 1, 3)     # (K,2L+1,P,P)
    wins = wins - wins[:, :, w, w][:, :, None, None]
    dists = (wins - patch_l[:, None]).abs().sum(dim=(2, 3))   # (K,2L+1)

    best = _first_argmin(dists)
    interior = (best > 0) & (best < 2 * L)           # reject endpoint minima
    b = best.clamp(1, 2 * L - 1)
    d1 = dists.gather(1, (b - 1)[:, None])[:, 0]
    d2 = dists.gather(1, b[:, None])[:, 0]
    d3 = dists.gather(1, (b + 1)[:, None])[:, 0]
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(denom.abs() > 1e-6, (d1 - d3) / (2.0 * denom),
                        torch.zeros_like(denom))
    ok = ok & interior & (delta >= -1.0) & (delta <= 1.0)
    uR = ur_c.to(torch.float32) + (b - L).to(torch.float32) + delta
    return uR, d2, ok


def nanmedian_midpoint(x):
    """Median of the non-NaN entries of a 1-D tensor, the mean of the two
    middle values for an even count (`jnp.nanmedian`); NaN when there are
    none. Computed on x's device, with no host sync."""
    s = torch.sort(x).values                         # NaNs sort last
    n = (~torch.isnan(x)).sum()
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    return (s[lo] + s[hi]) * 0.5


def refine_stereo_subpixel(img_l, img_r, kp_l, kp_r, idx, disp,
                           min_disp: float = 0.01, max_disp: float = 128.0):
    """Subpixel refinement and the reference's median-SAD outlier cut on the
    integer stereo matches. Where a refinement fails but the descriptor
    match stands, the integer disparity is kept. Returns refined (idx,
    disparity, uR), −1 where unmatched."""
    m = idx >= 0
    ur0 = kp_r.xy[idx.clamp(min=0).long(), 0]
    uR, sad, ok = subpixel_disparity(img_l, img_r, kp_l.xy, ur0, m)
    d = kp_l.xy[:, 0] - uR
    ok = ok & (d >= min_disp) & (d < max_disp)
    # median-SAD cut: drop matches with SAD > 1.5·1.4·median
    med = nanmedian_midpoint(torch.where(ok, sad, torch.nan))
    ok = ok & (sad <= 1.5 * 1.4 * med)
    keep = m & (ok | (disp > 0))
    d_out = torch.where(ok, d, disp)
    return (torch.where(keep, idx, -1),
            torch.where(keep, d_out, -1.0),
            torch.where(keep, kp_l.xy[:, 0] - d_out, -1.0))


def stereo_depth_for_frame(img_left, img_right, cfg, device=None):
    """The slow path's dense depth map (H,W) f32 numpy, 0 where unset:
    depth = bf / disparity splatted at the left keypoints (truncated to
    whole pixels), to be sampled at the keypoints of the frame later."""
    dev = resolve_device(device)
    left = torch.as_tensor(np.asarray(img_left), device=dev).to(torch.float32)
    right = torch.as_tensor(np.asarray(img_right),
                            device=dev).to(torch.float32)
    kl = orb.extract_orb(left, cfg.orb, device=dev)
    kr = orb.extract_orb(right, cfg.orb, device=dev)
    idx, disp = stereo_match(kl, kr)
    idx, disp, _ = refine_stereo_subpixel(left, right, kl, kr, idx, disp)
    # one transfer for what the host splat reads
    flat = torch.cat([disp[:, None], kl.xy,
                      kl.valid[:, None].to(torch.float32)], 1).cpu().numpy()
    disp, xy, valid = flat[:, 0], flat[:, 1:3], flat[:, 3] > 0.5
    H, W = np.asarray(img_left).shape[:2]
    depth = np.zeros((H, W), np.float32)
    ok = (disp > 0) & valid
    xi = np.clip(xy[ok, 0].astype(int), 0, W - 1)
    yi = np.clip(xy[ok, 1].astype(int), 0, H - 1)
    depth[yi, xi] = cfg.camera.bf / np.maximum(disp[ok], 1e-6)
    return depth
