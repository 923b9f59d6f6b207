"""A frame's pose, tracked plainly from the frame's images and the local
map the program tracked it against, in the precision it is handed.

The specification (ORB-SLAM2's TrackWithMotionModel and TrackLocalMap,
with the fork's BEV edges, as the program defines them):
1. ORB on the front image (and on the BEV image, inside its mask).
2. Every map point in the frustum of the predicted pose (in front by more
   than 5 cm, inside the image, 0.8-1.2 times its scale band, seen within
   60 degrees of its normal) is matched to the keypoint of the fewest
   descriptor bits apart (ties to the first keypoint) within its window
   (radius 2.5 px, or 4 px off-axis, times the search factor times the
   predicted level's scale) on a level at most one from the predicted one,
   if at most 100 bits apart; a keypoint claimed twice keeps the closer
   point (ties to the first). With fewer than 20 matches the window is
   doubled. BEV landmarks on the ground (|z| < 0.2 m in the vehicle's
   frame) match BEV keypoints within 15 px in the same way.
3. The pose is optimised over those matches (2 rounds), then every point
   is matched again in the refined pose's frustum with the local search
   factor, keeping a first-stage inlier where a point finds no match, and
   the pose optimised again (4 rounds).
4. The pose optimisation: Levenberg-Marquardt over the pose's twist with
   reprojection edges (information 1/σ² of the keypoint's level) and BEV
   point-to-point edges in the camera's frame (information 400); 10
   iterations a round, Huber kernels (5.991 / 7.815) in the first two
   rounds, every edge reclassified by its χ² after each round.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import orb, se3

TH_HIGH = 100
BIG = 1 << 14
CHI2_MONO = 5.991
CHI2_BIRD = 7.815


class Rig(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    n_levels: int
    scale_factor: float


class Bev(NamedTuple):
    pixel2meter: float
    rear_axle_to_center: float
    width: int
    height: int

    def to_base(self, uv):
        return torch.stack([
            (self.height / 2 - uv[:, 1]) * self.pixel2meter
            + self.rear_axle_to_center,
            (self.width / 2 - uv[:, 0]) * self.pixel2meter], -1)

    def to_pixel(self, xy):
        return torch.stack([
            self.width / 2 - xy[:, 1] / self.pixel2meter,
            self.height / 2 - (xy[:, 0] - self.rear_axle_to_center)
            / self.pixel2meter], -1)


def hamming(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(A, B) bits apart of two sets of 256-bit descriptors."""
    pa = bits_a.to(torch.float64) * 2 - 1
    pb = bits_b.to(torch.float64) * 2 - 1
    return ((256 - pa @ pb.T) / 2).round().long()


def first_min(d: torch.Tensor):
    """(min, index of its first occurrence) of each row."""
    best = d.min(1).values
    iota = torch.arange(d.shape[1], device=d.device)
    return best, torch.where(d == best[:, None], iota, d.shape[1]).min(1).values


def unique_targets(idx: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Where sources claim one target, the lowest score keeps it (ties to
    the first source); the others lose their match."""
    src = torch.arange(len(idx), device=idx.device)
    claim = (idx >= 0).nonzero()[:, 0]
    order = claim[torch.argsort(src[claim], stable=True)]
    order = order[torch.argsort(score[order], stable=True)]
    order = order[torch.argsort(idx[order], stable=True)]
    first = torch.ones(len(order), dtype=torch.bool, device=idx.device)
    first[1:] = idx[order][1:] != idx[order][:-1]
    out = torch.full_like(idx, -1)
    out[order[first]] = idx[order[first]]
    return out


def match(ham, uv, ok, radius, kp_xy, pred_oct=None, kp_oct=None):
    d2 = ((uv[:, None, :] - kp_xy[None, :, :]) ** 2).sum(-1)
    near = ok[:, None] & (d2 <= radius[:, None] ** 2)
    if pred_oct is not None:
        near &= (kp_oct[None, :] - pred_oct[:, None]).abs() <= 1
    best, idx = first_min(torch.where(near, ham, BIG))
    idx = torch.where(best <= TH_HIGH, idx, -1)
    return unique_targets(idx, best)


def keep_first(idx_new, idx_old, inlier_old, ham):
    """Second-stage matches over the first stage's inliers."""
    idx = torch.where(idx_new >= 0, idx_new,
                      torch.where(inlier_old, idx_old, -1))
    d = torch.gather(ham, 1, idx.clamp(min=0)[:, None])[:, 0]
    return unique_targets(idx, torch.where(idx >= 0, d, BIG + d))


def project(R, t, X, rig: Rig):
    """Pixels of world points under a pose."""
    Xc = se3.transform(R, t, X)
    return torch.stack([rig.fx * Xc[:, 0] / Xc[:, 2] + rig.cx,
                        rig.fy * Xc[:, 1] / Xc[:, 2] + rig.cy], -1)


def frustum(R, t, pos, normal, dmin, dmax, valid, rig: Rig):
    """(uv, predicted level, window factor, in the frustum)."""
    Xc = se3.transform(R, t, pos)
    z = Xc[:, 2]
    zs = torch.where(z.abs() > 1e-9, z, 1e-9)
    uv = torch.stack([rig.fx * Xc[:, 0] / zs + rig.cx,
                      rig.fy * Xc[:, 1] / zs + rig.cy], -1)
    ok = ((z > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < rig.width)
          & (uv[:, 1] >= 0) & (uv[:, 1] < rig.height) & valid)
    po = pos + (R.T @ t)
    dist = torch.linalg.vector_norm(po, dim=-1)
    ok &= (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
    cos = (po * normal).sum(-1) / dist.clamp(min=1e-9)
    ok &= cos > 0.5
    level = torch.ceil(torch.log((dmax.clamp(min=1e-9) / dist.clamp(min=1e-9))
                                 .clamp(min=1e-9))
                       / math.log(rig.scale_factor))
    level = level.clamp(0, rig.n_levels - 1).long()
    factor = torch.where(cos > 0.998, 2.5, 4.0).to(pos.dtype)
    return uv, level, factor, ok


def _huber(chi2, th):
    w = torch.where(chi2 <= th, 1.0, math.sqrt(th) / chi2.clamp(min=1e-12)
                    .sqrt())
    rho = torch.where(chi2 <= th, chi2,
                      2 * math.sqrt(th) * chi2.clamp(min=0).sqrt() - th)
    return w, rho


class Edges(NamedTuple):
    X: torch.Tensor       # (N, 3) world points of the reprojection edges
    uv: torch.Tensor      # (N, 2) observations
    info: torch.Tensor    # (N,)
    valid: torch.Tensor   # (N,)
    Xb: torch.Tensor      # (M, 3) BEV landmarks
    pc: torch.Tensor      # (M, 3) their observations in the camera frame
    infob: torch.Tensor   # (M,)
    validb: torch.Tensor  # (M,)


def _system(R, t, e: Edges, rig: Rig, act, actb, huber: bool):
    """(H, g, cost, χ² mono, χ² BEV) of the pose's normal equations."""
    Xc = se3.transform(R, t, e.X)
    x, y, z = Xc.unbind(-1)
    front = z > 1e-6
    iz = 1 / z.clamp(min=1e-9)
    r = e.uv - torch.stack([rig.fx * x * iz + rig.cx,
                            rig.fy * y * iz + rig.cy], -1)
    chi2 = (r * r).sum(-1) * e.info
    Jp = torch.zeros(len(z), 2, 3, dtype=z.dtype, device=z.device)
    Jp[:, 0, 0], Jp[:, 0, 2] = rig.fx * iz, -rig.fx * x * iz * iz
    Jp[:, 1, 1], Jp[:, 1, 2] = rig.fy * iz, -rig.fy * y * iz * iz
    dX = torch.cat([torch.eye(3, dtype=z.dtype, device=z.device).expand(
        len(z), 3, 3), -se3.hat(Xc)], -1)
    J = -(Jp @ dX)                                       # (N, 2, 6)
    Xbc = se3.transform(R, t, e.Xb)
    rb = e.pc - Xbc
    chib = (rb * rb).sum(-1) * e.infob
    Jb = -torch.cat([torch.eye(3, dtype=z.dtype, device=z.device).expand(
        len(Xbc), 3, 3), -se3.hat(Xbc)], -1)             # (M, 3, 6)
    w, rho = _huber(chi2, CHI2_MONO) if huber else (1.0, chi2)
    wb, rhob = _huber(chib, CHI2_BIRD) if huber else (1.0, chib)
    w = w * e.info * (act & front)
    wb = wb * e.infob * actb
    cost = (torch.where(act & front, rho, 0).sum()
            + 10 * CHI2_MONO * (act & ~front).sum()
            + torch.where(actb, rhob, 0).sum())
    Jall = torch.cat([J.reshape(-1, 6), Jb.reshape(-1, 6)])
    rall = torch.cat([r.reshape(-1), rb.reshape(-1)])
    wall = torch.cat([w.repeat_interleave(2), wb.repeat_interleave(3)])
    H = Jall.T @ (wall[:, None] * Jall)
    g = Jall.T @ (wall * rall)
    return H, g, cost, torch.where(front, chi2, math.inf), chib


def optimize_pose(R, t, e: Edges, rig: Rig, rounds: int, iters: int = 10):
    """(R, t, mono inliers, BEV inliers) after `rounds` rounds."""
    act, actb = e.valid, e.validb
    I6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for rnd in range(rounds):
        huber = rnd < 2
        H, g, cost, _, _ = _system(R, t, e, rig, act, actb, huber)
        lam = 1e-4
        for _ in range(iters):
            A = H + lam * torch.diag(torch.diag(H)) + 1e-10 * I6
            dx = -torch.linalg.solve(A, g)
            Rn, tn = se3.update(R, t, dx)
            Hn, gn, cn, _, _ = _system(Rn, tn, e, rig, act, actb, huber)
            accept = bool(cn < cost) and bool(torch.isfinite(dx).all())
            if accept:
                R, t, H, g, cost = Rn, tn, Hn, gn, cn
            lam = min(max(lam * 0.5 if accept else lam * 4.0, 1e-9), 1e6)
            if (accept and float(dx.abs().max()) < 1e-6) or lam > 1e5:
                break
        _, _, _, chi2, chib = _system(R, t, e, rig, act, actb, False)
        act = e.valid & (chi2 <= CHI2_MONO)
        actb = e.validb & (chib <= CHI2_BIRD)
    return R, t, act, actb


class Tracked(NamedTuple):
    front: orb.Features
    bev: Optional[orb.Features]
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor    # (n, 3) world points of the final front inliers


def track(front_img, lm: dict, R_pred, t_pred, rig: Rig, ex: orb.Extractor,
          search: dict, dtype, bev_img=None, bev_mask=None, blm=None,
          bev_ex=None, bev: Optional[Bev] = None, R_bc=None,
          t_bc=None) -> Tracked:
    """The frame's pose. `lm` holds the local map's `pos`, `normal`,
    `min_dist`, `max_dist`, `valid` and `desc_u8`; `blm` the BEV
    landmarks' `pos`, `valid` and `desc_u8`; `search` the factors
    `motion`, `local`, `min_widen`, `bird_radius` and `bird_info`."""
    dev = R_pred.device
    f = orb.extract(front_img.to(dev), ex, dtype)
    pos, normal, dmin, dmax = (lm[k].to(dev, dtype) for k in
                               ("pos", "normal", "min_dist", "max_dist"))
    valid = lm["valid"].to(dev)
    ham = hamming(orb.unpack(lm["desc_u8"].to(dev)), f.bits)
    ham = torch.where(valid[:, None], ham, BIG)
    scale = torch.as_tensor([ex.scale_factor ** l for l in
                             range(ex.n_levels)], dtype=dtype, device=dev)
    inv_sigma2 = 1 / scale ** 2
    R, t = R_pred.to(dtype), t_pred.to(dtype)

    def front_match(R, t, factor):
        uv, lvl, wf, ok = frustum(R, t, pos, normal, dmin, dmax, valid, rig)
        radius = wf * factor * scale[lvl]
        return uv, lvl, ok, radius

    none = torch.zeros(0, 3, dtype=dtype, device=dev)
    bird = dict(Xb=none, pc=none, infob=none[:, 0],
                validb=torch.zeros(0, dtype=torch.bool, device=dev))
    b = None
    if bev_img is not None and blm is not None:
        b = orb.extract(bev_img.to(dev), bev_ex, dtype, mask=bev_mask)
        bpos = blm["pos"].to(dev, dtype)
        bvalid = blm["valid"].to(dev)
        bham = hamming(orb.unpack(blm["desc_u8"].to(dev)), b.bits)
        bham = torch.where(bvalid[:, None], bham, BIG)
        base = torch.cat([bev.to_base(b.xy), torch.zeros_like(b.xy[:, :1])],
                         -1)
        R_bc, t_bc = R_bc.to(dev, dtype), t_bc.to(dev, dtype)
        pc = (base - t_bc) @ R_bc     # camera-frame observations
        radius_b = torch.full((len(bpos),), float(search["bird_radius"]),
                              dtype=dtype, device=dev)

        def bev_match(R, t):
            pb = se3.transform(R_bc @ R, R_bc @ t + t_bc, bpos)
            uv = bev.to_pixel(pb[:, :2])
            ok = ((pb[:, 2].abs() < 0.2) & (uv[:, 0] >= 0)
                  & (uv[:, 0] < bev.width) & (uv[:, 1] >= 0)
                  & (uv[:, 1] < bev.height) & bvalid)
            return match(bham, uv, ok, radius_b, b.xy)

        def bev_edges(bidx):
            return dict(Xb=bpos, pc=pc[bidx.clamp(min=0)],
                        infob=torch.full((len(bpos),),
                                         float(search["bird_info"]),
                                         dtype=dtype, device=dev),
                        validb=bidx >= 0)

        bidx1 = bev_match(R, t)
        bird = bev_edges(bidx1)

    def edges(idx, bird):
        lv = f.octave[idx.clamp(min=0)]
        return Edges(pos, f.xy[idx.clamp(min=0)], inv_sigma2[lv], idx >= 0,
                     **bird)

    uv, lvl, ok, radius = front_match(R, t, search["motion"])
    idx1 = match(ham, uv, ok, radius, f.xy, lvl, f.octave)
    if int((idx1 >= 0).sum()) < search["min_widen"]:
        idx1 = match(ham, uv, ok, radius * 2, f.xy, lvl, f.octave)
    R1, t1, inl1, inlb1 = optimize_pose(R, t, edges(idx1, bird), rig, 2)

    uv, lvl, ok, radius = front_match(R1, t1, search["local"])
    idx2 = keep_first(match(ham, uv, ok, radius, f.xy, lvl, f.octave), idx1,
                      inl1, ham)
    if b is not None:
        bird = bev_edges(keep_first(bev_match(R1, t1), bidx1, inlb1, bham))
    R2, t2, inl2, _ = optimize_pose(R1, t1, edges(idx2, bird), rig, 4)
    return Tracked(f, b, R2, t2, pos[inl2])
