"""Motion-only pose optimization (front + birdview edges).

The reference's design (`PoseOptimizationWithBirdview`): 4 rounds × 10 LM
iterations, Huber kernels in the first two rounds, and between rounds every
edge re-classified inlier/outlier by chi² (5.991 mono / 7.815 bird).

The reference leaves a round's LM loop early once it has converged (a
`while_loop` on data). Eager PyTorch would need a host sync per iteration
to do that, so here every round runs its full iteration budget and a
`done` flag freezes R, t, H, g, cost and λ from the iteration at which the
reference would have stopped: the results are those of the early-exit
loop, with no sync. The price is launches: ~60 iterations of a few hundred
small kernels per tracked frame, launch-bound on a GPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie, linalg, robust
from . import residuals

CHI2_MONO = 5.991
CHI2_BIRD = 7.815


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers_mono: torch.Tensor
    inliers_bird: torch.Tensor
    n_inliers: torch.Tensor   # front + bird, as the reference sums them
    chi2: torch.Tensor


def _robust(chi2, chi_th, use_huber):
    return robust.huber_rho(chi2, chi_th) if use_huber else chi2


def _cost_terms(chi2, active, ok, chi_th, use_huber, dtype):
    cost = torch.where(active & ok, _robust(chi2, chi_th, use_huber), 0.0).sum()
    # behind-camera edges pay a fixed penalty so a step that hides points
    # behind the camera can never look like a cost decrease
    return cost + 10.0 * chi_th * (active & ~ok).to(dtype).sum()


def _build_normal_eq(R, t, Xw, obs, info, active, fx, fy, cx, cy,
                     Xw_b, obs_b, info_b, active_b, use_huber: bool):
    """Normal equations in structure-of-arrays layout: the 6 Jacobian rows
    and the residual of every mono (2 per edge) and bird (3 per edge)
    component are stacked to one (7, 2N+3Nb) matrix P, and H, g come out
    of the single product (P·w) Pᵀ."""
    dtype = R.dtype
    Xc = residuals._rot(R, Xw) + t
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-9)
    depth_ok = z > 1e-6
    eu = obs[:, 0] - (fx * x * zi + cx)
    ev = obs[:, 1] - (fy * y * zi + cy)
    chi2 = (eu * eu + ev * ev) * info
    w = robust.huber_weight(chi2, CHI2_MONO) if use_huber else 1.0
    w = w * info * active.to(dtype) * depth_ok.to(dtype)
    cost = _cost_terms(chi2, active, depth_ok, CHI2_MONO, use_huber, dtype)

    # J = −Jp·[I | −hat(Xc)] rows as (N,) vectors (left-mult SE3 tangent)
    xz, yz = x * zi, y * zi
    zero = torch.zeros_like(zi)
    Ju = [-fx * zi, zero, fx * xz * zi,
          fx * xz * yz, -fx * (1.0 + xz * xz), fx * yz]
    Jv = [zero, -fy * zi, fy * yz * zi,
          fy * (1.0 + yz * yz), -fy * xz * yz, -fy * xz]
    # bird 3-D point-to-point edges: e = obs − (R Xw_b + t),
    # J_b = −[I | −hat(Xc)] (3,6) per edge
    Xb = residuals._rot(R, Xw_b) + t
    xb, yb, zb = Xb[:, 0], Xb[:, 1], Xb[:, 2]
    eb = obs_b - Xb
    chi2_b = torch.sum(eb * eb, dim=-1) * info_b
    wb = robust.huber_weight(chi2_b, CHI2_BIRD) if use_huber else 1.0
    wb = wb * info_b * active_b.to(dtype)
    zerob = torch.zeros_like(xb)
    oneb = torch.ones_like(xb)
    Jb = [
        [-oneb, zerob, zerob, zerob, -zb, yb],
        [zerob, -oneb, zerob, zb, zerob, -xb],
        [zerob, zerob, -oneb, -yb, xb, zerob],
    ]
    rows = [torch.cat([Ju[k], Jv[k], Jb[0][k], Jb[1][k], Jb[2][k]])
            for k in range(6)]
    rows.append(torch.cat([eu, ev, eb[:, 0], eb[:, 1], eb[:, 2]]))
    P = torch.stack(rows)                       # (7, 2N+3Nb)
    wall = torch.cat([w, w, wb, wb, wb])
    A = (P * wall) @ P.T                        # (7,7)
    H, g = A[:6, :6], A[:6, 6]
    cost = cost + torch.where(active_b, _robust(chi2_b, CHI2_BIRD, use_huber),
                              0.0).sum()
    return H, g, cost, chi2, chi2_b


def _chi2_only(R, t, Xw, obs, info, fx, fy, cx, cy, Xw_b, obs_b, info_b):
    _, chi2, depth_ok = residuals.mono_reproj_cost(R, t, Xw, obs, info,
                                                   fx, fy, cx, cy)
    chi2 = torch.where(depth_ok, chi2, torch.inf)
    eb, _, _ = residuals.bird_point(R, t, Xw_b, obs_b)
    return chi2, torch.sum(eb * eb, dim=-1) * info_b


def optimize_pose(R0, t0, Xw, obs_uv, info, valid, fx: float, fy: float,
                  cx: float, cy: float, Xw_bird=None, obs_pc_bird=None,
                  info_bird=None, valid_bird=None, rounds: int = 4,
                  iters_per_round: int = 10) -> PoseOptResult:
    """Xw (N,3) world points matched to observations obs_uv (N,2);
    info (N,) = 1/sigma² per edge; valid (N,) mask.
    Bird edges: world landmark Xw_bird vs observed camera-frame point
    obs_pc_bird with information info_bird."""
    dtype, dev = R0.dtype, R0.device
    if Xw_bird is None:
        Xw_bird = torch.zeros((1, 3), dtype=dtype, device=dev)
        obs_pc_bird = torch.zeros((1, 3), dtype=dtype, device=dev)
        info_bird = torch.zeros((1,), dtype=dtype, device=dev)
        valid_bird = torch.zeros((1,), dtype=torch.bool, device=dev)
    damp = 1e-10 * torch.eye(6, dtype=dtype, device=dev)

    def lm_iters(R, t, active, active_b, use_huber):
        # evaluate-at-trial: one normal-equation build per iteration, at the
        # trial point; its (H, g) are carried on if the step is accepted
        def build(R, t):
            H, g, cost, _, _ = _build_normal_eq(
                R, t, Xw, obs_uv, info, active, fx, fy, cx, cy,
                Xw_bird, obs_pc_bird, info_bird, active_b, use_huber)
            return H, g, cost

        H, g, cost = build(R, t)
        lam = torch.tensor(1e-4, dtype=dtype, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters_per_round):
            Haug = H + lam * torch.diag(torch.diag(H)) + damp
            dx = -linalg.solve_psd_small(Haug, g)
            Rn, tn = lie.se3_update_left(R, t, dx)
            Hn, gn, cost1 = build(Rn, tn)
            accept = (cost1 < cost) & torch.isfinite(dx).all()
            step = accept & ~done
            R = torch.where(step, Rn, R)
            t = torch.where(step, tn, t)
            H = torch.where(step, Hn, H)
            g = torch.where(step, gn, g)
            cost = torch.where(step, cost1, cost)
            lam_n = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                                1e-9, 1e6)
            # converged: an accepted step with a negligible update, or the
            # damping blown up (no descent direction left)
            stop = (accept & (dx.abs().max() < 1e-6)) | (lam_n > 1e5)
            lam = torch.where(done, lam, lam_n)
            done = done | stop
        return R, t, cost

    R, t = R0, t0
    active = valid
    active_b = valid_bird
    final_cost = torch.zeros((), dtype=dtype, device=dev)
    for rnd in range(rounds):
        R, t, final_cost = lm_iters(R, t, active, active_b, rnd < 2)
        chi2, chi2_b = _chi2_only(R, t, Xw, obs_uv, info, fx, fy, cx, cy,
                                  Xw_bird, obs_pc_bird, info_bird)
        active = valid & (chi2 <= CHI2_MONO)
        active_b = valid_bird & (chi2_b <= CHI2_BIRD)

    n_inl = active.sum(dtype=torch.int32) + active_b.sum(dtype=torch.int32)
    return PoseOptResult(R, t, active, active_b, n_inl, final_cost)
