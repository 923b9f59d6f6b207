"""Matrix-free bundle adjustment for large maps (implicit Schur + PCG).

`graph.ba.bundle_adjust` materializes the camera-landmark coupling W as a
dense (C,6,P,3) tensor: right for local windows, but O(C·P) memory rules
it out for a full-map BA of a large map. This module runs the same LM
protocol (two Huber phases, chi² re-classification between them, the
final classification against the original edge sets) with O(E) memory:
the reduced camera system S = Hcc − W·Hpp⁻¹·Wᵀ is never formed. S·x is
applied through edge-indexed gathers, per-edge 6×3 block products and
segment sums ("Bundle Adjustment in the Large", Agarwal et al. 2010):

    (Wᵀx)_p = Σ_{e: pt_e=p} U_eᵀ x_{cam_e}
    (S x)_c = (Hcc+λD)_c x_c − Σ_{e: cam_e=c} U_e G_{pt_e} (Wᵀx)_{pt_e}

with U_e = Jcᵀ w Jp and G = (Hpp+λD)⁻¹ (block-diagonal 3×3, closed
form). The camera system is solved by preconditioned CG with the exact
block-Jacobi preconditioner of S (a landmark is observed at most once per
camera, so the diagonal blocks of W·Hpp⁻¹·Wᵀ only receive same-edge
terms). Fixed cameras are projected out of every CG operand, frozen points
masked, as in `ba._schur_solve`. Both the LM and the CG loops have fixed
lengths with `torch.where` gates: no host sync.

The solve runs over the map blocks of a `parallel.runtime.Mesh`
(`solve_global`): each shard holds a block of landmarks and their edges,
the camera-side sums are summed over the mesh and solved on its first
device. `bundle_adjust_large` is the one-shard case;
`parallel/sharded_ba.py` partitions a map over several shards.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..core import lie
from ..parallel.runtime import Mesh
from . import ba
from .ba import BAResult, EdgeSet, _cost_only, _edge_terms, _inv3x3
from .segsum import SegmentSum


def _edge_blocks(cam_R, cam_t, points, edge_sets, intr, use_huber):
    """Per-edge Schur blocks, concatenated across edge types:
    (U (E,6,3) = Jcᵀ w Jp, Acc (E,6,6), App (E,3,3), bc_e (E,6),
    bp_e (E,3), total cost)."""
    Us, Accs, Apps, bcs, bps = [], [], [], [], []
    total_cost = None
    for kind, es in edge_sets:
        if es is None:
            continue
        e, Jc, Jp, w, cost, _, _ = _edge_terms(
            kind, cam_R, cam_t, points, es, intr, use_huber)
        total_cost = cost if total_cost is None else total_cost + cost
        Us.append(ba._gram(Jc, w, Jp))
        Accs.append(ba._gram(Jc, w, Jc))
        Apps.append(ba._gram(Jp, w, Jp))
        bcs.append(ba._gramv(Jc, w, e))
        bps.append(ba._gramv(Jp, w, e))
    if total_cost is None:
        raise ValueError("no edge sets")
    return (torch.cat(Us), torch.cat(Accs), torch.cat(Apps), torch.cat(bcs),
            torch.cat(bps), total_cost)


class _ShardLayout(NamedTuple):
    cams: torch.Tensor       # (E,) the shard's edges' cameras, all types
    ptsi: torch.Tensor       # (E,) their LOCAL points
    to_cam: SegmentSum
    to_pt: SegmentSum


def _shard_layout(sets, C, Pn) -> _ShardLayout:
    present = [es for _, es in sets if es is not None]
    cams = torch.cat([es.cam for es in present])
    ptsi = torch.cat([es.pt for es in present])
    return _ShardLayout(cams, ptsi, SegmentSum(cams, C), SegmentSum(ptsi, Pn))


def _implicit_schur_step(mesh, cam_R, cam_t, cam_free, points, pt_free,
                         shard_sets, lays, intr, lam, cg_iters,
                         use_huber=True):
    """One damped GN step by matrix-free Schur + PCG over the map blocks
    of `mesh`: shard s holds `points[s]`, its typed edge sets
    `shard_sets[s]` = [(kind, EdgeSet)] with LOCAL point indices and their
    layout `lays[s]`, on its device; the cameras lie on the first device.
    The camera blocks and the preconditioner are summed over the mesh
    once, each CG matvec's (C,6) vector once; the camera system is solved
    on the first device. Returns (dxc (C,6), [dxp (P_shard,3)], cost)."""
    C = cam_R.shape[0]
    dtype, d0 = cam_R.dtype, cam_R.device
    Rs, ts, lams = (mesh.broadcast(x) for x in (cam_R, cam_t, lam))
    eye6 = torch.eye(6, dtype=dtype, device=d0)
    acc, bcs, costs, local = [], [], [], []
    for R, t, X, sets, lay, pf, lm in zip(Rs, ts, points, shard_sets, lays,
                                          pt_free, lams):
        U, Acc, App, bc_e, bp_e, cost = _edge_blocks(
            R, t, X, sets, intr, use_huber)
        acc.append(lay.to_cam(Acc))
        bcs.append(lay.to_cam(bc_e))
        costs.append(cost)
        Pn = X.shape[0]
        eye3 = torch.eye(3, dtype=dtype, device=X.device).expand(Pn, 3, 3)
        # freeze invalid / unreferenced points (as ba._schur_solve)
        Hpp = torch.where(pf[:, None, None], ba._damp(lay.to_pt(App), lm),
                          eye3)
        bp = torch.where(pf[:, None], lay.to_pt(bp_e), 0.0)
        U = U * pf[lay.ptsi][:, None, None].to(dtype)
        local.append((U, _inv3x3(Hpp), bp, lay, pf))
    # the camera system: summed over the shards, damped after the sum
    Hcc = ba._damp(mesh.psum(acc), lam)
    bc = mesh.psum(bcs)

    # every per-edge / per-block product is a broadcast multiply-reduce
    def W_apply(ys):   # [(P_shard,3)] -> (C,6), summed over the mesh
        return mesh.psum([lay.to_cam(torch.sum(U * y[lay.ptsi][:, None, :],
                                               -1))
                          for (U, _, _, lay, _), y in zip(local, ys)])

    def WT_apply(s, x):   # (C,6) on shard s's device -> (P_shard,3)
        U, _, _, lay, _ = local[s]
        return lay.to_pt(torch.sum(U * x[lay.cams][:, :, None], 1))

    def proj(x):
        return torch.where(cam_free[:, None], x, 0.0)

    def S_apply(x):   # (C,6) -> (C,6), projected to the free cameras
        x = proj(x)
        ys = [torch.sum(G * WT_apply(s, xs)[:, None, :], -1)
              for s, ((_, G, _, _, _), xs) in enumerate(
                  zip(local, mesh.broadcast(x)))]
        return proj(torch.sum(Hcc * x[:, None, :], -1) - W_apply(ys))

    # exact block-Jacobi preconditioner of S: U·G·Uᵀ per edge
    D = []
    for U, G, _, lay, _ in local:
        T_e = torch.sum(U[:, :, :, None] * G[lay.ptsi][:, None, :, :], 2)
        D.append(lay.to_cam(torch.sum(T_e[:, :, None, :] * U[:, None, :, :],
                                      -1)))
    M = Hcc - mesh.psum(D)
    M = torch.where(cam_free[:, None, None], M, eye6.expand(C, 6, 6))
    Minv = _inv6x6(M)

    def prec(r):
        return torch.sum(Minv * r[:, None, :], -1)

    rhs = proj(bc - W_apply([torch.sum(G * bp[:, None, :], -1)
                             for _, G, bp, _, _ in local]))

    # PCG with a fixed trip count; the updates stop once converged
    x = torch.zeros((C, 6), dtype=dtype, device=d0)
    r = rhs
    p = prec(r)
    rz = torch.sum(r * p)
    eps = 1e-20
    tol2 = 1e-12 * torch.sum(rhs * rhs)
    for _ in range(cg_iters):
        live = (torch.sum(r * r) > tol2) & (rz > eps)
        Ap = S_apply(p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(live & (pAp > eps),
                            rz / torch.clamp(pAp, min=eps), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(live, rz_new / torch.clamp(rz, min=eps), 0.0)
        p = torch.where(live, z + beta * p, p)
        rz = torch.where(live, rz_new, rz)
    dxc = -x
    dxps = []
    for s, ((_, G, bp, _, pf), xs) in enumerate(zip(local,
                                                    mesh.broadcast(dxc))):
        dxp = -torch.sum(G * (bp + WT_apply(s, xs))[:, None, :], -1)
        dxps.append(torch.where(pf[:, None], dxp, 0.0))
    return dxc, dxps, mesh.psum(costs)


def _inv6x6(A):
    """Batched 6x6 inverse by blockwise (Schur) inversion on 3x3 blocks,
    closed form throughout."""
    A11 = A[..., :3, :3]
    A12 = A[..., :3, 3:]
    A21 = A[..., 3:, :3]
    A22 = A[..., 3:, 3:]
    A11i = _inv3x3(A11)
    Si = _inv3x3(A22 - (A21 @ A11i) @ A12)  # 3x3 Schur complement
    T = A11i @ A12
    B21 = -(Si @ (A21 @ A11i))
    B11 = A11i - T @ B21
    B12 = -(T @ Si)
    return torch.cat([torch.cat([B11, B12], -1), torch.cat([B21, Si], -1)],
                     -2)


def solve_global(mesh: Mesh, cam_R, cam_t, cam_fixed, cam_valid, points,
                 pt_valid, shard_sets, intr, iters_phase1: int = 5,
                 iters_phase2: int = 10, reclassify: bool = True,
                 cg_iters: int = 48):
    """The LM protocol of `bundle_adjust_large` over the map blocks of
    `mesh`: cameras on its first device; `points`, `pt_valid` and
    `shard_sets` (one [(kind, EdgeSet or None)] with LOCAL point indices a
    shard) lists with one entry per local shard, on its device. Two Huber
    phases, chi² re-classification between them, the final masks against
    the original edge sets. The LM gate stays on the device: a step's
    finiteness is a count summed over the mesh, so every shard takes the
    same decision. Returns (cam_R, cam_t, [points], [[mask or None]], the
    accepted cost)."""
    C = cam_R.shape[0]
    dtype, d0 = cam_R.dtype, cam_R.device
    lays = [_shard_layout(s, C, X.shape[0])
            for s, X in zip(shard_sets, points)]
    # a point is free when valid and referenced by a valid edge
    pt_free = []
    for s, pv, lay in zip(shard_sets, pt_valid, lays):
        valid = torch.cat([es.valid for _, es in s if es is not None])
        pt_free.append(pv & (lay.to_pt(valid.to(dtype)) > 0))
    cam_free = cam_valid & ~cam_fixed

    def phase(state, sets, n_iters):
        cam_R, cam_t, points = state
        lam = torch.tensor(1e-4, dtype=dtype, device=d0)
        cost = torch.zeros((), dtype=dtype, device=d0)
        for _ in range(n_iters):
            dxc, dxps, cost0 = _implicit_schur_step(
                mesh, cam_R, cam_t, cam_free, points, pt_free, sets, lays,
                intr, lam, cg_iters)
            Rn, tn = lie.se3_update_left(cam_R, cam_t, dxc)
            pns = [X + dp for X, dp in zip(points, dxps)]
            cost1 = mesh.psum([
                _cost_only(R, t, X, s, intr, True) for R, t, X, s in zip(
                    mesh.broadcast(Rn), mesh.broadcast(tn), pns, sets)])
            # gate on the STEP's finiteness too: a NaN pose fails the z>0
            # depth check and silently drops its edges from cost1
            bad_p = mesh.psum([(~torch.isfinite(dp)).sum() for dp in dxps])
            ok = ((cost1 < cost0) & torch.isfinite(cost1)
                  & torch.isfinite(dxc).all() & (bad_p == 0))
            cam_R = torch.where(ok, Rn, cam_R)
            cam_t = torch.where(ok, tn, cam_t)
            points = [torch.where(o, pn, X) for o, pn, X in
                      zip(mesh.broadcast(ok), pns, points)]
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0),
                              1e-9, 1e8)
            # the ACCEPTED state's cost
            cost = torch.where(ok, cost1, cost0)
        return (cam_R, cam_t, points), cost

    def masks(state, sets):
        R, t, pts = state
        return [[None if es is None else ba._classify(kind, Rs, ts, X, es,
                                                      intr)
                 for kind, es in s]
                for Rs, ts, X, s in zip(mesh.broadcast(R), mesh.broadcast(t),
                                        pts, sets)]

    state = (cam_R, cam_t, list(points))
    state, _ = phase(state, shard_sets, iters_phase1)
    sets = shard_sets
    if reclassify:
        sets = [[(kind, None if es is None else es._replace(valid=m))
                 for (kind, es), m in zip(s, ms)]
                for s, ms in zip(shard_sets, masks(state, shard_sets))]
    state, cost = phase(state, sets, iters_phase2)
    return (*state, masks(state, shard_sets), cost)


def bundle_adjust_large(
    cam_R,
    cam_t,
    cam_fixed,
    cam_valid,
    points,
    point_valid,
    mono: Optional[EdgeSet],
    stereo: Optional[EdgeSet],
    bird: Optional[EdgeSet],
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float = 0.0,
    iters_phase1: int = 5,
    iters_phase2: int = 10,
    reclassify: bool = True,
    cg_iters: int = 48,
    device=None,
) -> BAResult:
    """`ba.bundle_adjust` with O(E) memory, on `device` (`cuda` unless
    given): the same LM protocol, the inner solve implicit-Schur PCG; the
    one-shard case of `solve_global`."""
    dev = resolve_device(device)

    def on(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    cam_R, cam_t, points = (on(x, torch.float32)
                            for x in (cam_R, cam_t, points))
    cam_fixed, cam_valid, point_valid = (
        on(x, torch.bool) for x in (cam_fixed, cam_valid, point_valid))
    msets = [(kind, ba._edges_on(es, dev)) for kind, es in
             (("mono", mono), ("stereo", stereo), ("bird", bird))]
    if all(es is None for _, es in msets):
        raise ValueError("no edge sets")
    cam_R, cam_t, (points,), ((m_mono, m_stereo, m_bird),), cost = \
        solve_global(Mesh([dev]), cam_R, cam_t, cam_fixed, cam_valid,
                     [points], [point_valid], [msets],
                     (fx, fy, cx, cy, bf), iters_phase1, iters_phase2,
                     reclassify, cg_iters)
    empty = torch.zeros((0,), dtype=torch.bool, device=dev)
    return BAResult(
        cam_R, cam_t, points,
        m_mono if m_mono is not None else empty,
        m_stereo if m_stereo is not None else empty,
        m_bird if m_bird is not None else empty,
        cost,
    )
