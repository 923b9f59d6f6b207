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
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..core import lie
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


def _implicit_schur_step(cam_R, cam_t, points, edge_sets, intr, use_huber,
                         lam, cam_free, pt_free, cams, ptsi, to_cam, to_pt,
                         cg_iters):
    """One damped GN step by matrix-free Schur + PCG; cams / ptsi are the
    concatenated edge indices, to_cam / to_pt their sum layouts.
    Returns (dxc (C,6), dxp (P,3), cost_before)."""
    dtype, dev = cam_R.dtype, cam_R.device
    C, P = to_cam.n, to_pt.n
    U, Acc, App, bc_e, bp_e, cost0 = _edge_blocks(
        cam_R, cam_t, points, edge_sets, intr, use_huber)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hcc = ba._damp(to_cam(Acc), lam)
    bc = to_cam(bc_e)
    Hpp = ba._damp(to_pt(App), lam)
    bp = to_pt(bp_e)
    # freeze invalid / unreferenced points (as ba._schur_solve)
    Hpp = torch.where(pt_free[:, None, None], Hpp, eye3.expand(P, 3, 3))
    bp = torch.where(pt_free[:, None], bp, 0.0)
    U = U * pt_free[ptsi][:, None, None].to(dtype)
    G = _inv3x3(Hpp)
    G_e = G[ptsi]  # (E,3,3)

    # every per-edge / per-block product is a broadcast multiply-reduce
    def W_apply(y):   # (P,3) -> (C,6)
        return to_cam(torch.sum(U * y[ptsi][:, None, :], -1))

    def WT_apply(x):  # (C,6) -> (P,3)
        return to_pt(torch.sum(U * x[cams][:, :, None], 1))

    def proj(x):
        return torch.where(cam_free[:, None], x, 0.0)

    def S_apply(x):   # (C,6) -> (C,6), projected to the free cameras
        x = proj(x)
        y = torch.sum(G * WT_apply(x)[:, None, :], -1)
        return proj(torch.sum(Hcc * x[:, None, :], -1) - W_apply(y))

    # exact block-Jacobi preconditioner of S
    T_e = torch.sum(U[:, :, :, None] * G_e[:, None, :, :], 2)   # U·G
    D_e = torch.sum(T_e[:, :, None, :] * U[:, None, :, :], -1)  # U·G·Uᵀ
    M = Hcc - to_cam(D_e)
    M = torch.where(cam_free[:, None, None], M, eye6.expand(C, 6, 6))
    Minv = _inv6x6(M)

    def prec(r):
        return torch.sum(Minv * r[:, None, :], -1)

    rhs = proj(bc - W_apply(torch.sum(G * bp[:, None, :], -1)))

    # PCG with a fixed trip count; the updates stop once converged
    x = torch.zeros((C, 6), dtype=dtype, device=dev)
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
    tmp = bp + WT_apply(dxc)
    dxp = -torch.sum(G * tmp[:, None, :], -1)
    dxp = torch.where(pt_free[:, None], dxp, 0.0)
    return dxc, dxp, cost0


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
    given): the same LM protocol, the inner solve implicit-Schur PCG."""
    dev = resolve_device(device)

    def on(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    cam_R, cam_t, points = (on(x, torch.float32)
                            for x in (cam_R, cam_t, points))
    cam_fixed, cam_valid, point_valid = (
        on(x, torch.bool) for x in (cam_fixed, cam_valid, point_valid))
    mono, stereo, bird = (ba._edges_on(es, dev) for es in (mono, stereo, bird))
    C = cam_R.shape[0]
    P = points.shape[0]
    dtype = cam_R.dtype
    intr = (fx, fy, cx, cy, bf)
    cam_free = cam_valid & ~cam_fixed
    n_refs = torch.zeros((P,), dtype=torch.int32, device=dev)
    for es in (mono, stereo, bird):
        if es is not None:
            n_refs.index_add_(0, es.pt, es.valid.to(torch.int32))
    pt_free = point_valid & (n_refs > 0)

    msets = [("mono", mono), ("stereo", stereo), ("bird", bird)]
    present = [es for _, es in msets if es is not None]
    if not present:
        raise ValueError("no edge sets")
    cams = torch.cat([es.cam for es in present])
    ptsi = torch.cat([es.pt for es in present])
    # the edges stay fixed across every LM and CG iteration
    to_cam, to_pt = SegmentSum(cams, C), SegmentSum(ptsi, P)

    def run_phase(state, n_iters, use_huber, sets):
        cam_R, cam_t, points = state
        lam = torch.tensor(1e-4, dtype=dtype, device=dev)
        cost = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(n_iters):
            dxc, dxp, cost0 = _implicit_schur_step(
                cam_R, cam_t, points, sets, intr, use_huber, lam, cam_free,
                pt_free, cams, ptsi, to_cam, to_pt, cg_iters)
            Rn, tn = lie.se3_update_left(cam_R, cam_t, dxc)
            pn = points + dxp
            cost1 = _cost_only(Rn, tn, pn, sets, intr, use_huber)
            # gate on the STEP's finiteness too: a NaN pose fails the z>0
            # depth check and silently drops its edges from cost1
            ok = ((cost1 < cost0) & torch.isfinite(cost1)
                  & torch.isfinite(dxc).all() & torch.isfinite(dxp).all())
            cam_R = torch.where(ok, Rn, cam_R)
            cam_t = torch.where(ok, tn, cam_t)
            points = torch.where(ok, pn, points)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0),
                              1e-9, 1e8)
            # the ACCEPTED state's cost
            cost = torch.where(ok, cost1, cost0)
        return (cam_R, cam_t, points), cost

    def masks(state, sets):
        return [None if es is None else ba._classify(kind, *state, es, intr)
                for kind, es in sets]

    state = (cam_R, cam_t, points)
    state, _ = run_phase(state, iters_phase1, True, msets)
    if reclassify:
        msets = [(kind, None if es is None else es._replace(valid=m))
                 for (kind, es), m in zip(msets, masks(state, msets))]
    state, cost = run_phase(state, iters_phase2, True, msets)
    m_mono, m_stereo, m_bird = masks(
        state, [("mono", mono), ("stereo", stereo), ("bird", bird)])
    cam_R, cam_t, points = state
    empty = torch.zeros((0,), dtype=torch.bool, device=dev)
    return BAResult(
        cam_R, cam_t, points,
        m_mono if m_mono is not None else empty,
        m_stereo if m_stereo is not None else empty,
        m_bird if m_bird is not None else empty,
        cost,
    )
