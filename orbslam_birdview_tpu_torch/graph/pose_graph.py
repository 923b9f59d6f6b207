"""Sim3 pose-graph (essential graph) optimization
(`Optimizer::OptimizeEssentialGraph`).

Damped Gauss-Newton over Sim3 vertices (world→keyframe); edge residuals
are `residuals.sim3_relative`, their Jacobians over the 7-dim left tangent
at zero come from `torch.func.jacrev` under `torch.func.vmap`. Three
solvers of the same normal equations:
- `optimize_sim3_graph`: the (7K × 7K) system assembled by block sums and
  solved densely, for small graphs;
- `optimize_sim3_graph_pcg`: matrix-free, H·v edge-wise, block-Jacobi PCG;
  both are the one-shard case of `solve_dense` / `solve_pcg`, which sum
  the shards' contributions over a `parallel.runtime.Mesh`
  (`parallel/sharded_pose_graph.py` gives them several shards);
- `optimize_sim3_graph_banded`: exact O(K) steps for a time-ordered graph,
  block-Thomas over supernodes of g vertices plus Woodbury for the few
  long-range edges.
Every LM and CG loop has a fixed length with `torch.where` accept and
reject, and the solves are `solve_ex` (no singularity check): nothing waits
on the host. All in f32, in a normalized gauge (`gauge_normalize`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from ..parallel.runtime import Mesh
from . import residuals
from .segsum import SegmentSum


def sim3_update_left(R, t, s, xi):
    dR, dt, ds = lie.sim3_exp(xi)
    return lie.sim3_mul(dR, dt, ds, R, t, s)


def gauge_normalize(R, t, s, target_rms: float = 3.0):
    """A world-frame gauge change that centres the camera positions at the
    origin and scales their RMS radius to `target_rms`.

    Relative Sim3 measurements S_j∘S_i⁻¹ are invariant under
    right-composition with any world similarity G, so the solve runs in
    the normalized gauge and the result maps back exactly. In f32 this
    matters: at |t| ~ 50-200 m the translation blocks carry |J| ~ |t| and
    the system's conditioning is beyond f32.

    Returns (t', s', unnormalize) where unnormalize(R_o, t_o, s_o) maps a
    solution in the normalized gauge back to the input gauge."""
    p = -torch.einsum("kji,kj->ki", R, t) / s[:, None]   # camera centres
    tg = p.mean(0)
    rms = torch.sqrt(torch.mean(torch.sum((p - tg) ** 2, -1)) + 1e-12)
    sg = torch.clamp(rms / target_rms, min=1e-6)
    # S' = S ∘ G with G = (I, tg, sg):  t' = s·R·tg + t,  s' = s·sg
    t_n = s[:, None] * torch.einsum("kij,j->ki", R, tg) + t
    s_n = s * sg

    def unnormalize(R_o, t_o, s_o):
        s_back = s_o / sg
        t_back = t_o - s_back[:, None] * torch.einsum("kij,j->ki", R_o, tg)
        return R_o, t_back, s_back

    return t_n, s_n, unnormalize


def _edge_res(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    Ri2, ti2, si2 = sim3_update_left(Ri, ti, si, xi_i)
    Rj2, tj2, sj2 = sim3_update_left(Rj, tj, sj, xi_j)
    return residuals.sim3_relative(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)


_edge_jac = torch.func.vmap(torch.func.jacrev(_edge_res, argnums=(0, 1)))


def _vertices(R, t, s, ei, ej):
    return R[ei], t[ei], s[ei], R[ej], t[ej], s[ej]


def _edge_residuals(R, t, s, ei, ej, mR, mt, ms):
    zeros = torch.zeros((ei.shape[0], 7), dtype=R.dtype, device=R.device)
    return _edge_res(zeros, zeros, *_vertices(R, t, s, ei, ej), mR, mt, ms)


def _edge_terms(R, t, s, ei, ej, mR, mt, ms):
    """Residuals (E,7) and Jacobians wrt both vertices (E,7,7) at ξ = 0."""
    zeros = torch.zeros((ei.shape[0], 7), dtype=R.dtype, device=R.device)
    args = (*_vertices(R, t, s, ei, ej), mR, mt, ms)
    Ji, Jj = _edge_jac(zeros, zeros, *args)
    return _edge_res(zeros, zeros, *args), Ji, Jj


def _cost(r, w):
    return torch.sum(torch.sum(r * r, -1) * w)


def _on(dev, *xs, dtype=torch.float32):
    return [torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x, device=dev).to(dtype) for x in xs]


def _prepare(R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w, e_valid, device):
    dev = resolve_device(device)
    R, t, s, mR, mt, ms, e_w = _on(dev, R, t, s, mR, mt, ms, e_w)
    fixed, e_valid = _on(dev, fixed, e_valid, dtype=torch.bool)
    e_i, e_j = _on(dev, e_i, e_j, dtype=torch.long)
    return dev, R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w, e_valid


def _lm_gate(ok, R, t, s, Rn, tn, sn, lam):
    return (torch.where(ok, Rn, R), torch.where(ok, tn, t),
            torch.where(ok, sn, s),
            torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-10, 1e8))


def _shard(e_i, e_j, mR, mt, ms, e_w, e_valid):
    """One shard's edges as the solvers take them: (e_i, e_j, mR, mt, ms,
    w) with w the weight, zero on invalid edges."""
    return e_i, e_j, mR, mt, ms, e_w * e_valid.to(e_w.dtype)


def _cost_fn(mesh, shards):
    """cost(R, t, s) over every shard's edges, summed over the mesh."""
    def cost(R, t, s):
        return mesh.psum([
            _cost(_edge_residuals(Rs, ts, ss, ei, ej, a, b, c), w)
            for (ei, ej, a, b, c, w), Rs, ts, ss in zip(
                shards, mesh.broadcast(R), mesh.broadcast(t),
                mesh.broadcast(s))])
    return cost


def optimize_sim3_graph(R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w, e_valid,
                        n_iters: int = 20, device=None):
    """Dense solver. R (K,3,3), t (K,3), s (K,) vertex Sim3 (world→kf);
    fixed (K,); e_i, e_j (E,) vertex ids, the measurement (mR, mt, ms)
    maps i into j; e_w, e_valid (E,). Runs on `device` (`cuda` unless
    given). Returns (R, t, s, last cost, first cost): the costs are the
    normalized gauge's, the first one before any step."""
    (dev, R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w,
     e_valid) = _prepare(R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w, e_valid,
                         device)
    return solve_dense(Mesh([dev]), R, t, s, fixed,
                       [_shard(e_i, e_j, mR, mt, ms, e_w, e_valid)], n_iters)


def solve_dense(mesh: Mesh, R, t, s, fixed, shards, n_iters: int):
    """`optimize_sim3_graph` over the edge `shards` of `mesh` (one
    (e_i, e_j, mR, mt, ms, w) a local shard, on its device; the vertices
    on the first device): each shard assembles its edges' (7K × 7K) H and
    b, the sums over the mesh are solved once on the first device. One
    shard is the one-device solver."""
    K = R.shape[0]
    dtype, dev = R.dtype, R.device
    t, s, ungauge = gauge_normalize(R, t, s)
    # the four (K,7,K,7) blocks each edge touches, summed in one pass over
    # the flat (row vertex, column vertex) index; b over [e_i; e_j]
    to_H = [SegmentSum(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej,
                                  ej * K + ei]), K * K)
            for ei, ej, *_ in shards]
    to_b = [SegmentSum(torch.cat([ei, ej]), K) for ei, ej, *_ in shards]
    free = torch.repeat_interleave(~fixed, 7)
    eye = torch.eye(7 * K, dtype=dtype, device=dev)
    pin = torch.diag(torch.where(free, 0.0, 1.0))
    cost_of = _cost_fn(mesh, shards)

    def assemble(R, t, s):
        H, b, c = [], [], []
        for (ei, ej, mR, mt, ms, w), Rs, ts, ss, tH, tb in zip(
                shards, mesh.broadcast(R), mesh.broadcast(t),
                mesh.broadcast(s), to_H, to_b):
            r, Ji, Jj = _edge_terms(Rs, ts, ss, ei, ej, mR, mt, ms)
            JiW = Ji * w[:, None, None]
            JjW = Jj * w[:, None, None]
            blocks = torch.cat([
                torch.einsum("eri,erj->eij", JiW, Ji),
                torch.einsum("eri,erj->eij", JjW, Jj),
                torch.einsum("eri,erj->eij", JiW, Jj),
                torch.einsum("eri,erj->eij", JjW, Ji)])
            H.append(tH(blocks).view(K, K, 7, 7).permute(0, 2, 1, 3)
                     .reshape(7 * K, 7 * K))
            b.append(tb(torch.cat([torch.einsum("eri,er->ei", JiW, r),
                                   torch.einsum("eri,er->ei", JjW, r)]))
                     .reshape(-1))
            c.append(_cost(r, w))
        return mesh.psum(H), mesh.psum(b), mesh.psum(c)

    lam = torch.tensor(1e-6, dtype=dtype, device=dev)
    cost1 = first = torch.zeros((), dtype=dtype, device=dev)
    for it in range(n_iters):
        H, b, cost0 = assemble(R, t, s)
        if it == 0:
            first = cost0
        Hd = H + lam * eye
        Hd = torch.where(free[:, None] & free[None, :], Hd, 0.0) + pin
        b = torch.where(free, b, 0.0)
        dx = -torch.linalg.solve_ex(Hd, b).result.reshape(K, 7)
        Rn, tn, sn = sim3_update_left(R, t, s, dx)
        cost1 = cost_of(Rn, tn, sn)
        ok = (cost1 < cost0) & torch.isfinite(cost1)
        R, t, s, lam = _lm_gate(ok, R, t, s, Rn, tn, sn, lam)
    R, t, s = ungauge(R, t, s)
    return R, t, s, cost1, first


def optimize_sim3_graph_pcg(R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w,
                            e_valid, n_iters: int = 20, cg_iters: int = 60,
                            device=None):
    """Matrix-free variant of `optimize_sim3_graph` for large graphs: the
    GN system is solved by preconditioned CG with H·v applied edge-wise
    (gather → 7×7 block products → segment sums) and the block-Jacobi
    diagonal as preconditioner, O(E·49) per CG step. f32 CG on a long
    chain loses conjugacy, so the best-residual iterate is kept; the step
    is tried at 1, 1/2, 1/4 and 1/8 and the best cost kept."""
    (dev, R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w,
     e_valid) = _prepare(R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w, e_valid,
                         device)
    return solve_pcg(Mesh([dev]), R, t, s, fixed,
                     [_shard(e_i, e_j, mR, mt, ms, e_w, e_valid)], n_iters,
                     cg_iters)


def solve_pcg(mesh: Mesh, R, t, s, fixed, shards, n_iters: int,
              cg_iters: int):
    """`optimize_sim3_graph_pcg` over the edge `shards` of `mesh` (as
    `solve_dense`): only (K,7) vectors and the (K,7,7) block-Jacobi blocks
    are summed over the mesh, one (K,7) sum per CG step. One shard is the
    one-device solver."""
    K = R.shape[0]
    dtype, dev = R.dtype, R.device
    t, s, ungauge = gauge_normalize(R, t, s)
    free_v = (~fixed).to(dtype)[:, None]              # (K,1)
    to_v = [SegmentSum(torch.cat([ei, ej]), K) for ei, ej, *_ in shards]
    scales = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=dtype, device=dev)
    cost_of = _cost_fn(mesh, shards)

    lam = torch.tensor(1e-6, dtype=dtype, device=dev)
    last = first = torch.zeros((), dtype=dtype, device=dev)
    for it in range(n_iters):
        terms, b, D, c = [], [], [], []
        for (ei, ej, mR, mt, ms, w), Rs, ts, ss, tv in zip(
                shards, mesh.broadcast(R), mesh.broadcast(t),
                mesh.broadcast(s), to_v):
            r, Ji, Jj = _edge_terms(Rs, ts, ss, ei, ej, mR, mt, ms)
            JiW = Ji * w[:, None, None]
            JjW = Jj * w[:, None, None]
            terms.append((Ji, Jj, JiW, JjW))
            b.append(tv(torch.cat([torch.einsum("eri,er->ei", JiW, r),
                                   torch.einsum("eri,er->ei", JjW, r)])))
            D.append(tv(torch.cat([torch.einsum("eri,erj->eij", JiW, Ji),
                                   torch.einsum("eri,erj->eij", JjW, Jj)])))
            c.append(_cost(r, w))
        cost0 = mesh.psum(c)
        if it == 0:
            first = cost0
        b = -mesh.psum(b) * free_v
        # block-Jacobi preconditioner with Marquardt damping on its diagonal
        D = mesh.psum(D)
        dd = torch.diagonal(D, dim1=-2, dim2=-1)
        # the blocks stay fixed through the CG loop: invert them once
        Dinv = torch.linalg.inv_ex(
            D + torch.diag_embed(lam * dd + 1e-8)).inverse

        def prec(v):
            return torch.sum(Dinv * v[:, None, :], -1) * free_v

        def Hmul(v):
            ys = []
            for (Ji, Jj, JiW, JjW), (ei, ej, *_), tv, vs in zip(
                    terms, shards, to_v, mesh.broadcast(v)):
                u = (torch.einsum("erc,ec->er", Ji, vs[ei])
                     + torch.einsum("erc,ec->er", Jj, vs[ej]))
                ys.append(tv(torch.cat([torch.einsum("erc,er->ec", JiW, u),
                                        torch.einsum("erc,er->ec", JjW, u)])))
            return (mesh.psum(ys) + lam * dd * v) * free_v

        x = torch.zeros((K, 7), dtype=dtype, device=dev)
        rcg = b
        z = prec(rcg)
        p = z
        rz = torch.sum(rcg * z)
        x_best, rn_best = x, torch.sum(b * b)
        for _ in range(cg_iters):
            Hp = Hmul(p)
            denom = torch.sum(p * Hp)
            alpha = torch.where(denom > 1e-20, rz / denom, 0.0)
            x = x + alpha * p
            rcg = rcg - alpha * Hp
            rn = torch.sum(rcg * rcg)
            better = rn < rn_best
            x_best = torch.where(better, x, x_best)
            rn_best = torch.where(better, rn, rn_best)
            z = prec(rcg)
            rz_new = torch.sum(rcg * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            rz = rz_new
        dx = x_best
        trial = torch.stack([cost_of(*sim3_update_left(R, t, s, sc * dx))
                             for sc in scales])
        trial = torch.where(torch.isfinite(trial), trial, torch.inf)
        k = torch.argmin(trial)
        cost1 = trial[k]
        Rn, tn, sn = sim3_update_left(R, t, s, scales[k] * dx)
        ok = (cost1 < cost0) & torch.isfinite(cost1)
        R, t, s, lam = _lm_gate(ok, R, t, s, Rn, tn, sn, lam)
        last = torch.where(ok, cost1, cost0)
    R, t, s = ungauge(R, t, s)
    return R, t, s, last, first


def optimize_sim3_graph_banded(R, t, s, fixed,
                               b_i, b_j, b_mR, b_mt, b_ms, b_w, b_valid,
                               l_i, l_j, l_mR, l_mt, l_ms, l_w, l_valid,
                               g: int = 8, n_iters: int = 15, device=None):
    """Exact O(K) essential-graph solver for large graphs.

    An essential graph is a temporal chain (spanning tree and strong
    covisibility, |i−j| small) plus a few long-range loop edges. Grouping
    g consecutive vertices into supernodes of size G = 7g makes the GN
    system of the in-band edges (1 <= j−i <= g) block tridiagonal over
    M = K/g supernodes, solved exactly by block-Thomas forward and
    backward passes (M sequential (G,G) solves). The long-range edges
    enter as a PSD low-rank term U·Uᵀ (rank 7 per edge), handled by the
    Woodbury identity: one extra multi-RHS Thomas pass and a small dense
    solve. The steps are exact Newton steps, tried at 1, 1/2 and 1/4.

    Caller contract: vertices time-ordered, K a multiple of g, band edges
    with 1 <= j−i <= g, long edges the rest (padded with l_valid False).

    Damping: λ·diag + 1e-7 on the block diagonal, from the band edges'
    diagonal alone, as the reference package does: a vertex held only by
    long-range edges gets the 1e-7 floor (its U·Uᵀ carries it)."""
    dev = resolve_device(device)
    R, t, s, b_mR, b_mt, b_ms, b_w, l_mR, l_mt, l_ms, l_w = _on(
        dev, R, t, s, b_mR, b_mt, b_ms, b_w, l_mR, l_mt, l_ms, l_w)
    fixed, b_valid, l_valid = _on(dev, fixed, b_valid, l_valid,
                                  dtype=torch.bool)
    b_i, b_j, l_i, l_j = _on(dev, b_i, b_j, l_i, l_j, dtype=torch.long)
    K = R.shape[0]
    dtype = R.dtype
    G = 7 * g
    M = K // g
    Ecap = l_i.shape[0]
    m_cols = 7 * Ecap
    t, s, ungauge = gauge_normalize(R, t, s)
    free = (~fixed).to(dtype)
    wb = b_w * b_valid.to(dtype)
    wl = l_w * l_valid.to(dtype)
    rows7 = torch.arange(7, device=dev)

    def flat_block(sn, ro, co, width):
        """Flat element index of the 7×7 block at (row ro, column co) of
        supernode sn in an (·, G, width) table: (E,7,7)."""
        r = ro[:, None, None] + rows7[None, :, None]
        c = co[:, None, None] + rows7[None, None, :]
        return (sn[:, None, None] * G + r) * width + c

    # ---- the fixed sum layouts of A (block tridiagonal) and U ----------
    a_sn, bsn = b_i // g, b_j // g
    oi, oj = (b_i % g) * 7, (b_j % g) * 7
    same = (a_sn == bsn) & b_valid
    adj = (bsn == a_sn + 1) & b_valid
    diag_idx = torch.cat([flat_block(a_sn, oi, oi, G),
                          flat_block(bsn, oj, oj, G),
                          flat_block(a_sn, oi, oj, G),
                          flat_block(a_sn, oj, oi, G)]).reshape(-1)
    to_diag = SegmentSum(diag_idx, M * G * G)
    to_off = SegmentSum(
        flat_block(torch.clamp(a_sn, max=M - 1), oi, oj, G).reshape(-1),
        M * G * G)
    colb = torch.arange(Ecap, device=dev) * 7
    to_U = SegmentSum(torch.cat([
        flat_block(l_i // g, (l_i % g) * 7, colb, m_cols),
        flat_block(l_j // g, (l_j % g) * 7, colb, m_cols)]).reshape(-1),
        M * G * m_cols)
    to_v = SegmentSum(torch.cat([b_i, b_j, l_i, l_j]), K)
    fixed_diag = torch.repeat_interleave(fixed.reshape(M, g), 7,
                                         dim=1).to(dtype)
    eye_cap = torch.eye(m_cols, dtype=dtype, device=dev)
    scales = torch.tensor([1.0, 0.5, 0.25], dtype=dtype, device=dev)

    def cost_of(R, t, s):
        return (_cost(_edge_residuals(R, t, s, b_i, b_j, b_mR, b_mt, b_ms),
                      wb)
                + _cost(_edge_residuals(R, t, s, l_i, l_j, l_mR, l_mt, l_ms),
                        wl))

    def masked(mask, vals):
        return torch.where(mask[:, None, None], vals, 0.0)

    lam = torch.tensor(1e-6, dtype=dtype, device=dev)
    last = first = torch.zeros((), dtype=dtype, device=dev)
    for it in range(n_iters):
        rb, Jib, Jjb = _edge_terms(R, t, s, b_i, b_j, b_mR, b_mt, b_ms)
        rl, Jil, Jjl = _edge_terms(R, t, s, l_i, l_j, l_mR, l_mt, l_ms)
        cost0 = _cost(rb, wb) + _cost(rl, wl)
        if it == 0:
            first = cost0
        # gauge fix: zero the fixed vertices' Jacobian columns
        Jib = Jib * free[b_i][:, None, None]
        Jjb = Jjb * free[b_j][:, None, None]
        Jil = Jil * free[l_i][:, None, None]
        Jjl = Jjl * free[l_j][:, None, None]

        # ---- rhs b = −Jᵀ W r over ALL edges ---------------------------
        bvec = -to_v(torch.cat([
            torch.einsum("eri,er->ei", Jib * wb[:, None, None], rb),
            torch.einsum("eri,er->ei", Jjb * wb[:, None, None], rb),
            torch.einsum("eri,er->ei", Jil * wl[:, None, None], rl),
            torch.einsum("eri,er->ei", Jjl * wl[:, None, None], rl)]))

        # ---- block-tridiagonal A from the band edges --------------------
        JiW = Jib * wb[:, None, None]
        Bii = torch.einsum("eri,erj->eij", JiW, Jib)
        Bjj = torch.einsum("eri,erj->eij", Jjb * wb[:, None, None], Jjb)
        Bij = torch.einsum("eri,erj->eij", JiW, Jjb)
        Adiag = to_diag(torch.cat([
            masked(b_valid, Bii), masked(b_valid, Bjj), masked(same, Bij),
            masked(same, Bij.transpose(-1, -2))]).reshape(-1)
        ).view(M, G, G)
        Aoff = to_off(masked(adj, Bij).reshape(-1)).view(M, G, G)
        # damping, and the identity on fixed / padding vertices
        dd = torch.diagonal(Adiag, dim1=-2, dim2=-1)    # (M, G)
        Adiag = Adiag + torch.diag_embed(lam * dd + 1e-7 + fixed_diag)

        # ---- low-rank U of the long-range edges -------------------------
        # ΔH = U·Uᵀ, per-edge columns √w·[Ji;Jj]ᵀ at rows i, j
        sqw = torch.sqrt(torch.clamp(wl, min=0.0))[:, None, None]
        U = to_U(torch.cat([Jil.transpose(-1, -2) * sqw,
                            Jjl.transpose(-1, -2) * sqw]).reshape(-1)
                 ).view(M, G, m_cols)

        # ---- block-Thomas forward / backward with multi-RHS -------------
        rhs = torch.cat([bvec.reshape(M, G, 1), U], dim=2)
        n_cols = rhs.shape[2]
        Gp = torch.zeros((G, G), dtype=dtype, device=dev)
        Yp = torch.zeros((G, n_cols), dtype=dtype, device=dev)
        Gs, Ys = [], []
        for m in range(M):
            AopT = (Aoff[m - 1] if m > 0 else Gp.new_zeros((G, G))).T
            Ci = Adiag[m] - AopT @ Gp
            sol = torch.linalg.solve_ex(
                Ci, torch.cat([Aoff[m], rhs[m] - AopT @ Yp], 1)).result
            Gp, Yp = sol[:, :G], sol[:, G:]
            Gs.append(Gp)
            Ys.append(Yp)
        x_next = torch.zeros((G, n_cols), dtype=dtype, device=dev)
        Xs = [None] * M
        for m in reversed(range(M)):
            x_next = Ys[m] - Gs[m] @ x_next
            Xs[m] = x_next
        Xs = torch.stack(Xs)
        Ainv_b = Xs[:, :, 0]                          # (M, G)
        Ainv_U = Xs[:, :, 1:]                         # (M, G, m)
        # Woodbury: dx = A⁻¹b − A⁻¹U (I + UᵀA⁻¹U)⁻¹ Uᵀ A⁻¹ b
        cap = eye_cap + torch.einsum("mgc,mgd->cd", U, Ainv_U)
        y = torch.linalg.solve_ex(
            cap, torch.einsum("mgc,mg->c", U, Ainv_b)).result
        dx = (Ainv_b - torch.einsum("mgc,c->mg", Ainv_U, y)).reshape(K, 7)
        dx = dx * free[:, None]

        def trial_cost(sc):
            return cost_of(*sim3_update_left(R, t, s, sc * dx))

        trial = torch.stack([trial_cost(sc) for sc in scales])
        trial = torch.where(torch.isfinite(trial), trial, torch.inf)
        k = torch.argmin(trial)
        cost1 = trial[k]
        Rn, tn, sn = sim3_update_left(R, t, s, scales[k] * dx)
        ok = (cost1 < cost0) & torch.isfinite(cost1)
        R, t, s, lam = _lm_gate(ok, R, t, s, Rn, tn, sn, lam)
        last = torch.where(ok, cost1, cost0)
    R, t, s = ungauge(R, t, s)
    return R, t, s, last, first
