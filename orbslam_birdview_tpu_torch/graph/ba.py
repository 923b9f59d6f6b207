"""Bundle adjustment with explicit Schur complement, fully batched.

A dense-block Schur design in place of a sparse graph optimizer:

- Landmarks (front 3D points and BEV ground points live in ONE combined
  vertex array) are eliminated analytically: Hpp is block-diagonal 3x3.
- The camera-landmark coupling W is materialized as a dense (C, 6, P, 3)
  tensor — at SLAM scales (C ≤ 64 cameras, P ≤ 16k points) this is a few
  MB and turns the Schur product S = Hcc − W Hpp⁻¹ Wᵀ into one matmul.
- The reduced camera system (6C × 6C) is solved densely.

Edge types: monocular reprojection, stereo reprojection and BEV 3D
point-to-point. Robust Huber weights and the outlier re-classification
between the two phases (5.991 / 7.815 gates) follow ORB-SLAM2's 5+10
iteration local-BA protocol.

The LM loop has a fixed length and accepts or rejects each step with
`torch.where` on a device flag: no host sync. The scatter sums go through
`segsum.SegmentSum`, whose layouts are built once per problem: a BA run
twice on the card gives the same bits.

On a CUDA device the LM (~10,600 small kernels a BA) runs as CUDA graphs
captured at a problem shape's first call and replayed at every later one:
issued op by op, the host took as long to launch the kernels as the device
took to run them. A shape has four graphs (`_LM`): the set-up, ONE LM
iteration, replayed for each of the 15, the re-classification between the
phases and the final classification. (The whole LM as one graph took
~2.5× its eager run to capture and instantiate, too much for a set-up that
captures 15 buckets.) The graphs live in a process-wide cache (`_GRAPHS`),
so every `System` of a process shares them; `GRAPH_COUNTS` counts the
shapes captured and the BAs replayed. Each call copies its inputs into the
graphs' own input buffers and returns clones of their outputs, so a result
is never overwritten by a later replay and the caller's tensors are never
written. On the CPU the same pieces run eagerly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..core import lie, robust
from . import residuals
from .segsum import SegmentSum

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
CHI2_BIRD = 7.815
_CHI2 = {"mono": CHI2_MONO, "stereo": CHI2_STEREO, "bird": CHI2_BIRD}


class EdgeSet(NamedTuple):
    """Padded edge list. obs is (E,2) mono, (E,3) stereo (u,v,uR) or (E,3)
    bird (camera-frame point)."""

    cam: torch.Tensor   # (E,) int32
    pt: torch.Tensor    # (E,) int32 — index into the combined landmark array
    obs: torch.Tensor
    info: torch.Tensor  # (E,)
    valid: torch.Tensor


class BAResult(NamedTuple):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    points: torch.Tensor
    inl_mono: torch.Tensor
    inl_stereo: torch.Tensor
    inl_bird: torch.Tensor
    cost: torch.Tensor


def _inv3x3(A):
    """Batched closed-form 3x3 inverse for PSD blocks; A (…,3,3).

    Jacobi-equilibrated adjugate: B = D^-½ A D^-½ (unit diagonal) is
    inverted in closed form, then unscaled. Raw cofactor expansion is
    numerically fatal at f32 for ill-conditioned Hpp blocks (a landmark
    with one mono observation has rank-2 JᵀJ at scale s≈(f/z)²~10³; its
    true det ~ s²·λ is BELOW the cancellation noise s³·2⁻²⁴ of the raw
    expansion, so the computed det — and hence the inverse — is garbage).
    After equilibration every cofactor is O(1) and det(B) ∈ [0,1], so f32
    round-off (~2⁻²⁴ absolute) is harmless; det is clamped from below (PSD
    ⇒ det ≥ 0 exactly; tiny or round-off-negative dets mean a singular
    block, which LM damping regularizes on the next iteration anyway)."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp(diag, min=1e-30))
    B = A * s[..., :, None] * s[..., None, :]
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    d, e, f = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    g, h, i = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.clamp(det, min=1e-6)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    inv_B = adj / det[..., None, None]
    return inv_B * s[..., :, None] * s[..., None, :]


def _damp(H, lam, floor=1e-6):
    """Marquardt damping: H + λ·diag(max(diag H, floor)) — scale-free,
    unlike λ·I. In f32 this is essential: additive λ=1e-4 leaves a
    one-observation Hpp block at condition ~(f/z)²/λ ≈ 2²⁴ (unsolvable in
    f32), multiplicative bounds it by ~(1+λ)/λ ≈ 10⁴. It also prevents the
    huge |dxp| candidate steps that additive damping allows along
    weakly-observed directions."""
    n = H.shape[-1]
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=floor)
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return H + eye * (lam * d)[..., None, :]


def _robust_cost(kind, chi2, valid, ok, use_huber):
    """Σ ρ(chi²) over the valid edges; cheirality-gated edges pay a fixed
    penalty: otherwise an LM step that throws points behind the camera
    zeroes the masked cost and gets ACCEPTED as a "perfect" solution
    (degenerate minimum of the mask)."""
    chi_th = _CHI2[kind]
    rho = robust.huber_rho(chi2, chi_th) if use_huber else chi2
    cost = torch.where(valid & ok, rho, 0.0).sum()
    return cost + 10.0 * chi_th * (valid & ~ok).to(chi2.dtype).sum()


def _edge_terms(kind, cam_R, cam_t, points, es: EdgeSet, intr, use_huber):
    """Residual/Jacobian/weight per edge. kind in {mono, stereo, bird}."""
    R = cam_R[es.cam]
    t = cam_t[es.cam]
    X = points[es.pt]
    fx, fy, cx, cy, bf = intr
    if kind == "mono":
        e, Jc, Jp, ok = residuals.mono_reproj(R, t, X, es.obs, fx, fy, cx, cy)
    elif kind == "stereo":
        e, Jc, Jp, ok = residuals.stereo_reproj(R, t, X, es.obs, fx, fy, cx,
                                                cy, bf)
    else:
        e, Jc, Jp = residuals.bird_point(R, t, X, es.obs)
        ok = torch.ones(e.shape[0], dtype=torch.bool, device=e.device)
    chi2 = torch.sum(e * e, dim=-1) * es.info
    w_rob = robust.huber_weight(chi2, _CHI2[kind]) if use_huber else 1.0
    w = w_rob * es.info * (es.valid & ok).to(e.dtype)
    cost = _robust_cost(kind, chi2, es.valid, ok, use_huber)
    return e, Jc, Jp, w, cost, chi2, ok


def _cost_only(cam_R, cam_t, points, edge_sets, intr, use_huber):
    """Total cost without Jacobian/Hessian assembly — candidate-step
    evaluation inside LM (the full `_assemble` materializes the (C,6,P,3)
    coupling tensor W; skipping it halves the per-iteration work)."""
    fx, fy, cx, cy, bf = intr
    total = torch.zeros((), dtype=cam_R.dtype, device=cam_R.device)
    for kind, es in edge_sets:
        if es is None:
            continue
        R = cam_R[es.cam]
        t = cam_t[es.cam]
        X = points[es.pt]
        if kind == "mono":
            _, chi2, ok = residuals.mono_reproj_cost(
                R, t, X, es.obs, es.info, fx, fy, cx, cy)
        elif kind == "stereo":
            _, chi2, ok = residuals.stereo_reproj_cost(
                R, t, X, es.obs, es.info, fx, fy, cx, cy, bf)
        else:
            e = es.obs - (residuals._rot(R, X) + t)
            chi2 = torch.sum(e * e, -1) * es.info
            ok = torch.ones(e.shape[0], dtype=torch.bool, device=e.device)
        total = total + _robust_cost(kind, chi2, es.valid, ok, use_huber)
    return total


def _classify(kind, cam_R, cam_t, points, es: EdgeSet, intr):
    _, _, _, _, _, chi2, ok = _edge_terms(kind, cam_R, cam_t, points, es,
                                          intr, False)
    return es.valid & ok & (chi2 <= _CHI2[kind])


def _gram(Ja, w, Jb):
    """Σ_i Ja[n,i,j]·w[n]·Jb[n,i,k] -> (n,j,k), as a broadcast
    multiply-reduce: exact f32 in a fixed order per edge."""
    return torch.sum(
        Ja[:, :, :, None] * (w[:, None, None, None] * Jb[:, :, None, :]),
        dim=1)


def _gramv(Ja, w, e):
    """Σ_i Ja[n,i,j]·w[n]·e[n,i] -> (n,j)."""
    return torch.sum(Ja * (w[:, None] * e)[:, :, None], dim=1)


class Layouts(NamedTuple):
    """The scatter layouts of one problem's edges, all types concatenated
    in the order of `edge_sets`: to cameras, to points, and to the flat
    (camera, point) index of the coupling W."""

    cam: SegmentSum
    pt: SegmentSum
    cam_pt: SegmentSum


def layouts(edge_sets, C, P) -> Layouts:
    cams = torch.cat([es.cam for _, es in edge_sets if es is not None])
    pts = torch.cat([es.pt for _, es in edge_sets if es is not None])
    return Layouts(SegmentSum(cams, C), SegmentSum(pts, P),
                   SegmentSum(cams.long() * P + pts.long(), C * P))


def _assemble(cam_R, cam_t, points, edge_sets, intr, use_huber, lay):
    """The normal equations' blocks, every edge type summed in one pass
    per target through the problem's layouts."""
    dtype, dev = cam_R.dtype, cam_R.device
    total_cost = torch.zeros((), dtype=dtype, device=dev)
    acc, bcs, app, bps, wcp = [], [], [], [], []
    for kind, es in edge_sets:
        if es is None:
            continue
        e, Jc, Jp, w, cost, _, _ = _edge_terms(
            kind, cam_R, cam_t, points, es, intr, use_huber)
        total_cost = total_cost + cost
        acc.append(_gram(Jc, w, Jc))
        bcs.append(_gramv(Jc, w, e))
        app.append(_gram(Jp, w, Jp))
        bps.append(_gramv(Jp, w, e))
        wcp.append(_gram(Jc, w, Jp))                       # (E,6,3)
    C, P = lay.cam.n, lay.pt.n
    Hcc = lay.cam(torch.cat(acc))
    bc = lay.cam(torch.cat(bcs))
    Hpp = lay.pt(torch.cat(app))
    bp = lay.pt(torch.cat(bps))
    # W is summed camera-major over the flat (camera, point) index and
    # handed on in the (C, 6, P, 3) layout
    W = lay.cam_pt(torch.cat(wcp)).view(C, P, 6, 3).permute(0, 2, 1, 3)
    return Hcc, bc, Hpp, bp, W, total_cost


def _schur_solve(Hcc, bc, Hpp, bp, W, lam, cam_free, pt_free, C, P):
    dtype, dev = Hcc.dtype, Hcc.device
    # damping
    dHcc = _damp(Hcc, lam)
    dHpp = _damp(Hpp, lam)
    # freeze invalid/fixed points by forcing their block to identity, rhs 0
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(P, 3, 3)
    dHpp = torch.where(pt_free[:, None, None], dHpp, eye3)
    bp = torch.where(pt_free[:, None], bp, 0.0)
    W = W * pt_free[None, None, :, None].to(dtype)

    Hpp_inv = _inv3x3(dHpp)
    W3 = W.reshape(C * 6, P, 3)
    # Y[a,p,l] = Σ_k W3[a,p,k]·G[p,k,l] as a broadcast-reduce
    Y = torch.sum(W3[:, :, :, None] * Hpp_inv[None], dim=2)
    # block-diagonal Hcc
    S = torch.block_diag(*dHcc.unbind(0))
    # a plain contraction over (P, 3); TF32 is off package-wide
    S = S - Y.reshape(C * 6, P * 3) @ W3.reshape(C * 6, P * 3).T
    rhs = bc.reshape(-1) - torch.sum(Y * bp[None], dim=(1, 2))
    # freeze fixed cameras
    free6 = torch.repeat_interleave(cam_free, 6)
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free6, 0.0, 1.0))
    rhs = torch.where(free6, rhs, 0.0)
    # solve_ex: no singularity check, hence no host sync; a singular system
    # yields a non-finite step, which the LM gate rejects
    dxc = -torch.linalg.solve_ex(S, rhs).result
    # bp − Wᵀ(−dxc), then the 3x3 block solve — both broadcast-reduce
    tmp = bp + torch.sum(W3 * dxc[:, None, None], dim=0)
    dxp = -torch.sum(Hpp_inv * tmp[:, None, :], dim=-1)
    dxp = torch.where(pt_free[:, None], dxp, 0.0)
    return dxc.reshape(C, 6), dxp


# the dtype the LM takes each input in: the camera and point arrays, then
# the fields of each edge set
_ARRAY_DTYPES = (torch.float32, torch.float32, torch.bool, torch.bool,
                 torch.float32, torch.bool)
_EDGE_DTYPES = EdgeSet(torch.long, torch.long, torch.float32, torch.float32,
                       torch.bool)


def _fields(problem) -> list:
    """(cam_R, cam_t, cam_fixed, cam_valid, points, point_valid, mono,
    stereo, bird) as one flat list: the six arrays, then the fields of each
    edge set that is present."""
    flat = list(problem[:6])
    for es in problem[6:]:
        if es is not None:
            flat.extend(es)
    return flat


def _unflatten(flat, present) -> tuple:
    """`_fields`' inverse, for the edge sets marked in `present`."""
    it = iter(flat)
    arrays = tuple(next(it) for _ in range(6))
    return arrays + tuple(
        EdgeSet(*(next(it) for _ in EdgeSet._fields)) if p else None
        for p in present)


def _edges_on(es: Optional[EdgeSet], dev) -> Optional[EdgeSet]:
    if es is None:
        return None
    return EdgeSet(*(torch.as_tensor(x, dtype=dt, device=dev)
                     for x, dt in zip(es, _EDGE_DTYPES)))


def _dtypes(present) -> list:
    return _fields((*_ARRAY_DTYPES,
                    *(_EDGE_DTYPES if p else None for p in present)))


class _LM:
    """The LM of one problem, in four pieces that keep its state in place:
    `start` once, `step` once an LM iteration, `between` between the two
    phases and `finish` at the end (`_run`). In that order they are
    ORB-SLAM2's 5 + 10 iteration local BA, op for op; on a CUDA device each
    piece is captured once a problem shape and replayed. The inputs are
    tensors of one device in the dtypes of `_ARRAY_DTYPES` and
    `_EDGE_DTYPES`. No piece reads anything back to the host or copies
    anything to the device."""

    def __init__(self, cam_R, cam_t, cam_fixed, cam_valid, points,
                 point_valid, mono, stereo, bird, intr, reclassify):
        self.inputs = (cam_R, cam_t, cam_fixed, cam_valid, points,
                       point_valid)
        self.sets = [("mono", mono), ("stereo", stereo), ("bird", bird)]
        self.intr, self.reclassify = intr, reclassify
        # the state handed from piece to piece: the iterate, the damping,
        # the cost and the edges the phase counts
        self.cam_R, self.cam_t, self.points = (
            torch.empty_like(x) for x in (cam_R, cam_t, points))
        self.lam = torch.empty((), dtype=cam_R.dtype, device=cam_R.device)
        self.cost = torch.empty_like(self.lam)
        self.valid = [None if es is None else torch.empty_like(es.valid)
                      for _, es in self.sets]

    def _phase_sets(self):
        return [(kind, None if es is None else es._replace(valid=v))
                for (kind, es), v in zip(self.sets, self.valid)]

    def _new_phase(self):
        self.lam.fill_(1e-4)
        self.cost.zero_()

    def start(self):
        cam_R, cam_t, cam_fixed, cam_valid, points, point_valid = self.inputs
        dev = cam_R.device
        C = cam_R.shape[0]
        P = points.shape[0]
        self.cam_free = cam_valid & ~cam_fixed
        # points referenced by no valid edge must be frozen
        n_refs = torch.zeros((P,), dtype=torch.int32, device=dev)
        for _, es in self.sets:
            if es is not None:
                n_refs.index_add_(0, es.pt, es.valid.to(torch.int32))
        self.pt_free = point_valid & (n_refs > 0)
        # the edges stay fixed across every iteration: one layout per problem
        self.lay = layouts(self.sets, C, P)
        for dst, src in ((self.cam_R, cam_R), (self.cam_t, cam_t),
                         (self.points, points)):
            dst.copy_(src)
        for v, (_, es) in zip(self.valid, self.sets):
            if v is not None:
                v.copy_(es.valid)
        self._new_phase()

    def step(self):
        """One LM iteration, Huber-weighted, accepted or rejected on the
        device."""
        msets, intr, lay = self._phase_sets(), self.intr, self.lay
        cam_R, cam_t, points, lam = self.cam_R, self.cam_t, self.points, \
            self.lam
        C, P = lay.cam.n, lay.pt.n
        Hcc, bc, Hpp, bp, W, cost0 = _assemble(
            cam_R, cam_t, points, msets, intr, True, lay)
        dxc, dxp = _schur_solve(
            Hcc, bc, Hpp, bp, W, lam, self.cam_free, self.pt_free, C, P)
        Rn, tn = lie.se3_update_left(cam_R, cam_t, dxc)
        pn = points + dxp
        cost1 = _cost_only(Rn, tn, pn, msets, intr, True)
        # gate on the STEP's finiteness, not just cost1: a NaN pose
        # fails the z>0 depth check, silently dropping its edges from
        # cost1 — a NaN state can otherwise look like a cost decrease
        ok = ((cost1 < cost0) & torch.isfinite(cost1)
              & torch.isfinite(dxc).all() & torch.isfinite(dxp).all())
        cam_R.copy_(torch.where(ok, Rn, cam_R))
        cam_t.copy_(torch.where(ok, tn, cam_t))
        points.copy_(torch.where(ok, pn, points))
        lam.copy_(torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0),
                              1e-9, 1e8))
        # the ACCEPTED state's cost (cost0 if the step was rejected),
        # not the candidate's
        self.cost.copy_(torch.where(ok, cost1, cost0))

    def _masks(self, sets):
        return [None if es is None else _classify(
            kind, self.cam_R, self.cam_t, self.points, es, self.intr)
            for kind, es in sets]

    def between(self):
        """Outlier re-classification between the phases; the second phase
        starts its damping and cost afresh."""
        if self.reclassify:
            for v, m in zip(self.valid, self._masks(self._phase_sets())):
                if v is not None:
                    v.copy_(m)
        self._new_phase()

    def finish(self) -> BAResult:
        # final classification is against the ORIGINAL edge sets: an edge
        # excluded between phases re-qualifies if consistent with the
        # final state
        m_mono, m_stereo, m_bird = self._masks(self.sets)
        empty = torch.zeros((0,), dtype=torch.bool, device=self.lam.device)
        return BAResult(
            self.cam_R,
            self.cam_t,
            self.points,
            m_mono if m_mono is not None else empty,
            m_stereo if m_stereo is not None else empty,
            m_bird if m_bird is not None else empty,
            self.cost,
        )


def _run(start, step, between, finish, iters_phase1, iters_phase2):
    """The LM's pieces in order: run eagerly, or their graphs replayed."""
    start()
    for _ in range(iters_phase1):
        step()
    between()
    for _ in range(iters_phase2):
        step()
    return finish()


class _Graphs(NamedTuple):
    """One problem shape's LM pieces captured as CUDA graphs."""

    start: "torch.cuda.CUDAGraph"
    step: "torch.cuda.CUDAGraph"
    between: "torch.cuda.CUDAGraph"
    finish: "torch.cuda.CUDAGraph"
    inputs: list        # the input buffers, in `_fields`' order
    outputs: BAResult   # `finish`'s result, rewritten by every run
    lm: _LM             # keeps alive every tensor the graphs hand on


# (device, edge sets present, every input's shape, intrinsics,
# reclassify) -> _Graphs; bounded by the callers' pow2 problem buckets
_GRAPHS: dict = {}
# device -> (capture stream, memory pool), shared by the device's graphs
_CAPTURE: dict = {}
# problem shapes captured, and BAs run as graph replays
GRAPH_COUNTS = {"capture": 0, "replay": 0}


def _capture(dev, srcs, present, intr, reclassify) -> _Graphs:
    """Capture the LM's pieces for new input buffers that hold `srcs`.

    A device's graphs share one capture stream and one memory pool. That
    is safe because every BA replays its four graphs back to back on the
    caller's stream, its first graph computes everything its others read
    (apart from the inputs, which are no graph's memory), and its outputs
    are cloned before another BA's graphs run. The first capture on a
    device runs the LM once eagerly on the capture stream before it, so
    that the libraries' handles and workspaces exist before any capture."""
    inputs = [torch.empty(s.shape, dtype=dt, device=dev).copy_(s)
              for s, dt in zip(srcs, _dtypes(present))]
    lm = _LM(*_unflatten(inputs, present), intr, reclassify)
    pieces = (lm.start, lm.step, lm.between, lm.finish)
    if dev not in _CAPTURE:
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            _run(*pieces, 1, 1)
        torch.cuda.current_stream(dev).wait_stream(stream)
        _CAPTURE[dev] = (stream, torch.cuda.graph_pool_handle())
    stream, pool = _CAPTURE[dev]
    graphs = []
    for piece in pieces:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = piece()
        graphs.append(graph)
    GRAPH_COUNTS["capture"] += 1
    return _Graphs(*graphs, inputs, outputs, lm)


def _replay(dev, problem, intr, iters_phase1, iters_phase2,
            reclassify) -> BAResult:
    """The LM on `dev` as its problem shape's graphs: captured at the
    shape's first call; the inputs copied in, the graphs replayed, the
    outputs cloned out."""
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    srcs = [torch.as_tensor(x) for x in _fields(problem)]
    present = tuple(es is not None for es in problem[6:])
    key = (dev, present, tuple(tuple(s.shape) for s in srcs), intr,
           reclassify)
    with torch.cuda.device(dev):
        g = _GRAPHS.get(key)
        if g is None:
            g = _GRAPHS[key] = _capture(dev, srcs, present, intr,
                                        reclassify)
        else:
            for buf, src in zip(g.inputs, srcs):
                buf.copy_(src)
        _run(g.start.replay, g.step.replay, g.between.replay,
             g.finish.replay, iters_phase1, iters_phase2)
        GRAPH_COUNTS["replay"] += 1
        return BAResult(*(x.clone() for x in g.outputs))


def bundle_adjust(
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
    device=None,
) -> BAResult:
    """Levenberg-Marquardt BA with Schur elimination, on `device` (`cuda`
    unless given): on a CUDA device as its problem shape's CUDA graphs,
    replayed on the current stream (a device's graphs share one memory
    pool, so calls on one device must not overlap on two streams), eagerly
    on the CPU. The result's tensors are the call's own.

    cam poses are Tcw; `cam_fixed` marks frontier/anchor keyframes whose
    poses must not move. Landmarks: one combined array (front 3D points
    then BEV points); each edge indexes it via `pt`."""
    dev = resolve_device(device)
    problem = (cam_R, cam_t, cam_fixed, cam_valid, points, point_valid,
               mono, stereo, bird)
    intr = (fx, fy, cx, cy, bf)
    if dev.type == "cuda":
        return _replay(dev, problem, intr, iters_phase1, iters_phase2,
                       reclassify)
    arrays = (torch.as_tensor(x, dtype=dt, device=dev)
              for x, dt in zip(problem[:6], _ARRAY_DTYPES))
    lm = _LM(*arrays, *(_edges_on(es, dev) for es in problem[6:]), intr,
             reclassify)
    return _run(lm.start, lm.step, lm.between, lm.finish, iters_phase1,
                iters_phase2)
