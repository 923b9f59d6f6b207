"""Inputs and invariants for the solvers' small SVD and eigh.

One case per decomposition site of the solvers, at the shape that site sees
on its path, with the matrices that site builds (DLT systems, rank-2 E,
Kabsch and Horn matrices of minimal sets, EPnP's covariance and MᵀM)
made from a seed with numpy, plus the degenerate and non-finite entries
the paths can meet. Imports no JAX: `tests/test_torch_small_linalg.py`
holds the port's plain versions and the host build of the Jacobi routines
against JAX with these, and `tests/test_torch_kernels_cuda.py` and
`chip_smoke.py` the CUDA kernels against the plain versions.

Singular and eigenvectors are compared as projectors onto the subspace of
each cluster of equal values, never column by column: their signs, and
their basis inside a repeated value, are a free choice.

Tolerances (f32, ε = 2⁻²³ ≈ 1.19e-7). Each decomposition under test is
backward stable: it is the exact decomposition of A + E with |E| a small
multiple of n ε |A|. So
- values (σ, λ) agree within VALUE_TOL |A|₂ (Weyl), VALUE_TOL = 1e-5, about
  84 ε: the Jacobi routines show 1e-6 - 3e-6 relative at these shapes, the
  libraries less;
- the reconstruction U diag(σ) Vh (V diag(λ) Vᵀ) is within VALUE_TOL |A|₂
  of A, entry by entry;
- the bases are orthonormal within ORTHO_TOL = 1e-5 (seen: ≤ 2.5e-6 after
  the ≤ 8 sweeps of a 16×12 matrix's rotations);
- the projector onto a cluster of values separated from the rest by a
  gap g moves by at most |E| / g (Davis-Kahan, Wedin); two decompositions
  each within VALUE_TOL |A|₂ differ by at most 2 VALUE_TOL |A|₂ / g, which
  is the bound each cluster is held to (a bound ≥ 1 says nothing and is
  skipped). Values closer than CLUSTER_REL |A|₂ = 1e-3 |A|₂ form one
  cluster (a repeated σ of E, the four-dimensional null space of a
  minimal EPnP set's MᵀM).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

VALUE_TOL = 1e-5
ORTHO_TOL = 1e-5
CLUSTER_REL = 1e-3
MAX_SWEEPS = 30          # kMaxSweeps of csrc/small_linalg.cuh


class SvdSite(NamedTuple):
    name: str
    batch: tuple
    m: int
    n: int
    full_matrices: bool
    kind: str
    nonfinite: bool      # plant NaN / inf entries


class EighSite(NamedTuple):
    name: str
    batch: tuple
    n: int
    kind: str
    nonfinite: bool


# the port's call sites, solvers/<file>:<function>, at their path's shapes
SVD_SITES = [
    SvdSite("twoview_null_H", (256,), 8, 9, True, "dlt_h", True),
    SvdSite("twoview_null_F", (256,), 8, 9, True, "dlt_f", True),
    # repeated correspondences: rank 7 or 6, a null space of 2 or 3
    SvdSite("twoview_null_F_rank_deficient", (64,), 8, 9, True, "dlt_f_rank",
            False),
    SvdSite("twoview_F_rank2", (256,), 3, 3, False, "f_proj", True),
    SvdSite("twoview_E", (), 3, 3, False, "essential", False),
    SvdSite("twoview_E_nonfinite", (), 3, 3, False, "essential", True),
    SvdSite("twoview_H_decompose", (), 3, 3, False, "generic", False),
    SvdSite("twoview_H_decompose_nonfinite", (), 3, 3, False, "generic",
            True),
    SvdSite("icp_kabsch_2d", (256,), 2, 2, False, "kabsch2", True),
    SvdSite("icp_kabsch_2d_refit", (), 2, 2, False, "kabsch2_refit", False),
    SvdSite("icp_kabsch_3d", (256,), 3, 3, False, "kabsch3", True),
    SvdSite("icp_kabsch_3d_refit", (), 3, 3, False, "kabsch3_refit", False),
    SvdSite("epnp_procrustes", (256,), 3, 3, False, "procrustes", True),
    SvdSite("pnp_dlt", (256,), 12, 12, True, "dlt_pnp", True),
    SvdSite("pnp_dlt_M", (256,), 3, 3, False, "generic", True),
    # pnp_dlt on 12 and 30 points (not on a path): taller than 16 rows, no
    # U; 2 rows a lane of the kernel's 32
    SvdSite("pnp_dlt_12_points", (4,), 24, 12, True, "dlt_pnp_12", True),
    SvdSite("pnp_dlt_30_points", (4,), 60, 12, True, "dlt_pnp_30", True),
]

EIGH_SITES = [
    EighSite("epnp_cov", (256,), 3, "cov", True),
    EighSite("epnp_MtM", (256,), 12, "mtm", True),
    EighSite("sim3_horn", (256,), 4, "horn", True),
    EighSite("sim3_horn_refit", (), 4, "horn_refit", False),
    EighSite("sim3_horn_refit_nonfinite", (), 4, "horn_refit", True),
]

# batch entries given NaN / +inf / -inf when the site plants them
NAN_AT, INF_AT, NINF_AT = 1, 2, 3


def _rotation(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def _skew(t):
    return np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                     [-t[1], t[0], 0.0]])


def _two_view(rng, k, planar=False):
    """k points seen by two cameras: normalized coordinates (k,2) each."""
    X = np.c_[rng.uniform(-1, 1, (k, 2)),
              np.full(k, 4.0) if planar else rng.uniform(3, 6, k)]
    u, _, vt = np.linalg.svd(np.eye(3) + _skew(rng.normal(0, 0.05, 3)))
    R, t = u @ vt, rng.normal(0, 0.3, 3)
    x1 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:]
    return x1, x2


def _dlt_h(rng):
    x1 = rng.standard_normal((4, 2))
    H = np.eye(3) + 0.3 * rng.standard_normal((3, 3))
    h = np.c_[x1, np.ones(4)] @ H.T
    x2 = h[:, :2] / h[:, 2:] + rng.normal(0, 1e-3, (4, 2))
    u, v, up, vp = x1[:, 0], x1[:, 1], x2[:, 0], x2[:, 1]
    z, o = np.zeros(4), np.ones(4)
    r1 = np.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], -1)
    r2 = np.stack([u, v, o, z, z, z, -up * u, -up * v, -up], -1)
    return np.concatenate([r1, r2], 0)


def _dlt_f(rng, planar=False):
    x1, x2 = _two_view(rng, 8, planar)
    # Hartley normalization of each view, as twoview.normalize_points
    def norm(x):
        d = x - x.mean(0)
        return d / np.abs(d).mean(0)
    x1, x2 = norm(x1), norm(x2)
    u, v, up, vp = x1[:, 0], x1[:, 1], x2[:, 0], x2[:, 1]
    return np.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v,
                     np.ones(8)], -1)


def _essential(rng):
    return _skew(rng.standard_normal(3)) @ _rotation(rng)


def _centred_cross(rng, k, d, noise=1e-2):
    """Σ q2 q1ᵀ of k point pairs in d dimensions (the Kabsch H); k <= d
    gives a rank-deficient H."""
    p2 = rng.standard_normal((k, d))
    if d == 2:
        a = rng.uniform(-np.pi, np.pi)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    else:
        R = _rotation(rng)
    p1 = p2 @ R.T + rng.standard_normal(d) + rng.normal(0, noise, (k, d))
    q1, q2 = p1 - p1.mean(0), p2 - p2.mean(0)
    return q2.T @ q1


def _cov(rng, kind):
    X = rng.standard_normal((4, 3)) * [2.0, 1.0, 0.5]
    if kind == 1:                       # a planar set: one zero eigenvalue
        X[:, 2] = 0.0
        X = X @ _rotation(rng).T
    Q = X - X.mean(0)
    C = Q.T @ Q / 4
    if kind == 2:                       # isotropic: a triple eigenvalue
        C = np.eye(3) * rng.uniform(0.5, 2)
    if kind == 3:                       # a double eigenvalue
        R = _rotation(rng)
        C = R @ np.diag([1.0, 1.0, 3.0]) @ R.T
    return C


def _mtm(rng):
    """MᵀM of EPnP's (8,12) M for a minimal set of 4 points: rank 8, a
    four-dimensional null space."""
    alphas = rng.dirichlet(np.ones(4), 4)
    xy = rng.normal(0, 0.3, (4, 2))
    rows = []
    for a, (u, v) in zip(alphas, xy):
        rows.append(np.concatenate([aj * np.array([1.0, 0.0, -u]) for aj in a]))
        rows.append(np.concatenate([aj * np.array([0.0, 1.0, -v]) for aj in a]))
    M = np.array(rows)
    return M.T @ M


def _horn(rng, k=3, degenerate=False):
    if degenerate:                      # coincident points: N = 0
        return np.zeros((4, 4))
    S = _centred_cross(rng, k, 3, noise=1e-3)
    Sxx, Sxy, Sxz = S[0]
    Syx, Syy, Syz = S[1]
    Szx, Szy, Szz = S[2]
    return np.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]])


def _dlt_pnp(rng, k=6):
    X = np.c_[rng.uniform(-1, 1, (k, 2)), rng.uniform(3, 6, k)]
    R, t = _rotation(rng), rng.normal(0, 0.5, 3)
    Xc = X @ R.T + t
    Xc[:, 2] = np.abs(Xc[:, 2]) + 1.0
    x = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (k, 2))
    Xh = np.c_[X, np.ones(k)]
    z = np.zeros_like(Xh)
    r1 = np.c_[Xh, z, -x[:, :1] * Xh]
    r2 = np.c_[z, Xh, -x[:, 1:] * Xh]
    return np.concatenate([r1, r2], 0)


def _one(kind, rng, i):
    """The i-th matrix of a batch of `kind`."""
    if kind == "dlt_h":
        return _dlt_h(rng)
    if kind == "dlt_f":
        # entries 20-23 from coplanar points: a repeated zero σ
        return _dlt_f(rng, planar=20 <= i < 24)
    if kind == "dlt_f_rank":
        A = _dlt_f(rng)
        A[7] = A[0]
        if i % 2:
            A[6] = A[1]
        return A
    if kind == "f_proj":
        F = rng.standard_normal((3, 3))
        F /= np.linalg.norm(F)
        if 30 <= i < 36:                # already rank 2 (projected)
            u, s, vt = np.linalg.svd(F)
            F = (u * [s[0], s[1], 0.0]) @ vt
        return F
    if kind == "essential":
        return _essential(rng)
    if kind == "generic":
        return rng.standard_normal((3, 3))
    if kind == "kabsch2":               # minimal set of 2: rank 1
        return _centred_cross(rng, 2, 2)
    if kind == "kabsch2_refit":
        return _centred_cross(rng, 200, 2)
    if kind == "kabsch3":               # minimal set of 3: rank 2
        return _centred_cross(rng, 3, 3)
    if kind == "kabsch3_refit":
        return _centred_cross(rng, 200, 3)
    if kind == "procrustes":            # EPnP's 4 control points
        H = _centred_cross(rng, 4, 3)
        return H if i % 16 else np.zeros((3, 3))   # some all-zero H
    if kind == "dlt_pnp":
        return _dlt_pnp(rng)
    if kind.startswith("dlt_pnp_"):
        return _dlt_pnp(rng, int(kind.rsplit("_", 1)[1]))
    if kind == "cov":
        return _cov(rng, i % 4)
    if kind == "mtm":
        return _mtm(rng)
    if kind == "horn":
        return _horn(rng, degenerate=(i % 32 == 5))
    if kind == "horn_refit":
        return _horn(rng, k=300)
    raise ValueError(kind)


def make_input(site, seed=0):
    """The site's f32 batch, shaped (*batch, m, n), with NaN / ±inf entries
    planted where the site asks for them."""
    rng = np.random.default_rng(seed)
    B = int(np.prod(site.batch)) if site.batch else 1
    A = np.stack([_one(site.kind, rng, i) for i in range(B)])
    A = A.astype(np.float32)
    if site.nonfinite:
        if B == 1:
            A[0, 0, -1] = np.nan
        else:
            A[NAN_AT, 1, 1] = np.nan
            A[INF_AT, 0, 0] = np.inf
            A[NINF_AT, -1, -1] = -np.inf
    return A.reshape(*site.batch, *A.shape[-2:])


_W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def det_inputs(batch=64, seed=0):
    """The matrices whose determinant the solvers take, built from the SVD
    sites' inputs with numpy's SVD: solvers/twoview.py's
    `decompose_essential` R1 = U W Vh and R2 = U Wᵀ Vh and
    `motion_hypotheses_from_H`'s U and Vh; solvers/icp.py's V Uᵀ of the
    2-D and 3-D Kabsch matrices, minimal sets and refits. name ->
    (batch, d, d) f32, each orthogonal with det ±1."""
    sites = {s.name: s for s in SVD_SITES}

    def svd(name):
        site = sites[name]._replace(batch=(batch,), nonfinite=False)
        return np.linalg.svd(make_input(site, seed).astype(np.float64))

    out = {}
    U, _, Vh = svd("twoview_E")
    out.update(twoview_R1=U @ _W @ Vh, twoview_R2=U @ _W.T @ Vh)
    U, _, Vh = svd("twoview_H_decompose")
    out.update(twoview_H_U=U, twoview_H_Vh=Vh)
    for name in ("icp_kabsch_2d", "icp_kabsch_2d_refit", "icp_kabsch_3d",
                 "icp_kabsch_3d_refit"):
        U, _, Vh = svd(name)
        out[name] = np.swapaxes(Vh, -1, -2) @ np.swapaxes(U, -1, -2)
    return {k: v.astype(np.float32) for k, v in out.items()}


def finite_entries(A):
    """(B,) mask of the matrices with no non-finite entry."""
    A = np.asarray(A).reshape(-1, *np.shape(A)[-2:])
    return np.isfinite(A).all((-1, -2))


def _flat(x, tail):
    """x as float64 with its batch dimensions flattened into one."""
    x = np.asarray(x, np.float64)
    return x.reshape(-1, *x.shape[x.ndim - tail:])


def _clusters(vals, scale):
    """Index groups of `vals` (sorted) closer than CLUSTER_REL·scale."""
    groups = [[0]]
    for i in range(1, len(vals)):
        if abs(vals[i] - vals[i - 1]) <= CLUSTER_REL * scale:
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


def projector_err(cols, vals, cols_ref, vals_ref, scale):
    """Largest excess of the cluster projectors' difference over its bound,
    as max(|P − P_ref|_max − bound, 0), for one matrix; also the largest
    difference seen. `cols` (d, k) orthonormal columns paired with `vals`
    (k,), sorted; clusters from the reference's values. The bound adds
    2 ORTHO_TOL for the bases' own rounding. One cluster holding every
    column spans everything and is left to the orthogonality check."""
    excess, worst = 0.0, 0.0
    groups = _clusters(vals_ref, scale)
    if len(groups) == 1:
        return excess, worst
    for g in groups:
        others = [vals_ref[j] for j in range(len(vals_ref)) if j not in g]
        gap = min(abs(vals_ref[i] - o) for i in g for o in others)
        bound = (2 * VALUE_TOL * scale / gap + 2 * ORTHO_TOL if gap > 0
                 else np.inf)
        if bound >= 1.0:
            continue
        P = cols[:, g] @ cols[:, g].T
        P_ref = cols_ref[:, g] @ cols_ref[:, g].T
        d = float(np.abs(P - P_ref).max())
        worst = max(worst, d)
        excess = max(excess, d - bound)
    return excess, worst


class Report(NamedTuple):
    """Largest errors over the finite matrices of a batch, each relative
    to its matrix's |A|₂ where it is a value or a reconstruction."""
    value: float
    reconstruction: float
    orthogonality: float
    projector: float
    projector_excess: float
    n_finite: int
    n_nonfinite: int


def _check_nonfinite(outs, ok, what):
    for x in outs:
        x = np.asarray(x).reshape(len(ok), -1)
        assert np.isnan(x[~ok]).all(), f"{what}: a non-finite input must " \
            "give NaN in every output"
        assert np.isfinite(x[ok]).all(), f"{what}: a finite input gave a " \
            "non-finite output"


def check_svd(A, U, S, Vh, ref, what="svd"):
    """Hold (U, S, Vh) of the batch A (*batch, m, n) to the invariants and
    to the reference decomposition `ref` = (U, S, Vh) (any library's, with
    the same full_matrices), asserting the tolerances above; NaN in every
    output exactly where A has a non-finite entry. U None (a matrix taller
    than 16 rows) leaves U's checks out and holds |A vⱼ| to σⱼ instead of
    the reconstruction. Returns a Report."""
    m, n = np.shape(A)[-2:]
    A = _flat(A, 2)
    no_u = U is None
    Vh, S = _flat(Vh, 2), _flat(S, 1)
    U = np.zeros((len(A), m, 0)) if no_u else _flat(U, 2)
    Ur, Sr, Vhr = _flat(ref[0], 2), _flat(ref[1], 1), _flat(ref[2], 2)
    ok = finite_entries(A)
    _check_nonfinite((S, Vh) if no_u else (U, S, Vh), ok, what)
    ref_bad = ~np.isfinite(Sr).all(-1)
    assert (ref_bad == ~ok).all(), f"{what}: the reference's non-finite " \
        "entries differ from the input's"
    k = min(m, n)
    ku, kv = U.shape[-1], Vh.shape[-2]
    val = rec = orth = proj = excess = 0.0
    for b in np.flatnonzero(ok):
        scale = max(float(Sr[b, 0]), np.finfo(np.float32).tiny)
        val = max(val, float(np.abs(S[b] - Sr[b]).max()) / scale)
        if no_u:
            norms = np.linalg.norm(A[b] @ Vh[b].T, axis=0)
            want = np.r_[S[b], np.zeros(max(kv - k, 0))][:kv]
            rec = max(rec, float(np.abs(norms - want).max()) / scale)
        else:
            R = (U[b, :, :k] * S[b]) @ Vh[b, :k, :]
            rec = max(rec, float(np.abs(R - A[b]).max()) / scale)
        orth = max(orth, float(np.abs(Vh[b] @ Vh[b].T - np.eye(kv)).max()))
        if not no_u:
            orth = max(orth, float(np.abs(U[b].T @ U[b] - np.eye(ku)).max()))
        # U's and V's columns with their values; past k the values are 0
        s_u = np.r_[Sr[b], np.zeros(max(ku - k, 0))][:ku]
        s_v = np.r_[Sr[b], np.zeros(max(kv - k, 0))][:kv]
        pairs = [(Vh[b].T, Vhr[b].T, s_v)]
        if not no_u:
            pairs.append((U[b], Ur[b], s_u))
        for cols, cols_r, vals in pairs:
            e, w = projector_err(cols, vals, cols_r, vals, scale)
            excess, proj = max(excess, e), max(proj, w)
    rep = Report(val, rec, orth, proj, excess, int(ok.sum()),
                 int((~ok).sum()))
    assert rep.value <= VALUE_TOL, f"{what}: σ off by {rep.value} |A|"
    assert rep.reconstruction <= VALUE_TOL, \
        f"{what}: U diag(σ) Vh off A by {rep.reconstruction} |A|"
    assert rep.orthogonality <= ORTHO_TOL, \
        f"{what}: bases orthogonal to {rep.orthogonality}"
    assert rep.projector_excess == 0.0, \
        f"{what}: a singular subspace beyond its bound by {excess}"
    return rep


def check_eigh(A, w, V, ref, what="eigh"):
    """As `check_svd` for (w, V) of the symmetric batch A against
    `ref` = (w, V)."""
    n = np.shape(A)[-1]
    A = _flat(A, 2)
    w, V = _flat(w, 1), _flat(V, 2)
    wr, Vr = _flat(ref[0], 1), _flat(ref[1], 2)
    ok = finite_entries(A)
    _check_nonfinite((w, V), ok, what)
    ref_bad = ~np.isfinite(wr).all(-1)
    assert (ref_bad == ~ok).all(), f"{what}: the reference's non-finite " \
        "entries differ from the input's"
    val = rec = orth = proj = excess = 0.0
    for b in np.flatnonzero(ok):
        scale = max(float(np.abs(wr[b]).max()), np.finfo(np.float32).tiny)
        val = max(val, float(np.abs(w[b] - wr[b]).max()) / scale)
        R = (V[b] * w[b]) @ V[b].T
        rec = max(rec, float(np.abs(R - A[b]).max()) / scale)
        orth = max(orth, float(np.abs(V[b].T @ V[b] - np.eye(n)).max()))
        e, d = projector_err(V[b], wr[b], Vr[b], wr[b], scale)
        excess, proj = max(excess, e), max(proj, d)
    rep = Report(val, rec, orth, proj, excess, int(ok.sum()),
                 int((~ok).sum()))
    assert rep.value <= VALUE_TOL, f"{what}: λ off by {rep.value} |A|"
    assert rep.reconstruction <= VALUE_TOL, \
        f"{what}: V diag(λ) Vᵀ off A by {rep.reconstruction} |A|"
    assert rep.orthogonality <= ORTHO_TOL, \
        f"{what}: eigenvectors orthogonal to {rep.orthogonality}"
    assert rep.projector_excess == 0.0, \
        f"{what}: an eigenspace beyond its bound by {excess}"
    return rep
