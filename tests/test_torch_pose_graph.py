"""The Sim3 essential-graph solvers, the JAX package against the port, on
the CPU: dense, PCG and banded, each against its own JAX counterpart (same
solver on both sides), on the problems of `tests/test_graph.py`
(`test_sim3_pose_graph_pcg_matches_dense`, `_banded_matches_dense`), plus
`gauge_normalize` and a banded graph with a vertex held only by long-range
edges.

Tolerance: scales within 1e-3 and translations within 5e-3 m of the JAX
result (the solver-against-solver bars of `tests/test_graph.py` are 5e-3
and 5e-2), rotations within 1e-3; both packages sum and factor in f32 in
another order (the port's PCG inverts its block-Jacobi blocks once, the
JAX one solves them by Cholesky every CG step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid
from orbslam_birdview_tpu.graph import pose_graph as jpg
from orbslam_birdview_tpu_torch.graph import pose_graph as pg
from test_graph import _ring_pose_graph, _split_band

S_TOL, T_TOL, R_TOL = 1e-3, 5e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


def drift_circle():
    """The chain + loop edge of `test_sim3_pose_graph_pcg_matches_dense`."""
    rng = np.random.default_rng(3)
    K = 40
    yaw = np.linspace(0, 2 * np.pi, K, endpoint=False)
    vR, vt = [], []
    for i in range(K):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = np.array([5 * np.cos(yaw[i]), 5 * np.sin(yaw[i]), 0], np.float32)
        vR.append(R.T)
        vt.append((-R.T @ t).astype(np.float32))
    vR, vt = np.stack(vR), np.stack(vt)
    e_i = np.arange(K - 1, dtype=np.int32)
    e_j = e_i + 1
    mR = np.einsum("nij,nkj->nik", vR[e_j], vR[e_i])
    mt = vt[e_j] - np.einsum("nij,nj->ni", mR, vt[e_i])
    e_i = np.concatenate([e_i, [K - 1]]).astype(np.int32)
    e_j = np.concatenate([e_j, [0]]).astype(np.int32)
    mR = np.concatenate([mR, np.einsum("ij,kj->ik", vR[0], vR[K - 1])[None]])
    mt = np.concatenate([mt, (vt[0] - mR[-1] @ vt[K - 1])[None]])
    E = len(e_i)
    vt0 = vt + rng.normal(0, 0.15, vt.shape).astype(np.float32)
    vs0 = np.linspace(1.0, 1.15, K).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (vR, vt0, vs0, fixed, e_i, e_j, mR.astype(np.float32),
            mt.astype(np.float32), np.ones(E, np.float32),
            np.ones(E, np.float32), np.ones(E, bool))


def agree(port, ref):
    Rp, tp, sp, cp, cp0 = (np.asarray(x) for x in port)
    assert float(cp) <= float(cp0)
    Rj, tj, sj, cj = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(sp, sj, atol=S_TOL)
    np.testing.assert_allclose(tp, tj, atol=T_TOL)
    np.testing.assert_allclose(Rp, Rj, atol=R_TOL)
    return float(cp), float(cj)


@pytest.mark.parametrize("solver,iters", [("dense", 15), ("pcg", 60)])
def test_drift_circle_dense_and_pcg(solver, iters):
    args = drift_circle()
    jf = {"dense": jpg.optimize_sim3_graph,
          "pcg": jpg.optimize_sim3_graph_pcg}[solver]
    pf = {"dense": pg.optimize_sim3_graph,
          "pcg": pg.optimize_sim3_graph_pcg}[solver]
    ref = jf(*(jnp.asarray(a) for a in args), n_iters=iters)
    port = pf(*args, n_iters=iters, device="cpu")
    cp, cj = agree(port, ref)
    assert cp < 1e-4 and cj < 1e-4, (cp, cj)


def banded_args(K, long_only_vertex=None):
    R_gt, t_gt, vt, ei, ej, mR, mt = _ring_pose_graph(
        K, r_orbit=5.0, drift_vec=(0.15, -0.1, 0.05))
    if long_only_vertex is not None:
        # every band edge of the vertex goes; it keeps long-range edges
        # to vertices 20 and more slots away (measured from the truth)
        v = long_only_vertex
        keep = (ei != v) & (ej != v)
        ei, ej, mR, mt = ei[keep], ej[keep], mR[keep], mt[keep]
        others = np.array([v - 24, v + 20], np.int32)
        ni = np.minimum(others, v).astype(np.int32)
        nj = np.maximum(others, v).astype(np.int32)
        nR = np.einsum("eab,ecb->eac", R_gt[nj], R_gt[ni])
        nt = t_gt[nj] - np.einsum("eab,eb->ea", nR, t_gt[ni])
        ei, ej = np.concatenate([ei, ni]), np.concatenate([ej, nj])
        mR, mt = np.concatenate([mR, nR]), np.concatenate([mt, nt])
    band, long_ = _split_band(ei, ej, mR, mt)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return R_gt, vt, np.ones(K, np.float32), fixed, band, long_


@pytest.mark.parametrize("long_only", [None, 33])
def test_banded_against_jax(long_only):
    """The banded solver on the ring of `test_sim3_pose_graph_banded_
    matches_dense`, and on the same ring with vertex 33 held by long-range
    edges alone: its block diagonal then carries only the 1e-7 damping
    floor (both packages damp from the band edges' diagonal), and both
    packages must still agree."""
    R, vt, s, fixed, band, long_ = banded_args(64, long_only)
    ref = jpg.optimize_sim3_graph_banded(
        jnp.asarray(R), jnp.asarray(vt), jnp.asarray(s), jnp.asarray(fixed),
        *band, *long_, g=8, n_iters=15)
    port = pg.optimize_sim3_graph_banded(
        R, vt, s, fixed, *(np.asarray(x) for x in band),
        *(np.asarray(x) for x in long_), g=8, n_iters=15, device="cpu")
    cp, cj = agree(port, ref)
    assert np.isfinite(cp) and np.isfinite(cj)
    if long_only is None:
        assert cp < 1e-4 and cj < 1e-4, (cp, cj)


def test_gauge_normalize_roundtrip():
    rng = np.random.default_rng(7)
    K = 16
    R = []
    for _ in range(K):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R.append((q * np.sign(np.linalg.det(q))).astype(np.float32))
    R = np.stack(R)
    t = rng.normal(0, 80.0, (K, 3)).astype(np.float32)
    s = rng.uniform(0.8, 1.2, K).astype(np.float32)
    tn, sn, ung = pg.gauge_normalize(*(torch.from_numpy(x) for x in (R, t, s)))
    jtn, jsn, _ = jpg.gauge_normalize(jnp.asarray(R), jnp.asarray(t),
                                      jnp.asarray(s))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jtn), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(sn.numpy(), np.asarray(jsn), rtol=1e-6)
    _, t2, s2 = ung(torch.from_numpy(R), tn, sn)
    np.testing.assert_allclose(t2.numpy(), t, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(s2.numpy(), s, rtol=1e-5)
