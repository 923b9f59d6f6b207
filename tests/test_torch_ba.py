"""The port's bundle adjustment against the JAX package's, on the CPU, on
the synthetic problems of tests/test_graph.py made from a seed with numpy.

Tolerances: both packages run the same f32 arithmetic in nearly the same
order; the scatter-adds and the dense Schur product sum in another order,
so after 15 LM iterations costs agree to 1e-3 relative and poses / points
to 1e-4; inlier masks are equal up to edges that sit on a chi² gate
(MASK_BUDGET entries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.graph import ba as jba
from orbslam_birdview_tpu.graph import residuals as jres
from orbslam_birdview_tpu_torch.core import lie
from orbslam_birdview_tpu_torch.graph import ba, residuals
from orbslam_birdview_tpu_torch.pipeline import state

FX, FY, CX, CY, BF = 500.0, 500.0, 320.0, 240.0, 40.0
MASK_BUDGET = 3


def T(x):
    return torch.from_numpy(np.array(x))


def se3(xi):
    R, t = jlie.se3_exp(jnp.asarray(xi, jnp.float32))
    return np.array(R), np.array(t)


# ---------------------------------------------------------------------------
# the small pieces
# ---------------------------------------------------------------------------

def test_inv3x3_matches_and_stays_finite(rng):
    A = []
    for _ in range(50):
        J = rng.normal(0, 50.0, (2, 3)).astype(np.float32)   # rank 2
        A.append(J.T @ J)
    A = np.stack(A).astype(np.float32)
    Ad_j = np.asarray(jba._damp(jnp.asarray(A), 1e-4))
    Ad_t = ba._damp(T(A), torch.tensor(1e-4)).numpy()
    np.testing.assert_allclose(Ad_t, Ad_j, rtol=1e-6)
    inv_j = np.asarray(jba._inv3x3(jnp.asarray(Ad_j)))
    inv_t = ba._inv3x3(T(Ad_j)).numpy()
    assert np.isfinite(inv_t).all()
    # the damped blocks have condition ~1e4, which amplifies the last-digit
    # differences of the two cofactor expansions (XLA contracts to FMAs) to
    # ~1e-3 of a block's largest entry; both are as far from the f64 inverse
    scale = np.abs(inv_j).max(axis=(1, 2), keepdims=True)
    assert (np.abs(inv_t - inv_j) / scale).max() < 5e-3
    well = np.stack([np.eye(3) * 4 + rng.normal(size=(3, 3)) * 0.3
                     for _ in range(20)]).astype(np.float32)
    well = well @ well.transpose(0, 2, 1)
    np.testing.assert_allclose(ba._inv3x3(T(well)).numpy(),
                               np.asarray(jba._inv3x3(jnp.asarray(well))),
                               rtol=1e-4, atol=1e-6)
    resid = Ad_j.astype(np.float64) @ inv_t.astype(np.float64) - np.eye(3)
    assert np.abs(resid).max() < 0.1
    # exactly singular input: the det clamp keeps it finite, as the reference
    A0 = np.zeros((1, 3, 3), np.float32)
    A0[0, 0, 0] = 1.0
    np.testing.assert_allclose(ba._inv3x3(T(A0)).numpy(),
                               np.asarray(jba._inv3x3(jnp.asarray(A0))))


def test_marquardt_damp():
    H = np.diag([100.0, 4.0, 1e-9]).astype(np.float32)[None]
    D = ba._damp(T(H), 0.5, floor=1e-6)[0].numpy()
    np.testing.assert_allclose(D, np.asarray(jba._damp(jnp.asarray(H), 0.5,
                                                       floor=1e-6)[0]))
    assert np.isclose(D[0, 0], 150.0) and np.isclose(D[1, 1], 6.0)
    assert np.isclose(D[2, 2], 1e-9 + 0.5 * 1e-6)
    assert np.allclose(D - np.diag(np.diag(D)), 0.0)


def _fd(f, x, eps=1e-3):
    f0 = f(x)
    J = np.zeros(f0.shape + x.shape)
    for i in range(x.shape[0]):
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        J[..., i] = (f(xp) - f(xm)) / (2 * eps)
    return J


def test_stereo_reproj_jacobians(rng):
    R, t = se3(rng.normal(size=6) * 0.3)
    Xw = np.array([[0.6, -0.4, 5.0], [-1.0, 0.7, 7.5]], np.float32)
    obs = np.array([[300.0, 200.0, 290.0], [250.0, 260.0, 244.0]], np.float32)
    je, jJc, jJp, jok = jres.stereo_reproj(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(Xw), jnp.asarray(obs),
        FX, FY, CX, CY, BF)
    e, Jc, Jp, ok = residuals.stereo_reproj(T(R), T(t), T(Xw), T(obs),
                                            FX, FY, CX, CY, BF)
    for a, b in ((e, je), (Jc, jJc), (Jp, jJp), (ok, jok)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)
    assert Jc.shape == (2, 3, 6) and Jp.shape == (2, 3, 3)

    def f_pose(xi):
        Rn, tn = lie.se3_update_left(T(R), T(t), T(xi.astype(np.float32)))
        return residuals.stereo_reproj(Rn, tn, T(Xw), T(obs), FX, FY, CX, CY,
                                       BF)[0][0].numpy().astype(np.float64)

    def f_point(X):
        return residuals.stereo_reproj(
            T(R), T(t), T(X.astype(np.float32))[None], T(obs[:1]), FX, FY, CX,
            CY, BF)[0][0].numpy().astype(np.float64)

    np.testing.assert_allclose(Jc[0].numpy(), _fd(f_pose, np.zeros(6)),
                               rtol=2e-2, atol=0.1)
    np.testing.assert_allclose(Jp[0].numpy(), _fd(f_point, Xw[0].astype(float)),
                               rtol=2e-2, atol=0.1)
    # the Jacobian-free cost agrees with the full edge
    e2, chi2, ok2 = residuals.stereo_reproj_cost(
        T(R), T(t), T(Xw), T(obs), torch.tensor([0.5, 2.0]), FX, FY, CX, CY,
        BF)
    np.testing.assert_array_equal(e2.numpy(), e.numpy())
    np.testing.assert_allclose(chi2.numpy(),
                               (e.numpy() ** 2).sum(-1) * [0.5, 2.0], rtol=1e-6)


def test_behind_camera_edges_pay_a_penalty():
    rng = np.random.default_rng(0)
    P = 64
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P),
                  rng.uniform(4, 8, P)], 1).astype(np.float32)
    obs = np.stack([FX * X[:, 0] / X[:, 2] + CX,
                    FY * X[:, 1] / X[:, 2] + CY], 1).astype(np.float32)
    es = ba.EdgeSet(torch.zeros(P, dtype=torch.long), torch.arange(P),
                    T(obs), torch.ones(P), torch.ones(P, dtype=torch.bool))
    jes = jba.EdgeSet(jnp.zeros(P, jnp.int32), jnp.arange(P, dtype=jnp.int32),
                      jnp.asarray(obs), jnp.ones(P), jnp.ones(P, bool))
    intr = (FX, FY, CX, CY, 0.0)
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None]
    for Rc, lo, hi in ((np.eye(3, dtype=np.float32)[None], -1.0, 1e-3),
                       (flip, 100.0, np.inf)):
        *_, cost, _, _ = ba._edge_terms("mono", T(Rc), torch.zeros(1, 3),
                                        T(X), es, intr, True)
        *_, jcost, _, _ = jba._edge_terms("mono", jnp.asarray(Rc),
                                          jnp.zeros((1, 3)), jnp.asarray(X),
                                          jes, intr, True)
        assert lo < float(cost) < hi
        assert float(cost) == pytest.approx(float(jcost), rel=1e-5, abs=1e-6)
        only = ba._cost_only(T(Rc), torch.zeros(1, 3), T(X),
                             [("mono", es), ("stereo", None)], intr, True)
        assert float(only) == pytest.approx(float(cost), rel=1e-6, abs=1e-6)


# ---------------------------------------------------------------------------
# bundle_adjust on the synthetic problems
# ---------------------------------------------------------------------------

def synth_ba_problem(rng, n_cams=6, n_pts=300, noise=0.5):
    X = np.stack([rng.uniform(-5, 5, n_pts), rng.uniform(-4, 4, n_pts),
                  rng.uniform(6, 14, n_pts)], 1).astype(np.float32)
    poses = [se3([0.3 * c, 0.02 * c, 0.01 * c, 0.0, -0.02 * c, 0.0])
             for c in range(n_cams)]
    cam_R = np.stack([p[0] for p in poses])
    cam_t = np.stack([p[1] for p in poses])
    e_cam, e_pt, e_obs = [], [], []
    for c in range(n_cams):
        Xc = X @ cam_R[c].T + cam_t[c]
        uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX,
                       FY * Xc[:, 1] / Xc[:, 2] + CY], 1)
        vis = ((Xc[:, 2] > 0.5) & (np.abs(uv[:, 0] - CX) < 400)
               & (np.abs(uv[:, 1] - CY) < 300))
        ids = np.nonzero(vis)[0]
        e_cam += [c] * len(ids)
        e_pt += ids.tolist()
        e_obs += (uv[ids] + rng.normal(0, noise, (len(ids), 2))).tolist()
    return (cam_R, cam_t, X, np.array(e_cam, np.int32),
            np.array(e_pt, np.int32), np.array(e_obs, np.float32))


def perturb(rng, cam_R, cam_t, sigma, n_fixed):
    pert = rng.normal(0, sigma, (len(cam_R), 6)).astype(np.float32)
    pert[:n_fixed] = 0.0
    Rp, tp = jax.vmap(jlie.se3_update_left)(
        jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(pert))
    return np.array(Rp), np.array(tp)


def edges(cam, pt, obs, info=None, valid=None):
    E = len(cam)
    info = np.ones(E, np.float32) if info is None else info
    valid = np.ones(E, bool) if valid is None else valid
    return (cam, pt, obs, info.astype(np.float32), valid)


def run_both(Rp, tp, fixed, Xp, mono, stereo, bird, bf=0.0, **kw):
    C, P = len(Rp), len(Xp)

    def jes(e):
        return None if e is None else jba.EdgeSet(*(jnp.asarray(x) for x in e))

    def tes(e):
        return None if e is None else state.edge_set(e, device="cpu")

    jr = jba.bundle_adjust(
        jnp.asarray(Rp), jnp.asarray(tp), jnp.asarray(fixed),
        jnp.ones(C, bool), jnp.asarray(Xp), jnp.ones(P, bool),
        jes(mono), jes(stereo), jes(bird), FX, FY, CX, CY, bf=bf, **kw)
    tr = ba.bundle_adjust(Rp, tp, fixed, np.ones(C, bool), Xp,
                          np.ones(P, bool), tes(mono), tes(stereo), tes(bird),
                          FX, FY, CX, CY, bf=bf, device="cpu", **kw)
    return jr, tr


def compare(jr, tr, referenced=None):
    assert float(tr.cost) == pytest.approx(float(jr.cost), rel=1e-3)
    np.testing.assert_allclose(tr.cam_R.numpy(), np.asarray(jr.cam_R), atol=1e-4)
    np.testing.assert_allclose(tr.cam_t.numpy(), np.asarray(jr.cam_t), atol=1e-4)
    pj, pt = np.asarray(jr.points), tr.points.numpy()
    if referenced is not None:
        pj, pt = pj[referenced], pt[referenced]
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=1e-4)
    for a, b in ((tr.inl_mono, jr.inl_mono), (tr.inl_stereo, jr.inl_stereo),
                 (tr.inl_bird, jr.inl_bird)):
        assert a.shape == np.asarray(b).shape
        assert int((a.numpy() != np.asarray(b)).sum()) <= MASK_BUDGET


def test_bundle_adjust_synthetic(rng):
    cam_R, cam_t, X, e_cam, e_pt, e_obs = synth_ba_problem(rng)
    C, P, E = len(cam_R), len(X), len(e_cam)
    Rp, tp = perturb(rng, cam_R, cam_t, 0.02, 2)
    Xp = X + rng.normal(0, 0.05, (P, 3)).astype(np.float32)
    fixed = np.arange(C) < 2
    jr, tr = run_both(Rp, tp, fixed, Xp, edges(e_cam, e_pt, e_obs), None, None)
    compare(jr, tr)
    # and the port meets the oracle's own bars
    np.testing.assert_allclose(tr.cam_R[:2].numpy(), cam_R[:2], atol=1e-6)
    np.testing.assert_allclose(tr.cam_t[:2].numpy(), cam_t[:2], atol=1e-6)
    for c in range(2, C):
        assert np.linalg.norm(tr.cam_t[c].numpy() - cam_t[c]) < 2e-2
    perr = np.linalg.norm(tr.points.numpy() - X, axis=1)
    assert np.median(perr) < 0.12
    assert int(tr.inl_mono.sum()) > 0.95 * E
    assert float(tr.cost) / E < 1.0
    assert tr.inl_stereo.shape == (0,) and tr.inl_bird.shape == (0,)


def test_bundle_adjust_with_outliers(rng):
    cam_R, cam_t, X, e_cam, e_pt, e_obs = synth_ba_problem(rng, noise=0.3)
    C, E = len(cam_R), len(e_cam)
    n_out = E // 10
    e_obs[:n_out] += rng.uniform(30, 90, (n_out, 2)).astype(np.float32)
    Rp, tp = perturb(rng, cam_R, cam_t, 0.01, 2)
    fixed = np.arange(C) < 2
    jr, tr = run_both(Rp, tp, fixed, X, edges(e_cam, e_pt, e_obs), None, None)
    compare(jr, tr)
    inl = tr.inl_mono.numpy()
    assert inl[:n_out].mean() < 0.15 and inl[n_out:].mean() > 0.9
    # without the reclassification between the phases both still agree
    jr, tr = run_both(Rp, tp, fixed, X, edges(e_cam, e_pt, e_obs), None, None,
                      reclassify=False, iters_phase1=3, iters_phase2=4)
    compare(jr, tr)


def test_bundle_adjust_stereo_and_bird(rng):
    cam_R, cam_t, X, e_cam, e_pt, e_obs = synth_ba_problem(rng, n_cams=4)
    C, P, E = len(cam_R), len(X), len(e_cam)
    Xc = np.einsum("eij,ej->ei", cam_R[e_cam], X[e_pt]) + cam_t[e_cam]
    obs3 = np.concatenate([e_obs, e_obs[:, :1] - BF / Xc[:, 2:3]], 1)
    nb = 50
    Xb = np.stack([rng.uniform(-6, 6, nb), rng.uniform(-6, 6, nb),
                   np.zeros(nb)], 1).astype(np.float32)
    pts = np.concatenate([X, Xb], 0)
    b_cam = np.repeat(np.arange(C), nb).astype(np.int32)
    b_pt = np.tile(np.arange(nb) + P, C).astype(np.int32)
    b_obs = (np.einsum("eij,ej->ei", cam_R[b_cam], pts[b_pt]) + cam_t[b_cam]
             + rng.normal(0, 0.01, (C * nb, 3))).astype(np.float32)
    Rp, tp = perturb(rng, cam_R, cam_t, 0.01, 1)
    Xp = (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)
    fixed = np.arange(C) < 1
    jr, tr = run_both(
        Rp, tp, fixed, Xp, None, edges(e_cam, e_pt, obs3.astype(np.float32)),
        edges(b_cam, b_pt, b_obs, info=np.full(C * nb, 3.0 / 0.01 ** 2)),
        bf=BF)
    compare(jr, tr)
    for c in range(1, C):
        assert np.linalg.norm(tr.cam_t[c].numpy() - cam_t[c]) < 2e-2
    berr = np.linalg.norm(tr.points[P:].numpy() - Xb, axis=1)
    assert np.median(berr) < 2e-2
    assert tr.inl_mono.shape == (0,)


def test_bundle_adjust_padded_invalid_sets_and_unreferenced_points(rng):
    """The shape `_gather_ba_problem` hands over: all three edge sets
    present, stereo all-invalid, padded rows invalid, padded points that
    no edge references (they must not move), a padded fixed camera."""
    cam_R, cam_t, X, e_cam, e_pt, e_obs = synth_ba_problem(rng, n_cams=3,
                                                           n_pts=120)
    E, P = len(e_cam), len(X)
    pad = 64
    Rp, tp = perturb(rng, cam_R, cam_t, 0.01, 1)
    Rp = np.concatenate([Rp, np.eye(3, dtype=np.float32)[None]])
    tp = np.concatenate([tp, np.zeros((1, 3), np.float32)])
    fixed = np.array([True, False, False, True])
    Xp = np.concatenate([X + rng.normal(0, 0.03, X.shape).astype(np.float32),
                         np.zeros((40, 3), np.float32)])
    mono = edges(np.pad(e_cam, (0, pad)), np.pad(e_pt, (0, pad)),
                 np.pad(e_obs, ((0, pad), (0, 0))),
                 valid=np.arange(E + pad) < E)
    zeros = edges(np.zeros(pad, np.int32), np.zeros(pad, np.int32),
                  np.zeros((pad, 3), np.float32), valid=np.zeros(pad, bool))
    jr, tr = run_both(Rp, tp, fixed, Xp, mono, zeros, zeros)
    compare(jr, tr)
    assert not tr.inl_stereo.any() and tr.inl_stereo.shape == (pad,)
    np.testing.assert_array_equal(tr.points[P:].numpy(), 0.0)
    np.testing.assert_array_equal(tr.cam_R[3].numpy(), np.eye(3))
    assert torch.isfinite(tr.points).all() and torch.isfinite(tr.cam_t).all()


def test_bundle_adjust_single_observation_landmarks(rng):
    cam_R, cam_t, X, e_cam, e_pt, e_obs = synth_ba_problem(rng)
    C, P, E = len(cam_R), len(X), len(e_cam)
    valid = np.ones(E, bool)
    seen = set()
    for i, p in enumerate(e_pt.tolist()):
        if p % 2 == 0:
            valid[i] = p not in seen
            seen.add(p)
    Rp, tp = perturb(rng, cam_R, cam_t, 0.02, 2)
    Xp = X + rng.normal(0, 0.05, (P, 3)).astype(np.float32)
    jr, tr = run_both(Rp, tp, np.arange(C) < 2, Xp,
                      edges(e_cam, e_pt, e_obs, valid=valid), None, None)
    assert torch.isfinite(tr.cam_t).all() and torch.isfinite(tr.points).all()
    assert int(tr.inl_mono.sum()) > 0.9 * valid.sum()
    # one-observation landmarks slide along their rays: the reprojections
    # agree where the positions need not
    assert float(tr.cost) == pytest.approx(float(jr.cost), rel=1e-2)
    np.testing.assert_allclose(tr.cam_t.numpy(), np.asarray(jr.cam_t), atol=1e-3)
    assert int((tr.inl_mono.numpy() != np.asarray(jr.inl_mono)).sum()) \
        <= MASK_BUDGET


def test_bundle_adjust_needs_a_device_or_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ba.bundle_adjust(np.eye(3)[None], np.zeros((1, 3)), np.ones(1, bool),
                         np.ones(1, bool), np.zeros((4, 3)), np.ones(4, bool),
                         None, None, None, FX, FY, CX, CY)
