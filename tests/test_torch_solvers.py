"""The port's solvers against the JAX package's, on the CPU, on the same
numpy inputs made from a seed, and on the SAME hypothesis sets: the raw
draws are computed with `jax.random` from the keys the JAX functions split
for themselves and handed to the port, so both packages score the same
hypotheses.

Tolerances, and why: both packages run LAPACK SVDs of the same f32
matrices, but through different drivers, and sum in different orders, so
geometric quantities agree to 1e-4..1e-3 and raw H / F only up to sign and
scale. Inlier masks may differ on points that sit on a chi² gate: a handful
(MASK_BUDGET) of entries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.solvers import icp as jicp
from orbslam_birdview_tpu.solvers import initializer as jinit
from orbslam_birdview_tpu.solvers import ransac as jransac
from orbslam_birdview_tpu.solvers import twoview as jtv
from orbslam_birdview_tpu_torch.solvers import icp, initializer, ransac, twoview

KEY = jax.random.PRNGKey(0)
INT32_MAX = int(jnp.iinfo(jnp.int32).max)
K_np = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
N_HYP = 128
MASK_BUDGET = 3     # inlier-mask entries that may sit on a gate


def jax_draws(key, n_hyp, k):
    """The draws `sample_minimal_sets` makes from `key`."""
    return np.array(jax.random.randint(key, (n_hyp, k), 0, INT32_MAX))


def init_draws(key, n_hyp):
    """The draws `initialize_two_view` makes from `key` (split three ways)."""
    kH, kF, kI = jax.random.split(key, 3)
    return initializer.InitDraws(
        *(torch.from_numpy(jax_draws(k, n_hyp, n))
          for k, n in ((kH, 4), (kF, 8), (kI, 2))))


def T(x):
    return torch.from_numpy(np.array(x))


def rot(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def two_view(rng, n=200, planar=False, noise=0.5, outlier_frac=0.1,
             w=(0.02, -0.1, 0.03), t=(0.8, 0.05, 0.1), z=(4, 12)):
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  np.full(n, 6.0) if planar else rng.uniform(*z, n)], 1)
    R, t = rot(w), np.array(t, np.float32)

    def proj(Xc):
        uv = (K_np @ Xc.T).T
        return uv[:, :2] / uv[:, 2:3]

    x1 = proj(X) + rng.normal(0, noise, (n, 2))
    x2 = proj(X @ R.T + t) + rng.normal(0, noise, (n, 2))
    n_out = int(outlier_frac * n)
    x2[:n_out] = rng.uniform(0, 640, size=(n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32), R, t


def rot_angle(Ra, Rb):
    """Angle of RaᵀRb in radians, from the skew part (an arccos of the trace
    cannot resolve f32 round-off near zero)."""
    dR = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                              dR[1, 0] - dR[0, 1]])
    return float(np.arctan2(s, (np.trace(dR) - 1) / 2))


def up_to_sign_and_scale(M):
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


# ---------------------------------------------------------------------------
# sampler and argmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_valid,k", [(150, 8), (37, 4), (5, 2), (3, 4),
                                       (0, 2)])
def test_sampler_same_draws_same_sets(rng, n_valid, k):
    valid = np.zeros(200, bool)
    valid[rng.permutation(200)[:n_valid]] = True
    jidx, jok = jransac.sample_minimal_sets(KEY, jnp.asarray(valid), N_HYP, k)
    idx, ok = ransac.sample_minimal_sets(T(jax_draws(KEY, N_HYP, k)),
                                         T(valid), N_HYP, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert bool(ok.all()) == (n_valid >= k)
    if n_valid:
        assert valid[idx.numpy()].all()


def test_draw_is_seeded_int32_in_range():
    g = torch.Generator().manual_seed(3)
    u = ransac.draw(g, 64, 8, "cpu")
    assert u.shape == (64, 8) and u.dtype == torch.int32
    assert int(u.min()) >= 0 and int(u.max()) < 2 ** 31 - 1
    again = ransac.draw(torch.Generator().manual_seed(3), 64, 8, "cpu")
    assert torch.equal(u, again)
    assert not torch.equal(u, ransac.draw(g, 64, 8, "cpu"))   # the stream moves
    with pytest.raises(ValueError, match="draws of shape"):
        ransac.sample_minimal_sets(u, torch.ones(10, dtype=torch.bool), 64, 4)


def test_first_argmax_ties_go_to_the_first():
    x = torch.tensor([1.0, 7.0, 3.0, 7.0, 7.0, -2.0])
    assert int(ransac.first_argmax(x)) == 1 == int(jnp.argmax(jnp.asarray(x.numpy())))
    xi = torch.tensor([4, 4, 4], dtype=torch.int32)
    assert int(ransac.first_argmax(xi)) == 0
    assert int(ransac.first_argmax(torch.full((5,), -torch.inf))) == 0


def test_best_hypothesis_ties_and_suppression():
    scores = np.array([5.0, 9.0, 9.0, 2.0, 9.0], np.float32)
    for valid in ([True] * 5, [True, False, True, False, True],
                  [False] * 5):
        valid = np.array(valid)
        jb, js = jransac.best_hypothesis(jnp.asarray(scores), jnp.asarray(valid))
        b, s = ransac.best_hypothesis(T(scores), T(valid))
        assert int(b) == int(jb)
        assert float(s) == float(js)


# ---------------------------------------------------------------------------
# kabsch and ICP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,weighted", [(2, False), (2, True), (3, False),
                                        (3, True)])
def test_kabsch_matches(rng, D, weighted):
    n = 40
    p2 = rng.uniform(-5, 5, (n, D)).astype(np.float32)
    R = rot([0.2, -0.3, 0.5]) if D == 3 else np.array(
        [[np.cos(.3), -np.sin(.3)], [np.sin(.3), np.cos(.3)]], np.float32)
    p1 = (p2 @ R.T + np.arange(D) + rng.normal(0, 0.02, (n, D))).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32) if weighted else None
    jR, jt = jicp.kabsch(jnp.asarray(p1), jnp.asarray(p2),
                         None if w is None else jnp.asarray(w))
    tR, tt = icp.kabsch(T(p1), T(p2), None if w is None else T(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tR.numpy(), R, atol=5e-3)


@pytest.mark.parametrize("D", [2, 3])
def test_kabsch_reflection_guard(rng, D):
    """A mirrored set: the unconstrained optimum is a reflection; the det
    guard must return a proper rotation, the same one as the reference."""
    p2 = rng.uniform(-3, 3, (30, D)).astype(np.float32)
    p1 = p2.copy()
    p1[:, 0] *= -1
    jR, jt = jicp.kabsch(jnp.asarray(p1), jnp.asarray(p2))
    tR, tt = icp.kabsch(T(p1), T(p2))
    assert abs(float(torch.linalg.det(tR)) - 1.0) < 1e-5
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)


def test_kabsch_batched_equals_one_by_one(rng):
    p1 = rng.normal(size=(6, 3, 3)).astype(np.float32)
    p2 = rng.normal(size=(6, 3, 3)).astype(np.float32)
    Rb, tb = icp.kabsch(T(p1), T(p2))
    for i in range(6):
        R, t = icp.kabsch(T(p1[i]), T(p2[i]))
        np.testing.assert_allclose(Rb[i].numpy(), R.numpy(), atol=1e-5)
        np.testing.assert_allclose(tb[i].numpy(), t.numpy(), atol=1e-5)


@pytest.mark.parametrize("D", [2, 3])
def test_icp_ransac_same_draws(rng, D):
    n = 150
    p2 = rng.uniform(-5, 5, (n, D)).astype(np.float32)
    R = rot([0.2, -0.3, 0.5]) if D == 3 else np.array(
        [[np.cos(.3), -np.sin(.3)], [np.sin(.3), np.cos(.3)]], np.float32)
    t = np.array([1.2, -0.7, 0.4][:D], np.float32)
    p1 = (p2 @ R.T + t + rng.normal(0, 0.02, (n, D))).astype(np.float32)
    p1[:20] = rng.uniform(-5, 5, (20, D))
    valid = np.ones(n, bool)
    valid[100:110] = False
    jfn, tfn = ((jicp.icp2d_ransac, icp.icp2d_ransac) if D == 2
                else (jicp.icp3d_ransac, icp.icp3d_ransac))
    jres = jfn(KEY, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
               sigma=0.05, n_hyp=N_HYP)
    tres = tfn(T(jax_draws(KEY, N_HYP, D)), p1, p2, valid, sigma=0.05,
               n_hyp=N_HYP, device="cpu")
    assert bool(tres.ok) and bool(jres.ok)
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers) > 100
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-4)
    # a generator works in place of the draws, and recovers the motion too
    gres = tfn(torch.Generator().manual_seed(1), p1, p2, valid, sigma=0.05,
               n_hyp=N_HYP, device="cpu")
    np.testing.assert_allclose(gres.R.numpy(), R, atol=5e-3)
    np.testing.assert_allclose(gres.t.numpy(), t, atol=2e-2)


def test_rt2d_to_se3():
    R2 = np.array([[0.0, -1.0], [1.0, 0.0]], np.float32)
    t2 = np.array([0.5, -2.0], np.float32)
    jR, jt = jicp.rt2d_to_se3(jnp.asarray(R2), jnp.asarray(t2))
    tR, tt = icp.rt2d_to_se3(T(R2), T(t2))
    np.testing.assert_array_equal(tR.numpy(), np.asarray(jR))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# two-view models
# ---------------------------------------------------------------------------

def test_normalize_points(rng):
    xy = rng.uniform(0, 640, (80, 2)).astype(np.float32)
    valid = rng.uniform(size=80) > 0.3
    jxy, jT = jtv.normalize_points(jnp.asarray(xy), jnp.asarray(valid))
    txy, tT = twoview.normalize_points(T(xy), T(valid))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model,planar", [("H", True), ("F", False)])
def test_fit_ransac_same_draws(rng, model, planar):
    x1, x2, _, _ = two_view(rng, planar=planar)
    valid = np.ones(len(x1), bool)
    valid[50:60] = False
    k = 4 if model == "H" else 8
    jfit_fn, tfit_fn = ((jtv.fit_homography_ransac, twoview.fit_homography_ransac)
                        if model == "H" else
                        (jtv.fit_fundamental_ransac, twoview.fit_fundamental_ransac))
    jfit = jfit_fn(KEY, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                   1.0, N_HYP)
    tfit = tfit_fn(T(jax_draws(KEY, N_HYP, k)), x1, x2, valid, 1.0, N_HYP,
                   device="cpu")
    assert float(tfit.score) == pytest.approx(float(jfit.score), rel=1e-3)
    diff = int((tfit.inliers.numpy() != np.asarray(jfit.inliers)).sum())
    assert diff <= MASK_BUDGET, diff
    assert int(tfit.inliers.sum()) > 130
    np.testing.assert_allclose(up_to_sign_and_scale(tfit.model.numpy()),
                               up_to_sign_and_scale(jfit.model), atol=1e-3)


def test_scores_are_batched_over_hypotheses(rng):
    x1, x2, _, _ = two_view(rng)
    valid = np.ones(len(x1), bool)
    M = rng.normal(size=(5, 3, 3)).astype(np.float32)
    for jfn, tfn in ((jtv.score_homography, twoview.score_homography),
                     (jtv.score_fundamental, twoview.score_fundamental)):
        ts, tok = tfn(T(M), T(x1), T(x2), T(valid), 1.0)
        assert ts.shape == (5,) and tok.shape == (5, len(x1))
        for i in range(5):
            js, jok = jfn(jnp.asarray(M[i]), jnp.asarray(x1), jnp.asarray(x2),
                          jnp.asarray(valid), 1.0)
            assert float(ts[i]) == pytest.approx(float(js), rel=1e-3, abs=1e-3)
            assert int((tok[i].numpy() != np.asarray(jok)).sum()) <= MASK_BUDGET


# ---------------------------------------------------------------------------
# triangulation, cheirality, motion hypotheses
# ---------------------------------------------------------------------------

def _proj_mats(R, t):
    P1 = K_np @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K_np @ np.hstack([R, t[:, None]])
    return P1.astype(np.float32), P2.astype(np.float32)


def test_triangulate_dlt(rng):
    x1, x2, R, t = two_view(rng, noise=0.3, outlier_frac=0.0)
    P1, P2 = _proj_mats(R, t)
    jX = np.asarray(jtv.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2),
                                        jnp.asarray(x1), jnp.asarray(x2)))
    tX = twoview.triangulate_dlt(T(P1), T(P2), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(tX, jX, rtol=1e-4, atol=1e-4)
    assert (tX[:, 2] > 3).all() and (tX[:, 2] < 14).all()
    # batched over the second camera
    P2b = np.stack([P2, _proj_mats(R, 2 * t)[1]])
    tXb = twoview.triangulate_dlt(T(P1), T(P2b), T(x1), T(x2)).numpy()
    assert tXb.shape == (2, len(x1), 3)
    np.testing.assert_allclose(tXb[0], tX, rtol=1e-5, atol=1e-5)


def test_check_rt(rng):
    x1, x2, R, t = two_view(rng, noise=0.3)
    valid = np.ones(len(x1), bool)
    valid[::7] = False
    for Rc, tc in ((R, t), (R, -t), (np.eye(3, dtype=np.float32), t)):
        jn, jpar, jX, jgood = jtv.check_rt(
            jnp.asarray(Rc), jnp.asarray(tc), jnp.asarray(x1), jnp.asarray(x2),
            jnp.asarray(valid), jnp.asarray(K_np), 1.0)
        tn, tpar, tX, tgood = twoview.check_rt(
            T(Rc), T(tc), T(x1), T(x2), T(valid), T(K_np), 1.0)
        assert int((tgood.numpy() != np.asarray(jgood)).sum()) <= MASK_BUDGET
        assert abs(int(tn) - int(jn)) <= MASK_BUDGET
        assert float(tpar) == pytest.approx(float(jpar), abs=2e-2)
        g = np.asarray(jgood) & tgood.numpy()
        np.testing.assert_allclose(tX.numpy()[g], np.asarray(jX)[g],
                                   rtol=1e-3, atol=1e-3)
    assert int(tn) < 20     # the wrong rotation triangulates almost nothing


def _as_set_equal(Rs_a, ts_a, Rs_b, ts_b, tol=1e-3):
    """Every hypothesis of a has a twin in b and the other way round."""
    Rs_a, ts_a, Rs_b, ts_b = (np.asarray(x) for x in (Rs_a, ts_a, Rs_b, ts_b))
    assert Rs_a.shape == Rs_b.shape and ts_a.shape == ts_b.shape
    for (Ra, ta), others in (((Rs_a, ts_a), (Rs_b, ts_b)),
                             ((Rs_b, ts_b), (Rs_a, ts_a))):
        for R, t in zip(Ra, ta):
            d = [max(np.abs(R - R2).max(), np.abs(t - t2).max())
                 for R2, t2 in zip(*others)]
            assert min(d) < tol, min(d)


def test_motion_hypotheses_from_F_as_sets(rng):
    x1, x2, R, t = two_view(rng, noise=0.1, outlier_frac=0.0)
    E = np.cross(np.eye(3), t / np.linalg.norm(t)) @ R   # [t]x R
    Kinv = np.linalg.inv(K_np)
    F = (Kinv.T @ E @ Kinv).astype(np.float32)
    jRs, jts = jtv.motion_hypotheses_from_F(jnp.asarray(F), jnp.asarray(K_np))
    tRs, tts = twoview.motion_hypotheses_from_F(T(F), T(K_np))
    _as_set_equal(tRs.numpy(), tts.numpy(), jRs, jts)
    # the true motion is among them
    d = [max(np.abs(R - R2).max(), np.abs(t / np.linalg.norm(t) - t2).max())
         for R2, t2 in zip(tRs.numpy(), tts.numpy())]
    assert min(d) < 1e-3


def test_motion_hypotheses_from_H_as_sets(rng):
    n = np.array([0.1, -0.05, 1.0])
    n /= np.linalg.norm(n)
    R, t, d = rot([0.02, -0.1, 0.03]), np.array([0.8, 0.05, 0.1]), 6.0
    H = (K_np @ (R + np.outer(t, n) / d) @ np.linalg.inv(K_np)).astype(np.float32)
    jRs, jts = jtv.motion_hypotheses_from_H(jnp.asarray(H), jnp.asarray(K_np))
    tRs, tts = twoview.motion_hypotheses_from_H(T(H), T(K_np))
    assert tRs.shape == (8, 3, 3) and tts.shape == (8, 3)
    _as_set_equal(tRs.numpy(), tts.numpy(), jRs, jts)
    dmin = min(max(np.abs(R - R2).max(),
                   np.abs(t / np.linalg.norm(t) - t2).max())
               for R2, t2 in zip(tRs.numpy(), tts.numpy()))
    assert dmin < 1e-3


def test_select_motion_matches(rng):
    x1, x2, R, t = two_view(rng, noise=0.3)
    fit = jtv.fit_fundamental_ransac(KEY, jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.ones(len(x1), bool), 1.0, N_HYP)
    jRs, jts = jtv.motion_hypotheses_from_F(fit.model, jnp.asarray(K_np))
    jout = jtv.select_motion(jRs, jts, jnp.asarray(x1), jnp.asarray(x2),
                             fit.inliers, jnp.asarray(K_np), 1.0)
    tout = twoview.select_motion(T(jRs), T(jts), T(x1), T(x2), T(fit.inliers),
                                 T(K_np), 1.0)
    assert bool(tout[0]) and bool(jout[0])
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    assert int((tout[4].numpy() != np.asarray(jout[4])).sum()) <= MASK_BUDGET
    assert rot_angle(tout[1].numpy(), R) < 0.01


def test_select_motion_tie_goes_to_the_first(rng):
    """Two hypotheses that differ only in the length of t triangulate the
    same points: equal counts, and both packages take the first."""
    x1, x2, R, t = two_view(rng, noise=0.2, outlier_frac=0.0)
    th = (t / np.linalg.norm(t)).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    Rs = np.stack([eye, R, R, eye])
    ts = np.stack([th, 2 * th, th, -th])
    inl = np.ones(len(x1), bool)
    jn, _, _, _ = jax.vmap(lambda R_, t_: jtv.check_rt(
        R_, t_, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(inl),
        jnp.asarray(K_np), 1.0))(jnp.asarray(Rs), jnp.asarray(ts))
    tn = twoview.check_rt(T(Rs), T(ts), T(x1), T(x2), T(inl), T(K_np), 1.0)[0]
    assert int(tn[1]) == int(tn[2]) == int(jn[1]) == int(jn[2]) > 150  # a tie
    jout = jtv.select_motion(jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(x1),
                             jnp.asarray(x2), jnp.asarray(inl),
                             jnp.asarray(K_np), 1.0)
    tout = twoview.select_motion(T(Rs), T(ts), T(x1), T(x2), T(inl), T(K_np),
                                 1.0)
    assert bool(tout[0]) and bool(jout[0])
    np.testing.assert_array_equal(tout[2].numpy(), ts[1])
    np.testing.assert_array_equal(np.asarray(jout[2]), ts[1])


# ---------------------------------------------------------------------------
# the initializer
# ---------------------------------------------------------------------------

def _compare_init(jres, tres, pts_rtol=5e-3):
    assert bool(tres.ok) == bool(jres.ok)
    assert bool(tres.used_homography) == bool(jres.used_homography)
    assert bool(tres.icp_ok) == bool(jres.icp_ok)
    assert rot_angle(tres.R21.numpy(), jres.R21) < 1e-3          # rad
    np.testing.assert_allclose(tres.t21.numpy(), np.asarray(jres.t21),
                               atol=1e-3)                        # m
    np.testing.assert_array_equal(tres.bird_inliers.numpy(),
                                  np.asarray(jres.bird_inliers))
    good_j, good_t = np.asarray(jres.good), tres.good.numpy()
    assert int((good_j != good_t).sum()) <= MASK_BUDGET
    g = good_j & good_t
    np.testing.assert_allclose(tres.points3d.numpy()[g],
                               np.asarray(jres.points3d)[g], rtol=pts_rtol,
                               atol=pts_rtol)


def test_initializer_monocular(rng):
    x1, x2, R, t = two_view(rng, noise=0.3, outlier_frac=0.05)
    valid = np.ones(len(x1), bool)
    jres = jinit.initialize_two_view(KEY, jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(valid), jnp.asarray(K_np),
                                     sigma=1.0, n_hyp=N_HYP)
    tres = initializer.initialize_two_view(init_draws(KEY, N_HYP), x1, x2,
                                           valid, K_np, sigma=1.0,
                                           n_hyp=N_HYP, device="cpu")
    assert bool(tres.ok) and not bool(tres.icp_ok)
    assert tres.bird_inliers.shape == (0,)
    _compare_init(jres, tres)
    assert rot_angle(tres.R21.numpy(), R) < 0.01
    # a generator in place of the draws reaches the same motion
    gres = initializer.initialize_two_view(
        torch.Generator().manual_seed(5), x1, x2, valid, K_np, n_hyp=N_HYP,
        device="cpu")
    assert bool(gres.ok) and rot_angle(gres.R21.numpy(), R) < 0.01


def _bird_case(rng, tb, th=0.1, nb=120, z=(4, 12), noise=0.3, n=200):
    """Planar vehicle motion (yaw th, base translation tb) seen by a camera
    whose frame is the base frame; BEV points of both frames."""
    g2 = rng.uniform(-6, 6, (nb, 2)).astype(np.float32)
    R2d = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    tb = np.asarray(tb, np.float32)
    g1 = (g2 @ R2d.T + tb + rng.normal(0, 0.01, (nb, 2))).astype(np.float32)
    Rg = np.eye(3, dtype=np.float32)
    Rg[:2, :2] = R2d
    R21 = np.linalg.inv(Rg)
    t21 = (-R21 @ np.array([tb[0], tb[1], 0.0])).astype(np.float32)
    Xs = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(*z, n)], 1).astype(np.float32)

    def pr(Xc):
        uv = (K_np @ Xc.T).T
        return uv[:, :2] / uv[:, 2:3]

    x1 = (pr(Xs) + rng.normal(0, noise, (n, 2))).astype(np.float32)
    x2 = (pr(Xs @ R21.T + t21) + rng.normal(0, noise, (n, 2))).astype(np.float32)
    return x1, x2, g1, g2, R21, t21


def _both_inits(key, x1, x2, g1, g2, **kw):
    n, nb = len(x1), len(g1)
    jres = jinit.initialize_two_view(
        key, jnp.asarray(x1), jnp.asarray(x2), jnp.ones(n, bool),
        jnp.asarray(K_np), sigma=1.0, bird_xy1=jnp.asarray(g1),
        bird_xy2=jnp.asarray(g2), bird_valid=jnp.ones(nb, bool),
        bird_sigma=0.05, R_bc=jnp.eye(3), t_bc=jnp.zeros(3), n_hyp=N_HYP, **kw)
    tres = initializer.initialize_two_view(
        init_draws(key, N_HYP), x1, x2, np.ones(n, bool), K_np, sigma=1.0,
        bird_xy1=g1, bird_xy2=g2, bird_valid=np.ones(nb, bool),
        bird_sigma=0.05, R_bc=np.eye(3, dtype=np.float32),
        t_bc=np.zeros(3, np.float32), n_hyp=N_HYP, device="cpu", **kw)
    return jres, tres


def test_initializer_with_birdview_metric_scale(rng):
    x1, x2, g1, g2, R21, t21 = _bird_case(rng, tb=(0.9, 0.2))
    jres, tres = _both_inits(jax.random.PRNGKey(1), x1, x2, g1, g2)
    assert bool(tres.ok) and bool(tres.icp_ok)
    _compare_init(jres, tres)
    assert int(tres.bird_inliers.sum()) > 100
    # METRIC: |t| is the ICP's, not 1
    assert float(tres.t21.norm()) == pytest.approx(np.linalg.norm(t21), rel=0.08)


def test_initializer_small_baseline_veto(rng):
    """An ICP translation under 0.3 m vetoes the initialization."""
    x1, x2, g1, g2, _, _ = _bird_case(rng, tb=(0.05, 0.0), th=0.0)
    jres, tres = _both_inits(KEY, x1, x2, g1, g2)
    assert not bool(tres.ok) and not bool(jres.ok)
    assert not bool(tres.icp_ok) and not bool(jres.icp_ok)
    assert int(tres.bird_inliers.sum()) == 0
    # the same pairs pass with the gate lowered: the veto is the gate's
    jres, tres = _both_inits(KEY, x1, x2, g1, g2, min_icp_translation=0.01)
    assert bool(tres.icp_ok) and bool(jres.icp_ok)


def test_initializer_icp_fallback_branch(rng):
    """With the parallax gate out of reach the model selection is
    indecisive, and the ICP's metric pose is scored directly and taken."""
    x1, x2, g1, g2, R21, t21 = _bird_case(rng, tb=(0.9, 0.2))
    jres, tres = _both_inits(KEY, x1, x2, g1, g2, min_parallax=60.0)
    # without the bird arguments the same pairs do not initialize
    mono = initializer.initialize_two_view(
        init_draws(KEY, N_HYP), x1, x2, np.ones(len(x1), bool), K_np,
        n_hyp=N_HYP, min_parallax=60.0, device="cpu")
    assert not bool(mono.ok)
    assert bool(tres.ok) and bool(jres.ok) and bool(tres.icp_ok)
    _compare_init(jres, tres)
    # the pose IS the ICP's: a rotation about the vertical axis and no
    # vertical translation, which the E- or H-derived pose has only nearly
    assert float(tres.t21[2]) == 0.0 and float(tres.R21[2, 2]) == 1.0
    np.testing.assert_allclose(tres.t21.numpy(), t21, atol=0.02)
    assert rot_angle(tres.R21.numpy(), R21) < 5e-3
    assert int(tres.good.sum()) >= 100


def test_fetch_result_is_one_buffer(rng):
    x1, x2, g1, g2, _, _ = _bird_case(rng, tb=(0.9, 0.2))
    _, tres = _both_inits(KEY, x1, x2, g1, g2)
    host = initializer.fetch_result(tres)
    for a, b in zip(host, tres):
        assert isinstance(a, np.ndarray) and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    assert host.good.dtype == bool and host.ok.dtype == bool


def test_entry_points_need_a_device_or_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")
    x1, x2, _, _ = two_view(rng)
    valid = np.ones(len(x1), bool)
    g = torch.Generator().manual_seed(0)
    for call in (
        lambda: initializer.initialize_two_view(g, x1, x2, valid, K_np),
        lambda: twoview.fit_homography_ransac(g, x1, x2, valid, 1.0),
        lambda: twoview.fit_fundamental_ransac(g, x1, x2, valid, 1.0),
        lambda: icp.icp2d_ransac(g, x1, x2, valid, 0.05),
        lambda: icp.icp3d_ransac(g, x1, x2, valid, 0.05),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
