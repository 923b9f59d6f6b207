"""Sim3 algebra and the two-view Sim3 solvers, the JAX package against the
port, on the CPU, on the same numpy inputs.

- the Sim3 Lie functions, `se3_log`, `so3_left_jacobian_inv` and the
  relative-pose residuals with their Jacobians (jacrev at ξ = 0 and at
  random tangents, σ = 0 and θ = 0 exactly included, where `sim3_exp`
  takes its Taylor branches): within 1e-5;
- `horn_sim3` with and without weights and with the fixed scale: R, t, s
  within 1e-5 (q and −q give the same R);
- `sim3_ransac` with the JAX package's own draws (`jax.random.randint`
  from the key it is given): the same inlier mask, R, t and s within 1e-4;
- `optimize_sim3_two_frame`: the same inlier classification, the Sim3
  within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.graph import residuals as jres
from orbslam_birdview_tpu.graph import sim3_opt as jsim3_opt
from orbslam_birdview_tpu.solvers import sim3 as jsim3
from orbslam_birdview_tpu_torch.core import lie
from orbslam_birdview_tpu_torch.graph import residuals as res
from orbslam_birdview_tpu_torch.graph import sim3_opt
from orbslam_birdview_tpu_torch.solvers import sim3

TOL = 1e-5
INTR = (500.0, 500.0, 320.0, 240.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def tangents(rng, n=6):
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[0] = 0.0                      # identity
    xi[1, 6] = 0.0                   # sigma = 0 exactly
    xi[2, 3:6] = 0.0                 # theta = 0 exactly
    xi[3, 3:] = 0.0                  # both
    return xi


def test_sim3_group_functions():
    rng = np.random.default_rng(0)
    xi = tangents(rng)
    R, t, s = lie.sim3_exp(T(xi))
    jR, jt, js = jlie.sim3_exp(jnp.asarray(xi))
    for a, b in ((R, jR), (t, jt), (s, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    np.testing.assert_allclose(lie.sim3_log(R, t, s).numpy(),
                               np.asarray(jlie.sim3_log(jR, jt, js)),
                               atol=TOL)
    np.testing.assert_allclose(lie.sim3_log(R, t, s).numpy(), xi, atol=1e-4)
    p = rng.normal(0, 3, (6, 3)).astype(np.float32)
    np.testing.assert_allclose(lie.sim3_apply(R, t, s, T(p)).numpy(),
                               np.asarray(jlie.sim3_apply(jR, jt, js, p)),
                               atol=1e-4)
    Ri, ti, si = lie.sim3_inv(R, t, s)
    jRi, jti, jsi = jlie.sim3_inv(jR, jt, js)
    for a, b in ((Ri, jRi), (ti, jti), (si, jsi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    Rm, tm, sm = lie.sim3_mul(R, t, s, Ri.flip(0), ti.flip(0), si.flip(0))
    jm = jlie.sim3_mul(jR, jt, js, jRi[::-1], jti[::-1], jsi[::-1])
    for a, b in zip((Rm, tm, sm), jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    w = xi[:, :3]
    np.testing.assert_allclose(lie.so3_left_jacobian_inv(T(w)).numpy(),
                               np.asarray(jlie.so3_left_jacobian_inv(w)),
                               atol=TOL)
    se3 = xi[:, :6]
    R6, t6 = lie.se3_exp(T(se3))
    np.testing.assert_allclose(lie.se3_log(R6, t6).numpy(),
                               np.asarray(jlie.se3_log(*jlie.se3_exp(se3))),
                               atol=TOL)


def relative_args(rng):
    """Vertex Sim3s i, j and a measurement near S_j·S_i⁻¹."""
    xi_i, xi_j, xi_m = (tangents(rng) for _ in range(3))
    return [np.asarray(x) for x in (*jlie.sim3_exp(jnp.asarray(xi_i)),
                                    *jlie.sim3_exp(jnp.asarray(xi_j)),
                                    *jlie.sim3_exp(jnp.asarray(xi_m)))]


@pytest.mark.parametrize("at", ["zero", "random"])
def test_sim3_relative_and_its_jacobians(at):
    rng = np.random.default_rng(1)
    args = relative_args(rng)
    n = args[0].shape[0]
    d = (np.zeros((2, n, 7), np.float32) if at == "zero"
         else rng.normal(0, 0.2, (2, n, 7)).astype(np.float32))
    d[:, 1, 6] = 0.0
    d[:, 2, 3:6] = 0.0

    def jf(xi_i, xi_j, *a):
        Ri, ti, si = jlie.sim3_mul(*jlie.sim3_exp(xi_i), *a[0:3])
        Rj, tj, sj = jlie.sim3_mul(*jlie.sim3_exp(xi_j), *a[3:6])
        return jres.sim3_relative(Ri, ti, si, Rj, tj, sj, *a[6:9])

    def pf(xi_i, xi_j, *a):
        Ri, ti, si = lie.sim3_mul(*lie.sim3_exp(xi_i), *a[0:3])
        Rj, tj, sj = lie.sim3_mul(*lie.sim3_exp(xi_j), *a[3:6])
        return res.sim3_relative(Ri, ti, si, Rj, tj, sj, *a[6:9])

    jr = jax.vmap(jf)(d[0], d[1], *args)
    jJ = jax.vmap(jax.jacrev(jf, argnums=(0, 1)))(d[0], d[1], *args)
    pr = pf(T(d[0]), T(d[1]), *map(T, args))
    pJ = torch.func.vmap(torch.func.jacrev(pf, argnums=(0, 1)))(
        T(d[0]), T(d[1]), *map(T, args))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=TOL)
    for a, b in zip(pJ, jJ):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_se3_relative_and_point_transform():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.3, (3, 5, 6)).astype(np.float32)
    poses = [jlie.se3_exp(jnp.asarray(x)) for x in xi]
    args = [np.asarray(a) for p in poses for a in p]
    np.testing.assert_allclose(
        res.se3_relative(*map(T, args)).numpy(),
        np.asarray(jres.se3_relative(*args)), atol=TOL)
    pc2 = rng.normal(0, 2, (5, 3)).astype(np.float32)
    pc1 = rng.normal(0, 2, (5, 3)).astype(np.float32)
    e, J = res.point_transform(T(args[0]), T(args[1]), T(pc2), T(pc1))
    je, jJ = jres.point_transform(args[0], args[1], pc2, pc1)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=TOL)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=TOL)


def matched_points(rng, n=120, outliers=30, noise=0.002):
    """Frame-2 points in front of both cameras and their frame-1 images
    under a Sim3 (scale 1.3), with outliers."""
    p2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 9, n)], 1).astype(np.float32)
    R, t, s = (np.asarray(x) for x in jlie.sim3_exp(
        jnp.asarray([0.1, -0.05, 0.2, 0.02, 0.05, -0.03, np.log(1.3)],
                    jnp.float32)))
    p1 = (s * p2 @ R.T + t + rng.normal(0, noise, (n, 3))).astype(np.float32)
    p1[:outliers] += rng.normal(0, 1.0, (outliers, 3)).astype(np.float32)
    return p1, p2, (R, t, s)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3(fix_scale):
    rng = np.random.default_rng(3)
    p1, p2, _ = matched_points(rng, outliers=0)
    w = rng.uniform(0.2, 1.0, len(p1)).astype(np.float32)
    for weights in (None, w):
        got = sim3.horn_sim3(T(p1), T(p2), None if weights is None
                             else T(weights), fix_scale=fix_scale)
        ref = jsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), weights,
                              fix_scale=fix_scale)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    # batched over hypotheses, as the RANSAC calls it
    idx = rng.integers(0, len(p1), (16, 3))
    Rb, tb, sb = sim3.horn_sim3(T(p1[idx]), T(p2[idx]))
    one = sim3.horn_sim3(T(p1[idx[5]]), T(p2[idx[5]]))
    np.testing.assert_allclose(Rb[5].numpy(), one[0].numpy(), atol=TOL)


def jax_draws(key, n_hyp=256, k=3):
    return torch.from_numpy(np.array(jax.random.randint(
        key, (n_hyp, k), 0, jnp.iinfo(jnp.int32).max)))


@pytest.mark.parametrize("n_valid", [150, 10])
def test_sim3_ransac_with_shared_draws(n_valid):
    rng = np.random.default_rng(4)
    p1, p2, (R_gt, _, s_gt) = matched_points(rng, n=160)
    valid = np.arange(160) < n_valid
    err1 = np.full(160, 9.21, np.float32)
    err2 = np.full(160, 9.21 * 1.44, np.float32)
    key = jax.random.PRNGKey(11)
    ref = jsim3.sim3_ransac(key, jnp.asarray(p1), jnp.asarray(p2),
                            jnp.asarray(valid), jnp.asarray(err1),
                            jnp.asarray(err2), *INTR, *INTR)
    got = sim3.fetch_result(sim3.sim3_ransac(
        jax_draws(key), p1, p2, valid, err1, err2, *INTR, *INTR,
        device="cpu"))
    assert got.ok == bool(ref.ok) == (n_valid > 100)
    np.testing.assert_array_equal(got.inliers, np.asarray(ref.inliers))
    assert got.n_inliers == int(ref.n_inliers)
    if got.ok:
        np.testing.assert_allclose(got.R, np.asarray(ref.R), atol=1e-4)
        np.testing.assert_allclose(got.t, np.asarray(ref.t), atol=1e-4)
        assert abs(got.s - float(ref.s)) < 1e-4
        assert abs(got.s - s_gt) < 0.01
    # a generator draws its own sets; the same seed, the same answer
    a, b = (sim3.fetch_result(sim3.sim3_ransac(
        torch.Generator().manual_seed(42), p1, p2, valid, err1, err2, *INTR,
        *INTR, device="cpu")) for _ in range(2))
    np.testing.assert_array_equal(a.inliers, b.inliers)


def test_optimize_sim3_two_frame():
    rng = np.random.default_rng(5)
    p1, p2, (R_gt, t_gt, s_gt) = matched_points(rng, n=200, outliers=20,
                                                 noise=0.0)
    fx, fy, cx, cy = INTR

    def proj(p):
        return np.stack([fx * p[:, 0] / p[:, 2] + cx,
                         fy * p[:, 1] / p[:, 2] + cy], 1).astype(np.float32)

    uv1 = proj(p1) + rng.normal(0, 0.5, (200, 2)).astype(np.float32)
    uv2 = proj(p2) + rng.normal(0, 0.5, (200, 2)).astype(np.float32)
    info1 = np.ones(200, np.float32)
    info2 = np.full(200, 1 / 1.44, np.float32)
    valid = np.ones(200, bool)
    valid[-10:] = False
    # a start 3 % off in scale and a little off in rotation
    R0, t0, s0 = jlie.sim3_mul(*jlie.sim3_exp(jnp.asarray(
        [0.02, 0.0, -0.03, 0.01, -0.01, 0.005, 0.03], jnp.float32)),
        jnp.asarray(R_gt), jnp.asarray(t_gt), jnp.asarray(s_gt, jnp.float32))
    ref = jsim3_opt.optimize_sim3_two_frame(
        R0, t0, s0, p1, p2, uv1, uv2, info1, info2, valid, *INTR, iters=12)
    got = sim3_opt.optimize_sim3_two_frame(
        np.asarray(R0), np.asarray(t0), np.asarray(s0), p1, p2, uv1, uv2,
        info1, info2, valid, *INTR, iters=12, device="cpu")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4]) >= 150
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert abs(float(got[2]) - s_gt) < 0.01
