"""EPnP, the DLT pose, Gauss-Newton pose refinement and PnP-RANSAC: the JAX
package against the port, on the CPU, from the same numpy inputs.

`pnp_ransac` gets the JAX package's own draws (`jax.random.randint` with
the key its sampler uses), so both score the same hypothesis sets.

Tolerances: R and t to 1e-4 (metres / rotation entries) for the single-shot
solvers and the RANSAC result, which sum f32 products in another order;
`ok`, the inlier count and the inlier mask are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid

from orbslam_birdview_tpu.solvers import epnp as jepnp
from orbslam_birdview_tpu.solvers import pnp as jpnp
from orbslam_birdview_tpu_torch.pipeline import state
from orbslam_birdview_tpu_torch.solvers import epnp, pnp

TOL = 1e-4
INT32_MAX = int(jnp.iinfo(jnp.int32).max)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()



def scene(rng, n, noise, yaw=0.1, t=(0.2, -0.1, 0.3)):
    """n world points 4-10 m in front of a camera rotated by `yaw` about y
    and shifted by t; normalized image coordinates with Gaussian noise."""
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = np.asarray(t, np.float32)
    Xc = X @ R.T + t
    xy = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    xy = (xy + rng.normal(0, noise, xy.shape)).astype(np.float32)
    return X, xy, R, t


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)


@pytest.mark.parametrize("n,noise", [(6, 0.0), (12, 0.0), (40, 1e-3),
                                     (200, 2e-3)])
def test_epnp_matches_reference(n, noise):
    X, xy, R, t = scene(np.random.default_rng(n), n, noise)
    Rj, tj = jepnp.epnp(jnp.asarray(X), jnp.asarray(xy))
    Rp, tp = epnp.epnp(torch.from_numpy(X), torch.from_numpy(xy))
    close(Rp, Rj)
    close(tp, tj)
    if noise == 0.0:
        close(Rp, R, 1e-4)
        close(tp, t, 1e-3)


def test_epnp_batched_and_masked():
    """A leading batch dimension gives each slice's own solution, and rows
    masked invalid do not pull the fit (as the reference's `valid`)."""
    rng = np.random.default_rng(7)
    sets = [scene(rng, 40, 1e-3, yaw=0.05 * k) for k in range(3)]
    X = np.stack([s[0] for s in sets])
    xy = np.stack([s[1] for s in sets])
    Rb, tb = epnp.epnp(torch.from_numpy(X), torch.from_numpy(xy))
    for k in range(3):
        Rj, tj = jepnp.epnp(jnp.asarray(X[k]), jnp.asarray(xy[k]))
        close(Rb[k], Rj)
        close(tb[k], tj)
    Xo, xyo, R, t = scene(rng, 20, 0.0)
    valid = np.ones(20, bool)
    valid[:5] = False
    xyo[:5] += 0.3                       # outliers, masked out
    Rj, tj = jepnp.epnp(jnp.asarray(Xo), jnp.asarray(xyo), jnp.asarray(valid))
    Rp, tp = epnp.epnp(torch.from_numpy(Xo), torch.from_numpy(xyo),
                       torch.from_numpy(valid))
    close(Rp, Rj)
    close(tp, tj)
    # the centroid stand-ins bias the fit a little, in both packages
    close(Rp, R, 5e-3)


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_pnp_dlt_and_gn_refine_match_reference(noise):
    X, xy, R, t = scene(np.random.default_rng(3), 30, noise)
    Rj, tj = jpnp.pnp_dlt(jnp.asarray(X), jnp.asarray(xy))
    Rp, tp = pnp.pnp_dlt(torch.from_numpy(X), torch.from_numpy(xy))
    close(Rp, Rj)
    close(tp, tj)
    # refine from a perturbed start with per-point weights
    w = np.where(np.arange(30) % 7 == 0, 0.0, 1.0).astype(np.float32)
    R0 = (R @ np.array([[1, -0.02, 0], [0.02, 1, 0], [0, 0, 1]],
                       np.float32)).astype(np.float32)
    t0 = (t + 0.05).astype(np.float32)
    Rj, tj = jpnp.gn_refine_pose(*(jnp.asarray(a) for a in (R0, t0, X, xy, w)))
    Rp, tp = pnp.gn_refine_pose(*(torch.from_numpy(a) for a in (R0, t0, X,
                                                              xy, w)))
    close(Rp, Rj)
    close(tp, tj)
    # ten f32 SE3 updates leave R 2e-4 off the manifold, in both packages
    close(Rp, R, 2e-3 if noise else 1e-3)


def jax_draws(key, n_hyp=256, k=4):
    return torch.from_numpy(np.array(jax.random.randint(
        key, (n_hyp, k), 0, INT32_MAX)))


@pytest.mark.parametrize("n,outliers,n_valid", [(300, 60, 300), (512, 150, 400),
                                                (60, 10, 60)])
def test_pnp_ransac_with_shared_draws(n, outliers, n_valid):
    rng = np.random.default_rng(n)
    X, xy, R, t = scene(rng, n, 1e-3)
    xy[:outliers] = rng.uniform(-1, 1, (outliers, 2))
    valid = np.arange(n) < n_valid
    chi2 = np.full(n, 5.991 / 500.0 ** 2, np.float32)
    chi2[::3] *= 1.44                    # a coarser octave's gate
    key = jax.random.PRNGKey(n)
    jres = jpnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(xy),
                           jnp.asarray(valid), jnp.asarray(chi2))
    pres = pnp.pnp_ransac(jax_draws(key), X, xy, valid, chi2, device="cpu")
    assert bool(pres.ok) == bool(jres.ok) is True
    assert int(pres.n_inliers) == int(jres.n_inliers)
    np.testing.assert_array_equal(pres.inliers.numpy(),
                                  np.asarray(jres.inliers))
    close(pres.R, jres.R)
    close(pres.t, jres.t)
    close(pres.R, R, 1e-3)
    # one transfer to numpy, and the carrier the state module offers
    got = pnp.fetch_result(pres)
    assert got.ok is True and got.n_inliers == int(jres.n_inliers)
    np.testing.assert_array_equal(got.inliers, np.asarray(jres.inliers))
    carried = state.pnp_result_numpy(jres)
    close(carried.R, got.R)
    assert carried.n_inliers == got.n_inliers


def test_pnp_ransac_refuses_too_few_points_and_takes_a_generator():
    rng = np.random.default_rng(1)
    X, xy, _, _ = scene(rng, 40, 1e-3)
    valid = np.zeros(40, bool)
    valid[:3] = True                     # fewer valid points than a set
    chi2 = np.full(40, 1e-4, np.float32)
    key = jax.random.PRNGKey(0)
    jres = jpnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(xy),
                           jnp.asarray(valid), jnp.asarray(chi2))
    pres = pnp.pnp_ransac(jax_draws(key), X, xy, valid, chi2, device="cpu")
    assert not bool(pres.ok) and not bool(jres.ok)
    # a generator draws the sets itself; the same seed gives the same pose
    valid[:] = True
    a, b = (pnp.pnp_ransac(torch.Generator().manual_seed(5), X, xy, valid,
                           np.full(40, 5.991 / 500.0 ** 2, np.float32),
                           device="cpu") for _ in range(2))
    assert bool(a.ok) and torch.equal(a.R, b.R)
    with pytest.raises(ValueError, match="draws of shape"):
        pnp.pnp_ransac(torch.zeros((10, 4), dtype=torch.int32), X, xy, valid,
                       chi2, device="cpu")
