"""The matrix-free (implicit-Schur PCG) BA, the JAX package against the
port, on the CPU, on the problems of `tests/test_ba_large.py`: mono alone,
mono with outliers, and stereo + bird edges; plus `_inv6x6`.

Tolerance: camera translations within 2e-3 m and rotations (the skew part
of R_port·R_jaxᵀ) within 1e-3 rad of the JAX result, median point
difference below 5e-3 m, the cost within 1 % and at most 3 inlier
decisions apart: both packages run the same 48 CG and 15 LM iterations in
f32, summing in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.graph import ba as jba
from orbslam_birdview_tpu.graph import ba_large as jbal
from orbslam_birdview_tpu_torch.graph import ba, ba_large
from test_graph import BF, CX, CY, FX, FY, synth_ba_problem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


def problem(kind):
    rng = np.random.default_rng({"mono": 0, "outliers": 1, "mixed": 2}[kind])
    n_cams = 4 if kind == "mixed" else 6
    cam_R, cam_t, X_gt, e_cam, e_pt, e_obs, E = synth_ba_problem(
        rng, n_cams=n_cams, noise=0.3 if kind == "outliers" else 0.5)
    C, P = cam_R.shape[0], X_gt.shape[0]
    e_obs = np.array(e_obs)
    if kind == "outliers":
        e_obs[: E // 10] += rng.uniform(30, 90, (E // 10, 2))
    n_fixed = 1 if kind == "mixed" else 2
    pert = rng.normal(0, 0.02, (C, 6)).astype(np.float32)
    pert[:n_fixed] = 0.0
    Rp, tp = jax.vmap(jlie.se3_update_left)(cam_R, cam_t, jnp.asarray(pert))
    pts = np.array(X_gt)
    edges = [("mono", (np.array(e_cam), np.array(e_pt),
                       e_obs.astype(np.float32), np.ones(E, np.float32)))]
    if kind == "mixed":
        Rn, tn = np.asarray(cam_R), np.asarray(cam_t)
        Xc = np.einsum("eij,ej->ei", Rn[e_cam], pts[e_pt]) + tn[e_cam]
        obs3 = np.concatenate([e_obs, (e_obs[:, 0] - BF / Xc[:, 2])[:, None]],
                              1).astype(np.float32)
        nb = 50
        Xb = np.stack([rng.uniform(-6, 6, nb), rng.uniform(-6, 6, nb),
                       np.zeros(nb)], 1).astype(np.float32)
        b_cam = np.repeat(np.arange(C), nb).astype(np.int32)
        b_pt = np.tile(np.arange(nb) + P, C).astype(np.int32)
        b_obs = (np.einsum("eij,ej->ei", Rn[b_cam], Xb[b_pt - P]) + tn[b_cam]
                 + rng.normal(0, 0.01, (C * nb, 3))).astype(np.float32)
        edges = [("stereo", (np.array(e_cam), np.array(e_pt), obs3,
                             np.ones(E, np.float32))),
                 ("bird", (b_cam, b_pt, b_obs,
                           np.full(C * nb, 3.0 / 0.01 ** 2, np.float32)))]
        pts = np.concatenate([pts, Xb])
    pts = (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:n_fixed] = True
    return (np.asarray(Rp), np.asarray(tp), fixed, np.ones(C, bool), pts,
            np.ones(len(pts), bool)), dict(edges)


def edge_sets(es, mod, arr):
    out = []
    for kind in ("mono", "stereo", "bird"):
        if kind not in es:
            out.append(None)
            continue
        cam, pt, obs, info = es[kind]
        out.append(mod.EdgeSet(arr(cam), arr(pt), arr(obs), arr(info),
                               arr(np.ones(len(cam), bool))))
    return out


@pytest.mark.parametrize("kind", ["mono", "outliers", "mixed"])
def test_bundle_adjust_large_against_jax(kind):
    args, es = problem(kind)
    bf = BF if kind == "mixed" else 0.0
    ref = jbal.bundle_adjust_large(
        *(jnp.asarray(a) for a in args), *edge_sets(es, jba, jnp.asarray),
        FX, FY, CX, CY, bf=bf)
    got = ba_large.bundle_adjust_large(
        *args, *edge_sets(es, ba, torch.as_tensor), FX, FY, CX, CY, bf=bf,
        device="cpu")
    jR, pR = np.asarray(ref.cam_R), got.cam_R.numpy()
    skew = pR @ np.transpose(jR, (0, 2, 1))
    skew = 0.5 * (skew - np.transpose(skew, (0, 2, 1)))
    assert np.abs(skew).max() < 1e-3
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(ref.cam_t),
                               atol=2e-3)
    perr = np.linalg.norm(got.points.numpy() - np.asarray(ref.points), axis=1)
    assert np.median(perr) < 5e-3
    assert abs(float(got.cost) - float(ref.cost)) <= 0.01 * float(ref.cost)
    for a, b in ((got.inl_mono, ref.inl_mono), (got.inl_stereo,
                                                ref.inl_stereo),
                 (got.inl_bird, ref.inl_bird)):
        assert int((a.numpy() != np.asarray(b)).sum()) <= 3


def test_inv6x6():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    A = A @ np.transpose(A, (0, 2, 1)) + 6 * np.eye(6, dtype=np.float32)
    got = ba_large._inv6x6(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbal._inv6x6(jnp.asarray(A))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got @ A, np.broadcast_to(np.eye(6), A.shape),
                               atol=2e-3)
