"""The port's motion-only pose LM against the JAX package's on synthetic
problems with 20% gross outliers, mono-only and with bird edges.

Tolerance: R and t agree to 1e-4 (the normal equations are f32 sums of
~10^3 terms taken in another order; the LM amplifies their ulps a little
per accepted step) and the inlier masks are equal. Inlier residuals sit far
below the chi² gates and outliers far above, so an ulp cannot flip a mask.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.graph import pose_opt as jpo
from orbslam_birdview_tpu_torch.graph import pose_opt as tpo
from orbslam_birdview_tpu_torch.graph import residuals as tres
from orbslam_birdview_tpu.graph import residuals as jres

FX, FY, CX, CY = 350.0, 348.0, 320.0, 240.0


def _problem(rng, n=240, nb=120, outlier=0.2):
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    t = np.array([0.3, -0.1, 0.5], np.float32)
    Xw = np.concatenate([rng.uniform(-4, 4, (n, 2)), rng.uniform(4, 12, (n, 1))],
                        -1).astype(np.float32)
    Xc = Xw @ R.T + t
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY],
                  -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < outlier
    uv[bad] = rng.uniform(0, 640, (bad.sum(), 2))
    info = (1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    valid = rng.random(n) > 0.05
    Xb = np.concatenate([rng.uniform(-6, 6, (nb, 2)), np.zeros((nb, 1))],
                        -1).astype(np.float32)
    obs_b = Xb @ R.T + t + rng.normal(0, 0.01, (nb, 3))
    badb = rng.random(nb) < outlier
    obs_b[badb] += rng.uniform(-1, 1, (badb.sum(), 3))
    bird = dict(Xw_bird=Xb, obs_pc_bird=obs_b.astype(np.float32),
                info_bird=np.full(nb, 400.0, np.float32),
                valid_bird=rng.random(nb) > 0.05)
    # start away from the truth: 2 degrees and 15 cm
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.02, 0.025, -0.01], jnp.float32)))
    R0 = (dR @ R).astype(np.float32)
    t0 = (t + np.array([0.1, -0.08, 0.07], np.float32)).astype(np.float32)
    mono = (R0, t0, Xw, uv.astype(np.float32), info, valid)
    return mono, bird, (R, t)


@pytest.mark.parametrize("with_bird", [False, True], ids=["mono", "mono_bird"])
@pytest.mark.parametrize("rounds", [2, 4])
def test_optimize_pose_parity(rng, with_bird, rounds):
    mono, bird, (R_gt, t_gt) = _problem(rng)
    kw = bird if with_bird else {}
    ref = jpo.optimize_pose(*map(jnp.asarray, mono), FX, FY, CX, CY,
                            rounds=rounds,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    out = tpo.optimize_pose(*[torch.from_numpy(np.array(x)) for x in mono],
                            FX, FY, CX, CY, rounds=rounds,
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_array_equal(out.inliers_mono.numpy(),
                                  np.asarray(ref.inliers_mono))
    np.testing.assert_array_equal(out.inliers_bird.numpy(),
                                  np.asarray(ref.inliers_bird))
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(float(out.chi2), float(ref.chi2), rtol=1e-3)
    # and both found the truth
    np.testing.assert_allclose(out.t.numpy(), t_gt, atol=0.02)


def test_optimize_pose_on_cpu_builds_no_kernel(rng, monkeypatch):
    """CPU tensors take the plain version: no compiler is looked for, no
    library is loaded and the kernel's launch count stays put."""
    from orbslam_birdview_tpu_torch.utils import build

    def no_nvcc():
        raise AssertionError("optimize_pose on the CPU looked for nvcc")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    loaded, launches = dict(build.LOADED), build.LAUNCHES.copy()
    mono, bird, _ = _problem(rng)
    out = tpo.optimize_pose(*[torch.from_numpy(np.array(x)) for x in mono],
                            FX, FY, CX, CY,
                            **{k: torch.from_numpy(v) for k, v in bird.items()})
    assert out.R.device.type == "cpu"
    assert build.LOADED == loaded and build.LAUNCHES == launches


def test_build_normal_eq_parity(rng):
    (R0, t0, Xw, uv, info, valid), bird, _ = _problem(rng)
    args = (R0, t0, Xw, uv, info, valid, FX, FY, CX, CY, bird["Xw_bird"],
            bird["obs_pc_bird"], bird["info_bird"], bird["valid_bird"])
    for use_huber in (True, False):
        ref = jpo._build_normal_eq(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                     else a for a in args], use_huber)
        out = tpo._build_normal_eq(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                                     else a for a in args], use_huber)
        for r, o in zip(ref, out):
            r = np.asarray(r)
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max())


def test_residuals_parity(rng):
    (R0, t0, Xw, uv, info, _), bird, _ = _problem(rng)
    ref = jres.mono_reproj(*map(jnp.asarray, (R0, t0, Xw, uv)), FX, FY, CX, CY)
    out = tres.mono_reproj(*map(torch.from_numpy, (R0, t0, Xw, uv)),
                           FX, FY, CX, CY)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-3)
    args = (R0, t0, bird["Xw_bird"], bird["obs_pc_bird"])
    ref = jres.bird_point(*map(jnp.asarray, args))
    out = tres.bird_point(*map(torch.from_numpy, args))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
