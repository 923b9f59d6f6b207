"""Parity of the port's core/ (lie, linalg, robust, camera) with the JAX
package on the same numpy inputs.

Tolerance: 1e-6 relative (plus 1e-6 absolute for values near 0). Both sides
compute in f32; the only differences are the order of f32 sums inside
small matmuls and one-ulp differences of transcendental functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.core import camera as jcam
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.core import linalg as jlinalg
from orbslam_birdview_tpu.core import robust as jrobust
from orbslam_birdview_tpu_torch.core import camera as tcam
from orbslam_birdview_tpu_torch.core import lie as tlie
from orbslam_birdview_tpu_torch.core import linalg as tlinalg
from orbslam_birdview_tpu_torch.core import robust as trobust

RTOL, ATOL = 1e-6, 1e-6
# V = I + B·W + C·W² (the SE3 left Jacobian) takes B = (1−cos θ)/θ² and
# C = (θ−sin θ)/θ³ in f32 as the reference does; for 1e-4 < θ < 1e-2 both
# cancel catastrophically, and the one-ulp differences between the two
# libraries' sin/cos come out as up to ~2e-4 of the translation V·rho.
ATOL_V = 5e-4
_USES_V = {"so3_left_jacobian", "se3_exp", "se3_update_left"}


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


def _tangents(rng, n=64):
    """Rotation vectors from tiny (Taylor branch) to near pi."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    mags = np.concatenate([np.zeros(4), rng.uniform(1e-6, 1e-3, 12),
                           rng.uniform(0.01, 3.0, n - 20),
                           np.full(4, np.pi - 1e-3)])
    return (axes * mags[:, None]).astype(np.float32)


def _rotations(rng, n=64):
    return np.asarray(jlie.so3_exp(jnp.asarray(_tangents(rng, n))))


@pytest.mark.parametrize("name", ["hat", "vee", "so3_exp", "so3_log",
                                  "so3_left_jacobian", "se3_exp",
                                  "quat_to_rot", "rot_to_quat"])
def test_lie_unary_parity(rng, name):
    w = _tangents(rng)
    inputs = {
        "hat": w,
        "vee": np.asarray(jlie.hat(jnp.asarray(w))),
        "so3_exp": w,
        "so3_log": _rotations(rng),
        "so3_left_jacobian": w,
        "se3_exp": np.concatenate([rng.normal(size=w.shape).astype(np.float32),
                                   w], -1),
        "quat_to_rot": rng.normal(size=(64, 4)).astype(np.float32),
        "rot_to_quat": _rotations(rng),
    }[name]
    ref = getattr(jlie, name)(jnp.asarray(inputs))
    out = getattr(tlie, name)(torch.from_numpy(inputs))
    if isinstance(ref, tuple):
        _close(ref[0], out[0])
        _close(ref[1], out[1], atol=ATOL_V if name in _USES_V else ATOL)
    else:
        # so3_log near pi: atan2 of |q_v| against a q_w of ~5e-4 amplifies
        # one-ulp differences of the quaternion to ~1e-5 of the angle
        atol = {"so3_log": 2e-5, "so3_left_jacobian": ATOL_V}.get(name, ATOL)
        _close(ref, out, atol=atol)


@pytest.mark.parametrize("name", ["se3_mul", "se3_update_left", "se3_inv"])
def test_se3_binary_parity(rng, name):
    Ra, Rb = _rotations(rng), _rotations(rng)
    ta = rng.normal(size=(64, 3)).astype(np.float32)
    tb = rng.normal(size=(64, 3)).astype(np.float32)
    xi = np.concatenate([rng.normal(size=(64, 3)), _tangents(rng)],
                        -1).astype(np.float32)
    args = {"se3_mul": (Ra, ta, Rb, tb), "se3_update_left": (Ra, ta, xi),
            "se3_inv": (Ra, ta)}[name]
    ref = getattr(jlie, name)(*map(jnp.asarray, args))
    out = getattr(tlie, name)(*map(torch.from_numpy, args))
    _close(ref[0], out[0])
    _close(ref[1], out[1], atol=ATOL_V if name in _USES_V else ATOL)


@pytest.mark.parametrize("name", ["se3_apply", "se3_matrix",
                                  "se3_from_matrix"])
def test_se3_matrix_helpers_parity(rng, name):
    """Batched over two leading axes (points over poses for `se3_apply`);
    the port keeps its inputs' dtype and device."""
    R = _rotations(rng, 48).reshape(4, 12, 3, 3)
    t = rng.normal(size=(4, 12, 3)).astype(np.float32)
    p = rng.normal(size=(4, 12, 3)).astype(np.float32)
    T = np.asarray(jlie.se3_matrix(jnp.asarray(R), jnp.asarray(t)))
    args = {"se3_apply": (R, t, p), "se3_matrix": (R, t),
            "se3_from_matrix": (T,)}[name]
    ref = getattr(jlie, name)(*map(jnp.asarray, args))
    out = getattr(tlie, name)(*map(torch.from_numpy, args))
    for a, b in zip(ref if isinstance(ref, tuple) else (ref,),
                    out if isinstance(out, tuple) else (out,)):
        assert b.dtype == torch.float32 and b.shape == a.shape
        _close(a, b)


def test_se3_apply_matches_matrix(rng):
    """tests/test_lie.py's check on the port: applying (R, t) equals the
    homogeneous 4×4 product."""
    xi = rng.normal(size=(6,)).astype(np.float32)
    R, t = tlie.se3_exp(torch.from_numpy(xi))
    p = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))
    T = tlie.se3_matrix(R, t)
    ph = torch.cat([p, torch.ones(10, 1)], dim=1)
    np.testing.assert_allclose(tlie.se3_apply(R, t, p).numpy(),
                               (ph @ T.T)[:, :3].numpy(), atol=1e-5)
    R2, t2 = tlie.se3_from_matrix(T)
    assert torch.equal(R2, R) and torch.equal(t2, t)


@pytest.mark.parametrize("fn", ["so3_exp", "se3_exp"])
def test_gradients_finite_at_identity(fn):
    x = torch.zeros(3 if fn == "so3_exp" else 6, requires_grad=True)
    out = getattr(tlie, fn)(x)
    loss = sum(o.sum() for o in out) if isinstance(out, tuple) else out.sum()
    (g,) = torch.autograd.grad(loss, x)
    assert torch.isfinite(g).all()


def test_so3_log_gradient_finite_at_identity():
    w = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(tlie.so3_log(tlie.so3_exp(w)).sum(), w)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.ones(3), atol=1e-6)


def test_solve_psd_small_parity(rng):
    J = rng.normal(size=(32, 20, 6)).astype(np.float32)
    A = np.einsum("bki,bkj->bij", J, J) + 1e-3 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(32, 6)).astype(np.float32)
    # a rank-deficient matrix exercises the clamped pivot
    A[0] = 0.0
    ref = jlinalg.solve_psd_small(jnp.asarray(A), jnp.asarray(b))
    out = tlinalg.solve_psd_small(torch.from_numpy(A), torch.from_numpy(b))
    # relative to each solution's size: triangular solves amplify the
    # one-ulp differences of the Cholesky factors by the condition number
    scale = np.abs(np.asarray(ref)).max(axis=1, keepdims=True)
    np.testing.assert_allclose(out.numpy() / scale, np.asarray(ref) / scale,
                               atol=1e-5)
    np.testing.assert_allclose((A @ out.numpy()[..., None])[1:, :, 0],
                               b[1:], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fn", ["huber_weight", "huber_rho", "cauchy_weight"])
@pytest.mark.parametrize("delta2", [jrobust.CHI2_2DOF, jrobust.CHI2_3DOF])
def test_robust_parity(rng, fn, delta2):
    chi2 = np.concatenate([[0.0, delta2], rng.uniform(0, 50, 200)]).astype(
        np.float32)
    ref = getattr(jrobust, fn)(jnp.asarray(chi2), delta2)
    out = getattr(trobust, fn)(torch.from_numpy(chi2), delta2)
    _close(ref, out)


def test_birdview_camera_parity(rng):
    jb, tb = jcam.BirdviewCamera(), tcam.BirdviewCamera()
    uv = rng.uniform(-20, 400, (256, 2)).astype(np.float32)
    _close(jb.pixel_to_base_xy(jnp.asarray(uv)),
           tb.pixel_to_base_xy(torch.from_numpy(uv)))
    xy = np.asarray(jb.pixel_to_base_xy(jnp.asarray(uv)))
    _close(jb.base_xy_to_pixel(jnp.asarray(xy)),
           tb.base_xy_to_pixel(torch.from_numpy(xy)), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jb.in_image(jnp.asarray(uv), 3.0)),
                                  tb.in_image(torch.from_numpy(uv), 3.0).numpy())
    assert jb.footprint_mask_bounds() == tb.footprint_mask_bounds()


def test_pinhole_camera_parity(rng):
    kw = dict(fx=348.5, fy=347.0, cx=480.0, cy=302.0, k1=-0.0488316,
              k2=0.000298406, p1=-0.00591118, p2=0.00193258, width=950,
              height=400)
    jc, tc = jcam.PinholeCamera(**kw), tcam.PinholeCamera(**kw)
    pc = np.concatenate([rng.uniform(-5, 5, (128, 2)),
                         rng.uniform(0.5, 20, (128, 1))], -1).astype(np.float32)
    _close(jc.project(jnp.asarray(pc)), tc.project(torch.from_numpy(pc)),
           atol=1e-4)
    uv = rng.uniform(0, 900, (128, 2)).astype(np.float32)
    d = rng.uniform(1, 10, 128).astype(np.float32)
    _close(jc.backproject(jnp.asarray(uv), jnp.asarray(d)),
           tc.backproject(torch.from_numpy(uv), torch.from_numpy(d)))
    _close(jc.undistort_points(jnp.asarray(uv)),
           tc.undistort_points(torch.from_numpy(uv)), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(jc.K), tc.K.numpy())


def test_camera_to_base_extrinsics_parity():
    Rj, tj = jcam.camera_to_base_extrinsics(jcam.DEFAULT_BIRDVIEW_TBC_QUAT,
                                            jcam.DEFAULT_BIRDVIEW_TBC_T)
    Rt, tt = tcam.camera_to_base_extrinsics(tcam.DEFAULT_BIRDVIEW_TBC_QUAT,
                                            tcam.DEFAULT_BIRDVIEW_TBC_T)
    _close(Rj, Rt)
    _close(tj, tt)
