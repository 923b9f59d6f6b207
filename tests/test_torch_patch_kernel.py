"""The port's patch gather against the JAX package's Pallas kernel (run in
interpret mode on the CPU) and against the reference's CPU path,
`vmap(dynamic_slice)` in `orb.extract_patches`.

Bit-exact: the gather copies integer-valued f32 pixels, so any difference
is a wrong window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.frontend import patch_kernel as jpk
from orbslam_birdview_tpu_torch.frontend import patch_kernel as tpk

S = 48


def _image(rng, h=70, w=90):
    return np.round(rng.uniform(0, 255, (h, w))).astype(np.float32)


def _starts(rng, h, w, n, lo=0, over=0):
    """n top-left starts in [lo, H−S+over] × [lo, W−S+over]."""
    ys = rng.integers(lo, h - S + 1 + over, n).astype(np.int32)
    xs = rng.integers(lo, w - S + 1 + over, n).astype(np.int32)
    return ys, xs


def _dynamic_slice(img, ys, xs):
    """The reference's CPU path (`orb.extract_patches`)."""
    jimg = jnp.asarray(img)

    def sl(y, x):
        return jax.lax.dynamic_slice(jimg, (y, x), (S, S))
    return np.asarray(jax.vmap(sl)(jnp.asarray(ys), jnp.asarray(xs)))


def _port(img, ys, xs):
    return tpk.gather_patches(torch.from_numpy(img), torch.from_numpy(ys),
                              torch.from_numpy(xs), S).numpy()


@pytest.mark.parametrize("over", [0, 12], ids=["in_range", "over_range"])
def test_plain_matches_pallas_interpret(rng, over):
    img = _image(rng)
    ys, xs = _starts(rng, *img.shape, n=24, over=over)
    ref = np.asarray(jpk.gather_patches(jnp.asarray(img), jnp.asarray(ys),
                                        jnp.asarray(xs), S, interpret=True))
    np.testing.assert_array_equal(_port(img, ys, xs), ref)


@pytest.mark.parametrize("over", [0, 40], ids=["in_range", "over_range"])
def test_plain_matches_dynamic_slice(rng, over):
    img = _image(rng, 120, 150)
    ys, xs = _starts(rng, *img.shape, n=300, over=over)
    np.testing.assert_array_equal(_port(img, ys, xs),
                                  _dynamic_slice(img, ys, xs))


def test_negative_start_divergence(rng):
    """Negative starts: the Pallas kernel clamps them to 0 and so does the
    port; the reference's CPU path wraps −s to Hp−s before clamping. The
    extractor's starts are keypoint coordinates (≥ 0), so the main path
    never meets this case."""
    img = _image(rng)
    ys = np.array([-5, 3, -1], np.int32)
    xs = np.array([2, -7, -1], np.int32)
    port = _port(img, ys, xs)
    pallas = np.asarray(jpk.gather_patches(jnp.asarray(img), jnp.asarray(ys),
                                           jnp.asarray(xs), S, interpret=True))
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, _dynamic_slice(img, np.maximum(ys, 0),
                                                       np.maximum(xs, 0)))
    assert not np.array_equal(port, _dynamic_slice(img, ys, xs))


def test_cpu_tensors_take_the_plain_version(rng):
    img = _image(rng)
    ys, xs = _starts(rng, *img.shape, n=5)
    before = tpk.LAUNCHES
    out = tpk.gather_patches(torch.from_numpy(img), torch.from_numpy(ys),
                             torch.from_numpy(xs), S)
    assert tpk.LAUNCHES == before
    assert out.shape == (5, S, S) and out.dtype == torch.float32


def test_other_devices_raise():
    img = torch.empty((64, 64), device="meta")
    idx = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpk.gather_patches(img, idx, idx, S)
