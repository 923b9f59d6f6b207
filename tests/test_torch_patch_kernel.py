"""The port's patch gather against the JAX package's Pallas kernel (run in
interpret mode on the CPU) and against the reference's CPU path,
`vmap(dynamic_slice)` in `orb.extract_patches`: one level at a time
(`gather_patches`) and all levels of an extraction in one call
(`gather_patches_levels`), whose output is the per-level results
concatenated, level 0 first.

Bit-exact: the gather copies integer-valued f32 pixels, so any difference
is a wrong window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.frontend import patch_kernel as jpk
from orbslam_birdview_tpu_torch.frontend import orb as torb
from orbslam_birdview_tpu_torch.frontend import patch_kernel as tpk
from orbslam_birdview_tpu_torch.utils import build

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
    before = build.LAUNCHES[tpk.GATHER.name]
    out = tpk.gather_patches(torch.from_numpy(img), torch.from_numpy(ys),
                             torch.from_numpy(xs), S)
    assert build.LAUNCHES[tpk.GATHER.name] == before
    assert out.shape == (5, S, S) and out.dtype == torch.float32


def test_other_devices_raise():
    img = torch.empty((64, 64), device="meta")
    idx = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpk.gather_patches(img, idx, idx, S)


# ---------------------------------------------------------------------------
# all levels of an extraction in one call
# ---------------------------------------------------------------------------

# (Hp, Wp, K_l) per level: shapes shrink as a pyramid's do, some K_l = 1
LEVELS = [(120, 150, 40), (101, 126, 1), (85, 106, 23), (72, 89, 17),
          (61, 75, 1), (52, 64, 9), (49, 55, 5), (48, 48, 3)]


def _levels(rng, n_levels, over=0, lo=0):
    imgs, ys_l, xs_l = [], [], []
    for h, w, k in LEVELS[:n_levels]:
        imgs.append(_image(rng, h, w))
        ys, xs = _starts(rng, h, w, k, lo=lo, over=over)
        ys_l.append(ys)
        xs_l.append(xs)
    return imgs, ys_l, xs_l


def _port_levels(imgs, ys_l, xs_l):
    return tpk.gather_patches_levels(
        [torch.from_numpy(a) for a in imgs],
        [torch.from_numpy(a) for a in ys_l],
        [torch.from_numpy(a) for a in xs_l], S).numpy()


@pytest.mark.parametrize("over", [0, 30], ids=["in_range", "over_range"])
@pytest.mark.parametrize("n_levels", [1, 4, 8])
def test_levels_equal_per_level_plain_concatenated(rng, n_levels, over):
    imgs, ys_l, xs_l = _levels(rng, n_levels, over=over)
    out = _port_levels(imgs, ys_l, xs_l)
    per_level = [tpk.gather_patches_plain(torch.from_numpy(a),
                                          torch.from_numpy(y),
                                          torch.from_numpy(x), S).numpy()
                 for a, y, x in zip(imgs, ys_l, xs_l)]
    assert out.shape == (sum(k for _, _, k in LEVELS[:n_levels]), S, S)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, np.concatenate(per_level, 0))
    # and each window is the slice at its clamped start
    k = 0
    for a, ys, xs in zip(imgs, ys_l, xs_l):
        for y, x in zip(ys, xs):
            y = min(max(int(y), 0), a.shape[0] - S)
            x = min(max(int(x), 0), a.shape[1] - S)
            np.testing.assert_array_equal(out[k], a[y:y + S, x:x + S])
            k += 1


@pytest.mark.parametrize("over", [0, 30], ids=["in_range", "over_range"])
@pytest.mark.parametrize("n_levels", [1, 4, 8])
def test_levels_match_dynamic_slice(rng, n_levels, over):
    imgs, ys_l, xs_l = _levels(rng, n_levels, over=over)
    ref = np.concatenate([_dynamic_slice(a, y, x)
                          for a, y, x in zip(imgs, ys_l, xs_l)], 0)
    np.testing.assert_array_equal(_port_levels(imgs, ys_l, xs_l), ref)


@pytest.mark.parametrize("lo,over", [(0, 0), (-9, 12)],
                         ids=["in_range", "out_of_range"])
def test_levels_match_pallas_interpret(rng, lo, over):
    """Four levels, negative starts and starts past the far edge included:
    the Pallas kernel clamps both, level by level, and so does the port."""
    imgs, ys_l, xs_l = _levels(rng, 4, over=over, lo=lo)
    ref = np.concatenate(
        [np.asarray(jpk.gather_patches(jnp.asarray(a), jnp.asarray(y),
                                       jnp.asarray(x), S, interpret=True))
         for a, y, x in zip(imgs, ys_l, xs_l)], 0)
    np.testing.assert_array_equal(_port_levels(imgs, ys_l, xs_l), ref)


def test_one_level_is_the_one_level_case(rng):
    img = _image(rng)
    ys, xs = _starts(rng, *img.shape, n=11, over=5)
    np.testing.assert_array_equal(_port_levels([img], [ys], [xs]),
                                  _port(img, ys, xs))


def test_levels_on_cpu_take_the_plain_version(rng):
    imgs, ys_l, xs_l = _levels(rng, 4)
    before = build.LAUNCHES[tpk.GATHER.name]
    out = _port_levels(imgs, ys_l, xs_l)
    assert build.LAUNCHES[tpk.GATHER.name] == before
    assert out.shape[0] == sum(y.shape[0] for y in ys_l)


@pytest.mark.parametrize("n_img,n_ys,n_xs", [(17, 17, 17), (0, 0, 0),
                                             (3, 2, 3), (3, 3, 4)],
                         ids=["17_levels", "no_level", "ys_short", "xs_long"])
def test_levels_refuse_bad_lists(n_img, n_ys, n_xs):
    img = torch.zeros((64, 64))
    idx = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpk.gather_patches_levels([img] * n_img, [idx] * n_ys, [idx] * n_xs,
                                  S)


def test_levels_other_devices_raise():
    img = torch.empty((64, 64), device="meta")
    idx = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpk.gather_patches_levels([img, img], [idx, idx], [idx, idx], S)


def test_extractor_levels_equal_per_level_patches(rng):
    """The extractor's one gather over every level's edge-padded image
    (`Detection.padded`) and its int32 slots is the per-level
    `extract_patches` concatenated."""
    img = torch.from_numpy(np.round(_image(rng, 160, 224)))
    cfg = torb.ORBConfig(n_features=300, n_levels=4)
    det = torb.detect_levels_plain(img, None, cfg)
    counts = [max(b, 1) for b in cfg.level_budgets()]
    ys_l, xs_l = det.ys.split(counts), det.xs.split(counts)
    out = tpk.gather_patches_levels(det.padded, ys_l, xs_l, torb.PATCH)
    ref = torch.cat([torb.extract_patches(a, y, x)
                     for a, y, x in zip(det.levels, ys_l, xs_l)], 0)
    assert torch.equal(out, ref)
    # a patch is centred on its keypoint
    assert out[0, torb.PATCH_C, torb.PATCH_C] == det.levels[0][ys_l[0][0],
                                                               xs_l[0][0]]