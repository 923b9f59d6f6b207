"""The port's stereo front end (`frontend/stereo.py`) against the JAX
package's, on one rendered stereo pair of a textured wall: 320×240, 500
features on 8 levels, a 16 cm baseline at 4 m (about 10 px of disparity).

Both packages get the same keypoints (the JAX extractor's, carried across
as numpy), so what is compared is the stereo code alone.

Tolerances, and why:
- `stereo_match` works on integers: indices and disparities bit-equal.
- On 8-bit images every patch value is an integer, so every SAD is the
  same f32 integer whatever the summation order: equal `ok` masks, equal
  SADs, uR within 1e-5 px (the parabola's f32 division).
- On float renders the SADs are sums of 121 f32 terms in another order
  (~1e-5 relative apart), so uR agrees within 1e-4 px where both refine,
  and a match whose SAD sits at the median cut may go the other way:
  at most MAX_CUT_FLIPS of the matches (the count is printed).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid

from orbslam_birdview_tpu.api.config import SlamConfig as JSlamConfig
from orbslam_birdview_tpu.core import camera as jcam
from orbslam_birdview_tpu.frontend import orb as jorb
from orbslam_birdview_tpu.frontend import stereo as jst
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
from orbslam_birdview_tpu_torch.frontend import stereo as tst
from orbslam_birdview_tpu_torch.frontend.keypoints import Keypoints
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.utils.synth import WallSequence, render_wall_view

CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
BASELINE = 0.16
ORB = dict(n_features=500)
UR_TOL_U8, UR_TOL_F32 = 1e-5, 1e-4
MAX_CUT_FLIPS = 3
DEPTH_RTOL_F32 = 2e-5
N_SYSTEM_FEATURES, N_SYSTEM_FRAMES = 1000, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


def _views(seq, i):
    R_cw, t_cw = seq.gt_pose(i)
    right = render_wall_view(seq.cam, seq.tex, R_cw.astype(np.float64),
                             t_cw.astype(np.float64)
                             - np.array([BASELINE, 0.0, 0.0]), seq.wall_z)
    return seq.frame(i)[0], right


def _kp_pair(left, right):
    cfg = jorb.ORBConfig(**ORB)
    jl = jorb.extract_orb(jnp.asarray(left, jnp.float32), cfg)
    jr = jorb.extract_orb(jnp.asarray(right, jnp.float32), cfg)

    def port(kp):
        return Keypoints(*[torch.as_tensor(np.array(f)) for f in kp])

    return (jl, jr), (port(jl), port(jr))


@pytest.fixture(scope="module")
def pair():
    cam = PinholeCamera(**CAM, bf=CAM["fx"] * BASELINE)
    seq = WallSequence(cam, n_frames=2, step=0.03)
    left, right = _views(seq, 1)
    left8 = np.clip(np.round(left), 0, 255).astype(np.uint8)
    right8 = np.clip(np.round(right), 0, 255).astype(np.uint8)
    return dict(f32=(left, right, *_kp_pair(left, right)),
                u8=(left8, right8, *_kp_pair(left8, right8)), cam=cam)


def _match(jk, tk):
    jidx, jd = jst.stereo_match(*jk)
    tidx, td = tst.stereo_match(*tk)
    return (np.array(jidx), np.array(jd)), (tidx, td)


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_stereo_match_bit_equal(pair, kind):
    _, _, jk, tk = pair[kind]
    (jidx, jd), (tidx, td) = _match(jk, tk)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert (jidx >= 0).sum() > 150
    assert tidx.dtype == torch.int32


def _subpixel(pair, kind):
    left, right, jk, tk = pair[kind]
    (jidx, jd), (tidx, td) = _match(jk, tk)
    m = jidx >= 0
    ur0 = np.asarray(jk[1].xy)[np.where(m, jidx, 0), 0]
    jout = jst.subpixel_disparity(jnp.asarray(left, jnp.float32),
                                  jnp.asarray(right, jnp.float32),
                                  jk[0].xy, jnp.asarray(ur0), jnp.asarray(m))
    tout = tst.subpixel_disparity(torch.as_tensor(left).float(),
                                  torch.as_tensor(right).float(), tk[0].xy,
                                  torch.as_tensor(ur0), torch.as_tensor(m))
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def test_subpixel_disparity_integer_images(pair):
    (juR, jsad, jok), (tuR, tsad, tok) = _subpixel(pair, "u8")
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tsad, jsad)
    np.testing.assert_allclose(tuR, juR, atol=UR_TOL_U8, rtol=0)
    assert jok.sum() > 100


def test_subpixel_disparity_float_images(pair):
    (juR, jsad, jok), (tuR, tsad, tok) = _subpixel(pair, "f32")
    assert (tok != jok).sum() <= MAX_CUT_FLIPS
    both = tok & jok
    np.testing.assert_allclose(tuR[both], juR[both], atol=UR_TOL_F32, rtol=0)
    np.testing.assert_allclose(tsad, jsad, rtol=1e-5, atol=1e-3)
    assert both.sum() > 100


def _refine(pair, kind, edit=None):
    """Both packages' refine_stereo_subpixel on the pair's matches;
    `edit(jidx, xy_r)` may change the matches and the right keypoints'
    positions first (numpy, in place)."""
    left, right, jk, tk = pair[kind]
    (jidx, jd), _ = _match(jk, tk)
    xy_r = np.asarray(jk[1].xy).copy()
    if edit is not None:
        edit(jidx, jd, xy_r)
    jr = jk[1]._replace(xy=jnp.asarray(xy_r))
    tr = tk[1]._replace(xy=torch.as_tensor(xy_r))
    jout = jst.refine_stereo_subpixel(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
        jk[0], jr, jnp.asarray(jidx), jnp.asarray(jd))
    tout = tst.refine_stereo_subpixel(
        torch.as_tensor(left).float(), torch.as_tensor(right).float(),
        tk[0], tr, torch.as_tensor(jidx), torch.as_tensor(jd))
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout], jd


def _refined(pair, kind):
    """Indices of the matches whose subpixel step succeeded in the JAX
    package, before the median cut."""
    left, right, jk, tk = pair[kind]
    (juR, jsad, jok), _ = _subpixel(pair, kind)
    d = np.asarray(jk[0].xy)[:, 0] - juR
    return np.nonzero(jok & (d >= 0.01) & (d < 128.0))[0], jsad


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_refine_stereo_subpixel(pair, kind):
    (ji, jdisp, jur), (ti, tdisp, tur), _ = _refine(pair, kind)
    tol = UR_TOL_U8 if kind == "u8" else UR_TOL_F32
    flips = int((np.abs(tdisp - jdisp) > tol).sum())
    print(f"{kind}: {flips} matches refined differently "
          f"(median cut), of {(ji >= 0).sum()}")
    np.testing.assert_array_equal(ti, ji)
    if kind == "u8":
        assert flips == 0
    assert flips <= MAX_CUT_FLIPS
    same = np.abs(tdisp - jdisp) <= tol
    np.testing.assert_allclose(tur[same], jur[same], atol=tol, rtol=0)
    assert (ji >= 0).sum() > 150


def test_refine_even_count_median(pair):
    """An even number of refinements: the median is the mean of the two
    middle SADs, as `jnp.nanmedian` takes it (torch.nanmedian would take
    the lower one). A match whose SAD lies between the cut of the one and
    of the other is kept or dropped alike in both packages."""
    ok_idx, sad = _refined(pair, "u8")
    # the lowest and the highest quarter of the SADs: an even count whose
    # two middle values differ
    order = ok_idx[np.argsort(sad[ok_idx], kind="stable")]
    k = len(order) // 4
    keep = np.concatenate([order[:k], order[-k:]])
    drop = np.setdiff1d(np.arange(len(sad)), keep)

    def edit(jidx, jd, xy_r):
        jidx[drop] = -1
        jd[drop] = -1.0

    (ji, jdisp, jur), (ti, tdisp, tur), _ = _refine(pair, "u8", edit)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tdisp, jdisp)
    np.testing.assert_allclose(tur, jur, atol=UR_TOL_U8, rtol=0)
    s = np.sort(sad[keep])
    n = len(s)
    assert n % 2 == 0 and n > 60
    assert s[n // 2 - 1] != s[n // 2]     # the two middle values differ
    vals = torch.as_tensor(np.where(np.isin(np.arange(len(sad)), keep), sad,
                                    np.nan).astype(np.float32))
    mid_t = float(tst.nanmedian_midpoint(vals))
    assert mid_t == float(jnp.nanmedian(jnp.asarray(vals.numpy())))
    assert mid_t == (s[n // 2 - 1] + s[n // 2]) / 2
    assert mid_t != float(torch.nanmedian(vals))


def test_refine_no_valid_sad(pair):
    """No refinement can run (every right match at the image's edge): the
    median is NaN, every refinement fails, and the integer disparities of
    the positive matches stand."""
    W = CAM["width"]

    def edit(jidx, jd, xy_r):
        xy_r[:, 0] = W - 2.0

    (ji, jdisp, jur), (ti, tdisp, tur), jd = _refine(pair, "u8", edit)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tdisp, jdisp)
    np.testing.assert_array_equal(tur, jur)
    kept = ji >= 0
    assert kept.sum() > 100
    np.testing.assert_array_equal(tdisp[kept], jd[kept])
    assert np.isnan(float(tst.nanmedian_midpoint(
        torch.full((8,), float("nan")))))


def test_nanmedian_midpoint_counts():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 10, 11):
        x = np.full(16, np.nan, np.float32)
        x[rng.choice(16, n, replace=False)] = rng.integers(0, 50, n)
        got = float(tst.nanmedian_midpoint(torch.as_tensor(x)))
        assert got == float(jnp.nanmedian(jnp.asarray(x))), n


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_stereo_depth_for_frame(pair, kind):
    """The slow path's splatted depth map, each package extracting its own
    keypoints: equal wherever both set a pixel, and the same pixels set
    but for a few keypoints the two extractors place differently."""
    left, right = pair[kind][:2]
    cam = pair["cam"]
    jcfg = JSlamConfig(camera=jcam.PinholeCamera(**cam._asdict()),
                       orb=jorb.ORBConfig(**ORB), sensor="stereo")
    tcfg = SlamConfig(camera=cam, orb=ORBConfig(**ORB), sensor="stereo")
    jdep = jst.stereo_depth_for_frame(left, right, jcfg)
    tdep = tst.stereo_depth_for_frame(left, right, tcfg, device="cpu")
    assert tdep.dtype == np.float32 and tdep.shape == jdep.shape
    both = (tdep > 0) & (jdep > 0)
    either = (tdep > 0) | (jdep > 0)
    assert both.sum() > 150
    assert both.sum() >= 0.98 * either.sum()
    # bf / disparity: exact on 8-bit images; on float renders uR's 1e-4 px
    # over a disparity of about 10 px
    rtol = 0 if kind == "u8" else DEPTH_RTOL_F32
    np.testing.assert_allclose(tdep[both], jdep[both], rtol=rtol, atol=0)
    # the wall is 4 m away
    assert np.median(tdep[tdep > 0]) == pytest.approx(4.0, rel=0.05)


@pytest.fixture(scope="module")
def runs():
    return mid.system_runs("stereo", N_SYSTEM_FEATURES, N_SYSTEM_FRAMES)


def test_system_stereo(runs):
    """Both packages' System over 12 stereo frames of the depth drive (an
    8 cm baseline at 4 m: 5 px of disparity), each extracting and matching
    its own keypoints: see `torch_midrun.check_depth_runs`. 1000 features,
    since the depth initialization needs 500 matched keypoints."""
    frames, out = runs
    mid.check_depth_runs(frames, out, min_keyframes=2)
