"""The port's ORB extractor against the JAX package, stage by stage and end
to end, on the same numpy images.

Exact where the reference computes integers: FAST, NMS, selection, BRIEF
from given angles and blurred patches. Two places round f32 sums whose
order the two libraries choose differently, and each test states its
budget for them:
- the pyramid resize: XLA's CPU dot takes one of two operation orders
  depending on the shape (a fused multiply-add or not); the port takes one
  fixed order, exact at the front stream's full size, and elsewhere about
  1 pixel in 10^4 rounds the other way (always by 1);
- the 7×7 patch blur before BRIEF's integer comparisons, and atan2 of the
  orientation, which differ by an ulp.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.frontend import keypoints as jkeypoints
from orbslam_birdview_tpu.frontend import orb as jorb
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera, PinholeCamera
from orbslam_birdview_tpu_torch.frontend import orb as torb
from orbslam_birdview_tpu_torch.utils import synth

import orb_detect_cases as odc


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def texture():
    return synth.make_texture(11, size=512, n_blobs=500)


def _crop(texture, h, w, y=40, x=60):
    return np.round(texture[y:y + h, x:x + w]).astype(np.float32)


@pytest.mark.parametrize("threshold", [5.0, 7.0])
def test_fast_response_exact(texture, threshold):
    img = _crop(texture, 96, 128)
    rj, cj = jorb.fast_response(jnp.asarray(img), threshold)
    rt, ct = torb.fast_response(_t(img), threshold)
    np.testing.assert_array_equal(rt.numpy(), _n(rj))
    np.testing.assert_array_equal(ct.numpy(), _n(cj))
    assert ct.numpy().sum() > 20


def test_nms3_exact(texture):
    resp = np.asarray(jorb.fast_response(jnp.asarray(_crop(texture, 96, 128)),
                                         7.0)[0])
    np.testing.assert_array_equal(torb.nms3(_t(resp)).numpy(),
                                  _n(jorb.nms3(jnp.asarray(resp))))


def test_select_uniform_topk_ties_exact(rng):
    # responses from 8 values: ties inside cells and across cells, at every
    # rank, and rank-penalized comparisons that are equal in f32
    resp = rng.integers(0, 8, (75, 101)).astype(np.float32) * 100.0
    resp[rng.random(resp.shape) < 0.3] = 0.0
    for k in (60, 130):   # of 140 candidates
        ref = jorb.select_uniform_topk(jnp.asarray(resp), k, 16, 4)
        out = torb.select_uniform_topk(_t(resp), k, 16, 4)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(o.numpy(), _n(r))


def test_pyramid_level_exact_at_full_front_size(texture):
    img = np.round(synth.make_texture(3, size=1024, n_blobs=800)[:400, :950])
    ref = jnp.round(jorb.resize_bilinear(jnp.asarray(img), 333, 792))
    out = torch.round(torb.resize_bilinear(_t(img), 333, 792))
    np.testing.assert_array_equal(out.numpy(), _n(ref))


@pytest.mark.parametrize("shape", [(160, 224), (128, 128)])
def test_pyramid_levels_within_budget(texture, shape):
    cfg = jorb.ORBConfig(n_levels=4)
    sizes = jorb.level_sizes(*shape, cfg)
    lj = jnp.round(jnp.asarray(_crop(texture, *shape)))
    for h, w in sizes[1:]:
        # each level from the reference's previous level, so every level
        # is judged on its own resize
        ref = _n(jnp.round(jorb.resize_bilinear(lj, h, w)))
        out = torch.round(torb.resize_bilinear(torch.from_numpy(_n(lj).copy()),
                                               h, w)).numpy()
        diff = np.abs(out - ref)
        assert diff.max() <= 1.0
        assert (diff > 0).mean() <= 1e-3, (h, w, (diff > 0).mean())
        lj = jnp.asarray(ref)


def test_blur_patches_within_budget(rng):
    patches = np.round(rng.uniform(0, 255, (300, 48, 48))).astype(np.float32)
    ref = _n(jorb.blur_patches(jnp.asarray(patches)))
    out = torb.blur_patches(_t(patches)).numpy()
    # sums of 7×7 products in another order: a few ulps of 255 (1.5e-5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    # rounded values feed BRIEF; an ulp moves one across .5 rarely
    assert (np.round(out) != np.round(ref)).mean() <= 1e-4


def test_ic_angle_within_an_ulp(rng):
    patches = np.round(rng.uniform(0, 255, (500, 48, 48))).astype(np.float32)
    ref = _n(jorb.ic_angle_from_patches(jnp.asarray(patches)))
    out = torb.ic_angle_from_patches(_t(patches)).numpy()
    # the moments are exact integers; atan2 differs by at most an ulp
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_brief_exact_with_injected_angles(rng):
    patches = np.round(rng.uniform(0, 255, (600, 48, 48))).astype(np.float32)
    blurred = _n(jorb.blur_patches(jnp.asarray(patches)))
    angle = np.array(jorb.ic_angle_from_patches(jnp.asarray(patches)))
    angle[:40] = 0.0
    angle[40:80] = np.float32(np.pi / 2)
    ref = jorb.brief_from_patches(jnp.asarray(blurred), jnp.asarray(angle))
    out = torb.brief_from_patches(_t(blurred), _t(angle))
    np.testing.assert_array_equal(out.numpy(), _n(ref))


# ---------------------------------------------------------------------------
# the whole-image API (gaussian_blur7, ic_angle, brief_descriptors): the JAX
# package's functions on the same image and keypoints, and the OpenCV bars
# of tests/test_frontend.py beside them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cv_image():
    """tests/test_frontend.py's procedural image with corners."""
    r = np.random.default_rng(7)
    img = r.uniform(0, 60, size=(240, 320)).astype(np.float32)
    for _ in range(40):
        y, x = r.integers(20, 200), r.integers(20, 280)
        h, w = r.integers(8, 30), r.integers(8, 30)
        img[y:y + h, x:x + w] += r.uniform(60, 180)
    img = cv2.GaussianBlur(np.clip(img, 0, 255), (3, 3), 0.8)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv_keypoints(img_u8, **orb_kw):
    """Level-0 keypoints of cv2's ORB detector as int (ys, xs)."""
    kps = cv2.ORB_create(nlevels=1, **orb_kw).detect(img_u8, None)
    kps = [k for k in kps if k.octave == 0]
    ys = np.array([int(round(k.pt[1])) for k in kps], np.int32)
    xs = np.array([int(round(k.pt[0])) for k in kps], np.int32)
    return kps, ys, xs


def test_gaussian_blur7_parity(cv_image):
    img = cv_image.astype(np.float32)
    ref = _n(jorb.gaussian_blur7(jnp.asarray(img)))
    out = torb.gaussian_blur7(_t(img)).numpy()
    assert out.shape == ref.shape == img.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    cv = cv2.GaussianBlur(img, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(out, cv, atol=0.05)


def test_ic_angle_whole_image_parity(cv_image):
    kps, ys, xs = _cv_keypoints(cv_image, nfeatures=100, edgeThreshold=31,
                                fastThreshold=25)
    assert len(kps) >= 10
    img = cv_image.astype(np.float32)
    ref = _n(jorb.ic_angle(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    out = torb.ic_angle(_t(img), _t(ys), _t(xs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    diff = np.abs(((np.degrees(out) - np.array([k.angle for k in kps]))
                   + 180) % 360 - 180)
    assert np.median(diff) < 2.0, f"median angle diff {np.median(diff)}"


def test_brief_descriptors_parity(cv_image):
    """The same bits as the JAX package from the JAX package's blur and
    angles, and from each package's own; cv2.ORB.compute within the JAX
    test's borderline-bit budget."""
    det = cv2.FastFeatureDetector_create(threshold=25, nonmaxSuppression=True)
    kps = [k for k in det.detect(cv_image, None)
           if 25 < k.pt[0] < 295 and 25 < k.pt[1] < 215][:50]
    assert len(kps) >= 20
    ys = np.array([int(round(k.pt[1])) for k in kps], np.int32)
    xs = np.array([int(round(k.pt[0])) for k in kps], np.int32)
    img = cv_image.astype(np.float32)
    jblur = jorb.gaussian_blur7(jnp.asarray(img))
    jang = jorb.ic_angle(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    ref = _n(jorb.brief_descriptors(jblur, jnp.asarray(ys), jnp.asarray(xs),
                                    jang))
    got = torb.brief_descriptors(_t(_n(jblur)), _t(ys), _t(xs), _t(_n(jang)))
    np.testing.assert_array_equal(got.numpy(), ref)
    blur = torb.gaussian_blur7(_t(img))
    ang = torb.ic_angle(_t(img), _t(ys), _t(xs))
    own = torb.brief_descriptors(blur, _t(ys), _t(xs), ang).numpy()
    np.testing.assert_array_equal(own, ref)
    for k, a in zip(kps, ang.numpy()):
        k.angle, k.octave = float(np.degrees(a)), 0
        k.pt = (float(round(k.pt[0])), float(round(k.pt[1])))
    kps_out, desc_cv = cv2.ORB_create(nlevels=1, edgeThreshold=0).compute(
        cv_image, kps)
    assert desc_cv is not None and len(kps_out) == len(kps)
    ham = np.unpackbits(own ^ desc_cv, axis=1).sum(1)
    assert np.median(ham) <= 8 and np.mean(ham) <= 16, ham


# ---------------------------------------------------------------------------
# extract_orb end to end on rendered frames
# ---------------------------------------------------------------------------

CAM = PinholeCamera(fx=348.5 * 224 / 950, fy=347.0 * 224 / 950,
                    cx=480.0 * 224 / 950, cy=302.0 * 224 / 950,
                    width=224, height=160)
BV = BirdviewCamera(width=128, height=128)


@pytest.fixture(scope="module")
def frames():
    seq = synth.BirdSequence(CAM, BV, n_frames=4)
    img, bev, _ = seq.frame(2)
    return img, bev, synth.footprint_mask(BV)


@pytest.mark.parametrize("stream", ["front", "bev"])
def test_extract_orb_end_to_end(frames, stream):
    img, bev, mask = frames
    kw = dict(n_features=300, n_levels=4, min_threshold=5.0)
    im, m = (img, None) if stream == "front" else (bev, mask)
    ref = jorb.extract_orb(jnp.asarray(im), jorb.ORBConfig(**kw),
                           mask=None if m is None else jnp.asarray(m))
    out = torb.extract_orb(im, torb.ORBConfig(**kw), mask=m, device="cpu")
    valid = _n(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    np.testing.assert_array_equal(out.octave.numpy(), _n(ref.octave))
    assert valid.sum() > 150
    # keypoints as a set per slot range: a pyramid pixel rounded the other
    # way can reorder two equal-ish responses within a level
    key_ref = {(o, x, y): i for i, (o, (x, y)) in
               enumerate(zip(_n(ref.octave), _n(ref.xy))) if valid[i]}
    key_out = {(o, x, y): i for i, (o, (x, y)) in
               enumerate(zip(out.octave.numpy(), out.xy.numpy())) if valid[i]}
    common = key_ref.keys() & key_out.keys()
    # budget: 1% of the keypoints may move (pyramid rounding, see above)
    assert len(common) >= 0.99 * valid.sum(), (len(common), valid.sum())
    ir = np.array([key_ref[k] for k in common])
    io = np.array([key_out[k] for k in common])
    bits_ref = np.unpackbits(_n(ref.desc_u8)[ir], axis=1)
    bits_out = np.unpackbits(out.desc_u8.numpy()[io], axis=1)
    # budget: 0.5% of the descriptor bits of common keypoints (an ulp of
    # atan2 or of the blur moves a BRIEF tap across a pixel boundary)
    assert (bits_ref != bits_out).mean() <= 5e-3
    np.testing.assert_allclose(out.angle.numpy()[io], _n(ref.angle)[ir],
                               atol=1e-5)
    # the ±1 form is the port's own descriptor, unpacked as the reference
    # unpacks bits, and zero on invalid slots
    np.testing.assert_array_equal(
        out.desc_pm1.numpy(),
        _n(jkeypoints.unpack_bits_to_pm1(jnp.asarray(out.desc_u8.numpy())))
        * valid[:, None])


# ---------------------------------------------------------------------------
# detect_level_plain (the plain version of the card's detection kernels) at
# the bird rig's shapes: each level from the reference's own level image,
# against the reference's per-level functions, slot for slot
# ---------------------------------------------------------------------------

BIRD_FRONT = (400, 950, 8)
BIRD_BEV = (384, 384, 4)


@pytest.fixture(scope="module")
def bird_levels():
    """stream -> (reference level images, mask or None, port ORBConfig)."""
    tex = synth.make_texture(5, size=1024, n_blobs=900)
    out = {}
    for stream, (h, w, n_levels) in (("front", BIRD_FRONT),
                                     ("bev", BIRD_BEV)):
        img = np.round(tex[:h, :w] if stream == "front"
                       else tex[300:300 + h, 200:200 + w])
        mask = (synth.footprint_mask(BirdviewCamera(width=w, height=h))
                .astype(np.float32) if stream == "bev" else None)
        cfg = jorb.ORBConfig(**(odc.BIRD if stream == "front"
                                else odc.BIRD_BEV)._asdict())
        assert cfg.n_levels == n_levels
        lvl, levels = jnp.asarray(img, jnp.float32), []
        for l, (hl, wl) in enumerate(jorb.level_sizes(h, w, cfg)):
            if l:
                lvl = jnp.round(jorb.resize_bilinear(lvl, hl, wl))
            levels.append(_n(lvl))
        out[stream] = (levels, mask, torb.ORBConfig(**cfg._asdict()))
    return out


def _reference_level(lvl, mask, level, cfg):
    """The reference's `_extract_impl` loop body for one level, eagerly."""
    h, w = lvl.shape
    resp, corner = jorb.fast_response(jnp.asarray(lvl), cfg.min_threshold)
    resp = jnp.where(corner, resp, 0.0)
    resp = resp * jorb._border_mask(h, w, jorb.EDGE_MARGIN)
    if mask is not None:
        lvl_mask = jorb.resize_bilinear(jnp.asarray(mask), h, w) > 0.5
        resp = jnp.where(lvl_mask, resp, 0.0)
    k_l = max(cfg.level_budgets()[level], 1)
    ys, xs, r, valid = jorb.select_uniform_topk(jorb.nms3(resp), k_l,
                                                cfg.cell, cfg.per_cell)
    dx, dy = jorb._subpixel_offsets(resp, ys, xs)
    s = cfg.level_scales()[level]
    xy = jnp.stack([(xs.astype(jnp.float32) + dx) * s,
                    (ys.astype(jnp.float32) + dy) * s], -1)
    return ys, xs, xy, r, valid


@pytest.mark.parametrize("stream,level",
                         [("front", l) for l in range(BIRD_FRONT[2])]
                         + [("bev", l) for l in range(BIRD_BEV[2])])
def test_detect_level_plain_exact_at_bird_shapes(bird_levels, stream, level):
    levels, mask, cfg = bird_levels[stream]
    lvl = levels[level]
    ref = _reference_level(lvl, mask, level, cfg)
    out = torb.detect_level_plain(_t(lvl), None if mask is None else _t(mask),
                                  level, cfg)
    for name, r, o in zip(("ys", "xs", "xy", "response", "valid"), ref, out):
        np.testing.assert_array_equal(o.numpy(), _n(r), err_msg=name)
    if level < 3:
        assert _n(ref[4]).sum() > 50


@pytest.mark.parametrize("stream", ["front", "bev"])
def test_detect_levels_plain_is_its_levels(bird_levels, stream):
    """`detect_levels_plain` lays its levels' detections into the slot
    layout `extract_orb` returns, with the levels edge-padded for the
    gather; its pyramid rounds as `resize_bilinear` does, within the
    budget stated at the top of this file against the reference's."""
    levels, mask, cfg = bird_levels[stream]
    m = None if mask is None else _t(mask)
    det = torb.detect_levels_plain(_t(levels[0]), m, cfg)
    slots = [max(b, 1) for b in cfg.level_budgets()]
    begin = np.cumsum([0] + slots)
    assert det.valid.shape == (cfg.padded_capacity(),)
    assert not det.valid[begin[-1]:].any()
    assert (det.response[begin[-1]:] == -np.inf).all()
    assert (det.xy[begin[-1]:] == 0).all()
    for l, lvl in enumerate(det.levels):
        diff = np.abs(lvl.numpy() - levels[l])
        assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3, l
        c = torb.PATCH // 2
        np.testing.assert_array_equal(det.padded[l].numpy(),
                                      np.pad(lvl.numpy(), c, mode="edge"))
        ys, xs, xy, r, valid = torb.detect_level_plain(lvl, m, l, cfg)
        sl = slice(begin[l], begin[l + 1])
        np.testing.assert_array_equal(det.ys[sl].numpy(), ys.numpy())
        np.testing.assert_array_equal(det.xs[sl].numpy(), xs.numpy())
        np.testing.assert_array_equal(det.xy[sl].numpy(), xy.numpy())
        np.testing.assert_array_equal(det.valid[sl].numpy(), valid.numpy())
        np.testing.assert_array_equal(
            det.response[sl].numpy(),
            np.where(valid.numpy(), r.numpy(), -np.inf))
        assert (det.octave[sl] == l).all()
