"""The port's dataset loaders (`cli/datasets.py`, reading through
`utils/imageio.py`) against the JAX package's (reading through OpenCV),
record for record.

The fixtures are those of tests/test_dataset_goldens.py and
tests/test_datasets.py, rebuilt here with textured images: TUM RGB-D
(`rgb.txt` / `depth.txt` with their header comments, 16-bit depth at
factor 5000, an association gap), KITTI (`times.txt` in %e notation,
`image_0` / `image_1`), EuRoC (`data.csv` with CRLF endings, a missing
right frame, rectification from the configuration's LEFT./RIGHT. blocks in
both YAML forms) and the fisheye-birdview layout (five-field
`associate.txt`, the global front mask, the origin crop and 0.5× resize,
the colour bird masks).

Tolerances: every `FrameRecord` field equal bit for bit (images, depth,
masks, odometry, timestamps); the rectification maps within 1e-3 px of
`cv2.initUndistortRectifyMap`; rectified images within 1e-3 of the JAX
loader's (`cv2.remap`'s sampling against a float bilinear, which agree to
~5e-5 at 8-bit intensities).
"""
import os
from pathlib import Path

import cv2
import numpy as np
import pytest

from orbslam_birdview_tpu.cli import datasets as jdatasets
from orbslam_birdview_tpu_torch.cli import datasets
from orbslam_birdview_tpu_torch.utils import imageio

REPO = Path(__file__).resolve().parents[1]
MAP_TOL_PX = 1e-3
REMAP_TOL = 1e-3

OPENCV_MATRIX_YAML = """%YAML:1.0
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
          0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
          -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2, 0, 367.45, 0,  0, 435.2, 252.2, 0,  0, 0, 1, 0]
RIGHT.height: 480
RIGHT.width: 752
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
          0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
          -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2, 0, 367.45, -47.90639384423901, 0, 435.2, 252.2, 0, 0, 0, 1, 0]
"""


def texture(rng, shape, base):
    """A constant image (as the golden fixtures use) with texture on it."""
    return np.clip(base + rng.integers(-30, 31, shape), 0, 255).astype(
        np.uint8)


def assert_records_equal(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        for field in ("timestamp", "img", "depth", "right", "bird",
                      "bird_mask", "odom_pose"):
            a, b = getattr(g, field), getattr(w, field)
            if b is None:
                assert a is None, field
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, \
                (field, a.dtype, a.shape, b.dtype, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=field)


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------

TUM_RGB = ("1305031102.175304", "1305031102.211214", "1305031102.275326")
TUM_DEPTH = ("1305031102.160407", "1305031102.226738", "1305031102.262886")


def write_tum(root, rng, colour=True):
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    head = "# {}\n# file: 'rgbd_dataset_freiburg1_xyz.bag'\n# timestamp filename\n"
    (root / "rgb.txt").write_text(head.format("color images") + "".join(
        f"{t} rgb/{t}.png\n" for t in TUM_RGB))
    (root / "depth.txt").write_text(head.format("depth maps") + "".join(
        f"{t} depth/{t}.png\n" for t in TUM_DEPTH))
    for i, t in enumerate(TUM_RGB):
        shape = (48, 64, 3) if colour else (48, 64)
        cv2.imwrite(str(root / "rgb" / f"{t}.png"),
                    texture(rng, shape, 40 + i))
    for t, mm in zip(TUM_DEPTH, (5000, 10000, 15000)):
        d = (mm + rng.integers(-900, 900, (48, 64))).astype(np.uint16)
        cv2.imwrite(str(root / "depth" / f"{t}.png"), d)


@pytest.mark.parametrize("colour", [True, False])
def test_tum_equals_jax(tmp_path, rng, colour):
    write_tum(tmp_path, rng, colour)
    root = str(tmp_path)
    assert_records_equal(list(datasets.load_tum_mono(root)),
                         list(jdatasets.load_tum_mono(root)))
    got = list(datasets.load_tum_rgbd(root))
    assert_records_equal(got, list(jdatasets.load_tum_rgbd(root)))
    # the golden's association: 1, 2 and 3 m around each frame's stamp
    assert [round(float(np.median(r.depth))) for r in got] == [1, 2, 3]


def test_tum_association_gap_equals_jax(tmp_path, rng):
    write_tum(tmp_path, rng)
    late = TUM_DEPTH[1].replace("102.2", "102.8")
    txt = (tmp_path / "depth.txt").read_text().replace(TUM_DEPTH[1], late)
    (tmp_path / "depth.txt").write_text(txt)
    os.rename(tmp_path / "depth" / f"{TUM_DEPTH[1]}.png",
              tmp_path / "depth" / f"{late}.png")
    got = list(datasets.load_tum_rgbd(str(tmp_path)))
    assert len(got) == 2
    assert_records_equal(got, list(jdatasets.load_tum_rgbd(str(tmp_path))))


def test_tum_unreadable_depth_skips_like_jax(tmp_path, rng):
    """A depth file OpenCV cannot read drops the frame in both packages."""
    write_tum(tmp_path, rng)
    (tmp_path / "depth" / f"{TUM_DEPTH[2]}.png").write_bytes(b"broken")
    got = list(datasets.load_tum_rgbd(str(tmp_path)))
    assert len(got) == 2
    assert_records_equal(got, list(jdatasets.load_tum_rgbd(str(tmp_path))))


# ---------------------------------------------------------------------------
# KITTI
# ---------------------------------------------------------------------------

def test_kitti_equals_jax(tmp_path, rng):
    for d in ("image_0", "image_1"):
        os.makedirs(tmp_path / d)
    (tmp_path / "times.txt").write_text(
        "0.000000e+00\n1.038947e-01\n2.077893e-01\n")
    for i in range(3):
        cv2.imwrite(str(tmp_path / "image_0" / f"{i:06d}.png"),
                    texture(rng, (48, 64), 10 + i))
        cv2.imwrite(str(tmp_path / "image_1" / f"{i:06d}.png"),
                    texture(rng, (48, 64), 110 + i))
    for stereo in (True, False):
        got = list(datasets.load_kitti(str(tmp_path), stereo=stereo))
        assert_records_equal(
            got, list(jdatasets.load_kitti(str(tmp_path), stereo=stereo)))
    assert abs(got[1].timestamp - 0.1038947) < 1e-9


# ---------------------------------------------------------------------------
# EuRoC
# ---------------------------------------------------------------------------

def write_euroc(root, rng, shape=(48, 64), missing_right=True):
    for cam in ("cam0", "cam1"):
        d = root / "mav0" / cam / "data"
        d.mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(3):
            name = f"{1403636579763555584 + i * 50000000}.png"
            base = 10 * (i + 1) + (0 if cam == "cam0" else 1)
            cv2.imwrite(str(d / name), texture(rng, shape, 100 + base))
            lines.append(f"{1403636579763555584 + i * 50000000},{name}")
        # CRLF endings, as in the shipped zips
        (root / "mav0" / cam / "data.csv").write_bytes(
            "\r\n".join(lines).encode() + b"\r\n")
    if missing_right:
        os.remove(root / "mav0" / "cam1" / "data" /
                  f"{1403636579763555584 + 2 * 50000000}.png")


def test_euroc_equals_jax(tmp_path, rng):
    write_euroc(tmp_path, rng)
    root = str(tmp_path)
    mono = list(datasets.load_euroc(root))
    assert len(mono) == 3
    assert_records_equal(mono, list(jdatasets.load_euroc(root)))
    pairs = list(datasets.load_euroc(root, stereo=True))
    assert len(pairs) == 2
    assert_records_equal(pairs, list(jdatasets.load_euroc(root, stereo=True)))
    assert abs(mono[0].timestamp - 1403636579.763555584) < 1e-6


@pytest.fixture(params=["flat", "opencv-matrix"])
def rectification_yaml(request, tmp_path):
    if request.param == "flat":
        return str(REPO / "configs" / "euroc_stereo.yaml")
    path = tmp_path / "euroc_reference_style.yaml"
    path.write_text(OPENCV_MATRIX_YAML)
    return str(path)


def test_rectification_maps_equal_cv2(rectification_yaml):
    rect = datasets.parse_rectification(rectification_yaml)
    ref = jdatasets.parse_rectification(rectification_yaml)
    assert rect is not None and ref is not None
    for got, want in ((rect._ml, ref._ml), (rect._mr, ref._mr)):
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape == (480, 752)
            assert np.abs(g - w).max() <= MAP_TOL_PX


def test_euroc_rectified_pairs_equal_jax(tmp_path, rng, rectification_yaml):
    write_euroc(tmp_path, rng, shape=(480, 752), missing_right=False)
    root = str(tmp_path)
    got = list(datasets.load_euroc(
        root, stereo=True,
        rectifier=datasets.parse_rectification(rectification_yaml)))
    want = list(jdatasets.load_euroc(
        root, stereo=True,
        rectifier=jdatasets.parse_rectification(rectification_yaml)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.timestamp == w.timestamp
        for a, b in ((g.img, w.img), (g.right, w.right)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.abs(a - b).max() <= REMAP_TOL
        # where the rectified view leaves the raw image, both are 0
        np.testing.assert_array_equal(g.img == 0, w.img == 0)


def test_parse_rectification_absent(tmp_path):
    p = tmp_path / "mono.yaml"
    p.write_text("Camera.fx: 500.0\nCamera.fy: 500.0\n")
    assert datasets.parse_rectification(str(p)) is None


def test_resize_half_equals_cv2(rng):
    """The fisheye front image's `cv2.resize(fx=fy=0.5)`, on integer and
    fractional float32 images, odd sizes included."""
    for shape in ((800, 1900), (7, 9), (6, 9), (7, 8), (5, 5)):
        for img in (rng.integers(0, 256, shape).astype(np.float32),
                    rng.uniform(0, 255, shape).astype(np.float32)):
            want = cv2.resize(img, None, fx=0.5, fy=0.5)
            got = datasets.resize_half(img)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# fisheye-birdview (the fork's layout)
# ---------------------------------------------------------------------------

FISHEYE_ASSOCIATE_TXT = """\
1535697686.000000 0.000000 0.000000 0.000000 {0}
1535697686.040000 0.047321 0.001200 0.010000 {1}
"""


def write_fisheye(root, rng, ext, front_h=900, front_w=2000):
    names = (f"0001.{ext}", f"0002.{ext}")
    for d in ("image", "birdview", "mask"):
        os.makedirs(root / d)
    (root / "associate.txt").write_text(FISHEYE_ASSOCIATE_TXT.format(*names))
    for i, name in enumerate(names):
        img = texture(rng, (front_h, front_w, 3), 100 + i)
        img[850:, 1950:] = 255          # outside the origin crop
        cv2.imwrite(str(root / "image" / name), img)
        cv2.imwrite(str(root / "birdview" / name),
                    texture(rng, (384, 384), 60 + i))
        m = np.zeros((384, 384, 3), np.uint8)
        m[:, 192:, 1] = 250
        m[100:110, 200:260, 1] = 19     # just under the green >= 20 cut
        cv2.imwrite(str(root / "mask" / name), m)
    fm = np.zeros((front_h, front_w, 3), np.uint8)
    fm[:100, :100, 1] = 255
    fm[200:220, 300:400, 1] = 250       # not above 250: kept
    cv2.imwrite(str(root / "mask_new_front.png"), fm)


@pytest.mark.parametrize("front_mask", [True, False])
def test_fisheye_equals_jax(tmp_path, rng, front_mask):
    write_fisheye(tmp_path, rng, "png")
    if not front_mask:
        os.remove(tmp_path / "mask_new_front.png")
    got = list(datasets.load_fisheye_birdview(str(tmp_path)))
    assert_records_equal(
        got, list(jdatasets.load_fisheye_birdview(str(tmp_path))))
    r = got[0]
    assert r.img.shape == (400, 950) and r.bird_mask.shape == (384, 384)
    assert (float(r.img[10, 10]) == 0.0) == front_mask
    assert r.bird_mask[100, 10] == 0.0 and r.bird_mask[100, 300] == 1.0
    assert r.bird_mask[105, 230] == 0.0


def test_fisheye_jpeg_layout(tmp_path, rng):
    """The golden fixture's own `.jpg` names: the gray reads of the front
    and BEV JPEGs equal the JAX loader's, and so does every record of the
    layout, the colour bird-mask JPEGs included (read in colour by the
    port's decoder, through OpenCV by the JAX loader)."""
    write_fisheye(tmp_path, rng, "jpg")
    for name in ("0001.jpg", "0002.jpg"):
        for d in ("image", "birdview"):
            path = str(tmp_path / d / name)
            np.testing.assert_array_equal(
                datasets._gray(path), jdatasets._gray(path))
    got = list(datasets.load_fisheye_birdview(str(tmp_path)))
    assert_records_equal(
        got, list(jdatasets.load_fisheye_birdview(str(tmp_path))))
    assert len(got) == 2 and got[0].bird_mask.shape == (384, 384)
