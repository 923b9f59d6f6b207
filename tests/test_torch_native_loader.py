"""The port's native prefetching image loader (`utils/native_loader.py`
over native/libslamio.so): the four cases of tests/test_native_loader.py
on the port's `PrefetchLoader`, and the same frames as the JAX package's
loader. Skipped where the library does not load, as the JAX test is."""
import cv2
import numpy as np
import pytest

from orbslam_birdview_tpu.utils import native_loader as jloader
from orbslam_birdview_tpu_torch.utils.native_loader import (PrefetchLoader,
                                                            native_available)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native/libslamio.so not built")


@pytest.fixture
def image_dir(tmp_path, rng):
    paths = []
    for i in range(12):
        img = rng.uniform(0, 255, (120, 160)).astype(np.uint8)
        p = str(tmp_path / f"{i:03d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def test_decode_matches_cv2(image_dir):
    outs = list(PrefetchLoader(image_dir))
    assert len(outs) == len(image_dir)
    for o, j, p in zip(outs, jloader.PrefetchLoader(image_dir), image_dir):
        ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        assert o.dtype == np.float32
        np.testing.assert_array_equal(o, ref)
        np.testing.assert_array_equal(o, j)


def test_order_preserved_many_threads(image_dir):
    outs = list(PrefetchLoader(image_dir, n_threads=6, queue_cap=3))
    assert len(outs) == len(image_dir)
    for o, p in zip(outs, image_dir):
        ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        np.testing.assert_array_equal(o, ref)


def test_jpeg_and_pgm(tmp_path, rng):
    img = rng.uniform(0, 255, (64, 80)).astype(np.uint8)
    pj = str(tmp_path / "a.jpg")
    pp = str(tmp_path / "b.pgm")
    cv2.imwrite(pj, img)
    cv2.imwrite(pp, img)
    outs = list(PrefetchLoader([pj, pp]))
    assert outs[0].shape == (64, 80)
    np.testing.assert_array_equal(
        outs[0], cv2.imread(pj, cv2.IMREAD_GRAYSCALE).astype(np.float32))
    np.testing.assert_array_equal(outs[1], img.astype(np.float32))


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        list(PrefetchLoader([str(tmp_path / "nope.png")]))
