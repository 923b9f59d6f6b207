"""The port's image reader and writer (`utils/imageio.py`) against OpenCV,
which the JAX package reads and writes with.

Every decode must equal `cv2.imread` bit for bit — values, dtype and shape
— on files `cv2.imwrite` makes (and on palette, gray+alpha and sub-byte
files PIL makes, which cv2 cannot write): 8-bit gray, 8-bit colour and
RGBA under GRAYSCALE, COLOR and UNCHANGED, 16-bit gray and colour, at
zlib levels 0, 1 and 9 under each of libpng's filter strategies, so that
all five PNG row filters occur; P5/P6; JPEG through the native library.
The writer's files must read back bit for bit in cv2.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest
from scipy import ndimage

from orbslam_birdview_tpu_torch.utils import imageio, native_loader

FLAGS = (imageio.IMREAD_GRAYSCALE, imageio.IMREAD_COLOR,
         imageio.IMREAD_UNCHANGED)
assert FLAGS == (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED)


def images(rng):
    smooth = ndimage.gaussian_filter(rng.uniform(0, 255, (61, 83)), 2)
    smooth = smooth.astype(np.uint8)
    noise = rng.integers(0, 256, (61, 83), dtype=np.uint8)
    ramp = ((np.add.outer(np.arange(61), 3 * np.arange(83))) % 256).astype(
        np.uint8)
    colour = np.stack([smooth, ramp, noise], -1)
    return {
        "gray8": smooth,
        "noise8": noise,
        "colour8": colour,
        "rgba8": np.concatenate([colour, ramp[..., None]], -1),
        "gray16": smooth.astype(np.uint16) * 257 + ramp,
        "colour16": colour.astype(np.uint16) * 251,
    }


def png_filters(path) -> set:
    """The filter bytes of a PNG file's rows."""
    data = open(path, "rb").read()
    img, depth, ctype, _, _ = imageio.decode_png(data)
    pos, idat = 8, []
    while True:
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
        if kind == b"IEND":
            break
    row = (img.shape[1] * img.shape[2] * depth + 7) // 8 + 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(-1, row)[:, 0].tolist())


def assert_same(got, want, what):
    assert want is not None, what
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("level", [0, 1, 9])
def test_png_decode_equals_cv2(tmp_path, rng, level):
    seen = set()
    for name, img in images(rng).items():
        for strategy in range(5):
            path = str(tmp_path / f"{name}_{strategy}.png")
            cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level,
                                    cv2.IMWRITE_PNG_STRATEGY, strategy])
            seen |= png_filters(path)
            for flags in FLAGS:
                assert_same(imageio.imread(path, flags),
                            cv2.imread(path, flags), (name, strategy, flags))
    assert seen == {0, 1, 2, 3, 4}, seen


def test_png_decode_pil_files_equals_cv2(tmp_path, rng):
    """Palettes (8-bit, 4-bit, with transparency), gray + alpha and 1/2/4-bit
    gray, which cv2 reads but does not write."""
    from PIL import Image

    rgb = Image.fromarray(rng.integers(0, 256, (30, 41, 3), dtype=np.uint8))
    rgb.convert("P", palette=Image.ADAPTIVE, colors=200).save(
        tmp_path / "pal8.png")
    rgb.convert("P", palette=Image.ADAPTIVE, colors=16).save(
        tmp_path / "pal4.png", bits=4)
    rgb.convert("P", palette=Image.ADAPTIVE, colors=50).save(
        tmp_path / "palt.png", transparency=bytes(range(0, 250, 5)))
    Image.fromarray(rng.integers(0, 256, (30, 41, 2), dtype=np.uint8),
                    "LA").save(tmp_path / "la.png")
    Image.fromarray(rng.integers(0, 2, (30, 43)).astype(bool)).save(
        tmp_path / "bits1.png")
    for b in (2, 4):
        v = rng.integers(0, 1 << b, (30, 47)) * (255 // ((1 << b) - 1))
        Image.fromarray(v.astype(np.uint8)).save(tmp_path / f"bits{b}.png",
                                                 bits=b)
    for path in sorted(tmp_path.iterdir()):
        for flags in FLAGS:
            assert_same(imageio.imread(path, flags),
                        cv2.imread(str(path), flags), (path.name, flags))


def test_pnm_decode_equals_cv2(tmp_path, rng):
    for name, img in images(rng).items():
        if img.ndim == 3 and img.shape[2] == 4:
            continue
        path = str(tmp_path / (name + (".ppm" if img.ndim == 3 else ".pgm")))
        cv2.imwrite(path, img)
        for flags in FLAGS:
            assert_same(imageio.imread(path, flags), cv2.imread(path, flags),
                        (name, flags))
    # a comment in the header
    path = tmp_path / "comment.pgm"
    img = images(rng)["gray8"]
    path.write_bytes(b"P5\n# made by hand\n83 61\n255\n" + img.tobytes())
    assert_same(imageio.imread(path, 0), cv2.imread(str(path), 0), "comment")


@pytest.mark.skipif(not native_loader.native_available(),
                    reason="native/libslamio.so not built")
def test_jpeg_equals_cv2(tmp_path, rng):
    ims = images(rng)
    gray, colour = str(tmp_path / "g.jpg"), str(tmp_path / "c.jpg")
    cv2.imwrite(gray, ims["gray8"])
    cv2.imwrite(colour, ims["colour8"])
    for flags in FLAGS:
        assert_same(imageio.imread(gray, flags), cv2.imread(gray, flags),
                    ("gray jpeg", flags))
    assert_same(imageio.imread(colour, 0), cv2.imread(colour, 0),
                "colour jpeg as gray")
    # the native path decodes to gray only: a colour read of a colour
    # JPEG is refused, naming the file
    for flags in (imageio.IMREAD_COLOR, imageio.IMREAD_UNCHANGED):
        with pytest.raises(imageio.UnsupportedImage, match="c.jpg"):
            imageio.imread(colour, flags)


def test_jpeg_without_native_library_raises(tmp_path, rng, monkeypatch):
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, images(rng)["gray8"])
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_LIB_PATH", tmp_path / "absent.so")
    with pytest.raises(imageio.UnsupportedImage, match="frame.jpg"):
        imageio.imread(path, imageio.IMREAD_GRAYSCALE)


@pytest.mark.parametrize("name", ["gray8", "colour8", "gray16"])
def test_writer_read_by_cv2(tmp_path, rng, name):
    img = images(rng)[name]
    path = str(tmp_path / f"{name}.png")
    imageio.imwrite(path, img)
    assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img, name)
    buf = imageio.encode_png(img)
    assert_same(cv2.imdecode(np.frombuffer(buf, np.uint8),
                             cv2.IMREAD_UNCHANGED), img, name)
    assert_same(imageio.imread(path, imageio.IMREAD_UNCHANGED), img, name)


def test_missing_and_corrupt_files_raise(tmp_path, rng):
    with pytest.raises(FileNotFoundError):
        imageio.imread(tmp_path / "nope.png", 0)
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), images(rng)["gray8"])
    data = bytearray(path.read_bytes())
    data[40] ^= 0x01                  # inside the first IDAT chunk's data
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    assert cv2.imread(str(bad), 0) is None
    with pytest.raises(ValueError, match="bad CRC"):
        imageio.imread(bad, 0)
    (tmp_path / "short.png").write_bytes(bytes(data[:30]))
    with pytest.raises(ValueError):
        imageio.imread(tmp_path / "short.png", 0)
    (tmp_path / "text.png").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="text.png"):
        imageio.imread(tmp_path / "text.png", 0)


def test_unfilter_wavefront_matches_row_by_row(rng):
    """The anti-diagonal reconstruction of Average / Paeth rows against a
    plain per-byte loop of the PNG specification, for 1-4 bytes a pixel
    and every filter on every row."""
    def reference(filtered, ftype, bpp):
        H, n = filtered.shape
        out = np.zeros((H, n), np.int64)
        for y in range(H):
            for x in range(n):
                a = out[y, x - bpp] if x >= bpp else 0
                b = out[y - 1, x] if y else 0
                c = out[y - 1, x - bpp] if y and x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                pred = (0, a, b, (a + b) // 2, paeth)[ftype[y]]
                out[y, x] = (int(filtered[y, x]) + pred) % 256
        return out.astype(np.uint8)

    for bpp in (1, 2, 3, 4):
        filtered = rng.integers(0, 256, (9, 7 * bpp), dtype=np.uint8)
        ftype = rng.integers(0, 5, 9).astype(np.uint8)
        np.testing.assert_array_equal(
            imageio.unfilter(filtered, ftype, bpp),
            reference(filtered, ftype, bpp), err_msg=f"bpp {bpp}")
