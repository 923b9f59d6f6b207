"""The port's image reader and writer (`utils/imageio.py`) against OpenCV,
which the JAX package reads and writes with.

Every decode must equal `cv2.imread` bit for bit — values, dtype and shape
— on files `cv2.imwrite` makes (and on palette, gray+alpha and sub-byte
files PIL makes, which cv2 cannot write): 8-bit gray, 8-bit colour and
RGBA under GRAYSCALE, COLOR and UNCHANGED, 16-bit gray and colour, at
zlib levels 0, 1 and 9 under each of libpng's filter strategies, so that
all five PNG row filters occur; interlaced (Adam7) PNGs built here from
numpy and zlib; P5/P6; JPEG through the port's decoder (gray, 4:2:0,
4:4:4, 4:2:2, 4:1:1, 4:4:0, progressive, restart intervals, odd sizes)
under all three flags, and the committed fixtures of tests/data/jpeg
against the cv2 decodes stored beside them. The writer's files must read
back bit for bit in cv2.
"""
import struct
import zlib
from pathlib import Path

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


JPEG_DATA = Path(__file__).resolve().parent / "data" / "jpeg"


def test_jpeg_equals_cv2(tmp_path, rng):
    ims = images(rng)
    gray, colour = str(tmp_path / "g.jpg"), str(tmp_path / "c.jpg")
    cv2.imwrite(gray, ims["gray8"])
    cv2.imwrite(colour, ims["colour8"])
    for flags in FLAGS:
        assert_same(imageio.imread(gray, flags), cv2.imread(gray, flags),
                    ("gray jpeg", flags))
        assert_same(imageio.imread(colour, flags), cv2.imread(colour, flags),
                    ("colour jpeg", flags))


def test_jpeg_without_native_library_raises(tmp_path, rng, monkeypatch):
    """The native library plays no part in a JPEG read: with it made
    unloadable, gray and colour reads still equal cv2's."""
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, images(rng)["colour8"])
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_LIB_PATH", tmp_path / "absent.so")
    assert not native_loader.native_available()
    for flags in FLAGS:
        assert_same(imageio.imread(path, flags), cv2.imread(path, flags),
                    ("no native library", flags))


JPEG_VARIANTS = {
    "gray": (False, []),
    "420": (True, []),
    "444": (True, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "422": (True, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "411": (True, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]),
    "440": (True, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
    "progressive": (True, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "progressive-gray": (False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "restart": (True, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    "progressive-422-restart": (True, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "quality-100": (True, [cv2.IMWRITE_JPEG_QUALITY, 100]),
    "quality-5": (True, [cv2.IMWRITE_JPEG_QUALITY, 5]),
}


@pytest.mark.parametrize("variant", list(JPEG_VARIANTS))
def test_jpeg_variants_equal_cv2(tmp_path, rng, variant):
    """Every kind of file cv2 writes, at sizes that are not multiples of
    the MCU (and images of one and two pixels across), read under each
    flag: bit-equal to cv2.imread, colour included."""
    colour, params = JPEG_VARIANTS[variant]
    for h, w in ((61, 83), (17, 5), (2, 1), (33, 40)):
        img = images(rng)["colour8" if colour else "gray8"]
        img = np.ascontiguousarray(np.resize(img, (h, w) + img.shape[2:]))
        path = str(tmp_path / f"{variant}_{h}x{w}.jpg")
        assert cv2.imwrite(path, img, params)
        for flags in FLAGS:
            assert_same(imageio.imread(path, flags), cv2.imread(path, flags),
                        (variant, h, w, flags))


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        JPEG_DATA.glob("*.jpg")))
def test_jpeg_fixtures_equal_their_cv2_decodes(name):
    """The committed JPEGs (read again on the GPU machine, which has no
    cv2) against the cv2.imread arrays stored beside them."""
    want = np.load(JPEG_DATA / f"{name}.npz")
    path = JPEG_DATA / f"{name}.jpg"
    assert_same(imageio.imread(path, imageio.IMREAD_GRAYSCALE), want["gray"],
                name)
    assert_same(imageio.imread(path, imageio.IMREAD_COLOR), want["color"],
                name)


def _patched_jpeg(tmp_path, rng, name, patch):
    path = tmp_path / name
    cv2.imwrite(str(path), images(rng)["colour8"])
    data = bytearray(path.read_bytes())
    sof = data.index(b"\xff\xc0")
    patch(data, sof)
    path.write_bytes(bytes(data))
    return path


def test_unsupported_jpegs_raise(tmp_path, rng):
    """Arithmetic coding, lossless, 12-bit and CMYK files raise
    UnsupportedImage naming the file (cv2 writes none of the first three;
    they are its baseline files with the frame header changed)."""
    from PIL import Image

    def marker(code):
        def patch(data, sof):
            data[sof + 1] = code
        return patch

    def precision(data, sof):
        data[sof + 4] = 12

    paths = [_patched_jpeg(tmp_path, rng, "arith.jpg", marker(0xC9)),
             _patched_jpeg(tmp_path, rng, "lossless.jpg", marker(0xC3)),
             _patched_jpeg(tmp_path, rng, "twelve.jpg", precision)]
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(rng.integers(0, 256, (20, 30, 4), dtype=np.uint8),
                    "CMYK").save(cmyk)
    paths.append(cmyk)
    for path in paths:
        for flags in FLAGS:
            with pytest.raises(imageio.UnsupportedImage, match=path.name):
                imageio.imread(path, flags)


def test_corrupt_jpeg_raises_value_error(tmp_path, rng):
    path = tmp_path / "cut.jpg"
    cv2.imwrite(str(path), images(rng)["colour8"])
    data = path.read_bytes()
    (tmp_path / "cut.jpg").write_bytes(data[:data.index(b"\xff\xc0") + 6])
    with pytest.raises(ValueError):
        imageio.imread(tmp_path / "cut.jpg", 0)


def adam7_png(samples, depth, ctype, rng, palette=None):
    """An interlaced PNG of `samples` (H, W, C), every row of every pass
    under a random filter (all five kinds)."""
    h, w, c = samples.shape
    bits = depth * c
    bpp = max(1, bits // 8)
    raw = bytearray()
    for x0, y0, dx, dy in imageio.ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(sub.shape[0], -1)
        elif depth == 8:
            rows = sub.reshape(sub.shape[0], -1).astype(np.uint8)
        else:
            per = 8 // depth
            v = sub[..., 0].astype(np.uint8)
            pad = (-v.shape[1]) % per
            v = np.concatenate([v, np.zeros((v.shape[0], pad), np.uint8)], 1)
            v = v.reshape(v.shape[0], -1, per)
            shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
            rows = np.bitwise_or.reduce(v << shifts, axis=2).astype(np.uint8)
        prior = np.zeros(rows.shape[1], np.int64)
        for row in rows.astype(np.int64):
            f = int(rng.integers(0, 5))
            a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            c_ = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = prior
            elif f == 3:
                pred = (a + prior) // 2
            else:
                p = a + prior - c_
                pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c_)
                pred = np.where((pa <= pb) & (pa <= pc), a,
                                np.where(pb <= pc, prior, c_))
            raw.append(f)
            raw.extend(((row - pred) % 256).astype(np.uint8).tobytes())
            prior = row
    chunks = [imageio._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                   ctype, 0, 0, 1))]
    if palette is not None:
        chunks.append(imageio._chunk(b"PLTE", palette.tobytes()))
    chunks += [imageio._chunk(b"IDAT", zlib.compress(bytes(raw), 6)),
               imageio._chunk(b"IEND", b"")]
    return imageio.PNG_SIGNATURE + b"".join(chunks)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "palette8", "palette4",
                                  "gray16", "rgba8", "gray1"])
def test_adam7_png_equals_cv2(tmp_path, rng, kind):
    for h, w in ((61, 83), (5, 3), (1, 1), (9, 17)):
        palette = None
        if kind == "gray8":
            samples, depth, ctype = rng.integers(0, 256, (h, w, 1)), 8, 0
        elif kind == "rgb8":
            samples, depth, ctype = rng.integers(0, 256, (h, w, 3)), 8, 2
        elif kind == "rgba8":
            samples, depth, ctype = rng.integers(0, 256, (h, w, 4)), 8, 6
        elif kind == "gray16":
            samples, depth, ctype = rng.integers(0, 65536, (h, w, 1)), 16, 0
        elif kind == "gray1":
            samples, depth, ctype = rng.integers(0, 2, (h, w, 1)), 1, 0
        else:
            depth = 8 if kind == "palette8" else 4
            n = 1 << depth
            samples, ctype = rng.integers(0, n, (h, w, 1)), 3
            palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        path = tmp_path / f"{kind}_{h}x{w}.png"
        path.write_bytes(adam7_png(samples, depth, ctype, rng, palette))
        for flags in FLAGS:
            assert_same(imageio.imread(path, flags),
                        cv2.imread(str(path), flags), (kind, h, w, flags))


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
