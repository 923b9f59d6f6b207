"""Image files without OpenCV: the reads and writes the JAX package makes
through `cv2.imread` / `cv2.imwrite` / `cv2.imencode`, on numpy and zlib.

`imread(path, flags)` returns what `cv2.imread` returns for the same file
and flag, bit for bit:

- PNG (every colour type, bit depths 1-16, the five row filters):
  - IMREAD_GRAYSCALE: uint8 (H, W); 16-bit samples keep their high byte;
    colour becomes (9797·R + 19234·G + 3737·B) >> 15, truncated, which is
    libpng's fixed-point conversion at OpenCV's weights (16-bit colour:
    rounded at 16 bits, then the high byte);
  - IMREAD_COLOR: uint8 (H, W, 3) in BGR order, gray repeated;
  - IMREAD_UNCHANGED: the file's own samples, uint16 for 16-bit, BGR(A)
    channel order for colour, palettes expanded;
- PGM / PPM (P5 / P6, 8 and 16 bit), colour to gray as OpenCV's
  `cvtColor`: (4899·R + 9617·G + 1868·B + 8192) >> 14;
  Interlaced (Adam7) files: the seven passes, each unfiltered on its own,
  scattered into the image;
- JPEG through the port's own decoder (`csrc/jpeg_decode.cpp`, built with
  the host C++ compiler at first use): baseline, extended and progressive
  Huffman, 8-bit, 1 or 3 components, libjpeg's islow IDCT, fancy
  upsampling and fixed-point YCbCr tables, as OpenCV's libjpeg-turbo
  decodes. Arithmetic-coded, lossless, hierarchical, 12-bit and
  4-component (CMYK / YCCK) files raise `UnsupportedImage` naming the
  file.

Where `cv2.imread` returns None, `imread` raises: FileNotFoundError for a
missing file, ValueError for a file it cannot decode (a bad CRC, a
truncated stream, an unknown format).

`imwrite` / `encode_png` write 8-bit gray, 8-bit colour (BGR input, as
`cv2.imwrite` takes it) and 16-bit gray PNG.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
FLAGS_ALL = (IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnsupportedImage(NotImplementedError):
    """A file this reader does not decode where OpenCV would: never taken
    for a missing or corrupt file, so callers that skip those do not skip
    it."""


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def imread(path, flags: int = IMREAD_COLOR) -> np.ndarray:
    path = os.fspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(PNG_SIGNATURE):
            return _png_to_flags(*decode_png(data), flags)
        if data[:2] in (b"P5", b"P6"):
            return _pnm_to_flags(decode_pnm(data), flags)
        if data[:2] == b"\xff\xd8":
            return _read_jpeg(path, data, flags)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: not a PNG, PGM/PPM or JPEG file")


def decode_png(data: bytes):
    """The samples of a PNG stream as stored: (image, bit depth, colour
    type, palette or None, transparency chunk or None). The image is (H, W, C)
    uint8 or uint16 in the file's channel order; 1/2/4-bit samples are
    unpacked to one byte each, unscaled."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("no PNG signature")
    pos = len(PNG_SIGNATURE)
    ihdr, idat, plte, trns = None, [], None, None
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"bad CRC in the {ctype.decode('latin1')} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"bad PNG colour type {ctype} / depth {depth}")
    if interlace not in (0, 1):
        raise ValueError(f"bad PNG interlace method {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    channels = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    if not interlace:
        img, _ = _png_pass(raw, 0, width, height, depth, channels)
        return img, depth, ctype, plte, trns
    # Adam7: seven reduced images, each filtered on its own, then scattered
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.zeros((height, width, channels), dtype)
    off = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        sub, off = _png_pass(raw, off, pw, ph, depth, channels)
        img[y0::dy, x0::dx] = sub
    return img, depth, ctype, plte, trns


# (first column, first row, column step, row step) of the Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_pass(raw, off, width, height, depth, channels):
    """One image (or Adam7 pass) of `width` x `height` from the inflated
    stream at byte `off`: its samples (H, W, C) and the offset after it."""
    bits = depth * channels
    bpp = max(1, bits // 8)                      # filter unit in bytes
    row_bytes = (width * bits + 7) // 8
    end = off + height * (row_bytes + 1)
    if len(raw) < end:
        raise ValueError("truncated PNG data")
    rows = np.frombuffer(raw, np.uint8, end - off, off).reshape(
        height, row_bytes + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError("bad PNG filter type")
    pix = unfilter(rows[:, 1:], ftype, bpp)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16).reshape(height, width,
                                                        channels)
    elif depth == 8:
        img = pix.reshape(height, width, channels)
    else:
        # 1/2/4-bit (gray or palette, one sample a pixel), high bits first
        per = 8 // depth
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        vals = (pix[:, :, None] >> shifts) & ((1 << depth) - 1)
        img = vals.reshape(height, -1)[:, :width, None]
    return img, end


def unfilter(filtered: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Reverses the PNG row filters. `filtered` is (H, row_bytes) uint8,
    `ftype` (H,) the filter byte of each row, `bpp` the bytes of a pixel.

    None, Sub and Up run a row at a time (Sub as a running sum mod 256 at
    a stride of bpp). Average and Paeth read the reconstructed pixel to the
    left, so the rows from the first to the last that use them are
    reconstructed along anti-diagonals: after skewing row y right by y
    pixels, pixel (y, p) sits in column y + p, and its three neighbours
    (y, p-1), (y-1, p), (y-1, p-1) sit in columns y + p - 1 and y + p - 2,
    which are done one step earlier. One vectorized step per diagonal,
    W + H steps in all."""
    H, n = filtered.shape
    out = np.zeros((H, n), np.uint8)
    sequential = np.flatnonzero(ftype >= 3)
    first = sequential[0] if len(sequential) else H
    last = sequential[-1] + 1 if len(sequential) else H
    _unfilter_rows(filtered, ftype, bpp, out, 0, first)
    if first < last:
        _unfilter_diagonals(filtered, ftype, bpp, out, first, last)
    _unfilter_rows(filtered, ftype, bpp, out, last, H)
    return out


def _unfilter_rows(filtered, ftype, bpp, out, y0, y1):
    n = filtered.shape[1]
    zero = np.zeros(n, np.uint8)
    for y in range(y0, y1):
        raw = filtered[y]
        prior = out[y - 1] if y else zero
        f = ftype[y]
        if f == 0:
            out[y] = raw
        elif f == 1:
            pad = (-n) % bpp
            r = np.concatenate([raw, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            out[y] = np.cumsum(r, axis=0, dtype=np.uint8).reshape(-1)[:n]
        elif f == 2:
            out[y] = raw + prior
        else:
            raise AssertionError("Average and Paeth rows go by diagonals")


def _unfilter_diagonals(filtered, ftype, bpp, out, y0, y1):
    k = y1 - y0
    n = filtered.shape[1]
    npix = -(-n // bpp)
    width = npix + k + 2
    # wave-major: D[t, 1 + r] holds pixel t - 2 - r of row y0 + r, so each
    # step reads and writes contiguous memory; D[:, 0] is the row above
    # the block (as row -1), and the two zero pixels left of every row's
    # start come first
    D = np.zeros((width, k + 1, bpp), np.int16)
    R = np.zeros((width, k + 1, bpp), np.int16)
    src = np.zeros((k, npix * bpp), np.uint8)
    src[:, :n] = filtered[y0:y1]
    for r in range(k):
        R[2 + r: 2 + r + npix, 1 + r] = src[r].reshape(npix, bpp)
    if y0:
        prior = np.zeros(npix * bpp, np.uint8)
        prior[:n] = out[y0 - 1]
        D[1:1 + npix, 0] = prior.reshape(npix, bpp)
    ft = ftype[y0:y1]
    kinds = [int(f) for f in np.unique(ft)]
    masks = {f: (ft == f)[:, None] for f in kinds}
    pred = np.zeros((k, bpp), np.int16)
    for t in range(2, width):
        a, b, c = D[t - 1, 1:], D[t - 1, :-1], D[t - 2, :-1]
        for f in kinds:
            if f == 0:
                p = 0
            elif f == 1:
                p = a
            elif f == 2:
                p = b
            elif f == 3:
                p = (a + b) >> 1
            else:
                da, db = a - c, b - c
                pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
                p = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
            if len(kinds) == 1:
                pred = p
            else:
                np.copyto(pred, p, where=masks[f])
        # left of a row's start raw is 0 and so are a, b and c: the zero
        # pixels stay zero
        np.bitwise_and(R[t, 1:] + pred, 255, out=D[t, 1:])
    for r in range(k):
        out[y0 + r] = D[2 + r: 2 + r + npix, 1 + r].reshape(-1)[:n]


def _expand(img, ctype, depth, plte, trns):
    """A decoded PNG as 8/16-bit samples with gray scaled to full range
    and palettes expanded: (image (H, W, C), channels in RGB(A) order)."""
    if ctype == 3:
        rgb = plte[np.minimum(img[..., 0], len(plte) - 1)]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            t = np.frombuffer(trns, np.uint8)
            alpha[:len(t)] = t
            return np.concatenate([rgb, alpha[img[..., 0]][..., None]], -1)
        return rgb
    if depth < 8:
        scale = 255 // ((1 << depth) - 1)
        img = (img * scale).astype(np.uint8)
    return img


def _png_to_flags(img, depth, ctype, plte, trns, flags):
    img = _expand(img, ctype, depth, plte, trns)
    C = img.shape[-1]
    color = C >= 3
    if flags == IMREAD_UNCHANGED:
        if C == 1:
            return img[..., 0].copy()
        if C == 2:          # gray + alpha -> BGRA
            g, a = img[..., 0], img[..., 1]
            return np.stack([g, g, g, a], -1)
        return _bgr(img)
    if flags == IMREAD_GRAYSCALE:
        if not color:
            g = img[..., 0]
            return (g >> 8).astype(np.uint8) if g.dtype == np.uint16 else \
                g.copy()
        R, G, B = (img[..., i].astype(np.int64) for i in range(3))
        if img.dtype == np.uint16:
            return (((9797 * R + 19234 * G + 3737 * B + 16384) >> 15) >> 8
                    ).astype(np.uint8)
        return ((9797 * R + 19234 * G + 3737 * B) >> 15).astype(np.uint8)
    if flags == IMREAD_COLOR:
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if not color:
            return np.repeat(img[..., :1], 3, axis=-1)
        return _bgr(img[..., :3])
    raise ValueError(f"unsupported imread flags {flags}")


def _bgr(img):
    out = img.copy()
    out[..., 0], out[..., 2] = img[..., 2], img[..., 0]
    return out


def decode_pnm(data: bytes) -> np.ndarray:
    """P5 / P6 (binary PGM / PPM) samples, (H, W, C) uint8 or uint16 in
    the file's (RGB) order."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PGM/PPM header")
        fields.append(int(data[start:pos]))
    pos += 1                                   # one whitespace byte
    w, h, maxval = fields
    channels = 1 if data[:2] == b"P5" else 3
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    count = w * h * channels
    if len(data) - pos < count * dtype.itemsize:
        raise ValueError("truncated PGM/PPM data")
    img = np.frombuffer(data, dtype, count, pos).reshape(h, w, channels)
    return img.astype(np.uint16 if maxval > 255 else np.uint8)


def _pnm_to_flags(img, flags):
    C = img.shape[-1]
    if flags == IMREAD_UNCHANGED:
        return img[..., 0].copy() if C == 1 else _bgr(img)
    img8 = (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img
    if flags == IMREAD_GRAYSCALE:
        if C == 1:
            return img8[..., 0].copy()
        R, G, B = (img8[..., i].astype(np.int64) for i in range(3))
        return ((4899 * R + 9617 * G + 1868 * B + 8192) >> 14).astype(
            np.uint8)
    if flags == IMREAD_COLOR:
        return np.repeat(img8, 3, axis=-1) if C == 1 else _bgr(img8)
    raise ValueError(f"unsupported imread flags {flags}")


def jpeg_components(data: bytes) -> int:
    """The number of colour components in a JPEG stream's frame header."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG marker")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        # SOF0-SOF15 (not DHT 0xC4, JPG 0xC8 or DAC 0xCC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 10 > len(data):
                break
            return data[pos + 9]
        pos += 2 + length
    raise ValueError("JPEG without a frame header")


_JPEG_UNSUPPORTED = 2           # jpeg_decode.cpp's status codes: 1 corrupt


def _jpeg_library():
    """The decoder of csrc/jpeg_decode.cpp, built at first use."""
    from .build import load_library

    lib = load_library("jpeg_decode", ["jpeg_decode.cpp"])
    if not getattr(lib, "_typed", False):
        buf, i32p = ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)
        lib.jpeg_info.argtypes = [buf, ctypes.c_long, i32p, i32p, i32p,
                                  ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode.argtypes = [buf, ctypes.c_long, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_info.restype = lib.jpeg_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def decode_jpeg(data: bytes, color: bool):
    """A JPEG stream decoded as libjpeg does by default: (H, W) gray, or
    (H, W, 3) BGR with `color`. Raises UnsupportedImage or ValueError with
    the decoder's reason."""
    lib = _jpeg_library()
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()

    def check(status):
        if status == _JPEG_UNSUPPORTED:
            raise UnsupportedImage(err.value.decode())
        if status:
            raise ValueError(f"corrupt JPEG: {err.value.decode()}")

    check(lib.jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(c), err, len(err)))
    out = np.empty((h.value, w.value, 3) if color else (h.value, w.value),
                   np.uint8)
    check(lib.jpeg_decode(data, len(data), int(color),
                          out.ctypes.data_as(ctypes.c_void_p), out.size, err,
                          len(err)))
    return out


def _read_jpeg(path, data, flags):
    """A JPEG through the port's decoder: gray for IMREAD_GRAYSCALE, BGR
    for IMREAD_COLOR, and for IMREAD_UNCHANGED the file's own kind (gray
    for one component), as cv2.imread returns them."""
    if flags not in FLAGS_ALL:
        raise ValueError(f"unsupported imread flags {flags}")
    color = flags == IMREAD_COLOR or (
        flags == IMREAD_UNCHANGED and jpeg_components(data) != 1)
    try:
        return decode_jpeg(data, color)
    except UnsupportedImage as e:
        raise UnsupportedImage(f"{path}: {e}") from None


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(img: np.ndarray, level: int = 3) -> bytes:
    """PNG bytes of an 8-bit gray (H, W), 8-bit colour (H, W, 3) in BGR
    order, or 16-bit gray (H, W) image. Every row carries the Sub filter."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, samples = 0, 8, img[..., None]
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, samples = 2, 8, img[..., ::-1]
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, samples = 0, 16, img.astype(">u2")[..., None]
    else:
        raise ValueError(f"encode_png takes uint8 gray or BGR, or uint16 "
                         f"gray; got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // w
    sub = rows.copy()
    sub[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]
    body = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), level))
            + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray, level: int = 3) -> None:
    """Writes `img` as a PNG (see `encode_png`)."""
    path = os.fspath(path)
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG is written")
    with open(path, "wb") as f:
        f.write(encode_png(img, level))
