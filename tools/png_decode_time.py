"""Host time of the port's PNG reader (`utils/imageio.py`) on frames that
libpng writes through OpenCV, beside OpenCV's own decode.

    env PYTHONPATH=. python tools/png_decode_time.py

Needs OpenCV to write the files; the port itself never imports it. Each
frame is written twice: as `cv2.imwrite` writes by default (zlib level 1,
every row Sub-filtered here: the row-at-a-time path) and at libpng's own
defaults (level 6, the default strategy: adaptive filters that put Paeth
and Average rows in, which the reader reconstructs along anti-diagonals). Frames: a KITTI left image (1241×376 gray),
a TUM colour image read as gray (640×480) and a TUM 16-bit depth map read
unchanged, each textured as the synthetic drives are. Prints one JSON line
with the median ms of 7 decodes each.
"""
import json
import platform
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np

from orbslam_birdview_tpu_torch.utils import imageio, synth


WRITES = {
    "opencv_default": [],
    "libpng_default": [cv2.IMWRITE_PNG_COMPRESSION, 6,
                       cv2.IMWRITE_PNG_STRATEGY, cv2.IMWRITE_PNG_STRATEGY_DEFAULT],
}


def median_ms(fn, reps=7):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def row_filters(path):
    import struct
    import zlib
    data = path.read_bytes()
    img, depth, _, _, _ = imageio.decode_png(data)
    pos, idat = 8, []
    while True:
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
        if kind == b"IEND":
            break
    row = (img.shape[1] * img.shape[2] * depth + 7) // 8 + 1
    f = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[::row]
    return {int(k): int(v) for k, v in zip(*np.unique(f, return_counts=True))}


def main():
    tex = np.clip(np.rint(synth.make_texture(5, size=1280, n_blobs=1500)),
                  0, 255).astype(np.uint8)
    frames = {
        "kitti_gray_1241x376": (tex[:376, :1241], cv2.IMREAD_GRAYSCALE),
        "tum_rgb_640x480_as_gray": (
            np.stack([tex[:480, :640], tex[100:580, :640],
                      tex[200:680, :640]], -1), cv2.IMREAD_GRAYSCALE),
        "tum_depth16_640x480": (
            (tex[:480, :640].astype(np.uint16) * 40 + 5000),
            cv2.IMREAD_UNCHANGED),
    }
    out = dict(host=platform.processor() or platform.machine())
    with tempfile.TemporaryDirectory() as d:
        for name, (img, flags) in frames.items():
            for how, params in WRITES.items():
                path = Path(d) / f"{name}_{how}.png"
                cv2.imwrite(str(path), img, params)
                got = imageio.imread(path, flags)
                assert np.array_equal(got, cv2.imread(str(path), flags)), name
                out[f"{name}_{how}"] = dict(
                    port_ms=median_ms(lambda: imageio.imread(path, flags)),
                    opencv_ms=median_ms(lambda: cv2.imread(str(path), flags)),
                    bytes=path.stat().st_size, row_filters=row_filters(path))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
