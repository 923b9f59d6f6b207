"""Check and time design variants of the patch-gather kernel on the GPU.

    python3 tools/patch_gather_variants.py

Builds tools/patch_gather_variants.cu with nvcc, records the two gathers
one front and one BEV extraction make at chip_smoke.py's full width (8 and
4 levels, 2000 patches each), holds every variant against the plain
version on them (bit-exact), and times each variant's two launches with
the device queue full, twice over, beside the bound from bytes. A variant
with a `grid` runs that many blocks, each walking several patches; grid 0
is one block a patch. Prints one line per measurement and writes them to
chiprun_out/patch_gather_variants.json. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera  # noqa: E402
from orbslam_birdview_tpu_torch.frontend import orb  # noqa: E402
from orbslam_birdview_tpu_torch.frontend import patch_kernel as pk  # noqa: E402
from orbslam_birdview_tpu_torch.utils import build, synth  # noqa: E402

SIZE = 48
SMS = 132
REPS = 50
# variant number in the C entry point -> (name, grids to try)
VARIANTS = {
    0: ("A1 streaming stores", [0, SMS * 10, SMS * 5]),
    1: ("A1 plain stores", [0]),
    7: ("A1 streaming, size fixed and rows unrolled", [0, SMS * 10, SMS * 5]),
    3: ("A2 aligned 16-byte loads", [0, SMS * 10]),
    4: ("A3 staged in shared memory", [0, SMS * 8]),
    5: ("B bulk stores, 3 stages", [SMS * 2, SMS * 4, SMS * 8]),
    8: ("B bulk stores, 2 stages", [SMS * 4, SMS * 8, SMS * 12]),
    6: ("S scalar with division, one launch", [0]),
}


def build_variants():
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libpatch_gather_variants.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
           str(ROOT / "tools" / "patch_gather_variants.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(so)).gather_variant
    fn.argtypes = [ctypes.POINTER(pk._LevelTable), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def frame_calls(dev):
    """The arguments of the two gathers of one front + one BEV extraction."""
    cam = smoke.front_camera()
    bv = BirdviewCamera(width=smoke.BEV, height=smoke.BEV)
    cfg, bcfg = smoke.configs()
    img, bev, _ = synth.BirdSequence(cam, bv, n_frames=2).frame(1)
    calls, real = [], pk.gather_patches_levels

    def record(*args):
        calls.append(args)
        return real(*args)

    pk.gather_patches_levels = record
    try:
        orb.extract_orb(img, cfg, device=dev)
        orb.extract_orb(bev, bcfg, mask=synth.footprint_mask(bv), device=dev)
    finally:
        pk.gather_patches_levels = real
    return calls


def main() -> int:
    if not torch.cuda.is_available():
        print("patch_gather_variants: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fn = build_variants()
    card = smoke.card_line()
    print(card, flush=True)
    calls = frame_calls(dev)
    tables = [pk._level_table(pl, yl, xl, SIZE, pl[0].device)
              for pl, yl, xl, _ in calls]
    outs = [torch.empty((t.k_total, SIZE, SIZE), device=dev) for t in tables]
    refs = [pk.gather_patches_levels_plain(*c) for c in calls]
    n_bytes = sum(o.numel() * 4 for o in outs) + sum(
        (p.numel() + 2 * ys.numel()) * 4
        for pl, yl, _, _ in calls for p, ys in zip(pl, yl))
    bound_ms = n_bytes / smoke.HBM_BYTES_PER_S * 1e3
    stream = torch.cuda.current_stream().cuda_stream

    def run(variant, grid):
        for table, out in zip(tables, outs):
            err = fn(ctypes.byref(table), SIZE, out.data_ptr(), stream,
                     variant, grid)
            if err != 0:
                raise RuntimeError(f"variant {variant}: CUDA error {err}")

    rows = []
    for rnd in range(2):
        for variant, (name, grids) in VARIANTS.items():
            for grid in grids:
                for out in outs:
                    out.zero_()
                run(variant, grid)
                torch.cuda.synchronize()
                equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
                ms = smoke.cuda_ms(lambda: run(variant, grid), reps=REPS)
                rows.append(dict(round=rnd, variant=name, grid=grid,
                                 equals_plain=equal, ms=ms,
                                 bound_ms=bound_ms))
                print(json.dumps(rows[-1]), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "patch_gather_variants.json").write_text(
        json.dumps(dict(card=card, bytes=n_bytes, rows=rows), indent=1))
    return 0 if all(r["equals_plain"] for r in rows) else 2


if __name__ == "__main__":
    sys.exit(main())
