"""Time the solvers' sorted segment sums against `index_add_` on the GPU.

    python3 tools/scatter_ab.py

Runs chip_smoke.py's system phase (the full-width drive through `System`)
four times, the scatter sums of the BA, `ba_large` and the pose graph as
`index_add_` (A) and as the package's sorted segment sums (B), in turns
A, B, B, A. Prints one JSON line: each run's mapping calls, its mapping
stage medians and its map, and the card. `index_add_` lives here only:
the package has the sorted sums alone. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from orbslam_birdview_tpu_torch.frontend import patch_kernel  # noqa: E402
from orbslam_birdview_tpu_torch.graph import (  # noqa: E402
    ba, ba_large, pose_graph, segsum)
from orbslam_birdview_tpu_torch.utils import build  # noqa: E402

SOLVERS = (ba, ba_large, pose_graph)


class IndexAddSum:
    """`segsum.SegmentSum`'s interface, summed with `index_add_` (the
    atomic adds' order on CUDA changes between runs)."""

    def __init__(self, index, n: int):
        self.index = index.long()
        self.n = n

    def __call__(self, values):
        out = values.new_zeros((self.n,) + tuple(values.shape[1:]))
        return out.index_add_(0, self.index, values)


def run(layout, drive, dev):
    for mod in SOLVERS:
        mod.SegmentSum = layout
    try:
        _, rec = smoke.system_phase(drive, dev)
    finally:
        for mod in SOLVERS:
            mod.SegmentSum = segsum.SegmentSum
    return dict(
        scatter_sums="sorted" if layout is segsum.SegmentSum
        else "index_add_",
        mapping_calls_ms=rec["call_ms"]["keyframe_frames"],
        other_calls_ms=rec["call_ms"]["other_frames"],
        stages={k: rec["stages"][k]["median_ms"] for k in (
            "map.ba_dispatch", "map.tri_dispatch", "map.fuse_dispatch",
            "map.loop", "kf.mapper")},
        ate_m=rec["ate_m"], keyframes=rec["keyframes_minted"],
        map_points=rec["map_points"], bird_landmarks=rec["bird_landmarks"],
        local_ba=rec["local_ba"])


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smoke.card_line()
    build.load_library(*patch_kernel.LIBRARY)
    drive = smoke.render_drive(smoke.SYSTEM_FRAMES)
    runs = [run(layout, drive, dev) for layout in (
        IndexAddSum, segsum.SegmentSum, segsum.SegmentSum, IndexAddSum)]
    line = json.dumps({"scatter_ab": runs, "card": card})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "scatter_ab.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
