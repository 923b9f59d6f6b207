"""One run of one benchmark cell of orbslam_birdview_tpu_torch.

    python3 portbench/run.py --workload bird_street --seed 7 --seconds 51 --trace 0

Prints the run's parts on standard error, then the numbers the check
compared beside their limits as the last lines there, and one JSON object
as the last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`), `device` and, last, `check`. Exits non-zero
with no result when no CUDA device (or too few) is present, and when the
process holds jax, jaxlib, flax or the JAX package after the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["ORBSLAM_TORCH_BUILD_DIR"] = str(BUILD / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The cell's metrics: its end-to-end ones, or with a trace its
    per-layer ones; an entry with `workloads` only where it lists it."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from portbench import cells, harness

    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    t = time.perf_counter()
    import torch
    harness.log(f"torch imported in {time.perf_counter() - t:.3f} s, "
                f"{t - T_START:.3f} s after the start")
    if not torch.cuda.is_available():
        harness.log("no CUDA device: this benchmark measures the card")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"asks for {cell['chips']}")
        return 2
    result, checked, _ = harness.run_cell(
        cell, metrics_of(bench, args.workload, bool(args.trace)), args.seed,
        args.seconds, bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules loaded that the port may not load: {bad}")
        return 3
    for name, entry in checked.items():
        bound = (f">= {entry['at_least']}" if "at_least" in entry
                 else f"<= {entry['limit']}")
        harness.log(f"check {name}: {entry['value']} {bound}")
    result["check"] = checked
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
