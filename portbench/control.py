"""The check's two readings for a cell, on the card, in one process.

    python3 portbench/control.py --workload bird_street --seeds 11,12,13 --seconds 15

For each seed, one run of the cell with a short window at the cell's own
size and load; after it, the window's sampled tracking steps and bundle
adjustments are worked out by the plain reference in float64, and again
in float32 with TF32 on (the control, the precision below the program's
float32 with TF32 off), and the faults a tracking cell can have are
planted in the reference put in the program's place. Prints one JSON line
a seed: the numbers of the program against the reference (the lower
reading; all of them on standard error), of the control and of each
fault (the upper readings). The benchmark's own runs never run these.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from run import ROOT, cache_dirs, metrics_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import cells, harness

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the control is read on the card")
        return 2
    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, checked, control = harness.run_cell(
            cell, metrics_of(bench, args.workload, False), seed,
            args.seconds, False, t, control=True)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, correct=result["correct"],
            program={k: v["value"] for k, v in checked.items()},
            metrics=result["metrics"], **control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
