"""The check's control on the card: the plain reference computed with TF32
on (the precision below the configuration's float32 with TF32 off), put
in the program's place, must come out not correct; the program itself,
correct. At the cell's own size and window (its 80 frames, so that the
drift has its pairs); `portbench/control.py` reads the same readings,
and the planted faults', over many seeds.

Needs a CUDA device, so each test is marked `cuda` and skips without one:

    python -m pytest -o addopts="" -m cuda portbench/tests/test_portbench_control.py
"""
import time

import pytest
import torch

from portbench import cells, harness


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name", [w["name"] for w in cells.benchmark()["workloads"]])
def test_control_is_not_correct(cuda, name):
    bench = cells.benchmark()
    cell = cells.cell(bench, name)
    wl = cells.load("workloads", name)
    result, checked, readings = harness.run_cell(
        cell, [], 2 ** 31 + 99, 51.0, False, time.perf_counter(),
        device=cuda, control=True)
    assert result["correct"], checked
    limits = wl["limits"]
    control = readings["control"]
    failed = [k for k, v in control.items()
              if k in limits and not k.endswith("_checked") and v > limits[k]]
    assert failed, control
