"""The four mono and mono+bird tests of `tests/test_e2e.py` on the port, on
the CPU, with their own configurations and bars, on the port's own renders
and with loop closing off (it is ported with slice 3). The same functions
run on the card in `chip_smoke.py`'s e2e phase. Marked slow, as the
reference's tests are.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.slow
def test_monocular_wall_sequence():
    rec = smoke.e2e_monocular_wall_sequence(CPU)
    assert rec["tracked"] >= 24 and rec["ate_m"] < 0.02


@pytest.mark.slow
def test_birdview_metric_scale():
    rec = smoke.e2e_birdview_metric_scale(CPU)
    assert rec["ate_m"] < 0.05 and abs(rec["scale_ratio"] - 1.0) < 0.02


@pytest.mark.slow
def test_reset_and_localization_mode():
    assert smoke.e2e_reset_and_localization_mode(CPU)[
        "keyframes_before_reset"] >= 2


@pytest.mark.slow
def test_trajectory_savers(tmp_path):
    assert smoke.e2e_trajectory_savers(CPU, tmp_path)["tum_lines"] >= 10
