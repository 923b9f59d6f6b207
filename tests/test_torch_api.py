"""The port's `api` package: `System` resolves lazily, as in the JAX
package's `api/__init__.py`, and importing `api` leaves the pipeline
unimported (the pipeline imports `api.config`)."""
import os
import subprocess
import sys
from pathlib import Path

import orbslam_birdview_tpu_torch.api as api
from orbslam_birdview_tpu_torch.api import system

ROOT = Path(__file__).resolve().parents[1]


def test_api_exports_system():
    from orbslam_birdview_tpu_torch.api import System

    assert System is system.System
    assert api.System is system.System


def test_importing_api_does_not_import_the_pipeline():
    code = ("import sys\n"
            "import orbslam_birdview_tpu_torch.api as api\n"
            "assert api.SlamConfig is not None\n"
            "loaded = [m for m in sys.modules\n"
            "          if m.startswith('orbslam_birdview_tpu_torch.pipeline')]\n"
            "assert not loaded, loaded\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
