"""Images and configurations on which the ORB detection kernels are held
against `orb.detect_levels_plain`: by the card tests
(`test_torch_kernels_cuda.py`) and, through the kernels' host build, by the
CPU tests (`test_torch_orb_detect.py`). Imports no JAX."""
import json
from pathlib import Path

import numpy as np

from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.utils import synth

# the benchmark's bird rig (bird_street): its front and BEV extractors
BIRD_CONFIG = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
               / "fisheye_birdview.json")


def bird_orb(prefix: str) -> ORBConfig:
    """The `ORBextractor` (front) or `BirdORBextractor` (BEV) settings of
    the bird rig's configuration."""
    conf = json.loads(BIRD_CONFIG.read_text())
    return ORBConfig(n_features=int(conf[f"{prefix}.nFeatures"]),
                     n_levels=int(conf[f"{prefix}.nLevels"]),
                     scale_factor=conf[f"{prefix}.scaleFactor"],
                     fast_threshold=conf[f"{prefix}.iniThFAST"],
                     min_threshold=conf[f"{prefix}.minThFAST"])


BIRD = bird_orb("ORBextractor")
BIRD_BEV = bird_orb("BirdORBextractor")

# the bird rig's two streams, KITTI's stereo frame, the parallel dry run's
# frame, a flat image, a texture that ties responses within and across
# cells, and the kernels' other limits
CASES = ["bird_front", "bird_bev", "kitti", "dryrun", "flat", "ties",
         "odd_cell", "cell32"]


def case(name):
    """(image, mask or None, ORBConfig) of one case, float32 numpy."""
    tex = synth.make_texture(5, size=1400, n_blobs=1500)
    mask = None
    if name == "bird_front":
        img, cfg = tex[:400, :950], BIRD
    elif name == "bird_bev":
        mask = synth.footprint_mask(BirdviewCamera(width=384, height=384))
        img, cfg = tex[200:584, 300:684], BIRD_BEV
    elif name == "kitti":
        img, cfg = tex[10:386, 100:1341], BIRD._replace(min_threshold=7.0)
    elif name == "dryrun":
        img, cfg = tex[:96, :128], ORBConfig(n_features=200, n_levels=2)
    elif name == "flat":
        img, cfg = np.full((200, 300), 77.0), ORBConfig(n_features=500,
                                                        n_levels=3)
    elif name == "ties":
        # 4×4 blocks of two values: equal responses within and across cells,
        # and rank-penalised keys that round to equal in float32
        rng = np.random.default_rng(3)
        img = np.kron(rng.integers(0, 2, (60, 80)), np.ones((4, 4))) * 180.0
        img, cfg = img + 20.0, ORBConfig(n_features=1500, n_levels=3,
                                         min_threshold=7.0)
    elif name == "odd_cell":
        # a non-integer image, a mask of another size, cell 8 with 3 a cell
        img = tex[:301, :457] + 0.37
        mask = np.random.default_rng(1).random((150, 200)) > 0.3
        cfg = ORBConfig(n_features=700, n_levels=5, scale_factor=1.3,
                        min_threshold=9.0, cell=8, per_cell=3)
    elif name == "cell32":
        img, cfg = tex[:500, :700], ORBConfig(n_features=1000, n_levels=4,
                                              cell=32, per_cell=8)
    else:
        raise KeyError(name)
    img = np.ascontiguousarray(img, dtype=np.float32)
    if mask is not None:
        mask = np.ascontiguousarray(mask, dtype=np.float32)
    return img, mask, cfg


def min_valid(name) -> int:
    """The least valid slots the plain version gives in a case: the cases
    exercise the pick, not only the padding."""
    return 0 if name == "flat" else 100
