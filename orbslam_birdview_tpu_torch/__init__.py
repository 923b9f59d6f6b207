"""orbslam_birdview_tpu_torch — the PyTorch/CUDA port of orbslam_birdview_tpu.

Module names mirror the JAX package one for one, so every module here has
exactly one counterpart to be tested against. The port imports nothing of
the JAX package; its only hand-written kernel so far is the patch gather
(`frontend/patch_kernel.py`, `csrc/patch_gather.cu`), built by nvcc at
first use.

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a GPU and without that argument they raise (`resolve_device`).
"""
from __future__ import annotations

import torch

# The reference pins f32 "highest" matmul precision for geometry and BA
# (orbslam_birdview_tpu/__init__.py). TF32 keeps ~3 decimal digits, which
# would also make the integer-valued einsums of the ORB front end inexact.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless one is given.
    Raises when CUDA is asked for (or defaulted to) and no GPU exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
