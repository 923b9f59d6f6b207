"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device (a CUDA kernel has no CPU mode), so every test here is
marked `cuda` and skips without one. The file imports no JAX, so it also
runs on a machine with the card and without JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu_torch.frontend import patch_kernel as tpk

S = 48


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((448, 998), 434), ((432, 432), 644),
                                     ((113, 160), 122)])
def test_patch_gather_matches_plain(cuda, shape, k):
    rng = np.random.default_rng(0)
    img = torch.from_numpy(np.round(rng.uniform(0, 255, shape))
                           .astype(np.float32)).to(cuda)
    # in-range, past the far edge and negative starts
    ys = torch.from_numpy(rng.integers(-3, shape[0] - S + 6, k)
                          .astype(np.int32)).to(cuda)
    xs = torch.from_numpy(rng.integers(-3, shape[1] - S + 6, k)
                          .astype(np.int32)).to(cuda)
    before = tpk.LAUNCHES
    out = tpk.gather_patches(img, ys, xs, S)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES == before + 1
    assert torch.equal(out, tpk.gather_patches_plain(img, ys, xs, S))


@pytest.mark.cuda
def test_patch_gather_rejects_what_the_kernel_does_not_take(cuda):
    img = torch.zeros((64, 64), device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    for bad in (lambda: tpk.gather_patches(img, idx.long(), idx, S),
                lambda: tpk.gather_patches(img.double(), idx, idx, S),
                lambda: tpk.gather_patches(img.t(), idx, idx, S),
                lambda: tpk.gather_patches(img, idx, idx, 65),
                lambda: tpk.gather_patches(img, idx.cpu(), idx, S)):
        with pytest.raises(ValueError):
            bad()
