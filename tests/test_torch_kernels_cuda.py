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


# (Hp, Wp, K_l): the front stream's eight padded levels at 950x400 with
# their budgets' order of size, then a one-patch level and an empty one
LEVELS = [(448, 998, 434), (382, 840, 362), (326, 708, 301), (280, 598, 251),
          (241, 506, 209), (209, 430, 174), (182, 366, 145), (160, 313, 124),
          (113, 160, 1), (64, 64, 0)]


def _levels(cuda, n_levels, size=S):
    rng = np.random.default_rng(1)
    imgs, ys_l, xs_l = [], [], []
    for h, w, k in LEVELS[:n_levels]:
        imgs.append(torch.from_numpy(np.round(rng.uniform(0, 255, (h, w)))
                                     .astype(np.float32)).to(cuda))
        # in-range, past the far edge and negative starts
        ys_l.append(torch.from_numpy(rng.integers(-3, h - size + 6, k)
                                     .astype(np.int32)).to(cuda))
        xs_l.append(torch.from_numpy(rng.integers(-3, w - size + 6, k)
                                     .astype(np.int32)).to(cuda))
    return imgs, ys_l, xs_l


@pytest.mark.cuda
@pytest.mark.parametrize("n_levels,size", [(1, S), (4, S), (8, S), (10, S),
                                           (4, 31), (4, 64)])
def test_patch_gather_levels_matches_plain(cuda, n_levels, size):
    """One launch for all levels, float4 path (size % 4 == 0) and scalar
    path, against the per-level plain gathers concatenated."""
    imgs, ys_l, xs_l = _levels(cuda, n_levels, size)
    before = tpk.LAUNCHES
    out = tpk.gather_patches_levels(imgs, ys_l, xs_l, size)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES == before + 1
    assert out.shape == (sum(k for _, _, k in LEVELS[:n_levels]), size, size)
    assert torch.equal(out, tpk.gather_patches_levels_plain(imgs, ys_l, xs_l,
                                                            size))


@pytest.mark.cuda
def test_patch_gather_levels_rejects_what_the_kernel_does_not_take(cuda):
    img = torch.zeros((64, 64), device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    ok = ([img, img], [idx, idx], [idx, idx])

    def swap(which, value):
        args = [list(a) for a in ok]
        args[which][1] = value
        return args

    before = tpk.LAUNCHES
    for args, size in ((swap(1, idx.long()), S), (swap(0, img.double()), S),
                       (swap(0, img.t()), S), (swap(0, img[:40]), S),
                       (swap(2, idx[:2]), S), (swap(1, idx.cpu()), S),
                       (swap(0, img.cpu()), S), (ok, 65), (ok, 0),
                       (([img] * 17, [idx] * 17, [idx] * 17), S),
                       (([img] * 2, [idx] * 2, [idx] * 3), S)):
        with pytest.raises(ValueError):
            tpk.gather_patches_levels(*args, size)
    assert tpk.LAUNCHES == before
    # no patch at all: an empty result and no launch
    none = idx[:0]
    out = tpk.gather_patches_levels([img], [none], [none], S)
    assert out.shape == (0, S, S) and tpk.LAUNCHES == before


@pytest.mark.cuda
def test_init_phase_small_on_the_card(cuda):
    """The initialization path at half size on the card: `Tracker.process`
    until OK, the map against ground truth, then the fused step from the
    refreshed bundles; the patch gather launches twice a frame fed."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke

    drive = smoke.render_drive(8, 0.5, 1000)
    drive.update(P=3072, PB=1024)
    tracker, rec = smoke.init_phase(drive, cuda, floors=False)
    assert rec["frames_fed"] == 4 and rec["keyframe_frames"] == [0, 3]
    assert rec["icp_ok"] and rec["patch_gather_launches"] == 8
    assert abs(rec["scale_ratio"] - 1.0) < 0.02 and rec["rot_err_deg"] < 0.3
    assert rec["map_points"] >= 150 and rec["bird_landmarks"] >= 100
    assert max(rec["median_reproj_px"]) < 1.0
    assert rec["ba"]["cost_last"] <= rec["ba"]["cost_first"]
    assert tracker._K_dev.device.type == "cuda"
    tracked, rows = smoke.tracked_from_init_phase(tracker, drive, cuda)
    assert tracked["frames"] == 4 and tracked["patch_gather_launches"] == 8
    assert tracked["min_front_inliers"] >= 30
    assert tracked["min_bird_inliers"] >= 50
    assert tracked["max_pos_err_m"] < 0.06
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tracker.process(drive["frames"][4][0], 4.0, drive["frames"][4][1],
                        drive["mask"])
