"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device (a CUDA kernel has no CPU mode), so every test here is
marked `cuda` and skips without one. The file imports no JAX, so it also
runs on a machine with the card and without JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu_torch.core import linalg
from orbslam_birdview_tpu_torch.frontend import patch_kernel as tpk

import small_linalg_cases as sl

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
    # the tracker goes on from its map (the slow path: no velocity yet)
    fd = tracker.process(drive["frames"][4][0], 4.0, drive["frames"][4][1],
                         drive["mask"])
    assert fd.pose_ok and tracker.velocity is not None


@pytest.mark.cuda
def test_small_system_on_the_card(cuda):
    """`System.track_monocular_with_birdview` on 15 frames of the drive at
    half size on the card: initialized on the fourth frame, every frame
    after it tracked, keyframes minted and mapped, a metric trajectory, and
    two patch-gather launches a frame."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke

    drive = smoke.render_drive(15, 0.5, 1000)
    drive.update(P=3072, PB=1024)
    system, rec = smoke.system_phase(drive, cuda)
    assert rec["init_frame"] == 3 and rec["tracked_share_after_init"] == 1.0
    assert rec["keyframes_minted"] >= 4 and rec["local_ba"]["landed"] >= 1
    assert rec["patch_gather_launches"] == 30
    assert rec["ate_m"] < 0.05 and abs(rec["scale_ratio"] - 1.0) < 0.02
    assert rec["compact_overflows"] == 0 and rec["final_state_ok"]
    assert system.tracker._K_dev.device.type == "cuda"


@pytest.mark.cuda
def test_depth_modes_small_on_the_card(cuda):
    """The stereo front end on the CPU and on the card (the same match
    indices, uR within 1e-4 px), and the stereo e2e test's drive on the
    card with its bars; the patch gather launches 2 or 3 times a frame."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke

    rec = smoke.small_stereo_reference(cuda)
    assert rec["max_ur_diff_px"] <= 1e-4 and rec["matches"] > 150
    before = tpk.LAUNCHES
    rec = smoke.e2e_stereo_wall_sequence(cuda)
    launches = tpk.LAUNCHES - before
    assert rec["tracked"] >= 14 and rec["ate_m"] < 0.03
    assert 2 * 18 <= launches <= 3 * 18


def _np(x):
    return None if x is None else x.cpu().numpy()


def _sync_free(fn, *args):
    """fn(*args) under sync debug mode "error": it must not synchronise."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("site", sl.SVD_SITES,
                         ids=[s.name for s in sl.SVD_SITES])
def test_jacobi_svd_matches_plain(cuda, site):
    """`jacobi_svd_f32` against `torch.linalg.svd` behind the guard at
    every site's shape: one launch, no sync, the invariants and tolerances
    of small_linalg_cases, NaN exactly in the non-finite entries."""
    A = torch.from_numpy(sl.make_input(site)).to(cuda)
    before = linalg.LAUNCHES["jacobi_svd_f32"]
    got = _sync_free(linalg.svd_small, A, site.full_matrices)
    assert linalg.LAUNCHES["jacobi_svd_f32"] == before + 1
    ref = linalg.svd_small_plain(A, site.full_matrices)
    sl.check_svd(_np(A), *map(_np, got), [_np(r) for r in ref], site.name)


@pytest.mark.cuda
@pytest.mark.parametrize("site", sl.EIGH_SITES,
                         ids=[s.name for s in sl.EIGH_SITES])
def test_jacobi_eigh_matches_plain(cuda, site):
    A = torch.from_numpy(sl.make_input(site)).to(cuda)
    before = linalg.LAUNCHES["jacobi_eigh_f32"]
    got = _sync_free(linalg.eigh_small, A)
    assert linalg.LAUNCHES["jacobi_eigh_f32"] == before + 1
    sl.check_eigh(_np(A), *map(_np, got),
                  [_np(r) for r in linalg.eigh_small_plain(A)], site.name)


@pytest.mark.cuda
def test_small_linalg_rejects_what_the_kernels_do_not_take(cuda):
    before = dict(linalg.LAUNCHES)
    ok = torch.zeros((4, 3, 3), device=cuda)
    for fn in (linalg.svd_small, linalg.eigh_small):
        for bad in (ok.double(), ok.transpose(0, 1),
                    torch.zeros((2, 13, 13), device=cuda)):
            with pytest.raises(ValueError):
                fn(bad)
    assert linalg.LAUNCHES == before
    # an empty batch: empty results and no launch
    assert linalg.svd_small(ok[:0])[1].shape == (0, 3)
    assert linalg.eigh_small(ok[:0])[0].shape == (0, 3)
    assert linalg.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 17, 31, 32, 33, 48, 63, 64])
def test_jacobi_svd_group_boundaries(cuda, m):
    """At each change of the kernel's group (16 lanes up to 16 rows, then
    32 lanes of 2 rows, lane i holding rows i and i + 32), against the
    plain version."""
    A = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (64, m, 12)).astype(np.float32)).to(cuda)
    got = _sync_free(linalg.svd_small, A, True)
    ref = linalg.svd_small_plain(A, True)
    sl.check_svd(_np(A), *map(_np, got), [_np(r) for r in ref], f"{m}x12")


@pytest.mark.cuda
def test_det_small_closed_form_on_the_card(cuda):
    """On CUDA tensors det_small takes the closed form, with no sync, and
    gives the library's sign at every det site of the solvers."""
    for name, X in sl.det_inputs().items():
        got = _sync_free(linalg.det_small, torch.from_numpy(X).to(cuda))
        want = torch.linalg.det(torch.from_numpy(X))
        assert torch.equal(torch.sign(got.cpu()), torch.sign(want)), name
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
