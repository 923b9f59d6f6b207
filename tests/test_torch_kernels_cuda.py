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
from orbslam_birdview_tpu_torch.frontend import detect_kernel
from orbslam_birdview_tpu_torch.frontend import patch_kernel as tpk
from orbslam_birdview_tpu_torch.graph import ba
from orbslam_birdview_tpu_torch.graph import pose_opt as tpo
from orbslam_birdview_tpu_torch.utils import build

import orb_detect_cases as odc
import small_linalg_cases as sl

S = 48


def _launches(entry):
    return build.LAUNCHES[entry.name]


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
    before = _launches(tpk.GATHER)
    out = tpk.gather_patches(img, ys, xs, S)
    torch.cuda.synchronize()
    assert _launches(tpk.GATHER) == before + 1
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
    before = _launches(tpk.GATHER)
    out = tpk.gather_patches_levels(imgs, ys_l, xs_l, size)
    torch.cuda.synchronize()
    assert _launches(tpk.GATHER) == before + 1
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

    before = _launches(tpk.GATHER)
    for args, size in ((swap(1, idx.long()), S), (swap(0, img.double()), S),
                       (swap(0, img.t()), S), (swap(0, img[:40]), S),
                       (swap(2, idx[:2]), S), (swap(1, idx.cpu()), S),
                       (swap(0, img.cpu()), S), (ok, 65), (ok, 0),
                       (([img] * 17, [idx] * 17, [idx] * 17), S),
                       (([img] * 2, [idx] * 2, [idx] * 3), S)):
        with pytest.raises(ValueError):
            tpk.gather_patches_levels(*args, size)
    assert _launches(tpk.GATHER) == before
    # no patch at all: an empty result and no launch
    none = idx[:0]
    out = tpk.gather_patches_levels([img], [none], [none], S)
    assert out.shape == (0, S, S) and _launches(tpk.GATHER) == before


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
    before = _launches(tpk.GATHER)
    rec = smoke.e2e_stereo_wall_sequence(cuda)
    launches = _launches(tpk.GATHER) - before
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
    before = _launches(linalg.SVD)
    got = _sync_free(linalg.svd_small, A, site.full_matrices)
    assert _launches(linalg.SVD) == before + 1
    ref = linalg.svd_small_plain(A, site.full_matrices)
    sl.check_svd(_np(A), *map(_np, got), [_np(r) for r in ref], site.name)


@pytest.mark.cuda
@pytest.mark.parametrize("site", sl.EIGH_SITES,
                         ids=[s.name for s in sl.EIGH_SITES])
def test_jacobi_eigh_matches_plain(cuda, site):
    A = torch.from_numpy(sl.make_input(site)).to(cuda)
    before = _launches(linalg.EIGH)
    got = _sync_free(linalg.eigh_small, A)
    assert _launches(linalg.EIGH) == before + 1
    sl.check_eigh(_np(A), *map(_np, got),
                  [_np(r) for r in linalg.eigh_small_plain(A)], site.name)


@pytest.mark.cuda
def test_small_linalg_rejects_what_the_kernels_do_not_take(cuda):
    before = build.LAUNCHES.copy()
    ok = torch.zeros((4, 3, 3), device=cuda)
    for fn in (linalg.svd_small, linalg.eigh_small):
        for bad in (ok.double(), ok.transpose(0, 1),
                    torch.zeros((2, 13, 13), device=cuda)):
            with pytest.raises(ValueError):
                fn(bad)
    assert build.LAUNCHES == before
    # an empty batch: empty results and no launch
    assert linalg.svd_small(ok[:0])[1].shape == (0, 3)
    assert linalg.eigh_small(ok[:0])[0].shape == (0, 3)
    assert build.LAUNCHES == before


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


# ---- the pose LM kernel (csrc/pose_lm.cu) ----------------------------------
FX, FY, CX, CY = 350.0, 348.0, 320.0, 240.0


def _rodrigues(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


# the start: rotation vector and translation from the truth (2°, 15 cm)
FAR = (0.02, 0.025, -0.01, 0.1, -0.08, 0.07)


def _near(d):
    return (d, -d, d) * 2


def _pose_problem(seed, n, nb, start=FAR):
    """n mono and nb bird edges seen from a known pose, 20 % gross outliers
    displaced well past the chi² gates (30-200 px, 0.5-1 m), 5 % invalid;
    the LM starts `start` (rotation vector, translation) away from the
    truth. nb None: no bird tensors."""
    rng = np.random.default_rng(seed)
    R, t = _rodrigues([0.05, -0.1, 0.02]), np.array([0.3, -0.1, 0.5])
    Xw = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                         rng.uniform(4, 12, (n, 1))], -1)
    Xc = Xw @ R.T + t
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX,
                   FY * Xc[:, 1] / Xc[:, 2] + CY], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < 0.2
    ang = rng.uniform(0, 2 * np.pi, bad.sum())
    uv[bad] += rng.uniform(30, 200, (bad.sum(), 1)) * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    args = [f32(_rodrigues(start[:3]) @ R), f32(t + np.asarray(start[3:])),
            f32(Xw), f32(uv), f32(1.0 / 1.2 ** (2 * rng.integers(0, 3, n))),
            torch.from_numpy(rng.random(n) > 0.05)]
    bird = {}
    if nb is not None:
        Xb = np.concatenate([rng.uniform(-6, 6, (nb, 2)), np.zeros((nb, 1))],
                            -1)
        ob = Xb @ R.T + t + rng.normal(0, 0.01, (nb, 3))
        badb = rng.random(nb) < 0.2
        d = rng.normal(size=(badb.sum(), 3))
        ob[badb] += d / np.linalg.norm(d, axis=1, keepdims=True) * \
            rng.uniform(0.5, 1.0, (badb.sum(), 1))
        bird = dict(Xw_bird=f32(Xb), obs_pc_bird=f32(ob),
                    info_bird=f32(np.full(nb, 400.0)),
                    valid_bird=torch.from_numpy(rng.random(nb) > 0.05))
    return args, bird


def _on(cuda, args, bird):
    return ([a.to(cuda) for a in args],
            {k: v.to(cuda) for k, v in bird.items()})


# (id, n, nb, rounds, variant): the fused step's caps and both of its
# calls' round counts; ragged sizes around a warp and inside one CTA;
# 16,000 and MAX_EDGES edges (slices past the 48 KB of static shared
# memory); every edge invalid; a start 0.3 mrad / 0.3 mm from the truth,
# where round 1 leaves its loop after three iterations; a NaN world point
# on a valid edge (its NaN weight reaches H through (P·w) Pᵀ, so no step is
# ever accepted, on both sides)
POSE_LM_CASES = [
    ("caps_mono_r2", 6144, None, 2, None), ("caps_mono_r4", 6144, None, 4, None),
    ("caps_bird_r2", 6144, 2048, 2, None), ("caps_bird_r4", 6144, 2048, 4, None),
    *[(f"n{n}_nb{nb}", n, nb, 4, None)
      for n in (1, 31, 33, 1000) for nb in (None, 1)],
    ("n12000_nb4000", 12000, 4000, 4, None),
    ("max_edges", tpo.MAX_EDGES - 4000, 4000, 4, None),
    ("all_invalid", 500, 100, 4, "invalid"),
    ("early_exit", 500, 100, 4, "near"),
    ("nan_point", 500, 100, 4, "nan"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,nb,rounds,variant", POSE_LM_CASES,
                         ids=[c[0] for c in POSE_LM_CASES])
def test_pose_lm_matches_plain(cuda, name, n, nb, rounds, variant):
    """The kernel (one launch, no sync) against `optimize_pose_plain` on the
    card. R and t agree to 1e-4 (f32 sums in another order, amplified a
    little per accepted step), the masks and counts exactly (residuals sit
    clear of the gates), chi² to 1e-3 relative, 1e-6 absolute: one edge
    is fitted exactly and its cost is rounding. One edge leaves the pose
    free along four or one directions, where the two LMs drift apart by
    rounding in proportion to the path they take (1.5e-4 m from 15 cm
    away, 2e-5 from 1 mm in a CPU emulation of the kernel's arithmetic), so
    those problems start 1 mrad / 1 mm from the truth."""
    start = (_near(3e-4) if variant == "near" else _near(1e-3) if n == 1
             else FAR)
    args, bird = _pose_problem(n + (nb or 0), n, nb, start)
    if variant == "invalid":
        args[5][:] = False
        bird["valid_bird"][:] = False
    if variant == "nan":
        args[2][3] = float("nan")
        args[5][3] = True
    args, bird = _on(cuda, args, bird)
    before = _launches(tpo.POSE_LM)
    got = _sync_free(lambda: tpo.optimize_pose(*args, FX, FY, CX, CY,
                                               rounds=rounds, **bird))
    assert _launches(tpo.POSE_LM) == before + 1
    want = tpo.optimize_pose_plain(*args, FX, FY, CX, CY, rounds=rounds,
                                   **bird)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    torch.testing.assert_close(got.R, want.R, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.t, want.t, atol=1e-4, rtol=0)
    assert torch.equal(got.inliers_mono, want.inliers_mono)
    assert torch.equal(got.inliers_bird, want.inliers_bird)
    assert int(got.n_inliers) == int(want.n_inliers)
    torch.testing.assert_close(got.chi2, want.chi2, rtol=1e-3, atol=1e-6)
    if variant in ("invalid", "nan"):
        assert torch.equal(got.R, args[0]) and torch.equal(got.t, args[1])


@pytest.mark.cuda
def test_pose_lm_rejects_what_the_kernel_does_not_take(cuda):
    args, bird = _on(cuda, *_pose_problem(0, 50, 10))

    def call(i=None, x=None, **kw):
        a = list(args)
        if i is not None:
            a[i] = x
        return lambda: tpo.optimize_pose(*a, FX, FY, CX, CY,
                                         **{**bird, **kw})

    Xw = args[2]
    n = tpo.MAX_EDGES - 5    # + 10 bird edges: 5 past the limit
    big = [torch.zeros((n, 3), device=cuda), torch.zeros((n, 2), device=cuda),
           torch.ones(n, device=cuda),
           torch.ones(n, dtype=torch.bool, device=cuda)]
    for bad in (call(2, Xw.double()),                       # float64
                call(5, args[5].float()),                   # a float mask
                call(2, Xw.t().contiguous().t()),           # not contiguous
                call(3, args[3].cpu()),                     # mixed devices
                call(3, args[3][:, :1].contiguous()),       # (N,1) obs
                call(4, args[4][1:]),                       # N-1 infos
                call(0, args[0].reshape(9)),                # R0 (9,)
                call(obs_pc_bird=bird["obs_pc_bird"][:, :2].contiguous()),
                call(Xw_bird=None),                         # 3 of 4 bird
                lambda: tpo.optimize_pose(*args[:2], *big, FX, FY, CX, CY,
                                          **bird),          # too many edges
                ):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.cuda
def test_pose_lm_launches_twice_a_fused_step(cuda, monkeypatch):
    """On a small System on the card every fused step launches the kernel
    exactly twice: its two `optimize_pose` calls."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke
    from orbslam_birdview_tpu_torch.pipeline import fused_track

    step, launches = fused_track.track_step_mono, []

    def counted(*a, **kw):
        before = _launches(tpo.POSE_LM)
        out = step(*a, **kw)
        launches.append(_launches(tpo.POSE_LM) - before)
        return out

    monkeypatch.setattr(fused_track, "track_step_mono", counted)
    drive = smoke.render_drive(12, 0.5, 1000)
    system = smoke.make_system(smoke.slam_config(drive, 3072, 1024), cuda)
    for i, (img, bev, _) in enumerate(drive["frames"]):
        system.track_monocular_with_birdview(img, bev, drive["mask"], i / 25.0)
    system._flush()
    assert len(launches) >= 5 and set(launches) == {2}, launches


# ---------------------------------------------------------------------------
# ORB detection (csrc/orb_detect.cu): every slot, valid or not, and every
# level image equal to detect_levels_plain's on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", odc.CASES)
def test_orb_detect_matches_plain(cuda, name):
    from orbslam_birdview_tpu_torch.frontend import orb

    img, mask, cfg = odc.case(name)
    img = torch.from_numpy(img)
    mask = None if mask is None else torch.from_numpy(mask)
    ref = orb.detect_levels_plain(img, mask, cfg)
    before = _launches(detect_kernel.DETECT)
    out = orb.detect_levels(img.to(cuda),
                            None if mask is None else mask.to(cuda), cfg)
    torch.cuda.synchronize()
    assert _launches(detect_kernel.DETECT) == before + 1
    for field in ("ys", "xs", "xy", "response", "octave", "valid"):
        r, o = getattr(ref, field), getattr(out, field).cpu()
        assert o.dtype == r.dtype and o.shape == r.shape, field
        assert torch.equal(o, r), (field, int((o != r).sum()))
    for l, (r, o) in enumerate(zip(ref.padded, out.padded)):
        assert torch.equal(o.cpu(), r), ("padded level", l)
    for l, (r, o) in enumerate(zip(ref.levels, out.levels)):
        assert torch.equal(o.cpu(), r), ("level", l)
    assert int(ref.valid.sum()) >= odc.min_valid(name)


@pytest.mark.cuda
def test_orb_detect_rejects_what_the_kernel_does_not_take(cuda):
    from orbslam_birdview_tpu_torch.frontend import orb

    img = torch.full((200, 300), 50.0, device=cuda)
    cfg = orb.ORBConfig(n_features=500, n_levels=3)
    before = _launches(detect_kernel.DETECT)
    for bad in (lambda: orb.detect_levels(img.double(), None, cfg),
                lambda: orb.detect_levels(img.t(), None, cfg),
                lambda: orb.detect_levels(img, img.t(), cfg),
                lambda: orb.detect_levels(img, img.half(), cfg),
                lambda: orb.detect_levels(img, img.cpu(), cfg),
                lambda: orb.detect_levels(img[None], None, cfg),
                lambda: orb.detect_levels(img, None, cfg._replace(cell=33)),
                lambda: orb.detect_levels(img, None,
                                          cfg._replace(per_cell=9)),
                lambda: orb.detect_levels(img, None,
                                          cfg._replace(n_levels=17,
                                                       scale_factor=1.05)),
                # more slots than the level has candidates
                lambda: orb.detect_levels(img[:48, :48].contiguous(), None,
                                          cfg)):
        with pytest.raises(ValueError):
            bad()
    assert _launches(detect_kernel.DETECT) == before


@pytest.mark.cuda
def test_orb_detect_launches_twice_a_fused_step(cuda, monkeypatch):
    """On a small System on the card every fused bird step launches the
    detection exactly twice: its front and its BEV extraction."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke
    from orbslam_birdview_tpu_torch.pipeline import fused_track

    step, launches = fused_track.track_step_mono, []

    def counted(*a, **kw):
        before = _launches(detect_kernel.DETECT)
        out = step(*a, **kw)
        launches.append(_launches(detect_kernel.DETECT) - before)
        return out

    monkeypatch.setattr(fused_track, "track_step_mono", counted)
    drive = smoke.render_drive(12, 0.5, 1000)
    system = smoke.make_system(smoke.slam_config(drive, 3072, 1024), cuda)
    for i, (img, bev, _) in enumerate(drive["frames"]):
        system.track_monocular_with_birdview(img, bev, drive["mask"], i / 25.0)
    system._flush()
    assert len(launches) >= 5 and set(launches) == {2}, launches


# ---------------------------------------------------------------------------
# every entry point launches through `build.launch`, whose profiler range,
# named after the entry point, is what links its kernels to a caller's span
# ---------------------------------------------------------------------------

ENTRY_POINTS = [tpk.GATHER, detect_kernel.DETECT, tpo.POSE_LM, linalg.SVD,
                linalg.EIGH, linalg.EMPTY]


def _entry_point_call(entry, cuda):
    """(a call that makes one C call of `entry`, the kernels that C call
    launches)."""
    from orbslam_birdview_tpu_torch.frontend import orb

    if entry is tpk.GATHER:
        imgs, ys_l, xs_l = _levels(cuda, 4)
        return lambda: tpk.gather_patches_levels(imgs, ys_l, xs_l, S), 1
    if entry is detect_kernel.DETECT:
        img, _, cfg = odc.case("bird_front")
        img = torch.from_numpy(img).to(cuda)
        return lambda: orb.detect_levels(img, None, cfg), cfg.n_levels + 1
    if entry is tpo.POSE_LM:
        args, bird = _on(cuda, *_pose_problem(0, 500, 100))
        return lambda: tpo.optimize_pose(*args, FX, FY, CX, CY, **bird), 1
    A = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 3, 3)).astype(np.float32)).to(cuda)
    if entry is linalg.SVD:
        return lambda: linalg.svd_small(A), 1
    if entry is linalg.EIGH:
        sym = A + A.transpose(1, 2)
        return lambda: linalg.eigh_small(sym), 1
    return lambda: build.launch(linalg.EMPTY, cuda), 1


def _kernels_under(event):
    """The device kernels launched by a host-side profiler event and
    everything it called."""
    return len(event.kernels) + sum(_kernels_under(c)
                                    for c in event.cpu_children)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRY_POINTS,
                         ids=[e.name for e in ENTRY_POINTS])
def test_entry_point_kernels_are_linked_to_its_range(cuda, entry):
    """One C call of each kernel entry point under torch.profiler: the
    call's kernels are linked to one host range of the entry point's name,
    through which a caller's span counts them, and the call is counted
    once. A profiler session after the process's first can lose the first
    kernels it sees, so the session opens on a burst of small kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call, n_kernels = _entry_point_call(entry, cuda)
    call()
    burst = torch.zeros(1, device=cuda)
    torch.cuda.synchronize()
    before = _launches(entry)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            burst.add_(1.0)
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    ranges = [ev for ev in prof.events()
              if ev.device_type == DeviceType.CPU and ev.name == entry.name]
    assert len(ranges) == 1, sorted({ev.name for ev in prof.events()})
    assert _kernels_under(ranges[0]) == n_kernels
    assert _launches(entry) == before + 1


# ---- the local BA as one CUDA graph a problem shape (graph/ba.py) ---------
BF = 35.0


def _ba_problem(cuda, P, E, seed, C=48):
    """A local BA at `LocalMapper.prewarm`'s shapes for (C, P, E): E mono
    edges, the stereo and bird sets padded to max(E // 4, 4096). A street:
    cameras 0.12 m apart looking down it, two thirds of them free (the
    first anchored), points 8-20 m ahead; every edge is its point's true
    projection plus noise, a tenth of the mono edges 30 px off, the last
    fifth of the mono set and half of each aux set padding. The free poses
    start ~2 cm and ~0.3° off, the points ~5 cm. Returns (the positional
    arguments of `bundle_adjust`, its keyword arguments)."""
    rng = np.random.default_rng(seed)
    Eb = max(E // 4, 4096)
    R = np.stack([_rodrigues(rng.normal(0, 0.01, 3)) for _ in range(C)])
    centres = np.stack([np.zeros(C), np.zeros(C), 0.12 * np.arange(C)], 1)
    t = -np.einsum("cij,cj->ci", R, centres)
    X = np.concatenate([rng.uniform(-6, 6, (P, 1)), rng.uniform(-2, 2, (P, 1)),
                        rng.uniform(8, 20, (P, 1))], 1)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    fixed[C * 2 // 3:] = True

    def edges(n, kind):
        cam, pt = rng.integers(0, C, n), rng.integers(0, P, n)
        Xc = np.einsum("nij,nj->ni", R[cam], X[pt]) + t[cam]
        u = FX * Xc[:, 0] / Xc[:, 2] + CX
        v = FY * Xc[:, 1] / Xc[:, 2] + CY
        if kind == "mono":
            obs = np.stack([u, v], 1) + rng.normal(0, 0.5, (n, 2))
            obs[rng.random(n) < 0.1] += 30.0
            valid = np.arange(n) < n * 4 // 5
        elif kind == "stereo":
            obs = (np.stack([u, v, u - BF / Xc[:, 2]], 1)
                   + rng.normal(0, 0.5, (n, 3)))
            valid = rng.random(n) < 0.5
        else:
            obs = Xc + rng.normal(0, 0.01, (n, 3))
            valid = rng.random(n) < 0.5
        info = 400.0 if kind == "bird" else 1.0 / 1.2 ** (
            2 * rng.integers(0, 3, n))
        return ba.EdgeSet(
            torch.as_tensor(cam.astype(np.int32), device=cuda),
            torch.as_tensor(pt.astype(np.int32), device=cuda),
            torch.as_tensor(obs.astype(np.float32), device=cuda),
            torch.as_tensor(np.broadcast_to(info, (n,)).astype(np.float32),
                            device=cuda),
            torch.as_tensor(valid, device=cuda))

    free = ~fixed
    Rp = R.copy()
    Rp[free] = np.stack([_rodrigues(rng.normal(0, 0.003, 3)) @ r
                         for r in R[free]])
    tp = t + free[:, None] * rng.normal(0, 0.02, (C, 3))
    Xp = X + rng.normal(0, 0.05, X.shape)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=cuda)
    args = (f32(Rp), f32(tp), torch.as_tensor(fixed, device=cuda),
            torch.ones(C, dtype=torch.bool, device=cuda), f32(Xp),
            torch.ones(P, dtype=torch.bool, device=cuda),
            edges(E, "mono"), edges(Eb, "stereo"), edges(Eb, "bird"))
    return args, dict(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, iters_phase1=5,
                      iters_phase2=10, device=cuda)


BA_FIELDS = ("cam_R", "cam_t", "points", "inl_mono", "inl_stereo",
             "inl_bird", "cost")


@pytest.mark.cuda
@pytest.mark.parametrize("P,E", [(1024, 2048), (4096, 16384)])
def test_ba_graph_replay_matches_the_eager_lm(cuda, P, E):
    """A ladder bucket's BA by graph replay against the same LM issued op
    by op on the same inputs: the inlier masks equal and the state and
    cost bit for bit (the same kernels on the same data)."""
    args, kw = _ba_problem(cuda, P, E, seed=P + E)
    first = ba.bundle_adjust(*args, **kw)
    got = ba.bundle_adjust(*args, **kw)
    lm = ba._LM(*args[:6], *(ba._edges_on(es, cuda) for es in args[6:]),
                (FX, FY, CX, CY, BF), True)
    want = ba._run(lm.start, lm.step, lm.between, lm.finish, 5, 10)
    torch.cuda.synchronize()
    for name in BA_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name), getattr(first, name)), name
    # the LM moved the free poses and kept the mono edges that are not off
    assert torch.isfinite(got.cost) and not torch.equal(got.cam_t, args[1])
    assert 0.6 * E < int(got.inl_mono.sum()) <= 0.8 * E


@pytest.mark.cuda
def test_ba_graph_results_and_inputs_survive_the_next_replay(cuda):
    """Two problems of one bucket back to back: the first call's result and
    both calls' inputs are as they were after the second replay, and no
    result shares memory with the graph or with another result."""
    a, kw = _ba_problem(cuda, 1024, 2048, seed=11)
    b, _ = _ba_problem(cuda, 1024, 2048, seed=12)
    a_in = [x.clone() for x in ba._fields(a)]
    b_in = [x.clone() for x in ba._fields(b)]
    ra = ba.bundle_adjust(*a, **kw)
    ra_then = [x.clone() for x in ra]
    rb = ba.bundle_adjust(*b, **kw)
    torch.cuda.synchronize()
    assert not torch.equal(ra.cam_R, rb.cam_R)
    for x, y in zip(ra, ra_then):
        assert torch.equal(x, y)
    for was, x in zip(a_in + b_in, ba._fields(a) + ba._fields(b)):
        assert torch.equal(was, x)
    graph_ptrs = {x.data_ptr() for g in ba._GRAPHS.values()
                  for x in (*g.inputs, *g.outputs) if x.numel()}
    for x in (*ra, *rb):
        assert x.numel() == 0 or x.data_ptr() not in graph_ptrs
    assert not {x.data_ptr() for x in ra if x.numel()} & {
        x.data_ptr() for x in rb if x.numel()}


@pytest.mark.cuda
def test_ba_graph_captured_once_for_a_shape_off_the_ladder(cuda):
    """A problem shape no bucket has: its first call captures one graph and
    replays it, its second only replays, both counted in the mapper's span
    record."""
    from types import SimpleNamespace

    from orbslam_birdview_tpu_torch.pipeline.local_mapping import LocalMapper
    from orbslam_birdview_tpu_torch.utils.profiling import StageTimer

    args, kw = _ba_problem(cuda, 600, 1500, seed=13, C=7)
    mapper = SimpleNamespace(timer=StageTimer())
    for n in (1, 2):
        LocalMapper._bundle_adjust(mapper, *args, **kw)
        assert mapper.timer.counters["map.ba_graph_capture"] == 1
        assert mapper.timer.counters["map.ba_graph_replay"] == n
