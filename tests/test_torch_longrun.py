"""tests/test_longrun.py on the port: the port's `System` on the CPU over
640 frames of a synthetic orbit at KITTI-like keyframe density — capacity
growth past the initial store caps, keyframe / map-point culling under
sustained load, loop closing on revisits, and top-1 place recognition of
the packaged vocabulary against a small one — with the JAX test's bars.

Marked longrun, as the JAX test is, and slow as well: the tier-1 run
selects `not slow`, which would otherwise take it in, and 640 frames
through the port's `System` on the CPU take many minutes.

Known to fail its last bar on the port's run: the live keyframe database
never holds the two initialization keyframes (in both packages), and on
the port's map one of the nine retrieval queries has keyframe 0 as its
true neighbour, so the packaged vocabulary reads 8 of 9 against the
bootstrap's 9 of 9 (ROADMAP Queue 3). Every other bar passes.
"""
import numpy as np
import pytest

import torch_midrun as mid
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.core.camera import PinholeCamera
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.mapping import vocab as vocab_mod
from orbslam_birdview_tpu_torch.mapping.kfdb import KeyFrameDatabase
from orbslam_birdview_tpu_torch.utils.synth import CircleSequence, ate_rmse


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


@pytest.mark.longrun
@pytest.mark.slow
def test_kitti_scale_longrun():
    cam = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                        width=320, height=240)
    # 640 frames over ~1.3 revolutions with a LOWERED initial keyframe cap
    # exercise capacity growth + culling + loop closing
    N = 640
    seq = CircleSequence(cam, n_frames=N, speed=0.045, frames_per_rev=500,
                         box_half=9.0)
    cfg = SlamConfig(camera=cam, orb=ORBConfig(n_features=600), sensor="mono")
    # KITTI-like keyframe density: force a KF at least every 4 frames so
    # the run blows far past the initial store capacity
    cfg.tracking.max_frames_between_kf = 4
    cfg.max_keyframes = 32
    sys_ = System(cfg, device="cpu")
    gt = {}
    for i in range(N):
        img, pose = seq.frame(i)
        gt[i] = pose
        sys_.track_monocular(np.clip(img, 0, 255).astype(np.uint8), i / 10.0)
    sys_._flush()
    store = sys_.store

    # capacity growth actually exercised (initial cap 32 -> at least two
    # geometric doublings). The mint cadence is ~1 KF per 6-8 frames
    # (deferred-mint policy) and slows further under CI core contention,
    # so the floor leaves headroom: worst observed is ~85 mints.
    assert store.n_kf > 2 * 32, f"only {store.n_kf} KFs allocated"
    # sustained tracking: the surviving map must cover the orbit, and
    # culling must bound it: under the reference's redundancy criterion
    # (≥90% of points seen by ≥3 other KFs at same-or-finer scale) the
    # steady state retains roughly one revolution's coverage.
    n_valid_kf = int(store.kf_valid[: store.n_kf].sum())
    # floor ~one revolution's coverage; the bound is about CULLING
    # staying sane, not an exact count
    assert n_valid_kf >= 55, f"only {n_valid_kf} keyframes survived"
    assert n_valid_kf < 300, f"culling unbounded: {n_valid_kf} keyframes"
    # loop revisits detected and closed at least once over 4 revolutions
    assert sys_.loop_closer.n_loops_closed >= 1, "no loop closed"

    est, gtp = [], []
    for k in store.valid_kf_ids():
        fid = int(store.kf_frame_id[k])
        Rg, tg = gt[fid]
        est.append(-store.kf_R[k].T @ store.kf_t[k])
        gtp.append(-Rg.T @ tg)
    ate = ate_rmse(np.array(est), np.array(gtp), with_scale=True)
    # orbit radius ~3.6 m (diameter ~7.2 m); loop-corrected mono ATE must
    # stay a small fraction of the trajectory scale
    assert ate < 0.35, f"long-run ATE {ate:.3f} m"

    # --- production-vocabulary place-recognition quality. NOTE on what
    # is (not) asserted: the RAW candidate list
    # from DetectLoopCandidates is inherently noisy pre-revisit (its
    # floors are relative — the least-dissimilar far keyframe always
    # passes when no true revisit exists yet; the reference behaves the
    # same, which is exactly why it layers the 3-consistency and Sim3
    # gates, both covered by tests/test_loop_negative.py). Post-closure
    # audits are equally blind: true revisits become covisible and are
    # correctly EXCLUDED. The meaningful vocabulary metric is top-1
    # retrieval: for each late keyframe, the best-scoring
    # temporally-distant keyframe (|frame gap| >= 150, i.e. a different
    # revolution) should be a true spatial neighbor (<2.5 m; random
    # pairs on the ~3.6 m-radius orbit average ~4.5 m). Symmetric
    # between vocabularies and independent of covisibility.
    lc = sys_.loop_closer
    assert lc.voc is not None and lc.voc.n_words >= 100_000, \
        "pipeline default must be the production vocabulary"
    assert len(lc.detection_log) >= 3, "no loop detections were logged"

    def gt_center(k):
        Rg, tg = gt[int(store.kf_frame_id[k])]
        return -Rg.T @ tg
    descs = [store.kf_desc[k][store.kf_kp_valid[k]]
             for k in store.valid_kf_ids()]
    pm1 = (np.unpackbits(np.concatenate(descs), axis=-1,
                         bitorder="little").astype(np.int8) * 2 - 1)
    small_voc = vocab_mod.train_vocabulary(pm1, branching=10, depth=4,
                                           seed=0, max_train=16000,
                                           iters=3)
    kfdb_small = KeyFrameDatabase(small_voc, store)
    for k in store.valid_kf_ids():
        kfdb_small.add_keyframe(int(k), lc._kp_of(int(k)))

    def top1_accuracy(kfdb):
        valid = store.valid_kf_ids()
        fid = {int(k): int(store.kf_frame_id[k]) for k in valid}
        n_ok = n_tot = 0
        for q in valid[-30:]:
            far = [int(c) for c in valid
                   if abs(fid[int(c)] - fid[int(q)]) >= 150]
            if not far:
                continue
            dists = [np.linalg.norm(gt_center(c) - gt_center(q))
                     for c in far]
            if min(dists) > 1.0:
                # culling removed every true revisit of this place (the
                # steady state keeps ~one revolution's coverage) — no
                # correct answer exists, skip the query
                continue
            scores = [kfdb.pair_score(int(q), c) for c in far]
            best = int(np.argmax(scores))
            n_tot += 1
            n_ok += dists[best] < 2.5
        return (n_ok / n_tot if n_tot else 0.0), n_tot

    acc_big, nq = top1_accuracy(lc.kfdb)
    acc_small, nq_s = top1_accuracy(kfdb_small)
    assert nq >= 5, f"only {nq} retrieval queries had a surviving revisit"
    assert acc_big >= 0.6, f"top-1 retrieval {acc_big:.2f} over {nq}"
    assert acc_big >= acc_small - 0.05, \
        (f"100k-word vocab retrieval ({acc_big:.2f}) worse than small "
         f"bootstrap ({acc_small:.2f}, n={nq_s})")
