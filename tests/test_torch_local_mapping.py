"""Local mapping, the JAX package against the port, on the CPU, on the same
map carried across.

The map: the port's `System` fed the half-size bird drive until a keyframe
(the fourth or later) has just been minted and its triangulation
dispatched, not applied. Its store is copied into both packages
(`torch_midrun.copy_store`, `torch_midrun.jax_store`), and each stage of
the keyframe pipeline runs in both: point culling, triangulation, the
bidirectional fuse with its merges, the local BA with its writeback and
outlier removal, keyframe culling, and the per-frame ticks that advance
them.

Tolerances: the mapping ops' integer matching gives equal compacted lists,
so allocations, observations and merges are equal; positions agree to
1e-3 m (points 4-30 m away triangulated to 1e-4 relative), poses to 1e-3
after the BA; the BA's outlier classification may differ on an edge that
sits on its chi² gate (at most 3 observations, as the BA's own test).
"""
import numpy as np
import pytest
import torch

import torch_midrun as mid
from orbslam_birdview_tpu.pipeline import local_mapping as jlm
from orbslam_birdview_tpu_torch.pipeline import local_mapping as lm

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()



@pytest.fixture(scope="module")
def moment():
    seq, frames, mask = mid.drive(24)
    jcfg, cfg = mid.make_cfgs(seq)

    def fresh_triangulation(system):
        st = system.mapper._kf_stage
        return (system.store.n_kf >= 4 and st is not None
                and st[0] == "triangulate" and st[2] is not None)

    system, _ = mid.run_port(cfg, frames, mask, fresh_triangulation)
    kf = system.mapper._kf_stage[1]
    return dict(jcfg=jcfg, cfg=cfg, store=mid.copy_store(system.store), kf=kf,
                recent=list(system.mapper.recent_mp), system=system)


def mappers(m, recent=True):
    """A JAX and a port LocalMapper, each on its own copy of the map."""
    ps = mid.copy_store(m["store"])
    js = mid.jax_store(m["store"])
    jm = jlm.LocalMapper(m["jcfg"], js)
    pm = lm.LocalMapper(m["cfg"], ps, device="cpu")
    if recent:
        jm.recent_mp = list(m["recent"])
        pm.recent_mp = list(m["recent"])
    return jm, pm


@pytest.mark.parametrize("sensor", ["mono_bird", "mono"])
def test_cull_recent_points(moment, sensor):
    """Every valid point as a recent one, of four ages, a fifth of them seen
    often but found rarely: those go by their found ratio, in mono also the
    old points with two observations; the oldest graduate."""
    jm, pm = mappers(moment)
    kf = moment["kf"]
    store = moment["store"]
    ids = np.nonzero(store.mp_valid[:store.n_mp])[0]
    recent = [(int(i), kf - int(i) % 4) for i in ids]
    for mapper in (jm, pm):
        mapper.recent_mp = list(recent)
        mapper.store.mp_visible[ids[::5]] += 40
        mapper.cfg.sensor = sensor
    try:
        jm._cull_recent_points(kf)
        pm._cull_recent_points(kf)
    finally:
        for mapper in (jm, pm):
            mapper.cfg.sensor = "mono_bird"
    assert pm.stats["points_culled"] >= len(ids[::5]) // 2
    assert pm.recent_mp == jm.recent_mp
    mid.assert_stores_agree(pm.store, jm.store)


def triangulated(m):
    jm, pm = mappers(m)
    kf = m["kf"]
    for mapper in (jm, pm):
        meta, fetch = mapper._dispatch_triangulate(kf)
        mapper._apply_triangulate(kf, meta, fetch.get())
        mapper.store.update_covisibility(kf)
    return jm, pm


def test_triangulate_apply(moment):
    before = moment["store"].n_mp
    jm, pm = triangulated(moment)
    assert pm.store.n_mp - before > 50
    assert pm.compact_overflows == jm.compact_overflows == 0
    assert pm.recent_mp == jm.recent_mp
    mid.assert_stores_agree(pm.store, jm.store)


def test_fuse_apply_with_merges(moment):
    jm, pm = triangulated(moment)
    kf = moment["kf"]
    valid_before = int(pm.store.mp_valid.sum())
    obs_before = int((pm.store.kf_kp_mp[:pm.store.n_kf] >= 0).sum())
    for mapper in (jm, pm):
        meta, fetch = mapper._dispatch_fuse(kf)
        mapper._apply_fuse(kf, meta, fetch.get())
    merged = valid_before - int(pm.store.mp_valid.sum())
    assert merged > 0, "no duplicate landmark was merged"
    assert int((pm.store.kf_kp_mp[:pm.store.n_kf] >= 0).sum()) > obs_before
    mid.assert_stores_agree(pm.store, jm.store)


def test_local_ba_writeback_and_outlier_removal(moment):
    jm, pm = triangulated(moment)
    kf = moment["kf"]
    for mapper in (jm, pm):
        meta, fetch = mapper._dispatch_fuse(kf)
        mapper._apply_fuse(kf, meta, fetch.get())
    # five observations of the keyframe moved 40 px: outliers for the BA
    kps = np.nonzero(pm.store.kf_kp_mp[kf] >= 0)[0][::37][:5]
    for mapper in (jm, pm):
        mapper.store.kf_kp_xy[kf, kps] += 40.0
    obs_before = int((pm.store.kf_kp_mp[:pm.store.n_kf] >= 0).sum())
    R_before = pm.store.kf_R[:pm.store.n_kf].copy()
    for mapper in (jm, pm):
        mapper.local_ba(kf, async_dispatch=True)
        assert mapper._ba_pending is not None        # lands at its tick
        assert mapper.finalize_ba(start_fetch_only=True) is False
        assert mapper.finalize_ba(block=True) is True
        assert mapper._ba_pending is None
    ps, js = pm.store, jm.store
    assert pm.stats["ba_landed"] == 1
    moved = np.abs(ps.kf_R[:ps.n_kf] - R_before).max()
    assert moved > 1e-7, "the BA moved no pose"
    removed = obs_before - int((ps.kf_kp_mp[:ps.n_kf] >= 0).sum())
    assert removed >= 5, f"{removed} outlier observations removed"
    assert (ps.kf_kp_mp[kf, kps] < 0).all()
    np.testing.assert_allclose(ps.kf_R[:ps.n_kf], js.kf_R[:js.n_kf], atol=1e-3)
    np.testing.assert_allclose(ps.kf_t[:ps.n_kf], js.kf_t[:js.n_kf], atol=1e-3)
    live = ps.mp_valid[:ps.n_mp]
    np.testing.assert_allclose(ps.mp_pos[:ps.n_mp][live],
                               js.mp_pos[:js.n_mp][live], atol=1e-2)
    diff = int((ps.kf_kp_mp[:ps.n_kf] != js.kf_kp_mp[:js.n_kf]).sum())
    assert diff <= 3, f"{diff} observations differ after outlier removal"
    assert ps.big_change_idx == js.big_change_idx


@pytest.mark.parametrize("redundancy", [0.9, 0.3])
def test_cull_keyframes(moment, redundancy):
    """The reference's 90 % rule, and a loose 30 % that culls."""
    jm, pm = triangulated(moment)
    for mapper in (jm, pm):
        mapper.cfg.mapping.kf_cull_redundancy = redundancy
    try:
        jm._cull_keyframes(moment["kf"])
        pm._cull_keyframes(moment["kf"])
    finally:
        for mapper in (jm, pm):
            mapper.cfg.mapping.kf_cull_redundancy = 0.9
    if redundancy < 0.5:
        assert pm.stats["kf_culled"] > 0
    mid.assert_stores_agree(pm.store, jm.store)


def test_poll_background_ticks(moment):
    """`process_keyframe` and the per-frame ticks: the same stage advances
    on the same ticks, and the BA lands BA_LAG_FRAMES after its dispatch."""
    assert (lm.STAGE_LAG_FRAMES, lm.BA_LAG_FRAMES) == (
        jlm.STAGE_LAG_FRAMES, jlm.BA_LAG_FRAMES)
    jm, pm = mappers(moment)
    kf = moment["kf"]
    trace = {id(jm): [], id(pm): []}
    for mapper in (jm, pm):
        mapper.process_keyframe(kf)
        assert not mapper.mapping_idle
        for _ in range(12):
            mapper.poll_background()
            st = mapper._kf_stage
            trace[id(mapper)].append((
                None if st is None else st[0], mapper._stage_tick,
                mapper._ba_pending is not None, mapper._ba_tick,
                mapper.store.n_mp, mapper.store.big_change_idx,
                mapper.mapping_idle))
    assert trace[id(pm)] == trace[id(jm)]
    kinds = [t[0] for t in trace[id(pm)]]
    assert "fuse" in kinds and kinds[-1] is None
    # the BA dispatched with the fuse landing lands 6 ticks later
    pend = [t[2] for t in trace[id(pm)]]
    first = pend.index(True)
    assert pend[first:first + lm.BA_LAG_FRAMES - 1] == [True] * (
        lm.BA_LAG_FRAMES - 1) and pm.stats["ba_landed"] == 1
    assert pm.stats["tri_applied"] == pm.stats["fuse_applied"] == 1
    mid.assert_stores_agree(pm.store, jm.store, exact=False)


def test_kf_dev_cache_checks_shapes_and_equals_the_upload(moment):
    _, pm = mappers(moment)
    store = pm.store
    cap = store.kp_cap
    good = [torch.as_tensor(a) for a in (
        store.kf_kp_xy[0], store.kf_kp_octave[0], store.kf_kp_valid[0],
        store.kf_desc[0])]
    for i in range(4):
        bad = list(good)
        bad[i] = bad[i][: cap - 128]
        with pytest.raises(ValueError, match="keypoint slots"):
            pm.register_kf_device(0, *bad)
    kfs = [int(k) for k in store.valid_kf_ids()]
    nbs = np.asarray(kfs[:3], np.int64)
    assert pm._kf_dev_stack(nbs) is None              # nothing registered
    for k in kfs:
        pm.register_kf_device(k, *(torch.as_tensor(a) for a in (
            store.kf_kp_xy[k], store.kf_kp_octave[k], store.kf_kp_valid[k],
            store.kf_desc[k])))
    cached, uploaded = pm._kf_dev_stack(nbs), pm._kf_host_stack(nbs)
    for a, b in zip(cached, uploaded):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a triangulation through the cache lands exactly what the upload does
    _, host = mappers(moment)
    kf = moment["kf"]
    outs = [m._dispatch_triangulate(kf)[1].get() for m in (pm, host)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_full_map_ba_waits_for_loop_closing(moment):
    """The full-map BA came with loop closing: both packages' `global_ba`
    on the same map land the same poses (1e-3) and points (2e-2 m: mono
    points move along their weakly observed rays), keyframe 0 fixed."""
    assert not hasattr(lm, "_UNPORTED")
    jm, pm = mappers(moment)
    R0 = pm.store.kf_R[0].copy()
    for mapper in (jm, pm):
        mapper.global_ba(iters=(3, 3))
        assert mapper._gba_pending is None
    ps, js = pm.store, jm.store
    assert pm.stats["gba_landed"] == 1 and pm.last_gba["solver"] == "dense-W"
    np.testing.assert_array_equal(ps.kf_R[0], R0)
    np.testing.assert_allclose(ps.kf_R[:ps.n_kf], js.kf_R[:js.n_kf], atol=1e-3)
    np.testing.assert_allclose(ps.kf_t[:ps.n_kf], js.kf_t[:js.n_kf], atol=1e-3)
    live = ps.mp_valid[:ps.n_mp]
    np.testing.assert_allclose(ps.mp_pos[:ps.n_mp][live],
                               js.mp_pos[:js.n_mp][live], atol=2e-2)
    assert ps.big_change_idx == js.big_change_idx

