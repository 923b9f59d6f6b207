"""The port's map store against the JAX package's: the same sequence of
operations on both stores leaves equal arrays (exactly: both are numpy on
the host), with the cases of tests/test_mapstore.py as the oracle; a file
saved by either package loads in the other; `state.map_store` carries a
store across; `keypoints.to_host` lands device keypoints as the numpy
fields the store takes.
"""
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.frontend.keypoints import Keypoints as JKeypoints
from orbslam_birdview_tpu.mapping import mapstore as jms
from orbslam_birdview_tpu_torch.frontend import keypoints as tkp
from orbslam_birdview_tpu_torch.mapping import mapstore as tms
from orbslam_birdview_tpu_torch.pipeline import state

CAP, BCAP = 64, 16
SF = np.array([1.2 ** l for l in range(8)], np.float32)


def kp_fields(rng, n, cap):
    u8 = rng.integers(0, 256, (cap, 32)).astype(np.uint8)
    return dict(
        xy=rng.uniform(0, 640, (cap, 2)).astype(np.float32),
        response=rng.uniform(1, 50, cap).astype(np.float32),
        angle=rng.uniform(0, 6.28, cap).astype(np.float32),
        octave=rng.integers(0, 8, cap).astype(np.int32),
        valid=np.arange(cap) < n, desc_u8=u8,
        desc_pm1=(np.unpackbits(u8, axis=-1, bitorder="little")
                  .astype(np.int8) * 2 - 1))


def both(fields):
    return JKeypoints(**fields), tkp.Keypoints(**fields)


def assert_stores_equal(a, b):
    arrays_a = {k: v for k, v in vars(a).items() if isinstance(v, np.ndarray)}
    arrays_b = {k: v for k, v in vars(b).items() if isinstance(v, np.ndarray)}
    assert arrays_a.keys() == arrays_b.keys()
    for k in arrays_a:
        assert arrays_a[k].dtype == arrays_b[k].dtype, k
        np.testing.assert_array_equal(arrays_a[k], arrays_b[k], err_msg=k)
    for k in ("n_kf", "n_mp", "n_bmp", "big_change_idx", "correction_epoch",
              "max_kf", "max_mp", "max_bmp", "kp_cap", "bird_cap"):
        assert getattr(a, k) == getattr(b, k), k
    assert [tuple(e) for e in a.loop_edges] == [tuple(e) for e in b.loop_edges]


def build(ms, kps, rng, bird=True):
    """The fixture of tests/test_mapstore.py (3 keyframes sharing 30
    landmarks), with poses that differ, bird landmarks and point
    statistics."""
    store = ms.MapStore(max_kf=8, max_mp=256, max_bmp=64, kp_cap=CAP,
                        bird_cap=BCAP)
    for i, (kp, bkp, base) in enumerate(kps):
        store.alloc_keyframe(np.eye(3, dtype=np.float32),
                             np.array([0.1 * i, 0, 0], np.float32), i,
                             float(i), kp, bird=(bkp, base) if bird else None)
    pos = rng.uniform(-3, 3, (30, 3)).astype(np.float32) + [0, 0, 6]
    desc = rng.integers(0, 256, (30, 32)).astype(np.uint8)
    ids = store.alloc_points(pos, desc, 0, 0)
    store.add_observations(0, np.arange(30), ids)
    store.add_observations(1, np.arange(20), ids[10:])
    store.add_observations(2, np.arange(10), ids[20:])
    for i in range(3):
        store.update_covisibility(i)
    store.update_point_stats(ids, SF)
    if bird:
        bpos = rng.uniform(-5, 5, (8, 3)).astype(np.float32)
        bids = store.alloc_bird_points(
            bpos, rng.integers(0, 256, (8, 32)).astype(np.uint8), 0)
        store.add_bird_observations(0, np.arange(8), bids)
        store.add_bird_observations(1, np.arange(4) + 2, bids[:4])
        store.update_bird_point_desc(bids)
    return store, ids


@pytest.fixture
def pair():
    rng = np.random.default_rng(0)
    fields = [(kp_fields(rng, 60, CAP), kp_fields(rng, 12, BCAP),
               rng.uniform(-5, 5, (BCAP, 3)).astype(np.float32))
              for _ in range(3)]
    jkps = [(both(f)[0], both(b)[0], base) for f, b, base in fields]
    tkps = [(both(f)[1], both(b)[1], base) for f, b, base in fields]
    js, ids = build(jms, jkps, np.random.default_rng(1))
    ts, ids_t = build(tms, tkps, np.random.default_rng(1))
    np.testing.assert_array_equal(ids, ids_t)
    return js, ts, ids


def test_same_operations_same_arrays(pair):
    js, ts, ids = pair
    assert_stores_equal(js, ts)
    # the oracle's expectations hold for the port's store
    assert ts.covis[0, 1] == 20 and ts.covis[0, 2] == 10 and ts.covis[1, 2] == 10
    assert ts.covisible_kfs(0, min_weight=15).tolist() == [1]
    assert set(ts.covisible_kfs(0, min_weight=5).tolist()) == {1, 2}
    assert ts.mp_n_obs[ids[0]] == 1 and ts.mp_n_obs[ids[15]] == 2
    assert ts.mp_n_obs[ids[25]] == 3
    assert (ts.mp_min_dist[ids] < ts.mp_max_dist[ids]).all()
    np.testing.assert_allclose(np.linalg.norm(ts.mp_normal[ids], axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("op", ["erase_point", "erase_points", "replace_point",
                                "erase_keyframe", "erase_bird_point",
                                "remove_observation", "grow"])
def test_mutations_stay_equal(pair, op):
    js, ts, ids = pair
    for s in (js, ts):
        if op == "erase_point":
            s.erase_point(int(ids[25]))
            assert not s.mp_valid[ids[25]]
            assert (s.kf_kp_mp[:3] == ids[25]).sum() == 0
        elif op == "erase_points":
            s.erase_points(ids[5:25:3])
            assert not s.mp_valid[ids[5:25:3]].any()
        elif op == "replace_point":
            a, b = int(ids[0]), int(ids[1])
            s.replace_point(a, b)
            assert not s.mp_valid[a] and s.mp_valid[b]
            assert (s.kf_kp_mp[0] == b).sum() == 1
            assert s.kf_kp_mp[0, 0] == tms.INVALID
        elif op == "erase_keyframe":
            s.kf_parent[1] = 0
            s.kf_parent[2] = 1
            s.erase_keyframe(1)
            assert not s.kf_valid[1] and s.kf_parent[2] == 0
            assert s.mp_n_obs[ids[15]] == 1
        elif op == "erase_bird_point":
            s.erase_bird_point(2)
            assert not s.bmp_valid[2] and s.bmp_n_obs[2] == 0
        elif op == "remove_observation":
            s.remove_observation(1, np.arange(5))
            assert (s.kf_kp_mp[1, :5] == tms.INVALID).all()
        elif op == "grow":
            rng = np.random.default_rng(7)
            s.alloc_points(rng.normal(size=(300, 3)).astype(np.float32),
                           rng.integers(0, 256, (300, 32)).astype(np.uint8),
                           2, 2)
            s.alloc_bird_points(rng.normal(size=(70, 3)).astype(np.float32),
                                rng.integers(0, 256, (70, 32)).astype(np.uint8),
                                2)
            assert s.max_mp >= 330 and s.max_bmp >= 78
        s.update_covisibility(0)
    assert_stores_equal(js, ts)


def test_queries_agree(pair):
    js, ts, ids = pair
    np.testing.assert_array_equal(js.valid_kf_ids(), ts.valid_kf_ids())
    np.testing.assert_array_equal(js.valid_mp_ids(), ts.valid_mp_ids())
    np.testing.assert_array_equal(js.valid_bmp_ids(), ts.valid_bmp_ids())
    np.testing.assert_array_equal(js.kf_center(2), ts.kf_center(2))
    for a, b in zip(js.observations_of(int(ids[25])),
                    ts.observations_of(int(ids[25]))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (5, 32)).astype(np.uint8)
    b = rng.integers(0, 256, (7, 32)).astype(np.uint8)
    np.testing.assert_array_equal(jms.hamming_np(a, b), tms.hamming_np(a, b))


def test_out_of_cap_writes_fail_loudly(pair):
    _, ts, ids = pair
    big = both(kp_fields(np.random.default_rng(0), 100, 2 * CAP))[1]
    with pytest.raises(ValueError, match="kp_cap"):
        ts.alloc_keyframe(np.eye(3), np.zeros(3), 9, 9.0, big)
    with pytest.raises(IndexError, match="kp_cap"):
        ts.add_observations(0, np.array([CAP]), ids[:1])
    with pytest.raises(IndexError, match="bird_cap"):
        ts.add_bird_observations(0, np.array([BCAP]), np.array([0]))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_save_load_round_trip_and_across_packages(tmp_path, pair, saver):
    js, ts, _ = pair
    for s in (js, ts):
        s.loop_edges.append((0, 2))
    path = str(tmp_path / "map.npz")
    (js if saver == "jax" else ts).save(path)
    assert_stores_equal(tms.MapStore.load(path), ts)
    assert_stores_equal(jms.MapStore.load(path), ts)
    assert tms.MapStore.load(path).loop_edges == [(0, 2)]


def test_state_carries_a_store_across(pair):
    js, ts, ids = pair
    js.loop_edges.append((1, 2))
    ts.loop_edges.append((1, 2))
    carried = state.map_store(vars(js))
    assert isinstance(carried, tms.MapStore)
    assert_stores_equal(carried, ts)
    # a copy, not a view
    carried.mp_pos[ids[0]] += 1.0
    assert not np.array_equal(carried.mp_pos, js.mp_pos)


def test_keypoints_to_host_lands_every_field():
    f = kp_fields(np.random.default_rng(2), 40, 128)
    dev = tkp.Keypoints(**{k: torch.from_numpy(v) for k, v in f.items()})
    host = tkp.to_host(dev)
    for k, v in f.items():
        got = getattr(host, k)
        assert isinstance(got, np.ndarray) and got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    # and the store takes them
    store = tms.MapStore(max_kf=2, max_mp=8, max_bmp=8, kp_cap=128, bird_cap=8)
    store.alloc_keyframe(np.eye(3), np.zeros(3), 0, 0.0, host)
    np.testing.assert_array_equal(store.kf_desc[0], f["desc_u8"])
    np.testing.assert_array_equal(store.kf_kp_valid[0], f["valid"])
