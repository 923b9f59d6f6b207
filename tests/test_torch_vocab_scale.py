"""The reference-scale vocabulary on the port: tests/test_vocab_scale.py's
synthetic k=10, L=6 DBoW2 binary (10^6 words, the reference's geometry)
loaded through the port's `load_dbow2`, with that test's own bounds on the
port's keyframe database (registration < 50 ms a keyframe, a query < 50 ms
at 1k keyframes with at least one candidate, posting-list peak < 100 MB),
and the port's BoW vectors equal to the JAX package's on the same
descriptors. Slow, as the JAX test is."""
import time
import tracemalloc

import numpy as np
import pytest

from orbslam_birdview_tpu.mapping import vocab as jvocab
from orbslam_birdview_tpu.mapping.kfdb import KeyFrameDatabase as JKeyFrameDatabase
from orbslam_birdview_tpu.mapping.mapstore import MapStore as JMapStore
from orbslam_birdview_tpu_torch.frontend.keypoints import Keypoints
from orbslam_birdview_tpu_torch.mapping import vocab
from orbslam_birdview_tpu_torch.mapping.kfdb import KeyFrameDatabase
from orbslam_birdview_tpu_torch.mapping.mapstore import MapStore
from test_vocab_scale import K_BRANCH, L_DEPTH, _fake_kp, _write_dbow2_bin

N_KF = 1000


def port_kp(kp):
    return Keypoints(**kp._asdict())


@pytest.mark.slow
def test_million_word_vocabulary_kfdb(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "voc_1m.bin")
    _write_dbow2_bin(path, rng)
    voc = vocab.load_dbow2(path)
    assert voc.n_words == K_BRANCH ** L_DEPTH
    assert voc.branching == K_BRANCH and voc.depth == L_DEPTH

    store = MapStore(max_kf=1024)
    db = KeyFrameDatabase(voc, store)
    store.n_kf = N_KF
    store.kf_valid[:N_KF] = True
    frames = [port_kp(_fake_kp(rng)) for _ in range(8)]
    tracemalloc.start()
    t0 = time.perf_counter()
    for kf in range(N_KF):
        db.add_keyframe(kf, frames[kf % len(frames)])
    reg_ms = (time.perf_counter() - t0) / N_KF * 1e3
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 100 * (1 << 20), f"peak {peak / 2**20:.0f} MB during 1k " \
                                   "registrations"
    q = port_kp(_fake_kp(rng))
    t0 = time.perf_counter()
    for _ in range(5):
        cands = db.detect_relocalization_candidates(q)
    query_ms = (time.perf_counter() - t0) / 5 * 1e3
    assert query_ms < 50, f"query {query_ms:.1f} ms at 1k KFs"
    assert len(cands) > 0
    assert reg_ms < 50, f"registration {reg_ms:.1f} ms/KF"

    # the JAX package's database on the same file and descriptors: the
    # same sparse BoW vectors and the same candidates
    jvoc = jvocab.load_dbow2(path)
    jstore = JMapStore(max_kf=1024)
    jdb = JKeyFrameDatabase(jvoc, jstore)
    jstore.n_kf = N_KF
    jstore.kf_valid[:N_KF] = True
    for kf in range(N_KF):
        jdb.add_keyframe(kf, frames[kf % len(frames)])
    for kp in (*frames, q):
        (ids, wts), (jids, jwts) = db.transform_frame(kp), \
            jdb.transform_frame(kp)
        assert len(ids) > 400
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(wts, jwts, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        cands, jdb.detect_relocalization_candidates(q))
