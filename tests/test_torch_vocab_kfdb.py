"""The vocabulary and the keyframe database, the JAX package against the
port, on the CPU, on the same numpy inputs.

- the port's packaged vocabulary is a byte-equal copy of the JAX
  package's;
- word ids from `descend_np` (host) and `_descend` (torch) are bit-equal
  to the JAX package's on the 2000 descriptors of a rendered frame at the
  smoke's full width;
- `transform`, `l1_score` and `l1_score_matrix` within 1e-6;
- `train_vocabulary` with one seed gives equal centroids and weights;
- the DBoW2 text and binary imports give equal vocabularies;
- on a mid-run map (the half-size bird drive through the port's System
  with loop closing on), every keyframe's loop candidates and a frame's
  relocalization candidates are the same lists, the scores within 1e-6;
  `Tracker._reloc_candidates` takes the database's list.
"""
import filecmp
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
import torch_midrun as mid
from orbslam_birdview_tpu.frontend.keypoints import Keypoints as JKeypoints
from orbslam_birdview_tpu.mapping import kfdb as jkfdb
from orbslam_birdview_tpu.mapping import vocab as jvocab
from orbslam_birdview_tpu_torch.api import system as psystem
from orbslam_birdview_tpu_torch.frontend import orb
from orbslam_birdview_tpu_torch.frontend.keypoints import to_host
from orbslam_birdview_tpu_torch.mapping import kfdb, vocab

ROOT = Path(__file__).resolve().parents[1]
JAX_VOCAB = ROOT / "orbslam_birdview_tpu" / "data" / "vocab_100k.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


@pytest.fixture(scope="module")
def vocabs():
    return (jvocab.Vocabulary.load(str(JAX_VOCAB)),
            vocab.Vocabulary.load(psystem.DEFAULT_VOCABULARY))


@pytest.fixture(scope="module")
def frame_desc():
    """The 2000 descriptors of the full-width drive's first frame."""
    drive = smoke.render_drive(1)
    kp = to_host(orb.extract_orb(drive["frames"][0][0], drive["cfg"],
                                 device="cpu"))
    assert kp.valid.sum() >= 1900
    return kp


def test_packaged_vocabulary_is_a_copy(vocabs):
    assert filecmp.cmp(psystem.DEFAULT_VOCABULARY, JAX_VOCAB, shallow=False)
    jv, pv = vocabs
    assert (pv.branching, pv.depth, pv.n_words) == (10, 5, 100000)
    assert pv.centroids.dtype == np.int8
    np.testing.assert_array_equal(pv.centroids, np.asarray(jv.centroids))
    np.testing.assert_array_equal(pv.weights, np.asarray(jv.weights))


def test_word_ids_bit_equal(vocabs, frame_desc):
    jv, pv = vocabs
    pm1 = frame_desc.desc_pm1
    ref = jvocab.descend_np(jv, pm1)
    np.testing.assert_array_equal(vocab.descend_np(pv, pm1), ref)
    word, levels = vocab._descend(pv, torch.from_numpy(pm1))
    jword, jlevels = jvocab._descend(jv, jnp.asarray(pm1))
    np.testing.assert_array_equal(word.numpy(), np.asarray(jword))
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jlevels))
    np.testing.assert_array_equal(word.numpy(), ref)


def test_transform_and_scores(vocabs, frame_desc):
    jv, pv = vocabs
    pm1, valid = frame_desc.desc_pm1, frame_desc.valid
    half = len(pm1) // 2
    outs = []
    for sl in (slice(0, half), slice(half, None)):
        got = vocab.transform(pv, torch.from_numpy(pm1[sl]),
                              torch.from_numpy(valid[sl]))
        ref = jvocab.transform(jv, jnp.asarray(pm1[sl]), jnp.asarray(valid[sl]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-6)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        outs.append((got[0], ref[0]))
    (pa, ja), (pb, jb) = outs
    assert abs(float(vocab.l1_score(pa, pb))
               - float(jvocab.l1_score(ja, jb))) < 1e-6
    np.testing.assert_allclose(
        vocab.l1_score_matrix(pa, torch.stack([pa, pb])).numpy(),
        np.asarray(jvocab.l1_score_matrix(ja, jnp.stack([ja, jb]))),
        atol=1e-6)


def test_train_vocabulary_same_seed(frame_desc):
    pm1 = frame_desc.desc_pm1[frame_desc.valid]
    got = vocab.train_vocabulary(pm1, branching=4, depth=3, seed=0, iters=3)
    ref = jvocab.train_vocabulary(pm1, branching=4, depth=3, seed=0, iters=3)
    np.testing.assert_array_equal(got.centroids, np.asarray(ref.centroids))
    np.testing.assert_array_equal(got.weights, np.asarray(ref.weights))
    assert got.n_words == ref.n_words == 64


def tiny_dbow2(tmp_path):
    """A k=3, L=2 DBoW2 tree with a short branch and an early leaf
    (tests/test_placerec.py's), as a text and a binary file."""
    descs = np.zeros((9, 32), np.uint8)
    descs[2, :] = 0xFF
    descs[3, :] = 0x0F
    descs[4] = descs[1]; descs[4, 0] = 0x01
    descs[5] = descs[1]; descs[5, 1] = 0x03
    descs[6] = descs[1]; descs[6, 2] = 0x07
    descs[7] = descs[2]; descs[7, 0] = 0xFE
    descs[8] = descs[2]; descs[8, 1] = 0xF8
    nodes = [(0, 1, 0.0, 0), (0, 2, 0.0, 0), (0, 3, 0.7, 1), (1, 4, 0.4, 1),
             (1, 5, 0.5, 1), (1, 6, 0.6, 1), (2, 7, 0.8, 1), (2, 8, 0.9, 1)]
    lines = ["3 2 0 0"] + [
        f"{p} {leaf} " + " ".join(str(int(b)) for b in descs[i]) + f" {w}"
        for p, i, w, leaf in nodes]
    txt = tmp_path / "voc.txt"
    txt.write_text("\n".join(lines) + "\n")
    buf = struct.pack("<IIiiii", len(nodes) + 1, 41, 3, 2, 0, 0)
    for p, i, w, leaf in nodes:
        buf += struct.pack("<i", p) + bytes(descs[i]) + struct.pack(
            "<f", w) + bytes([leaf])
    binf = tmp_path / "voc.bin"
    binf.write_bytes(buf)
    return str(txt), str(binf)


def test_dbow2_imports(tmp_path):
    for path in tiny_dbow2(tmp_path):
        got, ref = vocab.load_dbow2(path), jvocab.load_dbow2(path)
        assert (got.branching, got.depth, got.n_words) == (3, 2, 9)
        np.testing.assert_array_equal(got.centroids, np.asarray(ref.centroids))
        np.testing.assert_array_equal(got.weights, np.asarray(ref.weights))
    bad = tmp_path / "bad.bin"
    bad.write_bytes(struct.pack("<IIiiii", 3, 17, 3, 2, 0, 0) + b"\0" * 34)
    with pytest.raises(ValueError, match="record size"):
        vocab.load_dbow2_binary(str(bad))


@pytest.fixture(scope="module")
def midrun(vocabs):
    """The port's System (loop closing on, the packaged vocabulary) fed the
    half-size bird drive until it holds 7 keyframes."""
    seq, frames, mask = mid.drive(40)
    _, cfg = mid.make_cfgs(seq)
    system, last = mid.run_port(cfg, frames, mask,
                                lambda s: s.store.n_kf >= 7,
                                loop_closing=True)
    return system, frames, mask, last


def databases(system, vocabs):
    jv, pv = vocabs
    store = system.store
    js = mid.jax_store(store)
    jdb, pdb = jkfdb.KeyFrameDatabase(jv, js), kfdb.KeyFrameDatabase(pv, store)
    for kf in store.valid_kf_ids():
        pkp = system.loop_closer._kp_of(int(kf))
        pdb.add_keyframe(int(kf), pkp)
        jdb.add_keyframe(int(kf), JKeypoints(*pkp))
    return jdb, pdb


def test_database_candidates_are_the_same(midrun, vocabs):
    system, frames, mask, last = midrun
    jdb, pdb = databases(system, vocabs)
    store = system.store
    for kf in store.valid_kf_ids():
        kf = int(kf)
        np.testing.assert_array_equal(pdb.kf_word_ids[kf],
                                      jdb.kf_word_ids[kf])
        np.testing.assert_allclose(pdb.kf_word_wts[kf], jdb.kf_word_wts[kf],
                                   atol=1e-6)
        ms = pdb.min_covisible_score(kf)
        assert abs(ms - jdb.min_covisible_score(kf)) < 1e-6
        for score in (0.0, ms):
            np.testing.assert_array_equal(
                pdb.detect_loop_candidates(kf, score),
                jdb.detect_loop_candidates(kf, score))
        for b in store.valid_kf_ids():
            assert abs(pdb.pair_score(kf, int(b))
                       - jdb.pair_score(kf, int(b))) < 1e-6
    # relocalization: the next frame's keypoints
    img = frames[last + 1][0]
    kp = to_host(orb.extract_orb(img, system.cfg.orb, device="cpu"))
    got = pdb.detect_relocalization_candidates(kp)
    ref = jdb.detect_relocalization_candidates(JKeypoints(*kp))
    assert len(got) > 0
    np.testing.assert_array_equal(got, ref)
    common, score = pdb._accumulate(*kfdb.transform_sparse(pdb.voc, kp))
    jcommon, jscore = jdb._accumulate(*jkfdb.transform_sparse(jdb.voc, kp))
    np.testing.assert_array_equal(common, jcommon)
    np.testing.assert_allclose(score, jscore, atol=1e-6)


def test_tracker_takes_the_database_candidates(midrun):
    system, frames, mask, last = midrun
    tr = system.tracker
    assert tr.loop_closer is system.loop_closer
    fd = tr.make_frame(frames[last + 1][0], 0.0)
    want = system.loop_closer.kfdb.detect_relocalization_candidates(
        tr._kp_host(fd))
    assert len(want)
    n0 = tr.timer.counters["reloc.kfdb_candidates"]
    np.testing.assert_array_equal(tr._reloc_candidates(fd), want)
    assert tr.timer.counters["reloc.kfdb_candidates"] == n0 + len(want)
    # without a database: the last 10 keyframes
    tr.loop_closer = None
    try:
        np.testing.assert_array_equal(
            tr._reloc_candidates(fd), system.store.valid_kf_ids()[::-1][:10])
    finally:
        tr.loop_closer = system.loop_closer
