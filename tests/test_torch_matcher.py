"""The port's matcher against the JAX package: every output is an integer
(or a mask), so every comparison is bit-exact, ties included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu.frontend import keypoints as jkp
from orbslam_birdview_tpu.frontend import matcher as jm
from orbslam_birdview_tpu.pipeline import device_ops as jops
from orbslam_birdview_tpu_torch.frontend import keypoints as tkp
from orbslam_birdview_tpu_torch.frontend import matcher as tm
from orbslam_birdview_tpu_torch.pipeline import device_ops as tops


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(out, ref):
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.fixture()
def descs(rng):
    """Descriptors with exact duplicates and near-duplicates, so distance
    ties occur along both axes."""
    a = rng.integers(0, 256, (96, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (160, 32), dtype=np.uint8)
    b[:48] = a[:48]
    b[48:64] = a[:16]                 # two equal targets per source
    flip = rng.integers(0, 256, (32, 32), dtype=np.uint8) & 0x11
    b[64:96] = a[48:80] ^ flip        # a few bits away
    a[80:88] = a[:8]                  # two equal sources per target
    va = rng.random(96) > 0.1
    vb = rng.random(160) > 0.1
    return a, b, va, vb


def _pm1(u8):
    return np.asarray(jkp.unpack_bits_to_pm1(jnp.asarray(u8)))


def test_bits_pack_unpack(descs):
    a = descs[0]
    _eq(tkp.unpack_bits_to_pm1(_t(a)), _pm1(a))
    _eq(tkp.pack_pm1_to_bits(_t(_pm1(a))), jkp.pack_pm1_to_bits(jnp.asarray(_pm1(a))))


def test_hamming_matrix(descs):
    a, b, va, vb = descs
    ref = jm.hamming_matrix(jnp.asarray(_pm1(a)), jnp.asarray(_pm1(b)),
                            jnp.asarray(va), jnp.asarray(vb))
    _eq(tm.hamming_matrix(_t(_pm1(a)), _t(_pm1(b)), _t(va), _t(vb)), ref)
    _eq(tm.hamming_matrix(_t(_pm1(a)), _t(_pm1(b))),
        jm.hamming_matrix(jnp.asarray(_pm1(a)), jnp.asarray(_pm1(b))))


def test_hamming_matrix_popcount(descs):
    a, b = descs[:2]
    ref = jm.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b))
    _eq(tm.hamming_matrix_popcount(_t(a), _t(b)), ref)
    _eq(tm.hamming_matrix(_t(_pm1(a)), _t(_pm1(b))), ref)


def _dist(descs):
    a, b, va, vb = descs
    return np.asarray(jm.hamming_matrix(jnp.asarray(_pm1(a)),
                                        jnp.asarray(_pm1(b)),
                                        jnp.asarray(va), jnp.asarray(vb)))


@pytest.mark.parametrize("axis", [0, 1])
def test_packed_min(descs, axis):
    d = _dist(descs)
    for r, o in zip(jm._packed_min(jnp.asarray(d), axis),
                    tm._packed_min(_t(d), axis)):
        _eq(o, r)


@pytest.mark.parametrize("ratio", [1.0, 0.8])
def test_match_mutual(descs, ratio):
    d = _dist(descs)
    for r, o in zip(jm.match_mutual(jnp.asarray(d), 60, ratio),
                    tm.match_mutual(_t(d), 60, ratio)):
        _eq(o, r)


@pytest.mark.parametrize("mutual", [True, False])
def test_match_window(descs, rng, mutual):
    d = _dist(descs)
    xa = rng.uniform(0, 60, (96, 2)).astype(np.float32)
    xb = rng.uniform(0, 60, (160, 2)).astype(np.float32)
    xb[:96] = xa + rng.normal(0, 3, xa.shape).astype(np.float32)
    ref = jm.match_window(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(d),
                          12.0, 80, 0.9, mutual)
    out = tm.match_window(_t(xa), _t(xb), _t(d), 12.0, 80, 0.9, mutual)
    for r, o in zip(ref, out):
        _eq(o, r)


@pytest.mark.parametrize("with_octave", [True, False])
def test_search_by_projection(descs, rng, with_octave):
    a, b, va, vb = descs
    uv = rng.uniform(0, 80, (96, 2)).astype(np.float32)
    kxy = rng.uniform(0, 80, (160, 2)).astype(np.float32)
    kxy[:96] = uv + rng.normal(0, 4, uv.shape).astype(np.float32)
    koct = rng.integers(0, 4, 160).astype(np.int32)
    rad = rng.uniform(4, 15, 96).astype(np.float32)
    poct = rng.integers(0, 4, 96).astype(np.int32) if with_octave else None
    args = (uv, va, _pm1(a), kxy, koct, vb, _pm1(b), rad, poct)
    ref = jm.search_by_projection(*[None if x is None else jnp.asarray(x)
                                    for x in args])
    out = tm.search_by_projection(*[None if x is None else _t(x)
                                    for x in args])
    for r, o in zip(ref, out):
        _eq(o, r)


def test_resolve_duplicate_targets_ties(rng):
    n_src, n_tgt = 300, 120      # n_src ≥ n_tgt, the reference's contract
    idx = rng.integers(-1, n_tgt, n_src).astype(np.int32)
    score = rng.integers(0, 6, n_src).astype(np.int32)   # many equal scores
    ref = jm.resolve_duplicate_targets(jnp.asarray(idx), jnp.asarray(score))
    _eq(tm.resolve_duplicate_targets(_t(idx), _t(score)), ref)
    _eq(tm.resolve_duplicate_targets(_t(idx), _t(score), n_tgt=n_tgt), ref)


def test_resolve_duplicate_targets_beyond_source_count():
    """Targets above the source count: the reference's table (sized by the
    sources) drops them; the port's table holds every target."""
    idx = np.array([7, 7, 2], np.int32)
    score = np.array([3, 1, 5], np.int32)
    out = tm.resolve_duplicate_targets(_t(idx), _t(score), n_tgt=8)
    np.testing.assert_array_equal(out.numpy(), [-1, 7, 2])


def test_rotation_consistency_mask(rng):
    n = 400
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, 250).astype(np.float32)
    idx = rng.integers(0, 250, n).astype(np.int32)
    # most matches rotate by ~0.5 rad, a few by anything
    ang_a[:300] = (ang_b[idx[:300]] + 0.5
                   + rng.normal(0, 0.05, 300)).astype(np.float32)
    matched = rng.random(n) > 0.2
    ref = jm.rotation_consistency_mask(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                       jnp.asarray(idx), jnp.asarray(matched))
    out = tm.rotation_consistency_mask(_t(ang_a), _t(ang_b), _t(idx).long(),
                                       _t(matched))
    _eq(out, ref)


# ---------------------------------------------------------------------------
# the frame-to-frame and projection matchers of pipeline/device_ops.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rot", [False, True], ids=["window", "window_rot"])
def test_match_frames_window(descs, rng, rot):
    a, b, va, vb = descs
    xy_b = rng.uniform(0, 300, (160, 2)).astype(np.float32)
    xy_a = (xy_b[:96] + rng.normal(0, 8, (96, 2))).astype(np.float32)
    ang_a = rng.uniform(0, 2 * np.pi, 96).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, 160).astype(np.float32)
    ang_b[:48] = ang_a[:48] + 0.02          # one full histogram bin
    radius = np.float32(20.0)
    if rot:
        ref = jops.match_frames_window_rot(
            jnp.asarray(xy_a), jnp.asarray(ang_a), jnp.asarray(_pm1(a)),
            jnp.asarray(va), jnp.asarray(xy_b), jnp.asarray(ang_b),
            jnp.asarray(_pm1(b)), jnp.asarray(vb), jnp.asarray(radius))
        out = tops.match_frames_window_rot(
            _t(xy_a), _t(ang_a), _t(_pm1(a)), _t(va), _t(xy_b), _t(ang_b),
            _t(_pm1(b)), _t(vb), _t(radius))
    else:
        ref = jops.match_frames_window(
            jnp.asarray(xy_a), jnp.asarray(_pm1(a)), jnp.asarray(va),
            jnp.asarray(xy_b), jnp.asarray(_pm1(b)), jnp.asarray(vb),
            jnp.asarray(radius))
        out = tops.match_frames_window(_t(xy_a), _t(_pm1(a)), _t(va),
                                       _t(xy_b), _t(_pm1(b)), _t(vb),
                                       _t(radius))
    _eq(out[0], ref[0])
    _eq(out[1], ref[1])
    assert 10 < int((out[0] >= 0).sum()) < 96


def test_match_projected(descs, rng):
    a, b, va, vb = descs
    xy_b = rng.uniform(0, 300, (160, 2)).astype(np.float32)
    uv = (xy_b[:96] + rng.normal(0, 3, (96, 2))).astype(np.float32)
    oct_b = rng.integers(0, 4, 160).astype(np.int32)
    pred = rng.integers(0, 4, 96).astype(np.int32)
    radius = rng.uniform(4, 12, 96).astype(np.float32)
    ref = jops.match_projected(
        jnp.asarray(uv), jnp.asarray(va), jnp.asarray(a), jnp.asarray(xy_b),
        jnp.asarray(oct_b), jnp.asarray(vb), jnp.asarray(_pm1(b)),
        jnp.asarray(radius), jnp.asarray(pred))
    out = tops.match_projected(_t(uv), _t(va), _t(a), _t(xy_b), _t(oct_b),
                               _t(vb), _t(_pm1(b)), _t(radius), _t(pred))
    _eq(out[0], ref[0])
    _eq(out[1], ref[1])
    assert int((out[0] >= 0).sum()) > 10
