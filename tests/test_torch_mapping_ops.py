"""The mapping ops of a keyframe — epipolar triangulation against its
neighbours and the bidirectional fuse projection, each with its on-device
compaction — the JAX package against the port, on the CPU, from the same
numpy keyframes.

Synthetic keyframes: n world points 4-10 m away seen by a keyframe and by
neighbours moved sideways, with pixel noise, descriptor bits flipped and
each neighbour's keypoints in its own order. Tolerances: the matching is
exact integer arithmetic and the gates compare floats far from their
thresholds, so every compacted index list is equal IN ORDER (the consumer's
first-neighbour-wins rule reads that order) and the accept counts are
equal; triangulated points agree to 1e-4 relative (the DLT's inverse
iteration sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid

from orbslam_birdview_tpu.pipeline import device_ops as jops
from orbslam_birdview_tpu_torch.pipeline import device_ops as ops

K = np.array([[300, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
LEVEL_SIGMA2 = np.array([1.2 ** (2 * l) for l in range(8)], np.float32)
X_RTOL = 1e-4

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()



def pose(yaw, tx):
    c, s = np.cos(yaw), np.sin(yaw)
    return (np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32),
            np.array([tx, 0, 0], np.float32))


def keyframes(seed, n=600, n_nb=3):
    """The keyframe (identity pose) and n_nb neighbours: xy, octave,
    desc_u8 per view, plus the world points and their descriptors."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    octave = rng.integers(0, 3, n).astype(np.int32)

    def view(R, t, perm):
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:] * 300 + np.array([160, 120])
        uv = uv + rng.normal(0, 0.3, uv.shape)
        d = desc.copy()
        d[rng.random((n, 32)) < 0.01] ^= 1
        return uv[perm].astype(np.float32), octave[perm], d[perm]

    kf = pose(0.0, 0.0) + view(*pose(0.0, 0.0), np.arange(n))
    nbs = [pose(0.02 * (j + 1), -0.3 * (j + 1)) for j in range(n_nb)]
    nbs = [p + view(*p, rng.permutation(n)) for p in nbs]
    return X, desc, kf, nbs


def tri_inputs(seed, n=600, n_nb=3, nb_ok=None, free_frac=1.0):
    X, _, (R1, t1, xy1, o1, d1), nbs = keyframes(seed, n, n_nb)
    rng = np.random.default_rng(seed + 100)
    free1 = rng.random(n) < free_frac
    free2 = rng.random((n_nb, n)) < free_frac
    if nb_ok is None:
        nb_ok = np.ones(n_nb, bool)
    stack = [np.stack([nb[i] for nb in nbs]) for i in range(5)]
    return (R1, t1, stack[0], stack[1], np.asarray(nb_ok), K, xy1, o1, free1,
            d1, stack[2], stack[3], free2, stack[4], LEVEL_SIGMA2)


def both(jfn, pfn, args):
    jout = [np.asarray(a) for a in jfn(*(jnp.asarray(a) for a in args))]
    pout = [a.numpy() for a in pfn(*(torch.as_tensor(a) for a in args))]
    return jout, pout


def test_epipolar_triangulate_single_neighbour():
    args = tri_inputs(0, n_nb=1)
    (R1, t1, R2s, t2s, _, K_, xy1, o1, f1, d1, xy2, o2, f2, d2, ls) = args
    from orbslam_birdview_tpu.frontend.keypoints import unpack_bits_to_pm1 as ju
    from orbslam_birdview_tpu_torch.frontend.keypoints import unpack_bits_to_pm1

    jargs = [jnp.asarray(a) for a in (R1, t1, R2s[0], t2s[0], K_, xy1, o1, f1)]
    jargs += [ju(jnp.asarray(d1))]
    jargs += [jnp.asarray(a) for a in (xy2[0], o2[0], f2[0])]
    jargs += [ju(jnp.asarray(d2[0])), jnp.asarray(ls)]
    jidx, jX, jok = (np.asarray(a) for a in jops.epipolar_triangulate(*jargs))
    t = torch.as_tensor
    pidx, pX, pok = (a.numpy() for a in ops.epipolar_triangulate(
        t(R1), t(t1), t(R2s[0]), t(t2s[0]), t(K_), t(xy1), t(o1), t(f1),
        unpack_bits_to_pm1(t(d1)), t(xy2[0]), t(o2[0]), t(f2[0]),
        unpack_bits_to_pm1(t(d2[0])), t(ls)))
    np.testing.assert_array_equal(pidx, jidx)
    np.testing.assert_array_equal(pok, jok)
    assert pok.sum() > 300
    np.testing.assert_allclose(pX[pok], jX[jok], rtol=X_RTOL, atol=X_RTOL)


@pytest.mark.parametrize("n_nb,nb_ok,free_frac", [
    (3, None, 1.0), (4, [True, True, False, False], 0.7), (2, [False, True], 1.0)])
def test_epipolar_triangulate_batch_compaction(n_nb, nb_ok, free_frac):
    args = tri_inputs(n_nb, n_nb=n_nb, nb_ok=nb_ok, free_frac=free_frac)
    (jn, jk, ji, jX, jv, jacc), (pn, pk, pi, pX, pv, pacc) = both(
        jops.epipolar_triangulate_batch, ops.epipolar_triangulate_batch, args)
    assert int(pacc) == int(jacc) > 100
    for a, b in ((pn, jn), (pk, jk), (pi, ji), (pv, jv)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pX[pv], jX[jv], rtol=X_RTOL, atol=X_RTOL)
    # the order the consumer relies on: accepted rows first, neighbour-major,
    # keypoint-ascending inside a neighbour; masked neighbours contribute none
    acc = int(pacc)
    assert pv[:acc].all() and not pv[acc:].any()
    key = pn[:acc].astype(np.int64) * 10 ** 6 + pk[:acc]
    assert (np.diff(key) > 0).all()
    if nb_ok is not None:
        assert set(pn[:acc].tolist()) <= set(np.nonzero(nb_ok)[0].tolist())


def test_triangulation_overflow_is_counted_not_hidden():
    """More accepted candidates than TRI_COMPACT_CAP: the first CAP in order
    ship, and the accept count shows the overflow."""
    args = tri_inputs(5, n=600, n_nb=6)
    (jn, jk, _, _, jv, jacc), (pn, pk, _, _, pv, pacc) = both(
        jops.epipolar_triangulate_batch, ops.epipolar_triangulate_batch, args)
    assert int(pacc) == int(jacc) > ops.TRI_COMPACT_CAP == len(pk)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(pk, jk)
    assert pv.all()


def fuse_inputs(seed, n=600, n_nb=3, P=640):
    """Forward set: the first 400 world points (P slots, the rest invalid);
    reverse set: the last 400, in another order. Rows: n_nb neighbours, the
    keyframe last. P >= the keypoint count: the duplicate-target table is
    sized by the landmark count, as the reference's."""
    X, desc, kf, nbs = keyframes(seed, n, n_nb)
    rng = np.random.default_rng(seed + 7)

    def bundle(ids):
        pos = np.full((P, 3), 1e9, np.float32)
        valid = np.zeros(P, bool)
        d = np.zeros((P, 32), np.uint8)
        pos[:len(ids)], valid[:len(ids)], d[:len(ids)] = X[ids], True, desc[ids]
        return pos, valid, d

    fwd = bundle(np.arange(400))
    rev = bundle(rng.permutation(np.arange(n - 400, n)))
    views = nbs + [kf]
    R2s = np.stack([v[0] for v in views])
    t2s = np.stack([v[1] for v in views])
    kxy = np.stack([v[2] for v in views])
    koct = np.stack([v[3] for v in views])
    kval = np.ones((len(views), n), bool)
    kval[:, ::11] = False
    kdesc = np.stack([v[4] for v in views])
    nb_ok = np.ones(len(views), bool)
    nb_ok[1] = False
    return R2s, t2s, nb_ok, fwd, rev, kxy, koct, kval, kdesc, P


INTR = (300.0, 300.0, 160.0, 120.0, 320, 240)


def test_fuse_project_batch2_fr_compaction():
    R2s, t2s, nb_ok, fwd, rev, kxy, koct, kval, kdesc, P = fuse_inputs(1)
    radius = np.full(P, 3.0, np.float32)
    args = (R2s, t2s, nb_ok, *fwd, *rev, kxy, koct, kval, kdesc)
    jout = [np.asarray(a) for a in jops.fuse_project_batch2_fr(
        *(jnp.asarray(a) for a in args), *INTR, jnp.asarray(radius))]
    pout = [a.numpy() for a in ops.fuse_project_batch2_fr(
        *(torch.as_tensor(a) for a in args), *INTR, torch.as_tensor(radius))]
    for a, b in zip(pout, jout):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    row, p, tgt, ok, n_acc = pout
    acc = int(n_acc)
    assert acc > 300 and ok[:acc].all() and not ok[acc:].any()
    assert (np.diff(row[:acc].astype(np.int64) * P + p[:acc]) > 0).all()
    assert 1 not in set(row[:acc].tolist())         # the masked row
    assert len(R2s) - 1 in set(row[:acc].tolist())  # the reverse row
    # the general op on the broadcast sets gives the same triples
    N = len(R2s)

    def bc(f, r):
        return np.concatenate([np.broadcast_to(f, (N - 1,) + f.shape),
                               r[None]])

    sets = [bc(f, r) for f, r in zip(fwd, rev)]
    gen = [a.numpy() for a in ops.fuse_project_batch2(
        *(torch.as_tensor(a) for a in (R2s, t2s, nb_ok, *sets, kxy, koct,
                                       kval, kdesc)),
        *INTR, torch.as_tensor(radius))]
    jgen = [np.asarray(a) for a in jops.fuse_project_batch2(
        *(jnp.asarray(a) for a in (R2s, t2s, nb_ok, *sets, kxy, koct, kval,
                                   kdesc)),
        *INTR, jnp.asarray(radius))]
    for a, b, c in zip(gen, jgen, pout):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
