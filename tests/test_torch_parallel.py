"""The multi-device layer, the JAX package against the port, on the CPU:
JAX's sharded solvers on its 8 virtual devices (tests/conftest.py), the
port's on `Mesh([cpu] * 8)`, both fed the same numpy inputs built by
`tests/test_parallel.py`'s recipes, so that both partition the problem
into the same 8 blocks.

- `sharded_global_ba` (mono, stereo and bird; masks scattered back
  through `perm`): camera translations within 2e-3 m and rotations (the
  skew part of R_port·R_jaxᵀ) within 1e-3 rad, the median point
  difference below 5e-3 m, the cost within 1 % — the bars
  `test_torch_ba_large.py` holds the one-device solver to (both packages
  run the same LM and CG iterations in f32, summing in another order);
- `sharded_optimize_sim3_graph` and `_pcg`: scales within 1e-3,
  translations within 5e-3 m, rotations within 1e-3 of the JAX result
  (`test_torch_pose_graph.py`'s S_TOL / T_TOL / R_TOL), and the sharded
  PCG against the port's one-device PCG at the same bars;
- `partition_gba_problem` and `shard_edges`: equal arrays;
- the one-device `bundle_adjust_large`, `optimize_sim3_graph` and
  `optimize_sim3_graph_pcg` equal, bit for bit, their sharded loops on a
  one-shard mesh (they are that case);
- two runs bit-identical; 2 gloo processes × 4 shards against one process
  × 8 (test_parallel.py::test_sharded_matches_single_device's bars:
  translations 1e-3, cost 1e-2 relative); the dry run at C=16, P=512,
  K=64 on 4 shards.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_midrun as mid
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.parallel import sharded_ba as jsba
from orbslam_birdview_tpu.parallel import sharded_pose_graph as jspg
from orbslam_birdview_tpu_torch.graph import ba_large
from orbslam_birdview_tpu_torch.graph import pose_graph as pg
from orbslam_birdview_tpu_torch.graph.ba import EdgeSet
from orbslam_birdview_tpu_torch.parallel import dryrun, runtime
from orbslam_birdview_tpu_torch.parallel import sharded_ba as sba
from orbslam_birdview_tpu_torch.parallel import sharded_pose_graph as spg
from test_parallel import CX, CY, FX, FY, build_full_problem
from test_torch_pose_graph import R_TOL, S_TOL, T_TOL, drift_circle

N_SHARDS = 8
T_POSE_TOL, R_POSE_TOL, PT_MEDIAN_TOL, COST_RTOL = 2e-3, 1e-3, 5e-3, 1e-2
REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == N_SHARDS
    return runtime.Mesh(["cpu"] * N_SHARDS)


def rot_err(Ra, Rb):
    """Largest rotation angle (the skew part) of Ra·Rbᵀ over the batch."""
    D = np.einsum("kij,klj->kil", Ra, Rb)
    return float(np.abs((D - np.swapaxes(D, 1, 2)) / 2).max())


def assert_ba_agree(port, ref, pt_median_tol=PT_MEDIAN_TOL):
    (Rp, tp, Xp, cp), (Rj, tj, Xj, cj) = (
        [np.asarray(x) for x in r] for r in (port, ref))
    np.testing.assert_allclose(tp, tj, atol=T_POSE_TOL)
    assert rot_err(Rp, Rj) < R_POSE_TOL
    assert np.median(np.linalg.norm(Xp - Xj, axis=1)) < pt_median_tol
    np.testing.assert_allclose(float(cp), float(cj), rtol=COST_RTOL)


def full_problem(seed=0):
    """`test_sharded_global_ba_all_edge_types`' problem (global indices):
    6 cameras, 256 points, mono / stereo / bird edges; camera 0 fixed, the
    others perturbed by 1e-2, the points by 5 cm."""
    rng = np.random.default_rng(seed)
    cam_R, cam_t, X_gt, mono, stereo, bird, BF = build_full_problem(rng)
    C = cam_R.shape[0]
    pert = rng.normal(0, 0.01, (C, 6)).astype(np.float32)
    pert[0] = 0.0
    Rp, tp = jax.vmap(jlie.se3_update_left)(
        jnp.asarray(cam_R), jnp.asarray(cam_t), jnp.asarray(pert))
    Xp = X_gt + rng.normal(0, 0.05, X_gt.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    sets = [(k, EdgeSet(*(np.asarray(f) for f in es)))
            for k, es in (("mono", mono), ("stereo", stereo), ("bird", bird))]
    return dict(R=np.asarray(Rp), t=np.asarray(tp), fixed=fixed,
                valid=np.ones(C, bool), X=Xp, sets=sets, bf=BF)


def port_global_ba(m, p, iters=(5, 8)):
    P = p["X"].shape[0]
    pts_p, ptv_p, part, _ = sba.partition_gba_problem(
        m.n_shards, p["X"], np.ones(P, bool), p["sets"])
    cR, ct, cf, cv, pts, ptv, edges = sba.place_gba_problem(
        m, p["R"], p["t"], p["fixed"], p["valid"], pts_p, ptv_p, part)
    out = sba.sharded_global_ba(
        m, cR, ct, cf, cv, pts, ptv, *(edges[k][0] for k, _ in p["sets"]),
        FX, FY, CX, CY, bf=p["bf"], iters_phase1=iters[0],
        iters_phase2=iters[1])
    return out, part


def test_sharded_global_ba_matches_jax(mesh):
    p = full_problem()
    P = p["X"].shape[0]
    jsets = [(k, jsba.EdgeSet(*(jnp.asarray(f) for f in es)))
             for k, es in p["sets"]]
    jpts, jptv, jpart, _ = jsba.partition_gba_problem(
        N_SHARDS, p["X"], np.ones(P, bool), jsets)
    jmesh = jsba.make_mesh()
    jplaced = jsba.place_gba_problem(jmesh, jnp.asarray(p["R"]),
                                     jnp.asarray(p["t"]), p["fixed"],
                                     p["valid"], jpts, jptv, jpart)
    jR, jt, jX, jmasks, jcost = jsba.sharded_global_ba(
        jmesh, *jplaced[:6], *(jplaced[6][k][0] for k, _ in p["sets"]),
        FX, FY, CX, CY, bf=p["bf"], iters_phase1=5, iters_phase2=8)
    (R, t, X, masks, cost), part = port_global_ba(mesh, p)
    assert_ba_agree((R, t, X[:P], cost), (jR, jt, np.asarray(jX)[:P], jcost))
    for (kind, es), flips in zip(p["sets"], (3, 3, 3)):
        n = len(es.cam)
        mine = sba.scatter_mask(masks[kind], part[kind][1], n)
        theirs = sba.scatter_mask(jmasks[kind], jpart[kind][1], n)
        assert (mine != theirs).sum() <= flips, kind
        assert mine.mean() > 0.95, kind


def test_partition_gba_problem_matches_jax():
    p = full_problem(1)
    P = p["X"].shape[0]
    # invalid edges go to every shard in turn: make some
    sets = [(k, es._replace(valid=np.arange(len(es.cam)) % 7 != 3))
            for k, es in p["sets"]]
    jsets = [(k, jsba.EdgeSet(*(jnp.asarray(f) for f in es)))
             for k, es in sets]
    for n in (3, N_SHARDS):
        mine = sba.partition_gba_problem(n, p["X"][:P - 5],
                                         np.ones(P - 5, bool), sets)
        ref = jsba.partition_gba_problem(n, p["X"][:P - 5],
                                         np.ones(P - 5, bool), jsets)
        for a, b in zip(mine[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
        assert mine[3] == ref[3]
        for kind, _ in sets:
            (es, perm), (jes, jperm) = mine[2][kind], ref[2][kind]
            np.testing.assert_array_equal(perm, jperm)
            for a, b in zip(es, jes):
                np.testing.assert_array_equal(a, np.asarray(b))


def loop_problem(rng, K=16):
    """`test_sharded_pose_graph_matches_single_device`'s drifted loop."""
    gt = []
    for k in range(K):
        th = 2 * np.pi * k / K
        Rk = np.asarray(jlie.so3_exp(jnp.asarray([0, 0, th],
                                                 dtype=jnp.float32)))
        pk = np.array([np.cos(th), np.sin(th), 0.0], np.float32) * 4
        gt.append((Rk.T, -Rk.T @ pk))
    est_R, est_t = [gt[0][0]], [gt[0][1]]
    for k in range(1, K):
        Rr = gt[k][0] @ gt[k - 1][0].T
        tr = ((gt[k][1] - Rr @ gt[k - 1][1]) * (1.02 ** k)
              + rng.normal(0, 0.01, 3).astype(np.float32))
        est_R.append(Rr @ est_R[-1])
        est_t.append(Rr @ est_t[-1] + tr)
    est_R, est_t = np.stack(est_R), np.stack(est_t)
    e_i, e_j, mR, mt = [], [], [], []
    for k in range(1, K):
        Rr = est_R[k] @ est_R[k - 1].T
        e_i.append(k - 1)
        e_j.append(k)
        mR.append(Rr)
        mt.append(est_t[k] - Rr @ est_t[k - 1])
    Rr = gt[0][0] @ gt[K - 1][0].T
    e_i.append(K - 1)
    e_j.append(0)
    mR.append(Rr)
    mt.append(gt[0][1] - Rr @ gt[K - 1][1])
    E = len(e_i)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (est_R.astype(np.float32), est_t.astype(np.float32),
            np.ones(K, np.float32), fixed, np.array(e_i, np.int32),
            np.array(e_j, np.int32), np.stack(mR).astype(np.float32),
            np.stack(mt).astype(np.float32), np.ones(E, np.float32),
            np.ones(E, np.float32), np.ones(E, bool))


def pose_agree(port, ref):
    (Rp, tp, sp), (Rj, tj, sj) = ([np.asarray(x) for x in r[:3]]
                                  for r in (port, ref))
    np.testing.assert_allclose(sp, sj, atol=S_TOL)
    np.testing.assert_allclose(tp, tj, atol=T_TOL)
    np.testing.assert_allclose(Rp, Rj, atol=R_TOL)


PCG_ITERS = 20


@pytest.fixture(scope="module")
def sharded_pcg(mesh):
    """The port's sharded PCG on the drift circle, shared by the tests that
    hold it against the JAX package and against the one-device PCG."""
    args = drift_circle()
    return args, spg.sharded_optimize_sim3_graph_pcg(
        mesh, *args[:4], *spg.shard_edges(mesh, *args[4:]),
        n_iters=PCG_ITERS)


def test_sharded_pose_graph_matches_jax_dense(mesh, rng):
    args = loop_problem(rng)
    jmesh = jsba.make_mesh()
    ref = jspg.sharded_optimize_sim3_graph(
        jmesh, *(jnp.asarray(a) for a in args[:4]),
        *jspg.shard_edges(jmesh, *args[4:]), n_iters=15)
    port = spg.sharded_optimize_sim3_graph(
        mesh, *args[:4], *spg.shard_edges(mesh, *args[4:]), n_iters=15)
    pose_agree(port, ref)
    assert np.isfinite(float(ref[3])) and np.isfinite(float(port[3]))


def test_sharded_pose_graph_matches_jax_pcg(sharded_pcg):
    args, port = sharded_pcg
    jmesh = jsba.make_mesh()
    ref = jspg.sharded_optimize_sim3_graph_pcg(
        jmesh, *(jnp.asarray(a) for a in args[:4]),
        *jspg.shard_edges(jmesh, *args[4:]), n_iters=PCG_ITERS)
    pose_agree(port, ref)
    assert float(port[3]) <= float(port[4])
    np.testing.assert_allclose(float(port[3]), float(ref[3]), rtol=COST_RTOL)


def test_sharded_pcg_matches_one_device_pcg(sharded_pcg):
    """The parity test `parallel/sharded_pose_graph.py:144` of the JAX
    package cites: the sharded PCG against the one-device PCG, here the
    port's, on the drift circle."""
    args, sharded = sharded_pcg
    one = pg.optimize_sim3_graph_pcg(*args, n_iters=PCG_ITERS, device="cpu")
    pose_agree(sharded, one)
    np.testing.assert_allclose(float(sharded[3]), float(one[3]),
                               rtol=COST_RTOL)
    assert float(one[3]) < 0.01 * float(one[4])


@pytest.mark.parametrize("solver", ["ba_large", "dense", "pcg"])
def test_one_device_solver_is_the_one_shard_case(solver):
    """The one-device solvers run the sharded loops on `Mesh([cpu])`: the
    two entry points give the same bits."""
    one = runtime.Mesh(["cpu"])
    if solver == "ba_large":
        p = full_problem(4)
        P = p["X"].shape[0]
        ref = ba_large.bundle_adjust_large(
            p["R"], p["t"], p["fixed"], p["valid"], p["X"], np.ones(P, bool),
            *(es for _, es in p["sets"]), FX, FY, CX, CY, bf=p["bf"],
            iters_phase1=3, iters_phase2=3, device="cpu")
        (R, t, X, masks, cost), part = port_global_ba(one, p, (3, 3))
        got = (R, t, X[:P], cost)
        ref_masks = (ref.inl_mono, ref.inl_stereo, ref.inl_bird)
        for (kind, es), m in zip(p["sets"], ref_masks):
            np.testing.assert_array_equal(
                sba.scatter_mask(masks[kind], part[kind][1], len(es.cam)),
                m.numpy())
        ref = (ref.cam_R, ref.cam_t, ref.points, ref.cost)
    else:
        args = drift_circle()
        f1, fs = {"dense": (pg.optimize_sim3_graph,
                            spg.sharded_optimize_sim3_graph),
                  "pcg": (pg.optimize_sim3_graph_pcg,
                          spg.sharded_optimize_sim3_graph_pcg)}[solver]
        ref = f1(*args, n_iters=4, device="cpu")
        got = fs(one, *args[:4], *spg.shard_edges(one, *args[4:]),
                 n_iters=4)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_shard_edges_matches_jax(mesh, rng):
    args = loop_problem(rng, K=13)          # 13 edges: 3 padding slots
    mine = spg.shard_edges(mesh, *args[4:])
    ref = jspg.shard_edges(jsba.make_mesh(), *args[4:])
    for parts, b in zip(mine, ref):
        assert len(parts) == N_SHARDS
        np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                      np.asarray(b).astype(
                                          torch.cat(parts).numpy().dtype))
    # the padding rotations are identities, the scales 1
    np.testing.assert_array_equal(torch.cat(mine[2])[13:].numpy(),
                                  np.tile(np.eye(3, dtype=np.float32),
                                          (3, 1, 1)))


def test_sharded_runs_are_bit_identical(mesh):
    p = full_problem(2)
    (a, _), (b, _) = port_global_ba(mesh, p, (3, 3)), \
        port_global_ba(mesh, p, (3, 3))
    for x, y in zip(a[:3] + (a[4],), b[:3] + (b[4],)):
        assert torch.equal(x, y)
    for k in a[3]:
        assert torch.equal(a[3][k], b[3][k])
    args = drift_circle()
    runs = [spg.sharded_optimize_sim3_graph_pcg(
        mesh, *args[:4], *spg.shard_edges(mesh, *args[4:]), n_iters=3,
        cg_iters=20) for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_two_gloo_processes_match_one_process(mesh, rng, tmp_path):
    """2 processes × 4 CPU shards, reduced by gloo through a `file://`
    store, against this process's 8-shard mesh: `sharded_global_ba` and
    the dense `sharded_optimize_sim3_graph` (its (7K,7K) system summed
    across the processes)."""
    p = full_problem(3)
    g = loop_problem(rng)
    arrays = dict(R=p["R"], t=p["t"], X=p["X"], fixed=p["fixed"],
                  valid=p["valid"],
                  intr=np.array([FX, FY, CX, CY, p["bf"]], np.float64))
    for kind, es in p["sets"]:
        arrays.update({f"{kind}_{f}": v for f, v in zip(EdgeSet._fields, es)})
    arrays.update({f"g{i}": v for i, v in enumerate(g)})
    problem = tmp_path / "problem.npz"
    np.savez(problem, **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, str(REPO / "tests" / "torch_parallel_worker.py")]
    procs = [subprocess.Popen(cmd + [str(r), "2", str(tmp_path / "store"),
                                     str(problem), str(tmp_path / "out")],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        for proc in procs:
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    (R, t, X, _, cost), _ = port_global_ba(mesh, p)
    gR, gt, gs, gcost, _ = spg.sharded_optimize_sim3_graph(
        mesh, *g[:4], *spg.shard_edges(mesh, *g[4:]), n_iters=15)
    half = X.shape[0] // 2
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        assert int(out["first_shard"]) == 4 * r
        np.testing.assert_allclose(out["t"], t.numpy(), atol=1e-3)
        np.testing.assert_allclose(float(out["cost"]), float(cost), rtol=1e-2)
        np.testing.assert_allclose(out["X"], X[r * half:(r + 1) * half],
                                   atol=1e-3)
        np.testing.assert_allclose(out["gt"], gt.numpy(), atol=1e-3)
        np.testing.assert_allclose(out["gs"], gs.numpy(), atol=1e-3)
        np.testing.assert_allclose(float(out["gcost"]), float(gcost),
                                   rtol=1e-2, atol=1e-6)


def test_dryrun_reduced():
    rec = dryrun.dryrun_multichip(4, device="cpu", n_cams=16, n_points=512,
                                  n_vertices=64)
    assert rec["shards"] == 4 and rec["devices"] == ["cpu"] * 4
    assert rec["gba"]["E"] == 2048 and rec["gba"]["mono_inlier_share"] > 0.5
    pg_rec = rec["pose_graph"]
    assert pg_rec["cost"] < 0.01
    assert pg_rec["drift_after_m"] < pg_rec["drift_before_m"]
    assert rec["frontend"]["shape"][0] == 4


def test_mesh_reduction_and_placement():
    m = runtime.Mesh(["cpu"] * 3)
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    # in shard order: (1e8 + 1) - 1e8 in f32
    assert m.psum(parts).item() == float(np.float32(np.float32(1e8 + 1.0)
                                                    - np.float32(1e8)))
    x = torch.ones(2)
    assert all(y is x for y in m.broadcast(x))
    assert (m.size, m.n_shards, m.first_shard) == (3, 3, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.Mesh(["cuda:0"] * 2)
