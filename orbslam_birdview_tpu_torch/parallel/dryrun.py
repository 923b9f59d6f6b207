"""The multi-device dry run: the sharded global BA, the sharded PCG pose
graph and the data-parallel front end on an n-shard mesh, at the scale
and with the asserts of the JAX package's `__graft_entry__.py::
dryrun_multichip`.

    python -m orbslam_birdview_tpu_torch.parallel.dryrun --shards 4
    python -m orbslam_birdview_tpu_torch.parallel.dryrun --shards 8 \
        --device cpu --cams 16 --points 512 --vertices 64

The mesh repeats one device n times (the card's, or the CPU's), so the
shards run one after another: the same partition, shard-local code and
reductions as on n devices, not an n-device speed.

- the full-protocol sharded GBA at C=512 keyframes, P=65,536 landmarks,
  E=262,144 edges (mono, stereo and bird interleaved), 2+2 LM iterations,
  24 CG steps: cost finite, mono inlier share > 0.5;
- the sharded PCG essential graph at K=1024 (a two-revolution orbit, the
  spanning tree, skip-4 covisibility edges, a loop edge every 16 vertices
  between the revolutions, a seam edge), 10 GN steps, 128 CG steps: cost
  < 0.01 and the mean drift of the camera centres reduced;
- one 96×128 frame per shard through `extract_orb` (200 features on 2
  levels) on its shard's device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from ..graph.ba import EdgeSet
from . import sharded_ba, sharded_pose_graph as spg
from .runtime import Mesh

FX, FY, CX, CY, BF = 500.0, 500.0, 320.0, 240.0, 40.0


def gba_problem(n_cams: int = 512, n_points: int = 65536,
                obs_per_pt: int = 4, seed: int = 0) -> dict:
    """A global-index BA problem with every edge type (numpy): points in
    front of a slowly turning, receding camera track; each point seen by
    `obs_per_pt` cameras, its edges cycling mono / stereo / bird."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-6, 6, n_points), rng.uniform(-4, 4, n_points),
                  rng.uniform(6, 14, n_points)], 1).astype(np.float32)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0] = 0.01 * np.arange(n_cams)
    xi[:, 4] = -0.0002 * np.arange(n_cams)
    Rs, ts = (a.numpy() for a in lie.se3_exp(torch.from_numpy(xi)))
    pt = np.repeat(np.arange(n_points), obs_per_pt)
    cam = ((pt * 7 + np.tile(np.arange(obs_per_pt), n_points)) % n_cams
           ).astype(np.int32)
    Xc = np.einsum("eij,ej->ei", Rs[cam], X[pt]) + ts[cam]
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX,
                   FY * Xc[:, 1] / Xc[:, 2] + CY], 1)
    uv += rng.normal(0, 0.3, uv.shape)
    kind = pt % 3

    def sub(k, obs):
        m = kind == k
        return EdgeSet(cam[m], pt[m].astype(np.int32),
                       obs[m].astype(np.float32),
                       np.ones(m.sum(), np.float32), np.ones(m.sum(), bool))

    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return dict(
        R=Rs, t=ts, X=X, fixed=fixed, valid=np.ones(n_cams, bool),
        mono=sub(0, uv),
        stereo=sub(1, np.concatenate([uv, uv[:, :1] - BF / Xc[:, 2:3]], 1)),
        bird=sub(2, Xc + rng.normal(0, 0.01, Xc.shape)),
        edges=len(pt))


def run_sharded_gba(mesh: Mesh, prob: dict, iters=(2, 2), cg_iters=24):
    """`sharded_global_ba` on `prob` over `mesh`: (R, t, points in the
    caller's order, mono inlier mask over the partition's slots, cost)."""
    P = prob["X"].shape[0]
    pts_p, ptv_p, part, _ = sharded_ba.partition_gba_problem(
        mesh.n_shards, prob["X"], np.ones(P, bool),
        [(k, prob[k]) for k in ("mono", "stereo", "bird")])
    cR, ct, cf, cv, pts, ptv, edges = sharded_ba.place_gba_problem(
        mesh, prob["R"], prob["t"], prob["fixed"], prob["valid"], pts_p,
        ptv_p, part)
    R, t, X, masks, cost = sharded_ba.sharded_global_ba(
        mesh, cR, ct, cf, cv, pts, ptv, edges["mono"][0],
        edges["stereo"][0], edges["bird"][0], FX, FY, CX, CY, bf=BF,
        iters_phase1=iters[0], iters_phase2=iters[1], cg_iters=cg_iters)
    return R, t, X[:P], masks["mono"], cost


def pose_graph_problem(K: int = 1024) -> dict:
    """A drifted two-revolution orbit of K vertices with its
    essential-graph edges, measured from ground truth (numpy)."""
    theta = 2 * np.pi * 2.0 * np.arange(K) / K
    c, sn = np.cos(theta), np.sin(theta)
    R_gt = np.zeros((K, 3, 3), np.float32)
    R_gt[:, 0, 0] = c
    R_gt[:, 0, 1] = sn
    R_gt[:, 1, 0] = -sn
    R_gt[:, 1, 1] = c
    R_gt[:, 2, 2] = 1.0
    centers = np.stack([50.0 * c, 50.0 * sn, np.zeros(K)], 1)
    t_gt = -np.einsum("kij,kj->ki", R_gt, centers).astype(np.float32)
    drift = (np.linspace(0, 1, K)[:, None]
             * np.array([0.8, -0.5, 0.3], np.float32))
    ei_list, ej_list = [], []
    for step in (1, 4):
        ei_list.append(np.arange(K - step, dtype=np.int32))
        ej_list.append(np.arange(step, K, dtype=np.int32))
    ei_list.append(np.arange(0, K // 2, 16, dtype=np.int32))
    ej_list.append(np.arange(0, K // 2, 16, dtype=np.int32) + K // 2)
    ei_list.append(np.array([K - 1], np.int32))       # the seam
    ej_list.append(np.array([0], np.int32))
    ei, ej = np.concatenate(ei_list), np.concatenate(ej_list)
    mR = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei])   # Rj Riᵀ
    mt = t_gt[ej] - np.einsum("eab,eb->ea", mR, t_gt[ei])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    E = len(ei)
    return dict(R_gt=R_gt, t_gt=t_gt, t0=(t_gt + drift).astype(np.float32),
                s0=np.ones(K, np.float32), fixed=fixed, e_i=ei, e_j=ej,
                mR=mR.astype(np.float32), mt=mt.astype(np.float32),
                ms=np.ones(E, np.float32), e_w=np.ones(E, np.float32),
                e_valid=np.ones(E, bool))


def pose_graph_edges(pgp: dict):
    return tuple(pgp[k] for k in ("e_i", "e_j", "mR", "mt", "ms", "e_w",
                                  "e_valid"))


def run_sharded_pose_graph(mesh: Mesh, pgp: dict, n_iters=10, cg_iters=128):
    return spg.sharded_optimize_sim3_graph_pcg(
        mesh, pgp["R_gt"], pgp["t0"], pgp["s0"], pgp["fixed"],
        *spg.shard_edges(mesh, *pose_graph_edges(pgp)),
        n_iters=n_iters, cg_iters=cg_iters)


def mean_drift(pgp: dict, R, t, s) -> float:
    """Mean distance of the camera centres from ground truth."""
    def centres(R, t, s):
        return (-np.einsum("kji,kj->ki", R, t) / s[:, None])
    c_gt = centres(pgp["R_gt"], pgp["t_gt"], np.ones(len(pgp["s0"])))
    return float(np.linalg.norm(centres(R, t, s) - c_gt, axis=1).mean())


def frontend(mesh: Mesh, seed: int = 0):
    """One 96×128 frame per shard through `extract_orb` (200 features on 2
    levels) on its shard's device; the responses, stacked."""
    from ..frontend import orb

    rng = np.random.default_rng(seed)
    cfg = orb.ORBConfig(n_features=200, n_levels=2)
    resp = []
    for d in mesh.devices:
        img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
        resp.append(orb.extract_orb(img, cfg, device=d).response.to(
            mesh.devices[0]))
    return torch.stack(resp)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_multichip(n_shards: int, device=None, n_cams: int = 512,
                     n_points: int = 65536, n_vertices: int = 1024,
                     mesh: Mesh = None) -> dict:
    """The dry run on `mesh` (default: `device`, `cuda` unless given,
    repeated n_shards times), asserting what the JAX dry run asserts.
    Returns its record."""
    if mesh is None:
        mesh = Mesh([resolve_device(device)] * n_shards)
    d0 = mesh.devices[0]
    rec = dict(shards=mesh.n_shards, devices=[str(d) for d in mesh.devices])

    prob = gba_problem(n_cams, n_points)
    t0 = time.perf_counter()
    R, t, X, mono, cost = run_sharded_gba(mesh, prob)
    cost = float(cost)
    rec["gba"] = dict(C=n_cams, P=n_points, E=prob["edges"], cost=cost,
                      wall_s=time.perf_counter() - t0)
    assert np.isfinite(cost), "sharded GBA produced a non-finite cost"
    inl = float(mono.float().mean())
    rec["gba"]["mono_inlier_share"] = inl
    assert inl > 0.5, f"sharded GBA inlier ratio {inl}"

    pgp = pose_graph_problem(n_vertices)
    t0 = time.perf_counter()
    pR, pt_, ps, pcost, _ = run_sharded_pose_graph(mesh, pgp)
    pcost = float(pcost)
    rec["pose_graph"] = dict(K=n_vertices, E=len(pgp["e_i"]), cost=pcost,
                             wall_s=time.perf_counter() - t0)
    assert np.isfinite(pcost), "sharded pose graph non-finite"
    err0 = mean_drift(pgp, pgp["R_gt"], pgp["t0"], pgp["s0"])
    err1 = mean_drift(pgp, *(x.cpu().numpy() for x in (pR, pt_, ps)))
    rec["pose_graph"].update(drift_before_m=err0, drift_after_m=err1)
    assert pcost < 0.01, f"pose graph cost {pcost:.4f}"
    assert err1 < err0, (
        f"pose graph did not reduce drift: {err0:.3f} -> {err1:.3f}")

    resp = frontend(mesh)
    _sync(d0)
    rec["frontend"] = dict(shape=list(resp.shape),
                           finite=bool(torch.isfinite(resp).any(1).all()))
    assert rec["frontend"]["finite"], "a shard's extraction found nothing"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; repeated once per shard")
    ap.add_argument("--cams", type=int, default=512)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--vertices", type=int, default=1024)
    args = ap.parse_args(argv)
    rec = dryrun_multichip(args.shards, args.device, args.cams, args.points,
                           args.vertices)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
