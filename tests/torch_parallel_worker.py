"""One process of a multi-process mesh, for `test_torch_parallel.py`:

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE PROBLEM OUT

brings up gloo through the `file://` store INIT_FILE, builds a mesh of
four CPU shards in this process over the group, and runs
`sharded_global_ba` (global point indices) and the dense
`sharded_optimize_sim3_graph` on the problems in the PROBLEM .npz. Each
process writes its results to OUT with its rank appended. Imports torch
and the port only.
"""
import sys

import numpy as np
import torch

LOCAL_SHARDS = 4


def main(rank, world, init_file, problem, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from orbslam_birdview_tpu_torch.graph.ba import EdgeSet
    from orbslam_birdview_tpu_torch.parallel import runtime, sharded_ba as sba
    from orbslam_birdview_tpu_torch.parallel import sharded_pose_graph as spg

    assert runtime.init_distributed(f"file://{init_file}", world, rank,
                                    backend="gloo") == (world, rank)
    mesh = runtime.Mesh(["cpu"] * LOCAL_SHARDS, group=dist.group.WORLD)
    d = np.load(problem)
    kinds = ("mono", "stereo", "bird")
    sets = [(k, EdgeSet(*(d[f"{k}_{f}"] for f in EdgeSet._fields)))
            for k in kinds]
    pts_p, ptv_p, part, _ = sba.partition_gba_problem(
        mesh.n_shards, d["X"], np.ones(len(d["X"]), bool), sets)
    cR, ct, cf, cv, pts, ptv, edges = sba.place_gba_problem(
        mesh, d["R"], d["t"], d["fixed"], d["valid"], pts_p, ptv_p, part)
    fx, fy, cx, cy, bf = d["intr"].tolist()
    R, t, X, masks, cost = sba.sharded_global_ba(
        mesh, cR, ct, cf, cv, pts, ptv, *(edges[k][0] for k in kinds),
        fx, fy, cx, cy, bf=bf, iters_phase1=5, iters_phase2=8)
    g = [d[f"g{i}"] for i in range(11)]
    gR, gt, gs, gcost, _ = spg.sharded_optimize_sim3_graph(
        mesh, *g[:4], *spg.shard_edges(mesh, *g[4:]), n_iters=15)
    np.savez(f"{out}{rank}.npz", R=R.numpy(), t=t.numpy(), X=X.numpy(),
             cost=cost.numpy(), gR=gR.numpy(), gt=gt.numpy(),
             gs=gs.numpy(), gcost=gcost.numpy(),
             first_shard=mesh.first_shard)
    dist.destroy_process_group()


if __name__ == "__main__":
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    main(rank, world, *sys.argv[3:6])
