"""Distributed Sim3 essential-graph optimization over a mesh of shards.

The essential graph's EDGES (spanning tree, strong covisibility, loop
edges) are split over the shards; the K Sim3 vertices are replicated on
the mesh's first device. Each shard assembles the normal-equation
contributions of its edges on its own device; H and b (dense solver) or
b, the block-Jacobi blocks and every CG matvec (PCG) are summed over the
mesh (`Mesh.psum`) and solved once on the first device.

The loops are `graph/pose_graph.solve_dense` / `solve_pcg`, of which the
one-device `optimize_sim3_graph` / `_pcg` are the one-shard case: this
module places the vertices and splits the edges over the mesh. The
sharded result equals the one-device result up to the float order of the
reductions. Both solve in the normalized gauge of
`pose_graph.gauge_normalize` (the JAX package's sharded dense solver does
not; a gauge change moves only the f32 rounding).
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph import pose_graph as pg
from .runtime import Mesh
from .sharded_ba import _np, _rep, _split


def _on_mesh(mesh, R, t, s, fixed, e_i, e_j, mR, mt, ms, e_w, e_valid):
    """The vertices on the mesh's first device, the shards' edges as the
    solvers take them."""
    verts = (_rep(mesh, R, torch.float32), _rep(mesh, t, torch.float32),
             _rep(mesh, s, torch.float32), _rep(mesh, fixed, torch.bool))
    return verts, [pg._shard(*e) for e in zip(e_i, e_j, mR, mt, ms, e_w,
                                              e_valid)]


def sharded_optimize_sim3_graph(mesh: Mesh, R, t, s, fixed, e_i, e_j, mR, mt,
                                ms, e_w, e_valid, n_iters: int = 20):
    """Gauss-Newton over the Sim3 graph with the dense (7K,7K) H and b
    summed over the mesh. R (K,3,3), t (K,3), s (K,) world→kf vertices and
    fixed (K,); the edge arrays as `shard_edges` returns them (one tensor
    per local shard, padding rows with e_valid False). Returns (R, t, s,
    the last candidate's cost, the first cost)."""
    verts, shards = _on_mesh(mesh, R, t, s, fixed, e_i, e_j, mR, mt, ms,
                             e_w, e_valid)
    return pg.solve_dense(mesh, *verts, shards, n_iters)


def sharded_optimize_sim3_graph_pcg(mesh: Mesh, R, t, s, fixed, e_i, e_j,
                                    mR, mt, ms, e_w, e_valid,
                                    n_iters: int = 20, cg_iters: int = 60):
    """Matrix-free sharded variant for LARGE essential graphs (K >= ~256):
    only (K,7) vectors and the (K,7,7) block-Jacobi blocks cross shards,
    one (K,7) reduction per CG step; the normalized gauge, the
    best-residual CG iterate and the backtracking over the scales 1, 1/2,
    1/4, 1/8 of `pose_graph.optimize_sim3_graph_pcg`, whose loop this is.
    Returns (R, t, s, the accepted cost, the first cost)."""
    verts, shards = _on_mesh(mesh, R, t, s, fixed, e_i, e_j, mR, mt, ms,
                             e_w, e_valid)
    return pg.solve_pcg(mesh, *verts, shards, n_iters, cg_iters)


def shard_edges(mesh: Mesh, e_i, e_j, mR, mt, ms, e_w, e_valid):
    """Pad the edge arrays to a multiple of the mesh's shards and split
    them over the shards: a tuple of seven lists (e_i, e_j, mR, mt, ms,
    e_w, e_valid), one tensor per local shard on its device. Padding edges
    carry identity rotations and scale 1: they are weight-0, but still
    pass through `sim3_log`, where a zero rotation gives a NaN that a zero
    weight cannot scrub."""
    n = mesh.n_shards
    E = len(e_i)
    pad = (-E) % n

    def pd(x, fill=0):
        x = _np(x)
        return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1),
                      constant_values=fill)

    mR_p = pd(mR)
    if pad:
        mR_p[E:] = np.eye(3, dtype=mR_p.dtype)
    out = (pd(e_i), pd(e_j), mR_p, pd(mt), pd(ms, 1.0), pd(e_w),
           pd(e_valid, False))
    dtypes = (torch.long, torch.long, torch.float32, torch.float32,
              torch.float32, torch.float32, torch.bool)
    return tuple(_split(mesh, x, dt) for x, dt in zip(out, dtypes))
