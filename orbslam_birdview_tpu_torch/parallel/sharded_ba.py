"""Distributed global bundle adjustment over a mesh of shards
(`runtime.Mesh`).

Landmarks and their observation edges are partitioned into map blocks,
one block per shard; cameras are replicated. Each shard assembles its
local Schur contributions on its own device; the reduced camera system is
summed over the shards (`Mesh.psum`), solved ONCE on the mesh's first
device and the step copied to the other shards' devices (the JAX package
solves the replicated system on every device: the inputs are identical,
so are the numbers). Landmark updates stay local: only (C,6) and (C,6,6)
tensors cross shards.

`sharded_global_ba` is the full-map protocol over mono, stereo and bird
edges (two Huber phases, chi² re-classification, final masks against the
original edge sets) on the matrix-free step: the loop is
`graph/ba_large.solve_global`, of which the one-device
`bundle_adjust_large` is the one-shard case. This module partitions the
map (`partition_gba_problem`), places it on the mesh
(`place_gba_problem`) and scatters the masks back (`scatter_mask`).

A sharded array is a list with one tensor per local shard.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph import ba_large
from ..graph.ba import EdgeSet
from .runtime import Mesh


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _split(mesh: Mesh, x, dtype):
    """This process's shards of the global array `x` (split evenly along
    axis 0 over every shard of the mesh), each on its shard's device."""
    x = torch.from_numpy(np.array(_np(x))).to(dtype)
    n = mesh.n_shards
    if x.shape[0] % n:
        raise ValueError(f"axis 0 of length {x.shape[0]} does not split "
                         f"over {n} shards")
    per = x.shape[0] // n
    g0 = mesh.first_shard
    return [x[(g0 + i) * per:(g0 + i + 1) * per].to(d)
            for i, d in enumerate(mesh.devices)]


def _edges_split(mesh: Mesh, es):
    fields = [_split(mesh, f, dt) for f, dt in zip(
        es, (torch.long, torch.long, torch.float32, torch.float32,
             torch.bool))]
    return [EdgeSet(*parts) for parts in zip(*fields)]


def _rep(mesh: Mesh, x, dtype):
    return torch.from_numpy(np.array(_np(x))).to(dtype).to(mesh.devices[0])


def _gather(mesh, parts):
    """The local shards of a sharded array, concatenated on the first
    device (the global order for a one-process mesh)."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def sharded_global_ba(mesh: Mesh, cam_R, cam_t, cam_fixed, cam_valid,
                      points, pt_valid, mono, stereo, bird,
                      fx, fy, cx, cy, bf: float = 0.0,
                      iters_phase1: int = 5, iters_phase2: int = 10,
                      reclassify: bool = True, cg_iters: int = 48):
    """Full-protocol distributed global BA over ALL edge types: the sharded
    counterpart of `ba_large.bundle_adjust_large`, landmarks + edges in
    map blocks over the mesh, one (C,6) reduction per CG step.

    Inputs as `place_gba_problem` returns them: cameras on the first
    device; points, pt_valid and each edge set (or None) lists with one
    entry per local shard, `pt` LOCAL. Returns (cam_R, cam_t, points,
    masks {kind: (E_shards,)}, final cost), points and masks the local
    shards concatenated on the first device."""
    kinds = [k for k, es in (("mono", mono), ("stereo", stereo),
                             ("bird", bird)) if es is not None]
    lists = [es for es in (mono, stereo, bird) if es is not None]
    if not lists:
        raise ValueError("no edge sets")
    shard_sets = [list(zip(kinds, shard)) for shard in zip(*lists)]
    R, t, pts, masks, cost = ba_large.solve_global(
        mesh, cam_R, cam_t, cam_fixed, cam_valid, points, pt_valid,
        shard_sets, (fx, fy, cx, cy, bf), iters_phase1, iters_phase2,
        reclassify, cg_iters)
    return (R, t, _gather(mesh, pts),
            {k: _gather(mesh, [m[i] for m in masks])
             for i, k in enumerate(kinds)}, cost)


# ---------------------------------------------------------------------------
# partition and placement
# ---------------------------------------------------------------------------

def partition_gba_problem(n_dev: int, points, pt_valid, edge_sets):
    """Host-side partitioner: pad points to a multiple of n_dev (contiguous
    block sharding) and regroup every edge set so shard k's edges reference
    shard k's points via LOCAL indices, each shard padded to the same edge
    count.

    edge_sets: list of (kind, EdgeSet with GLOBAL pt indices, or None), of
    numpy arrays or tensors. Returns (points_padded, pt_valid_padded,
    {kind: (EdgeSet of numpy arrays, perm)}, P_padded) where perm maps the
    regrouped edge order back to the caller's edge order (−1 for padding
    slots): use it to scatter inlier masks back."""
    points, pt_valid = _np(points), _np(pt_valid)
    P_total = points.shape[0]
    P_pad = ((P_total + n_dev - 1) // n_dev) * n_dev
    points_p = np.zeros((P_pad, 3), np.float32)
    points_p[:P_total] = points
    pt_valid_p = np.zeros(P_pad, bool)
    pt_valid_p[:P_total] = pt_valid
    per = P_pad // n_dev
    out = {}
    for kind, es in edge_sets:
        if es is None:
            out[kind] = None
            continue
        cam, pt, obs, info, valid = (_np(f) for f in es)
        valid = valid.astype(bool)
        shard = np.clip(pt, 0, P_pad - 1) // per
        # padding / invalid edges can go anywhere; spread them evenly so
        # the per-shard cap stays tight
        shard = np.where(valid, shard, np.arange(len(pt)) % n_dev)
        counts = np.bincount(shard, minlength=n_dev)
        cap = max(int(counts.max()) if len(counts) else 1, 1)
        perm = np.full(cap * n_dev, -1, np.int64)
        order = np.argsort(shard, kind="stable")
        off = 0
        for s in range(n_dev):
            k = counts[s]
            perm[s * cap: s * cap + k] = order[off:off + k]
            off += k
        sel = np.maximum(perm, 0)
        out[kind] = (EdgeSet(cam[sel].astype(np.int32),
                             (pt[sel] % per).astype(np.int32),
                             obs[sel].astype(np.float32),
                             info[sel].astype(np.float32),
                             valid[sel] & (perm >= 0)), perm)
    return points_p, pt_valid_p, out, P_pad


def place_gba_problem(mesh: Mesh, cam_R, cam_t, cam_fixed, cam_valid,
                      points_p, pt_valid_p, partitioned):
    """A `partition_gba_problem` output on the mesh: cameras on its first
    device, this process's shards of points and edges on their devices.
    Returns (cam_R, cam_t, cam_fixed, cam_valid, [points], [pt_valid],
    {kind: ([EdgeSet] or None, perm)})."""
    edges = {}
    for kind, v in partitioned.items():
        if v is None:
            edges[kind] = (None, None)
        else:
            es, perm = v
            edges[kind] = (_edges_split(mesh, es), perm)
    return (_rep(mesh, cam_R, torch.float32), _rep(mesh, cam_t, torch.float32),
            _rep(mesh, cam_fixed, torch.bool),
            _rep(mesh, cam_valid, torch.bool),
            _split(mesh, points_p, torch.float32),
            _split(mesh, pt_valid_p, torch.bool), edges)


def scatter_mask(mask, perm, n_edges: int) -> np.ndarray:
    """An inlier mask of a partitioned edge set back in the caller's edge
    order (`perm` from `partition_gba_problem`)."""
    mask, perm = _np(mask), np.asarray(perm)
    out = np.zeros(n_edges, bool)
    keep = perm >= 0
    out[perm[keep]] = mask[keep]
    return out

