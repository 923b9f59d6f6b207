"""The one scatter sum of the port's solvers: per-edge values summed into
their targets, out[index[e]] += values[e].

The edges are sorted by target ONCE per problem (they stay fixed across LM
and CG iterations) and summed with a segment sum over the sorted values:
each target's edges are summed in edge order, on the CPU and on the GPU
alike, which is also `index_add_`'s order on the CPU. A BA or a pose graph
run twice on the card therefore gives the same bits, where `index_add_`'s
atomic adds on CUDA moved a fixed-length LM to another place between runs.
Measured against `index_add_` on an NVIDIA H100 at no cost beyond the
host's noise (PERF.md).
"""
from __future__ import annotations

import torch


class SegmentSum:
    """The target layout of one edge list. `index` (E,) holds target ids
    in [0, n); calling the layout with values (E, …) gives (n, …)."""

    def __init__(self, index, n: int):
        index = index.long()
        self.n = n
        self.order = torch.argsort(index, stable=True)
        # integer counts sum exactly in any order; no host sync (a
        # bincount reads the maximum on the host)
        self.lengths = torch.zeros(n, dtype=torch.long,
                                   device=index.device).index_add_(
            0, index, torch.ones_like(index))

    def __call__(self, values):
        return torch.segment_reduce(values[self.order], "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True)
