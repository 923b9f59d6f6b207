"""Batched RANSAC utilities.

All hypotheses are generated and scored in one shot: (n_hyp, k) index sets
are sampled from the valid matches, the minimal solver runs over the
leading hypothesis dimension, every hypothesis is scored against every
correspondence as one (n_hyp, N) tensor, and the first maximum wins.

The sampler is split in two so that runs are reproducible across packages
and devices: `draw` makes raw non-negative int32 draws from an explicit
`torch.Generator`, and `minimal_sets_from_draws` is a pure function of the
draws. Every fit function takes either a generator or the draws.
"""
from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


def draw(generator: torch.Generator, n_hyp: int, k: int, device):
    """(n_hyp, k) int32 draws in [0, INT32_MAX) on `device`. The draws are
    made on the generator's own device, so a CPU generator gives the same
    hypothesis sets on the CPU and on the GPU."""
    u = torch.randint(0, INT32_MAX, (n_hyp, k), generator=generator,
                      device=generator.device, dtype=torch.int32)
    return u.to(device)


def minimal_sets_from_draws(u, valid, k: int):
    """Map draws u (n_hyp, k) to indices of True entries of `valid`.

    Fixed-shape: entries come from the compacted valid prefix (a stable
    valid-first argsort); with fewer than k valid items every hypothesis is
    marked invalid. Duplicates within a set are possible and vanishingly
    rare for n >> k; such a hypothesis scores as degenerate and loses."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    n_valid = valid.sum(dtype=torch.int32)
    idx_in_valid = u % torch.clamp(n_valid, min=1)
    idx = order[idx_in_valid.long()]
    return idx, (n_valid >= k).expand(u.shape[0])


def sample_minimal_sets(source, valid, n_hyp: int, k: int):
    """(n_hyp, k) indices sampled uniformly from the True entries of
    `valid`. `source` is a `torch.Generator` or the (n_hyp, k) draws."""
    if isinstance(source, torch.Generator):
        source = draw(source, n_hyp, k, valid.device)
    if tuple(source.shape) != (n_hyp, k):
        raise ValueError(f"draws of shape {tuple(source.shape)}, "
                         f"expected {(n_hyp, k)}")
    return minimal_sets_from_draws(source.to(valid.device), valid, k)


def first_argmax(x):
    """Index of the FIRST maximum of a 1-D tensor, on the CPU and on CUDA
    alike (ties between hypotheses are the rule for integer inlier counts,
    and the choice must not depend on the device)."""
    n = x.shape[0]
    iota = torch.arange(n, device=x.device)
    first = torch.where(x == x.max(), iota, n).min()
    return first.clamp(max=n - 1)


def best_hypothesis(scores, hyp_valid):
    """First argmax over hypotheses with invalid ones suppressed."""
    s = torch.where(hyp_valid, scores, -torch.inf)
    best = first_argmax(s)
    return best, s[best]
