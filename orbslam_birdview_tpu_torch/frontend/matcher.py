"""Descriptor matching as batched tensor ops.

Two distance paths, both exact:

- matmul path: descriptors as ±1 vectors; hamming = (256 − a·b)/2. CUDA
  has no int8 `torch.matmul`, so the product runs in f32 with TF32 off
  (the package turns it off when imported). Every product is ±1 and every
  partial sum an integer of magnitude ≤ 256, all exactly representable in
  f32, so the result is exact in any summation order. This is the
  reference's int8 MXU matmul, which the JAX package also leaves to XLA
  outside any Pallas kernel.
- packed path: XOR + popcount on the packed uint8 words (a 256-entry
  lookup table; torch has no popcount).

Thresholds mirror ORBmatcher: TH_LOW=50, TH_HIGH=100, rotation histogram
with 30 bins / top-3 maxima. Ties go to the lowest index everywhere.
"""
from __future__ import annotations

import functools
import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
INVALID = -1
BIG_DIST = 1 << 14


def hamming_matrix(desc_a_pm1, desc_b_pm1, valid_a=None, valid_b=None):
    """(…,Na,256)±1 × (…,Nb,256)±1 -> (…,Na,Nb) int32 hamming distances,
    leading dimensions broadcast. Invalid rows/cols get BIG_DIST."""
    dot = torch.matmul(desc_a_pm1.to(torch.float32),
                       desc_b_pm1.to(torch.float32).mT).to(torch.int32)
    dist = torch.div(256 - dot, 2, rounding_mode="floor")
    if valid_a is not None:
        dist = torch.where(valid_a[..., :, None], dist, BIG_DIST)
    if valid_b is not None:
        dist = torch.where(valid_b[..., None, :], dist, BIG_DIST)
    return dist


@functools.lru_cache(maxsize=None)
def _popcount_table(device: torch.device):
    return torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.int32, device=device)


def hamming_matrix_popcount(desc_a_u8, desc_b_u8):
    """Packed-bits path: (Na,32)u8 × (Nb,32)u8 -> (Na,Nb) int32."""
    x = torch.bitwise_xor(desc_a_u8[:, None, :], desc_b_u8[None, :, :])
    return _popcount_table(x.device)[x.long()].sum(dim=-1, dtype=torch.int32)


def rotation_consistency_mask(angle_a, angle_b, idx_ab, matched):
    """Keep only matches whose angle difference falls in the 3 fullest of 30
    histogram bins (`ORBmatcher::ComputeThreeMaxima`)."""
    dth = angle_a - angle_b[idx_ab]
    dth = torch.remainder(dth, 2 * math.pi)
    bins = torch.floor(dth * (HISTO_BINS / (2 * math.pi))).to(torch.int64)
    bins = torch.clamp(bins, 0, HISTO_BINS - 1)
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=bins.device)
    hist = hist.scatter_add(0, bins, matched.to(torch.int32))
    top3 = torch.topk(hist, 3).values
    # the reference drops bins 2/3 if much smaller than the max (<0.1·max)
    maxv = top3[0]
    keep = ((hist == top3[0])
            | ((hist == top3[1]) & (top3[1] > 0.1 * maxv))
            | ((hist == top3[2]) & (top3[2] > 0.1 * maxv)))
    keep = keep & (hist > 0)
    return matched & keep[bins]


def _pack_shift(n: int) -> int:
    """Bits needed to pack an index 0..n−1 alongside a distance value."""
    return max(12, (n - 1).bit_length())


def _packed_min(dist, axis: int):
    """(min, argmin) along `axis` in one reduction by packing
    (dist << s) | index; ties go to the lowest index. Distances must be
    < 2^(31−s) (hamming ≤ BIG_DIST). `axis` counts from the front of a
    2-D (Na,Nb) matrix; leading batch dimensions are allowed."""
    axis = axis - 2 if axis >= 0 else axis     # -2: over a, -1: over b
    n = dist.shape[axis]
    shift = _pack_shift(n)
    iota = torch.arange(n, dtype=torch.int32, device=dist.device)
    iota = iota if axis == -1 else iota[:, None]
    m = torch.amin((dist << shift) | iota, dim=axis)
    return m >> shift, m & ((1 << shift) - 1)


def match_mutual(dist, max_dist: int = TH_LOW, ratio: float = 1.0):
    """Mutual-best match with Lowe ratio test on (…,Na,Nb) distances.
    Returns (idx (…,Na) int32 into b or −1, best_dist (…,Na) int32)."""
    best, idx = _packed_min(dist, axis=1)
    if ratio < 1.0:
        shift = _pack_shift(dist.shape[-1])
        comb = (dist << shift) | torch.arange(
            dist.shape[-1], dtype=torch.int32, device=dist.device)
        m = (best << shift) | idx
        second = torch.amin(
            torch.where(comb == m[..., None], BIG_DIST << shift, comb),
            dim=-1) >> shift
        ok_ratio = best.to(torch.float32) < ratio * second.to(torch.float32)
    else:
        ok_ratio = torch.ones_like(best, dtype=torch.bool)
    _, arg_b = _packed_min(dist, axis=0)
    mutual = torch.take_along_dim(arg_b, idx.long(), dim=-1) == torch.arange(
        dist.shape[-2], dtype=torch.int32, device=dist.device)
    ok = (best <= max_dist) & ok_ratio & mutual
    return torch.where(ok, idx, INVALID), best


def match_window(xy_a, xy_b, dist, radius, max_dist: int = TH_LOW,
                 ratio: float = 0.9, mutual: bool = True):
    """Windowed match: only pairs within `radius` pixels."""
    d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, dim=-1)
    dist = torch.where(d2 <= radius * radius, dist, BIG_DIST)
    return match_mutual(dist, max_dist=max_dist,
                        ratio=ratio if mutual else 1.0)


def search_by_projection(proj_uv, pt_valid, pt_desc_pm1, kp_xy, kp_octave,
                         kp_valid, kp_desc_pm1, radius_per_point,
                         pred_octave=None, octave_window: int = 1,
                         max_dist: int = TH_HIGH):
    """Project-and-match: map points with predicted pixel positions vs frame
    keypoints (`ORBmatcher::SearchByProjection`).
    Returns (idx (M,) into keypoints or −1, dist (M,))."""
    dist = hamming_matrix(pt_desc_pm1, kp_desc_pm1, pt_valid, kp_valid)
    d2 = torch.sum((proj_uv[:, None, :] - kp_xy[None, :, :]) ** 2, dim=-1)
    ok = d2 <= (radius_per_point[:, None] ** 2)
    if pred_octave is not None:
        ok = ok & ((kp_octave[None, :] - pred_octave[:, None]).abs()
                   <= octave_window)
    dist = torch.where(ok, dist, BIG_DIST)
    best, idx = _packed_min(dist, axis=1)
    return torch.where(best <= max_dist, idx, INVALID), best


def resolve_duplicate_targets(idx, score, n_tgt: int | None = None):
    """Several sources may claim the same target; keep the best (lowest
    score) per target, ties to the lowest source, and invalidate the rest.

    The per-target table holds max(n_src, n_tgt) + 1 slots. The reference
    sizes it by the source count alone, so a target index above n_src is
    silently dropped there; callers that know the target count pass it."""
    n_src = idx.shape[0]
    size = max(n_src, n_tgt or 0) + 1
    valid = idx >= 0
    tgt = torch.where(valid, idx, 0).long()
    sc = torch.where(valid, score, BIG_DIST).to(score.dtype)
    best_per_tgt = torch.full((size,), BIG_DIST, dtype=score.dtype,
                              device=idx.device)
    best_per_tgt = best_per_tgt.scatter_reduce(0, tgt, sc, reduce="amin")
    is_best = valid & (sc == best_per_tgt[tgt])
    src_ids = torch.arange(n_src, dtype=torch.int32, device=idx.device)
    first_src = torch.full((size,), n_src, dtype=torch.int32, device=idx.device)
    first_src = first_src.scatter_reduce(
        0, tgt, torch.where(is_best, src_ids, n_src), reduce="amin")
    keep = is_best & (first_src[tgt] == src_ids)
    return torch.where(keep, idx, INVALID)
