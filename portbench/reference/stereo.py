"""Stereo depth of the left image's keypoints, written plainly from the
specification (ORB-SLAM2's Frame::ComputeStereoMatches as the program
defines it):
- a left keypoint and a right one pair up when they lie within 2 rows,
  0.1-128 px of disparity, on levels at most one apart, are each other's
  fewest descriptor bits apart among such pairs (ties to the first) and
  at most 100 bits apart;
- the pair is refined on the full-size images: an 11×11 window about the
  left keypoint (rounded), less its centre, against the right windows at
  shifts of -5..5 px about the right keypoint (rounded), each less its
  centre, by the sum of absolute differences; a parabola through the
  least sum (not at either end; ties to the first) and its neighbours
  gives the sub-pixel shift, at most 1 px;
- a refinement is kept where its disparity lies in [0.01, 128) and its sum
  is at most 1.5 · 1.4 times the median of the kept sums (the mean of the
  two middle ones); elsewhere the pair keeps its keypoints' disparity;
- depth = bf / disparity.
"""
from __future__ import annotations

import torch

from . import orb
from .track import TH_HIGH, BIG, first_min, hamming

W = 5
L = 5


def depth(left, right, fl: orb.Features, fr: orb.Features,
          bf: float) -> torch.Tensor:
    """(K,) depth of each left keypoint, -1 where none."""
    dt = fl.xy.dtype
    ham = hamming(fl.bits, fr.bits)
    dy = (fl.xy[:, None, 1] - fr.xy[None, :, 1]).abs()
    disp = fl.xy[:, None, 0] - fr.xy[None, :, 0]
    ok = ((dy <= 2.0) & (disp >= 0.1) & (disp <= 128.0)
          & ((fl.octave[:, None] - fr.octave[None, :]).abs() <= 1))
    d = torch.where(ok, ham, BIG)
    best, idx = first_min(d)
    _, back = first_min(d.T)
    paired = (best <= TH_HIGH) & (back[idx] == torch.arange(
        len(idx), device=idx.device))
    coarse = fl.xy[:, 0] - fr.xy[idx, 0]

    left = torch.as_tensor(left).to(fl.xy.device, dt)
    right = torch.as_tensor(right).to(fl.xy.device, dt)
    Hh, Ww = left.shape
    ul, vl = torch.round(fl.xy[:, 0]).long(), torch.round(fl.xy[:, 1]).long()
    ur = torch.round(fr.xy[idx, 0]).long()
    inside = (paired & (ul - W >= 0) & (ul + W < Ww) & (vl - W >= 0)
              & (vl + W < Hh) & (ur - W - L >= 0) & (ur + W + L < Ww))
    ulc, vlc = ul.clamp(W, Ww - W - 1), vl.clamp(W, Hh - W - 1)
    urc = ur.clamp(W + L, Ww - W - L - 1)
    off = torch.arange(-W, W + 1, device=ul.device)
    rows = (vlc[:, None] + off)[:, :, None]
    pl = left[rows, (ulc[:, None] + off)[:, None, :]]
    pl = pl - pl[:, W, W][:, None, None]
    sads = []
    for s in range(-L, L + 1):
        pr = right[rows, (urc[:, None] + s + off)[:, None, :]]
        pr = pr - pr[:, W, W][:, None, None]
        sads.append((pr - pl).abs().sum((1, 2)))
    sad = torch.stack(sads, 1)
    _, k = first_min(sad)
    kc = k.clamp(1, 2 * L - 1)
    d1, d2, d3 = (sad.gather(1, (kc + j)[:, None])[:, 0] for j in (-1, 0, 1))
    den = d1 + d3 - 2 * d2
    delta = torch.where(den.abs() > 1e-6, (d1 - d3) / (2 * den), 0.0)
    fine = fl.xy[:, 0] - (urc + kc - L + delta)
    good = (inside & (k > 0) & (k < 2 * L) & (delta >= -1) & (delta <= 1)
            & (fine >= 0.01) & (fine < 128))
    kept = d2[good].sort().values
    n = len(kept)
    if n:
        med = (kept[(n - 1) // 2] + kept[n // 2]) / 2
        good &= d2 <= 1.5 * 1.4 * med
    disp_out = torch.where(good, fine, coarse)
    has = paired & (good | (coarse > 0)) & (disp_out > 0)
    return torch.where(has, bf / disp_out.clamp(min=1e-6), -1.0)

