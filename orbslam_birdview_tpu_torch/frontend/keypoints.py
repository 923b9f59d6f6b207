"""Fixed-capacity keypoint/descriptor containers.

Every frame produces exactly `capacity` slots with a validity mask;
downstream ops are masked, never ragged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Keypoints(NamedTuple):
    """A padded batch of keypoints for one image.

    xy:        (K, 2) float32 — level-0 pixel coords (x=col, y=row)
    response:  (K,)  float32 — detector response (−inf for padding)
    angle:     (K,)  float32 — orientation in radians [0, 2π)
    octave:    (K,)  int32   — pyramid level
    valid:     (K,)  bool
    desc_u8:   (K, 32) uint8 — 256-bit BRIEF, OpenCV byte/bit order
    desc_pm1:  (K, 256) int8 — same bits as a ±1 vector
    """

    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    octave: torch.Tensor
    valid: torch.Tensor
    desc_u8: torch.Tensor
    desc_pm1: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def count(self):
        return self.valid.sum(dtype=torch.int32)


def _bit_weights(device):
    return torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                        device=device)


def unpack_bits_to_pm1(desc_u8):
    """(…,32) uint8 -> (…,256) int8 in {−1,+1}; bit k of byte j -> 8j+k
    (little-endian, as numpy's bitorder="little")."""
    bits = (desc_u8[..., None] & _bit_weights(desc_u8.device)) != 0
    bits = bits.reshape(*desc_u8.shape[:-1], desc_u8.shape[-1] * 8)
    return bits.to(torch.int8) * 2 - 1


def pack_bits(bits):
    """(…,8n) bool -> (…,n) uint8, little-endian within each byte."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    return (b * _bit_weights(bits.device)).sum(dim=-1, dtype=torch.uint8)


def pack_pm1_to_bits(pm1):
    return pack_bits(pm1 > 0)
