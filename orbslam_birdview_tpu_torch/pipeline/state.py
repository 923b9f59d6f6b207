"""Carry tracking state across from the JAX package to the port.

The JAX package's state reaches this module as numpy arrays and plain
values (`np.asarray` of its device arrays, `_asdict()` of its NamedTuple
configurations); nothing of that package is imported. The result is the
port's containers on one device, with the dtypes the port's step expects,
so both packages can compute on the same state. The system has no trained
weights; the BoW vocabulary belongs to loop closing and is not carried.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import BirdviewCamera
from ..frontend.orb import ORBConfig
from .fused_track import BirdMapDevice, LocalMapDevice

_F32 = torch.float32


def _t(x, dtype, dev):
    return torch.as_tensor(np.asarray(x), device=dev).to(dtype).contiguous()


def local_map_device(pos, normal, min_dist, max_dist, valid, desc_u8,
                     device=None) -> LocalMapDevice:
    """The front camera's candidate bundle (`fused_track.LocalMapDevice`)."""
    dev = resolve_device(device)
    return LocalMapDevice(_t(pos, _F32, dev), _t(normal, _F32, dev),
                          _t(min_dist, _F32, dev), _t(max_dist, _F32, dev),
                          _t(valid, torch.bool, dev),
                          _t(desc_u8, torch.uint8, dev))


def bird_map_device(pos, valid, desc_u8, device=None) -> BirdMapDevice:
    """The ground-landmark bundle (`fused_track.BirdMapDevice`)."""
    dev = resolve_device(device)
    return BirdMapDevice(_t(pos, _F32, dev), _t(valid, torch.bool, dev),
                         _t(desc_u8, torch.uint8, dev))


class TrackState(NamedTuple):
    """Everything `track_step_mono` takes besides the images and poses."""

    lm: LocalMapDevice
    scale_factors: torch.Tensor   # (L,) f32
    inv_sigma2: torch.Tensor      # (L,) f32
    cfg: ORBConfig
    bird_lm: Optional[BirdMapDevice] = None
    bird_cfg: Optional[ORBConfig] = None
    bv: Optional[BirdviewCamera] = None
    R_bc: Optional[torch.Tensor] = None   # (3,3) camera -> base
    t_bc: Optional[torch.Tensor] = None   # (3,)

    def to(self, device) -> "TrackState":
        """The same state on another device."""
        def move(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            if isinstance(v, (LocalMapDevice, BirdMapDevice)):
                return type(v)(*(f.to(device) for f in v))
            return v
        return TrackState(*(move(v) for v in self))


def carry_across(lm: Mapping, scale_factors, inv_sigma2, cfg: Mapping, *,
                 bird_lm: Optional[Mapping] = None,
                 bird_cfg: Optional[Mapping] = None,
                 bv: Optional[Mapping] = None, R_bc=None, t_bc=None,
                 device=None) -> TrackState:
    """Build the port's tracking state from the JAX package's.

    `lm` and `bird_lm` map the bundle field names to numpy arrays (e.g.
    `{k: np.asarray(v) for k, v in jax_lm._asdict().items()}`); `cfg`,
    `bird_cfg` and `bv` are the field dicts of the JAX package's
    `ORBConfig` and `BirdviewCamera`."""
    dev = resolve_device(device)
    bird = {}
    if bird_lm is not None:
        bird = dict(bird_lm=bird_map_device(**bird_lm, device=dev),
                    bird_cfg=ORBConfig(**bird_cfg),
                    bv=BirdviewCamera(**bv),
                    R_bc=_t(R_bc, _F32, dev), t_bc=_t(t_bc, _F32, dev))
    return TrackState(lm=local_map_device(**lm, device=dev),
                      scale_factors=_t(scale_factors, _F32, dev),
                      inv_sigma2=_t(inv_sigma2, _F32, dev),
                      cfg=ORBConfig(**cfg), **bird)
