"""Carry state across from the JAX package to the port.

The JAX package's state reaches this module as numpy arrays and plain
values (`np.asarray` of its device arrays, `_asdict()` of its NamedTuple
configurations); nothing of that package is imported. The result is the
port's containers on one device, with the dtypes the port's step expects,
so both packages can compute on the same state: the fused step's bundles,
keypoints and frames (with their associations and pose), the map store
(from another store's fields, or from a file the other package saved:
`MapStore.load` reads the shared format), the tracker's and the local
mapper's mid-run fields, the BA problem, and (the other way) an
initialization or a PnP result as numpy. The system has no trained
weights; the BoW vocabulary belongs to loop closing and is not carried.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.camera import BirdviewCamera
from ..frontend.keypoints import Keypoints
from ..frontend.orb import ORBConfig
from ..graph import ba
from ..mapping.mapstore import MapStore
from ..solvers.initializer import InitResult
from ..solvers.pnp import PnPResult
from .frame import FrameData
from .fused_track import BirdMapDevice, LocalMapDevice

_F32 = torch.float32


def _t(x, dtype, dev):
    return torch.as_tensor(np.array(x), device=dev).to(dtype).contiguous()


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


# ---------------------------------------------------------------------------
# initialization: keypoints, frames, the map store, the BA problem
# ---------------------------------------------------------------------------

def keypoints_from_numpy(fields: Mapping, device=None) -> Keypoints:
    """`Keypoints` on `device` from the JAX package's, given as a mapping
    of its field names to numpy arrays."""
    dev = resolve_device(device)
    dtypes = dict(xy=_F32, response=_F32, angle=_F32, octave=torch.int32,
                  valid=torch.bool, desc_u8=torch.uint8, desc_pm1=torch.int8)
    return Keypoints(**{k: _t(fields[k], dt, dev) for k, dt in dtypes.items()})


def frame_from_numpy(frame_id: int, timestamp: float, kp: Mapping,
                     bird_kp: Optional[Mapping] = None, bird_base_xyz=None,
                     device=None, kp_mp=None, bird_mp=None, R=None, t=None,
                     pose_ok: bool = False, kp_depth=None,
                     kp_ur=None) -> FrameData:
    """A `FrameData` from the JAX package's frame: its keypoints as numpy,
    in bird mode its BEV keypoints and their base-frame points, with a
    depth sensor its keypoints' depth and right-image u, and, for a frame
    met mid-run, its associations (kp_mp, bird_mp), pose and pose_ok.
    Without them the frame is fresh: identity pose, no associations, not
    tracked."""
    dev = resolve_device(device)
    kpt = keypoints_from_numpy(kp, dev)
    fd = FrameData(frame_id=frame_id, timestamp=timestamp, kp=kpt,
                   R=np.eye(3, dtype=np.float32) if R is None
                   else np.array(R, np.float32),
                   t=np.zeros(3, np.float32) if t is None
                   else np.array(t, np.float32),
                   kp_mp=np.full(kpt.capacity, -1, np.int64) if kp_mp is None
                   else np.array(kp_mp, np.int64))
    fd.pose_ok = pose_ok
    if kp_depth is not None:
        fd.kp_depth = np.array(kp_depth, np.float32)
        fd.kp_ur = np.array(kp_ur, np.float32)
    if bird_kp is not None:
        fd.bird_kp = keypoints_from_numpy(bird_kp, dev)
        fd.bird_base_xyz = np.array(bird_base_xyz, np.float32)
        fd.bird_mp = (np.full(fd.bird_kp.capacity, -1, np.int64)
                      if bird_mp is None else np.array(bird_mp, np.int64))
    return fd


# the tracker's fields the slow path and the keyframe policy read
TRACKER_FIELDS = ("state", "ref_kf", "velocity", "last_kf_frame_id",
                  "last_reloc_frame_id", "_kf_suppress_before", "frame_id",
                  "_n_last_inliers")


def tracker_fields(tracker) -> dict:
    """The fields of TRACKER_FIELDS of a tracker of either package, as
    plain values and numpy."""
    out = {}
    for k in TRACKER_FIELDS:
        v = getattr(tracker, k)
        out[k] = None if v is None else (np.array(v) if isinstance(
            v, np.ndarray) else int(v))
    return out


def set_tracker_state(tracker, fields: Mapping, last_frame=None,
                      trajectory=()):
    """Give a port `Tracker` the mid-run state of another: the fields of
    TRACKER_FIELDS (`tracker_fields` of the other tracker), its last frame
    (a `FrameData` from `frame_from_numpy`) and its trajectory entries
    (timestamp, ref_kf, T_rel, lost, frame_id)."""
    from .tracking import TrajectoryEntry

    for k in TRACKER_FIELDS:
        v = fields[k]
        setattr(tracker, k, None if v is None else (
            np.array(v, np.float32) if k == "velocity" else int(v)))
    tracker.last_frame = last_frame
    tracker.trajectory = [TrajectoryEntry(float(e.timestamp), int(e.ref_kf),
                                          np.array(e.T_rel, np.float32),
                                          bool(e.lost), int(e.frame_id))
                          for e in trajectory]
    return tracker


# the local mapper's queue and deterministic-schedule ticks
MAPPER_FIELDS = ("_frame_tick", "_stage_tick", "_ba_tick", "recent_mp",
                 "_kf_queue")


def set_mapper_state(mapper, other):
    """Give a port `LocalMapper` the queue, ticks and recent points of
    another mapper with no stage or BA in flight."""
    if other._kf_stage is not None or other._ba_pending is not None:
        raise ValueError("a mapper with work in flight cannot be carried "
                         "across: drain it first")
    mapper._frame_tick = int(other._frame_tick)
    mapper._stage_tick = int(other._stage_tick)
    mapper._ba_tick = int(other._ba_tick)
    mapper.recent_mp = [(int(a), int(b)) for a, b in other.recent_mp]
    mapper._kf_queue.clear()
    mapper._kf_queue.extend(int(k) for k in other._kf_queue)
    return mapper


def map_store(fields: Mapping) -> MapStore:
    """A `MapStore` from another store's attribute dictionary (e.g.
    `vars(jax_store)`): every numpy array is copied, the counters and
    capacities taken over, the loop edges rebuilt."""
    store = MapStore(**{k: int(fields[k]) for k in
                        ("max_kf", "max_mp", "max_bmp", "kp_cap", "bird_cap")})
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            setattr(store, k, v.copy())
        elif k in MapStore._SCALARS:
            setattr(store, k, int(v))
    store.loop_edges = [tuple(int(x) for x in e)
                        for e in fields.get("loop_edges", [])]
    return store


def edge_set(fields, device=None) -> ba.EdgeSet:
    """`ba.EdgeSet` from the JAX package's (cam, pt, obs, info, valid), as
    numpy."""
    dev = resolve_device(device)
    cam, pt, obs, info, valid = fields
    return ba.EdgeSet(_t(cam, torch.int32, dev), _t(pt, torch.int32, dev),
                      _t(obs, _F32, dev), _t(info, _F32, dev),
                      _t(valid, torch.bool, dev))


def ba_problem(problem, device=None):
    """The tuple `LocalMapper._gather_ba_problem` returns, from the JAX
    package's (its arrays as numpy): the same 15 entries with the camera,
    point and edge arrays on `device`."""
    dev = resolve_device(device)
    (all_kfs, cam_R, cam_t, fixed, cam_valid, points, pvalid, mono_es,
     stereo_es, bird_es, mp_ids, bmp_ids, n_mp, n_bmp, n_mono) = problem
    return (np.asarray(all_kfs), _t(cam_R, _F32, dev), _t(cam_t, _F32, dev),
            _t(fixed, torch.bool, dev), _t(cam_valid, torch.bool, dev),
            _t(points, _F32, dev), _t(pvalid, torch.bool, dev),
            edge_set(mono_es, dev), edge_set(stereo_es, dev),
            edge_set(bird_es, dev), np.asarray(mp_ids), np.asarray(bmp_ids),
            int(n_mp), int(n_bmp), int(n_mono))


def pnp_result_numpy(res) -> PnPResult:
    """A `PnPResult` with numpy fields (ok and n_inliers as Python values),
    from tensors on any device or from the JAX package's arrays."""
    ok, R, t, inl, n = (f.detach().cpu().numpy() if isinstance(
        f, torch.Tensor) else np.asarray(f) for f in res)
    return PnPResult(bool(ok), R.astype(np.float32), t.astype(np.float32),
                     inl.astype(bool), int(n))


def init_result_numpy(res: InitResult) -> InitResult:
    """An `InitResult` with numpy fields, from tensors on any device or
    from the JAX package's arrays."""
    return InitResult(*(f.detach().cpu().numpy()
                        if isinstance(f, torch.Tensor) else np.asarray(f)
                        for f in res))
