"""Shared set-up of the port's mid-run parity tests: the half-size bird
drive of `test_torch_init_map.py` in both packages' configurations, a port
`System` run on the CPU to a chosen moment, and the port's store carried
into the JAX package's `MapStore` (the other direction of
`state.map_store`), so that both packages compute on the same map.
"""
import copy

import jax.numpy as jnp
import numpy as np
import torch

from orbslam_birdview_tpu.api.config import SlamConfig as JSlamConfig
from orbslam_birdview_tpu.core import camera as jcam
from orbslam_birdview_tpu.core import lie as jlie
from orbslam_birdview_tpu.frontend import orb as jorb
from orbslam_birdview_tpu.mapping.mapstore import MapStore as JMapStore
from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.core.camera import BirdviewCamera, PinholeCamera
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.pipeline import state
from orbslam_birdview_tpu_torch.utils import synth

SCALE = 0.5
CAM = PinholeCamera(fx=348.5 * SCALE, fy=347.0 * SCALE, cx=480.0 * SCALE,
                    cy=302.0 * SCALE, width=475, height=200)
BV = BirdviewCamera(pixel2meter=0.03984 * 1.7 / SCALE, width=192, height=192)
ORB = dict(n_features=1000, n_levels=4, min_threshold=5.0)
BIRD_ORB = dict(n_features=1000, n_levels=4)
# a smaller local-BA window than the default 32 + 16 keeps the CPU tests
# quick; both packages get the same value
BA_WINDOW, BA_FIXED = 8, 4


def one_torch_thread():
    """Generator for a module-scoped fixture: torch computes on one thread
    while the module runs. These tests run many small eager ops, which the
    intra-op pool only slows down when several test processes share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def make_cfgs(seq):
    """(JAX config, port config) of the drive, field for field equal."""
    quat = tuple(np.asarray(jlie.rot_to_quat(jnp.asarray(seq.R_bc))).tolist())
    out = []
    for cfg_cls, cam, orb_cls, bv in (
            (JSlamConfig, jcam.PinholeCamera(**CAM._asdict()), jorb.ORBConfig,
             jcam.BirdviewCamera(**BV._asdict())),
            (SlamConfig, CAM, ORBConfig, BV)):
        cfg = cfg_cls(camera=cam, orb=orb_cls(**ORB),
                      bird_orb=orb_cls(**BIRD_ORB), sensor="mono_bird",
                      birdview=bv)
        cfg.tbc_quat, cfg.tbc_t = quat, tuple(seq.t_bc.tolist())
        cfg.mapping.local_ba_window = BA_WINDOW
        cfg.mapping.local_ba_fixed = BA_FIXED
        out.append(cfg)
    return tuple(out)


def drive(n_frames):
    seq = synth.BirdSequence(CAM, BV, n_frames=n_frames)
    frames = [seq.frame(i) for i in range(n_frames)]
    return seq, frames, synth.footprint_mask(BV)


def run_port(cfg, frames, mask, stop, loop_closing=False):
    """A port System fed the frames on the CPU until `stop(system)` holds
    after a frame; returns (system, index of the last frame fed)."""
    system = System(cfg, enable_loop_closing=loop_closing, device="cpu")
    for i, (img, bev, _) in enumerate(frames):
        system.track_monocular_with_birdview(img, bev, mask, i / 25.0)
        if stop(system):
            return system, i
    raise AssertionError("the drive ended before the moment was reached")


def copy_store(store):
    """An independent copy of a port store."""
    return state.map_store(copy.deepcopy(vars(store)))


def jax_store(store):
    """The JAX package's `MapStore` holding a copy of a port store's
    arrays, counters and loop edges."""
    js = JMapStore(**{k: int(getattr(store, k)) for k in
                      ("max_kf", "max_mp", "max_bmp", "kp_cap", "bird_cap")})
    for k, v in vars(store).items():
        if isinstance(v, np.ndarray):
            setattr(js, k, v.copy())
        elif k in type(store)._SCALARS:
            setattr(js, k, int(v))
    js.loop_edges = list(store.loop_edges)
    return js


def assert_stores_agree(ps, js, pos_tol=1e-3, exact=True):
    """Every array of the two stores: equal, or for positions and poses
    within pos_tol (metres, rotation entries)."""
    close = ("kf_R", "kf_t", "mp_pos", "bmp_pos", "mp_normal", "mp_min_dist",
             "mp_max_dist")
    assert (ps.n_kf, ps.n_mp, ps.n_bmp) == (js.n_kf, js.n_mp, js.n_bmp)
    for name, v in vars(js).items():
        if not isinstance(v, np.ndarray):
            continue
        got = getattr(ps, name)
        assert got.shape == v.shape, name
        if name in close:
            tol = pos_tol * (10 if "dist" in name else 1)
            np.testing.assert_allclose(got, v, atol=tol, rtol=3e-3,
                                       err_msg=name)
        elif exact:
            np.testing.assert_array_equal(got, v, err_msg=name)
