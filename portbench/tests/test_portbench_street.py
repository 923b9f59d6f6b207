"""The street generator on the CPU: the same seed gives the same drive, no
texture tile recurs along it, and the exact poses are the rig's."""
import numpy as np
import pytest
import torch

from portbench import cells
from portbench.tests import smallcell
from portbench.traffic import street

SEED = 2 ** 31 + 977


def _drive(config, seed, n=4, scale=0.25):
    conf = smallcell.scaled(config, scale)
    traffic = cells.load("traffic", "street_4mps")
    return street.render(traffic, cells.rig(conf), conf["Camera.fps"], n,
                         seed, "cpu"), conf


@pytest.mark.parametrize("config", ["fisheye_birdview", "kitti_stereo"])
def test_same_seed_same_drive(config):
    a, _ = _drive(config, SEED)
    b, _ = _drive(config, SEED)
    c, _ = _drive(config, SEED + 1)
    for x, y in ((a.front, b.front), (a.right, b.right), (a.bev, b.bev)):
        if x is not None:
            assert x.dtype == np.uint8 and np.array_equal(x, y)
    assert np.array_equal(a.Tcw, b.Tcw)
    assert not np.array_equal(a.front, c.front)
    # every seed drives the same distance
    assert a.base_xy_yaw[-1, 0] == c.base_xy_yaw[-1, 0]


def test_no_texture_tile_repeats():
    traffic = cells.load("traffic", "street_3mps")
    s = street.Street(traffic, x_end=60.0, seed=SEED, device="cpu")
    for tex in (s.facades, s.ground):
        flat = tex.reshape(tex.shape[0], -1).double()
        flat = flat - flat.mean(1, keepdim=True)
        flat = flat / flat.norm(dim=1, keepdim=True)
        corr = flat @ flat.T
        corr.fill_diagonal_(0)
        assert tex.shape[0] >= 8
        assert float(corr.abs().max()) < 0.2


def test_exact_poses_follow_the_rig():
    traffic = cells.load("traffic", "street_3mps")
    base = street.base_poses(traffic, 25.0, 50)
    assert np.allclose(np.diff(base[:, 0]), 3.0 / 25.0)
    assert np.abs(base[:, 1]).max() <= traffic["weave_amplitude_m"] + 1e-12
    T = street.camera_poses(base, 1.2)
    centres = -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])
    assert np.allclose(centres[:, :2], base[:, :2])
    assert np.allclose(centres[:, 2], 1.2)
    # the camera looks along the vehicle's heading
    fwd = T[:, 2, :3]
    assert np.allclose(fwd[:, 0], np.cos(base[:, 2]))
    right = street.camera_poses(base, 1.2, lateral=0.5)
    cr = -np.einsum("nji,nj->ni", right[:, :3, :3], right[:, :3, 3])
    assert np.allclose(np.linalg.norm(cr - centres, axis=1), 0.5)


def test_textures_sum_exactly():
    """The rectangles are integer sums: one generator state gives the
    same texture on every call, whatever order the adds run in."""
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = street.textures(g1, 3, 120, 200, "cpu")
    b = street.textures(g2, 3, 120, 200, "cpu")
    assert torch.equal(a, b)
    assert float(a.min()) >= 0 and float(a.max()) <= 255
