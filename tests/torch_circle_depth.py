"""Depth maps for an RGB-D revisit drive: `BirdSequence`'s circle inside a
small box room, seen by its front camera with exact depth.

`BirdSequence` renders no depth. `box_depth` gives, for each pixel of the
front camera, the camera z (metres) of the nearest of the room's four
walls along that pixel's ray, 0 where no wall is hit: the ray has camera
z = 1, so this is the ray parameter of `render_box_view`'s nearest hit.
It is plain numpy, written here and not taken from either package's
`synth`, so the depth the port is fed is not the port's own code.
"""
import numpy as np

from orbslam_birdview_tpu.utils.synth import ate_rmse

# the drive: a circle of 2π/120 rad a frame (tests/test_loop_closing.py's
# yaw rate) at CIRCLE_SPEED m a frame, a radius of 0.76 m, inside a room
# of half-width ROOM_HALF m centred on the world origin. The walls in view
# lie 0.9-4.0 m from the camera, most pixels within the close depth
# ThDepth·bf/fx = 3.09 m of TUM1 (configs/tum1_rgbd.yaml); with the mono
# circle's 8 m walls almost every point would be far
CIRCLE_FRAMES = 142
CIRCLE_SPEED = 0.04
CIRCLE_YAW_RATE = 2 * np.pi / 120
ROOM_HALF = 2.4


def box_depth(cam, R_cw, t_cw, box_half):
    """(H, W) f32 camera-z depth of the box room's nearest wall."""
    R_cw = np.asarray(R_cw, np.float64)
    p = -R_cw.T @ np.asarray(t_cw, np.float64)
    us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    d_cam = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                      np.ones_like(us)], -1)
    d_w = d_cam @ R_cw          # each row R_wc @ d
    best = np.full(us.shape, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis in (0, 1):
            for wall in (box_half, -box_half):
                t = (wall - p[axis]) / d_w[..., axis]
                hit = (t > 0.1) & (t < best) & np.isfinite(t)
                best = np.where(hit, t, best)
    return np.where(np.isfinite(best), best, 0.0).astype(np.float32)


def circle_frames(seq, n_frames=CIRCLE_FRAMES):
    """[(front image, depth map, (R_cw, t_cw))] of a `BirdSequence` of
    either package (its BEV stream unused)."""
    out = []
    for i in range(n_frames):
        img, _, gt = seq.frame(i)
        out.append((img, box_depth(seq.cam, *gt, seq.wall_x), gt))
    return out


def keyframe_ate(store, seq):
    """Metric ATE (m) of the keyframe centres, rigid alignment and no
    scale (tests/test_loop_closing.py's measure)."""
    est, gt = [], []
    for k in store.valid_kf_ids():
        R_g, t_g = seq.gt_cam_pose(int(store.kf_frame_id[k]))
        est.append(-store.kf_R[k].T @ store.kf_t[k])
        gt.append(-R_g.T @ t_g)
    return ate_rmse(np.array(est), np.array(gt), with_scale=False)


def drive(system, frames, fps=30.0):
    """Feed the frames to a System of either package through `track_rgbd`
    with each loop correction watched, then `_flush`. Returns the loops
    [(kf, cand, Sim3 scale)] and the frames' pose_ok."""
    loops = []
    lc = system.loop_closer
    correct = lc._correct_loop

    def correct_loop(kf, cand, S, loop_points):
        loops.append((int(kf), int(cand), float(S[2])))
        return correct(kf, cand, S, loop_points)

    lc._correct_loop = correct_loop
    ok = [system.track_rgbd(img, depth, i / fps).pose_ok
          for i, (img, depth, _) in enumerate(frames)]
    system._flush()
    lc._correct_loop = correct
    return loops, ok
