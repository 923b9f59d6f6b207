"""The check that decides `correct`: the window's own tracking steps and
bundle adjustments, worked out again by the plain reference and compared.

A tracking step is worked out from the frame's images (the benchmark's
own), the configuration's numbers and the state the program tracked the
frame from: its motion-model prediction, its local map and BEV landmarks
(`track.py`, `stereo.py`, `orb.py`). A bundle adjustment is worked out from
the problem the mapper posed (`ba.py`). The reference computes in float64;
the control is the same reference in float32 with TF32 on.

Numbers, each the worst over the checked calls:
- `front_unmatched`, `bev_unmatched`: the share of one side's keypoints
  with no keypoint of the other on the same level within `KP_PX` pixels
  (the larger of the two directions);
- `front_desc_share`, `bev_desc_share`: of the keypoints matched so, the
  share whose descriptors differ; `front_desc_bits`, `bev_desc_bits`: the
  most bits apart of such a pair;
- `depth_mismatch` (stereo): of the keypoints matched so, the share whose
  depth is on one side only or differs by more than `DEPTH_REL`;
- `pose_m`, `pose_deg`: the step's camera centre and rotation apart;
- `pose_px`: the median over the reference's final inliers of the pixels
  between their projections under the two poses;
- `ba_cost_gap`: the BA's Huber cost at the program's state over the
  reference's at its own, less one, in magnitude, both over the edges that
  the reference's second phase kept: how far the program fell short of the
  minimum, or passed it, as a share of it;
- `ba_cam_m`: the free keyframes' centres apart after the BA;
- `ba_point_m`: the median over its free points of their distance apart.
  A local BA can hold a direction only weakly (a new keyframe pulled far,
  a point left with one edge): float32 then ends a few centimetres from
  float64's minimum along it at nearly the same cost, so these two are printed
  and `ba_cost_gap` is held.
"""
from __future__ import annotations

import contextlib
import math

import torch

from . import ba, orb, se3, stereo, track

KP_PX = 0.01
DEPTH_REL = 1e-3
REF = torch.float64


@contextlib.contextmanager
def tf32(on: bool):
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _t(x, dev):
    return torch.as_tensor(x).to(dev)


def _pairs(a_xy, a_oct, b_xy, b_oct):
    """For each of a's keypoints the nearest of b's on its level within
    KP_PX (ties to the first), or -1."""
    d = torch.cdist(a_xy.double(), b_xy.double())
    d = torch.where((a_oct[:, None] == b_oct[None, :]) & (d <= KP_PX), d,
                    math.inf)
    if d.shape[1] == 0:
        return torch.full((len(a_xy),), -1, dtype=torch.long,
                          device=a_xy.device)
    best, idx = track.first_min(d)
    return torch.where(torch.isfinite(best), idx, -1)


def kp_numbers(p_xy, p_oct, p_bits, ref: orb.Features) -> dict:
    """The program's keypoints against the reference's."""
    out = dict(unmatched=0.0, desc_share=0.0, desc_bits=0)
    pr = _pairs(p_xy, p_oct, ref.xy, ref.octave)
    rp = _pairs(ref.xy, ref.octave, p_xy, p_oct)
    for pair, n in ((pr, len(p_xy)), (rp, len(ref.xy))):
        if n:
            out["unmatched"] = max(out["unmatched"],
                                   float((pair < 0).double().mean()))
    m = pr >= 0
    if bool(m.any()):
        apart = (p_bits[m] != ref.bits[pr[m]]).sum(1)
        out["desc_share"] = float((apart > 0).double().mean())
        out["desc_bits"] = int(apart.max())
    return out


def depth_mismatch(p_xy, p_oct, p_depth, ref_f, ref_depth) -> float:
    pr = _pairs(p_xy, p_oct, ref_f.xy, ref_f.octave)
    m = pr >= 0
    x, y = p_depth[m].double(), ref_depth[pr[m]].double()
    either = (x > 0) | (y > 0)
    if not bool(either.any()):
        return 0.0
    bad = ((x > 0) != (y > 0)) | ((x - y).abs() > DEPTH_REL * y.abs())
    return float((bad & either).double().sum() / either.double().sum())


def pose_numbers(R, t, ref: track.Tracked, rig: track.Rig) -> dict:
    m, deg = se3.pose_gap(R, t, ref.R, ref.t)
    R, t = (torch.as_tensor(x).to(ref.R.device, torch.float64) for x in (R, t))
    px = 0.0
    if len(ref.inliers):
        X = ref.inliers.double()
        gap = (track.project(R, t, X, rig)
               - track.project(ref.R.double(), ref.t.double(), X, rig))
        px = float(torch.linalg.vector_norm(gap, dim=-1).median())
    return dict(pose_m=m, pose_deg=deg, pose_px=px)


def _finite(nums: dict) -> dict:
    return {k: (v if math.isfinite(v) else math.inf) for k, v in nums.items()}


def _program_kp(kp, dev):
    v = _t(kp.valid, dev).bool()
    return (_t(kp.xy, dev)[v], _t(kp.octave, dev)[v].long(),
            orb.unpack(_t(kp.desc_u8, dev)[v]), v)


def step_numbers(out, ref: track.Tracked, rig, ref_depth=None) -> dict:
    dev = ref.R.device
    nums = {}
    xy, octv, bits, v = _program_kp(out.kp, dev)
    for k, x in kp_numbers(xy, octv, bits, ref.front).items():
        nums[f"front_{k}"] = x
    nums.update(pose_numbers(out.R, out.t, ref, rig))
    if ref.bev is not None:
        if getattr(out, "bird_kp", None) is None:
            nums.update(bev_unmatched=1.0, bev_desc_share=1.0,
                        bev_desc_bits=256)
        else:
            bxy, boct, bbits, _ = _program_kp(out.bird_kp, dev)
            for k, x in kp_numbers(bxy, boct, bbits, ref.bev).items():
                nums[f"bev_{k}"] = x
    if ref_depth is not None:
        pd = getattr(out, "kp_depth", None)
        nums["depth_mismatch"] = (1.0 if pd is None else depth_mismatch(
            xy, octv, _t(pd, dev)[v], ref.front, ref_depth))
    return _finite(nums)


def control_numbers(ctl: track.Tracked, ctl_depth, ref: track.Tracked,
                    rig, ref_depth) -> dict:
    """The control's step against the reference's, as a program's."""
    nums = {}
    for k, x in kp_numbers(ctl.front.xy, ctl.front.octave, ctl.front.bits,
                           ref.front).items():
        nums[f"front_{k}"] = x
    nums.update(pose_numbers(ctl.R, ctl.t, ref, rig))
    if ref.bev is not None:
        for k, x in kp_numbers(ctl.bev.xy, ctl.bev.octave, ctl.bev.bits,
                               ref.bev).items():
            nums[f"bev_{k}"] = x
    if ref_depth is not None:
        nums["depth_mismatch"] = depth_mismatch(
            ctl.front.xy, ctl.front.octave, ctl_depth, ref.front, ref_depth)
    return _finite(nums)


def ba_numbers(R, t, X, ref: ba.Solution, p: ba.Problem) -> dict:
    dev = ref.R.device
    R, t, X = (_t(x, dev).double() for x in (R, t, X))
    rR, rt, rX = ref.R.double(), ref.t.double(), ref.X.double()

    def centres(R, t):
        return -(R.transpose(1, 2) @ t[..., None])[..., 0]

    dc = torch.linalg.vector_norm(centres(R, t) - centres(rR, rt),
                                  dim=-1)[p.cam_free]
    dp = torch.linalg.vector_norm(X - rX, dim=-1)[p.pt_free]
    c = float(ba.huber_cost(R, t, X, ref.edges, p))
    c_ref = float(ba.huber_cost(rR, rt, rX, ref.edges, p))
    return _finite(dict(ba_cost_gap=abs(c - c_ref) / max(c_ref, 1e-12),
                        ba_cam_m=float(dc.max()) if len(dc) else 0.0,
                        ba_point_m=float(dp.median()) if len(dp) else 0.0))


def worst(rows: list[dict]) -> dict:
    out: dict = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def _half(p: ba.Problem) -> ba.Problem:
    """The problem with every other reprojection edge left out."""
    edges = {}
    for kind, (c, q, o, i, v) in p.edges.items():
        if kind != "bird":
            v = v.clone()
            v[::2] = False
        edges[kind] = (c, q, o, i, v)
    return p._replace(edges=edges)


def fault_numbers(s: dict, ref: track.Tracked, p_ba=None, ref_ba=None):
    """The faults a tracking cell can have, planted in the reference put
    in the program's place: a step that returns its prediction, an answer
    moved 1 cm where it is produced, half the keypoints left out; a BA
    that returns its problem's state, half the edges left out."""
    out = {}
    if ref is not None:
        rig = s["rig"]
        out["step_state_unchanged"] = pose_numbers(s["R_pred"], s["t_pred"],
                                                   ref, rig)
        out["step_answer_altered"] = pose_numbers(
            ref.R, ref.t + torch.tensor([0.01, 0.0, 0.0], dtype=ref.t.dtype,
                                        device=ref.t.device), ref, rig)
        f = ref.front
        half = orb.Features(f.xy[::2], f.octave[::2], f.bits[::2])
        out["step_half_keypoints"] = {
            f"front_{k}": x for k, x in kp_numbers(
                half.xy, half.octave, half.bits, ref.front).items()}
    if p_ba is not None:
        out["ba_state_unchanged"] = ba_numbers(p_ba.R, p_ba.t, p_ba.X,
                                               ref_ba, p_ba)
        half = ba.solve(_half(p_ba))
        out["ba_half_edges"] = ba_numbers(half.R, half.t, half.X, ref_ba,
                                          p_ba)
    return {k: _finite(v) for k, v in out.items()}


def check(steps: list, bas: list, bf: float, control: bool = False):
    """(the program's numbers, the control's, the planted faults'), the
    last two {} without `control`, each the worst over the sampled steps
    and BAs, with the counts checked.

    `steps` holds for each sampled step the arguments of `track.track`,
    with `right_img` on a stereo rig, and the program's output `out`;
    `bas` each BA's `ba.Problem` in float64 with the program's (R, t, X);
    `bf` is the stereo baseline times fx."""
    prog, ctrl, prog_ba, ctrl_ba, faults = [], [], [], [], []
    for s in steps:
        out = s.pop("out")
        right = s.pop("right_img", None)
        with tf32(False):
            ref = track.track(**s, dtype=REF)
            ref_d = (None if right is None else stereo.depth(
                s["front_img"], right, ref.front,
                orb.extract(right, s["ex"], REF), bf))
        prog.append(step_numbers(out, ref, s["rig"], ref_d))
        if control:
            with tf32(True):
                ctl = track.track(**s, dtype=torch.float32)
                ctl_d = (None if right is None else stereo.depth(
                    s["front_img"], right, ctl.front,
                    orb.extract(right, s["ex"], torch.float32), bf))
            ctrl.append(control_numbers(ctl, ctl_d, ref, s["rig"], ref_d))
            with tf32(False):
                faults.append(fault_numbers(s, ref))
    for p, (R, t, X) in bas:
        with tf32(False):
            ref = ba.solve(p)
        prog_ba.append(ba_numbers(R, t, X, ref, p))
        if control:
            p32 = p._replace(R=p.R.float(), t=p.t.float(), X=p.X.float(),
                             edges={k: (c, q, o.float(), i.float(), v)
                                    for k, (c, q, o, i, v) in
                                    p.edges.items()})
            with tf32(True):
                ctl = ba.solve(p32)
            ctrl_ba.append(ba_numbers(ctl.R, ctl.t, ctl.X, ref, p))
            with tf32(False):
                faults.append(fault_numbers({}, None, p, ref))
    counts = dict(steps_checked=len(prog), bas_checked=len(prog_ba))
    planted = {}
    for row in faults:
        for name, nums in row.items():
            planted[name] = worst([planted.get(name, {}), nums])
    if not control:
        return {**worst(prog), **worst(prog_ba), **counts}, {}, {}
    return ({**worst(prog), **worst(prog_ba), **counts},
            {**worst(ctrl), **worst(ctrl_ba), **counts}, planted)
