"""Fixed-scale (RGB-D) loop closing end to end, the JAX package against the
port, on the CPU: the same frames and depth maps of the RGB-D revisit
(`torch_circle_depth`: tests/test_loop_closing.py's circle of 2π/120 rad a
frame, 142 frames, inside a box room of half-width 2.4 m at 0.04 m a frame,
the front camera with exact depth) through both packages' `System.track_rgbd`
with loop closing on and the packaged vocabulary, at the depth drive's
320×240 configuration (`torch_midrun.make_depth_cfgs`, 1000 features, a
keyframe at least every 3 frames) with the default 32 + 16 local-BA window.

The JAX package's tests run on 8 virtual devices, so its closer and its
full-map BA take the sharded branches; the port runs on
`Mesh(["cpu"] * 8)`, where it takes the same ones. Held:
- each package closes at least one loop, with the Sim3 scale exactly 1;
- the loop's candidate keyframe is the same in both, and the loop
  keyframes are minted within one keyframe interval of each other (the
  keyframe sets agree through frame 85, then diverge: see the test);
- the essential-graph and full-map BA solvers are the same in both;
- each package's keyframe ATE after the loop and the GBA < 0.05 m with no
  scale alignment, and the two within 0.01 m of each other.
Slow: ~6 min on the CPU.
"""
import contextlib

import pytest

import torch_circle_depth as cd
import torch_midrun as mid
from orbslam_birdview_tpu.api.system import System as JSystem
from orbslam_birdview_tpu.core.camera import BirdviewCamera as JBirdviewCamera
from orbslam_birdview_tpu.core.camera import PinholeCamera as JPinholeCamera
from orbslam_birdview_tpu.graph import ba as jba
from orbslam_birdview_tpu.graph import ba_large as jba_large
from orbslam_birdview_tpu.graph import pose_graph as jpose_graph
from orbslam_birdview_tpu.parallel import sharded_ba as jsharded_ba
from orbslam_birdview_tpu.parallel import sharded_pose_graph as jspg
from orbslam_birdview_tpu.utils.synth import BirdSequence
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.parallel import runtime

MAX_ATE_M = 0.05
AGREE_THROUGH_FRAME = 85
MAX_FRAMES_BETWEEN_KF = 3
MAX_ATE_GAP_M = 0.01
# the JAX package's solver entry points, named as the port's records name
# them: (module, function, stage, name)
JAX_SOLVERS = (
    (jpose_graph, "optimize_sim3_graph", "graph", "dense"),
    (jpose_graph, "optimize_sim3_graph_banded", "graph", "banded"),
    (jspg, "sharded_optimize_sim3_graph", "graph", "sharded-dense"),
    (jspg, "sharded_optimize_sim3_graph_pcg", "graph", "sharded-pcg"),
    (jba, "bundle_adjust", "gba", "dense-W"),
    (jba_large, "bundle_adjust_large", "gba", "large"),
    (jsharded_ba, "sharded_global_ba", "gba", "sharded-implicit"),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from mid.one_torch_thread()


@contextlib.contextmanager
def jax_solver_names(system):
    """The solvers a JAX System's loop corrections call, as
    {"graph": [...], "gba": [...]}: the first solver entered in each
    `_correct_loop` (outside its full-map BA) and each `global_ba`."""
    names = {"graph": [], "gba": []}
    stage = []
    saved = [(m, f, getattr(m, f)) for m, f, _, _ in JAX_SOLVERS]

    def spy(fn, want, name):
        def call(*args, **kw):
            if stage and stage[-1] == want and len(names[want]) < stage_n[
                    want]:
                names[want].append(name)
            return fn(*args, **kw)
        return call

    def staged(fn, which):
        def call(*args, **kw):
            stage.append(which)
            stage_n[which] += 1
            try:
                return fn(*args, **kw)
            finally:
                stage.pop()
        return call

    stage_n = {"graph": 0, "gba": 0}
    for (module, fn, want, name), (_, _, orig) in zip(JAX_SOLVERS, saved):
        setattr(module, fn, spy(orig, want, name))
    lc, mapper = system.loop_closer, system.mapper
    lc._correct_loop = staged(lc._correct_loop, "graph")
    mapper.global_ba = staged(mapper.global_ba, "gba")
    try:
        yield names
    finally:
        for module, fn, orig in saved:
            setattr(module, fn, orig)
        del lc._correct_loop, mapper.global_ba


@pytest.fixture(scope="module")
def circle():
    seq = BirdSequence(JPinholeCamera(**mid.DEPTH_CAM),
                       JBirdviewCamera(width=64, height=64),
                       n_frames=cd.CIRCLE_FRAMES, speed=cd.CIRCLE_SPEED,
                       yaw_rate=cd.CIRCLE_YAW_RATE, wall_x=cd.ROOM_HALF)
    frames = cd.circle_frames(seq)
    jcfg, cfg = mid.make_depth_cfgs("rgbd", 1000, MAX_FRAMES_BETWEEN_KF)
    for c in (jcfg, cfg):
        c.mapping.local_ba_window, c.mapping.local_ba_fixed = 32, 16
    jsys = JSystem(jcfg)
    with jax_solver_names(jsys) as jnames:
        jloops, jok = cd.drive(jsys, frames)
    psys = System(cfg, device="cpu", mesh=runtime.Mesh(["cpu"] * 8))
    ploops, pok = cd.drive(psys, frames)
    pnames = dict(graph=[r["solver"] for r in psys.loop_closer.loop_log],
                  gba=[psys.mapper.last_gba.get("solver")])
    return dict(seq=seq,
                jax=dict(system=jsys, loops=jloops, ok=jok, names=jnames),
                port=dict(system=psys, loops=ploops, ok=pok, names=pnames))


@pytest.mark.slow
def test_rgbd_circle_closes_the_same_fixed_scale_loop(circle):
    """The same candidate keyframe in both (id and frame), the keyframe
    sets equal through AGREE_THROUGH_FRAME, and the loop keyframes minted
    within one keyframe interval of each other: past frame 85 a count of
    tracked points crosses the tracker's starving threshold (60) in one
    package and not in the other, and the keyframe ids shift by one or two
    from there (see CHANGES.md)."""
    found = {}
    for name in ("jax", "port"):
        run = circle[name]
        assert all(run["ok"]), name
        assert run["system"].loop_closer.n_loops_closed >= 1, name
        assert run["loops"] and all(s == 1.0 for _, _, s in run["loops"])
        store = run["system"].store
        kf, cand, _ = run["loops"][0]
        frames = store.kf_frame_id[:store.n_kf]
        found[name] = dict(
            cand=(cand, int(frames[cand])), kf_frame=int(frames[kf]),
            early=frames[frames <= AGREE_THROUGH_FRAME].tolist())
    j, p = found["jax"], found["port"]
    assert p["cand"] == j["cand"]
    assert p["early"] == j["early"]
    assert abs(p["kf_frame"] - j["kf_frame"]) <= MAX_FRAMES_BETWEEN_KF


@pytest.mark.slow
def test_rgbd_circle_solvers_and_ate(circle):
    jnames, pnames = (circle[n]["names"] for n in ("jax", "port"))
    assert pnames["graph"] == jnames["graph"][:len(pnames["graph"])] \
        == ["sharded-dense"]
    assert pnames["gba"] == jnames["gba"][-1:] == ["sharded-implicit"]
    ate = {n: cd.keyframe_ate(circle[n]["system"].store, circle["seq"])
           for n in ("jax", "port")}
    assert ate["jax"] < MAX_ATE_M and ate["port"] < MAX_ATE_M, ate
    assert abs(ate["jax"] - ate["port"]) < MAX_ATE_GAP_M, ate
