"""The System's span record (`utils/profiling.StageTimer`) on the CPU: one
record per System, shared by its tracker, mapper and loop closer and kept
across `reset`; spans stamped with the System's call number; device spans
resolved only once their events report done, never by waiting; a bounded
ring; and, on a short bird drive, the lag queue's stamps: each fused frame
retires exactly `fused_max_lag` calls after its dispatch.
"""
import numpy as np
import pytest
import torch

from orbslam_birdview_tpu_torch.api.config import SlamConfig
from orbslam_birdview_tpu_torch.api.system import System
from orbslam_birdview_tpu_torch.core import lie
from orbslam_birdview_tpu_torch.core.camera import (BirdviewCamera,
                                                    PinholeCamera)
from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig
from orbslam_birdview_tpu_torch.utils import profiling, synth

# the half-size bird drive of the port's System tests
SCALE = 0.5
CAM = PinholeCamera(fx=348.5 * SCALE, fy=347.0 * SCALE, cx=480.0 * SCALE,
                    cy=302.0 * SCALE, width=475, height=200)
BV = BirdviewCamera(pixel2meter=0.03984 * 1.7 / SCALE, width=192, height=192)
N_FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bird_config(seq, loop_closing=False) -> SlamConfig:
    cfg = SlamConfig(camera=CAM, orb=ORBConfig(n_features=1000, n_levels=4,
                                               min_threshold=5.0),
                     bird_orb=ORBConfig(n_features=1000, n_levels=4),
                     sensor="mono_bird", birdview=BV)
    cfg.tbc_quat = tuple(lie.rot_to_quat(
        torch.as_tensor(seq.R_bc, dtype=torch.float32)).tolist())
    cfg.tbc_t = tuple(seq.t_bc.tolist())
    cfg.mapping.local_ba_window, cfg.mapping.local_ba_fixed = 8, 4
    if loop_closing:
        cfg.vocab_path = None    # the closer trains one mid-run
    return cfg


@pytest.fixture(scope="module")
def drive():
    seq = synth.BirdSequence(CAM, BV, n_frames=N_FRAMES)
    return seq, [seq.frame(i) for i in range(N_FRAMES)], \
        synth.footprint_mask(BV)


@pytest.fixture(scope="module")
def bird_run(drive):
    """A System over the drive with no pose read until the end, so that
    every fused frame retires through the lag queue."""
    seq, frames, mask = drive
    system = System(bird_config(seq), enable_loop_closing=False,
                    device="cpu")
    fds = [system.track_monocular_with_birdview(img, bev, mask, i / 25.0)
           for i, (img, bev, _) in enumerate(frames)]
    system._flush()
    return system, fds


def test_spans_carry_the_call_number(bird_run):
    system, fds = bird_run
    rec = system.timer
    assert rec.frame == N_FRAMES - 1
    assert [fd.call for fd in fds] == list(range(N_FRAMES))
    fused = {s[1] for s in rec.spans(names={"dispatched"})}
    assert len(fused) >= 8
    for f in fused:
        names = {s[0] for s in rec.spans(frames={f})}
        # the step's three host spans and the tracker's dispatch, in the
        # frame that dispatched it
        assert {"step.extract", "step.match", "step.pose_lm",
                "fused.dispatch"} <= names
        assert len(rec.spans(frames={f}, names={"step.pose_lm"})) == 2
    # every span lies inside the program clock's frames, in call order
    starts = [rec.spans(frames={f}, names={"fused.dispatch"})[0][2]
              for f in sorted(fused)]
    assert starts == sorted(starts)
    # the stages every reader reads are in the samples
    n_fused = system.timer.counters["track.fused"]
    assert len(rec.samples["step.pose_lm"]) == 2 * n_fused
    assert len(rec.samples["step.extract"]) == n_fused
    # on the CPU a device span is a no-op
    assert all(fd._step_span is None for fd in fds)
    assert "step" not in rec.samples


def test_fused_frames_retire_at_the_lag(bird_run):
    system, fds = bird_run
    rec = system.timer
    lag = system.cfg.tracking.fused_max_lag
    stamp = {(s[0], s[1]): s[2] for s in rec.spans(
        names={"dispatched", "retire", "pose"})}
    fused = sorted(f for n, f in stamp if n == "dispatched")
    retire_spans = {s[1]: (s[2], s[3])
                    for s in rec.spans(names={"fused.retire"})}
    held = 0
    for f in fused:
        t_disp, t_ret, t_pose = (stamp[("dispatched", f)],
                                 stamp[("retire", f)], stamp[("pose", f)])
        assert t_disp <= t_ret <= t_pose
        assert t_pose == fds[f]._finalized_wall
        if f + lag >= N_FRAMES:
            continue       # retired by the flush after the drive
        if any(c not in fused for c in range(f + 1, f + lag + 1)):
            continue       # a slow-path call drains the queue first
        lo, hi = retire_spans[f + lag]
        assert lo <= t_ret <= t_pose <= hi, f
        held += 1
    assert held >= 5


def test_one_record_for_tracker_mapper_closer_across_reset(drive):
    seq, frames, mask = drive
    system = System(bird_config(seq, loop_closing=True), device="cpu")
    rec = system.timer
    parts = lambda: (system.tracker.timer, system.mapper.timer,  # noqa: E731
                     system.loop_closer.timer)
    assert all(p is rec for p in parts())
    for i in range(2):
        system.track_monocular_with_birdview(*frames[i][:2], mask, i / 25.0)
    before = {k: list(v) for k, v in rec.samples.items()}
    assert before
    system.reset()
    assert system.timer is rec and all(p is rec for p in parts())
    system.track_monocular_with_birdview(*frames[2][:2], mask, 2 / 25.0)
    # frames run on across the reset; nothing recorded before it is lost
    assert rec.frame == 2
    assert {s[1] for s in rec.spans()} >= {0, 1, 2}
    for k, v in before.items():
        assert rec.samples[k][:len(v)] == v


def test_two_systems_do_not_mix(drive):
    seq, frames, mask = drive
    a = System(bird_config(seq), enable_loop_closing=False, device="cpu")
    b = System(bird_config(seq), enable_loop_closing=False, device="cpu")
    assert a.timer is not b.timer
    a.track_monocular_with_birdview(*frames[0][:2], mask, 0.0)
    assert a.timer.spans() and a.timer.samples
    assert b.timer.spans() == [] and not b.timer.samples
    assert b.timer.frame == -1
    # the program writes nothing process-wide
    assert not profiling.GLOBAL_TIMER.samples
    assert profiling.GLOBAL_TIMER.spans() == []


class FakeEvent:
    """A timing event whose completion and device time the test sets."""
    never_wait = "the record waited on the device"

    def __init__(self, at_ms: float):
        self.at_ms = at_ms
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done
        return other.at_ms - self.at_ms

    def synchronize(self):
        raise AssertionError(self.never_wait)


def test_device_span_resolves_only_when_done(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError(FakeEvent.never_wait)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    clock = iter([10.0, 11.0, 12.0, 13.0, 14.0])
    made = []

    def record_event(device):
        ev = FakeEvent(next(clock))
        made.append(ev)
        return ev
    rec = profiling.StageTimer(record_event=record_event)
    cuda = torch.device("cuda")
    rec.anchor_device(cuda)               # device 10.0 ms
    anchor_t = rec._anchor[1]
    rec.begin_frame()
    with rec.device_span("step", cuda) as a:      # 11.0 -> 12.0 ms
        pass
    assert a.seconds is None
    made[0].done = True
    rec.poll()                                    # the pair is not done
    assert a.seconds is None and "step" not in rec.samples
    made[1].done = True                           # start done, end not
    rec.poll()
    assert a.seconds is None
    rec.begin_frame()
    with rec.device_span("step", cuda) as b:      # 13.0 -> ...
        made[2].done = True
        rec.poll()                                # a resolves now
        assert a.seconds == pytest.approx(1e-3)
        assert a.t0 == pytest.approx(anchor_t + 1e-3)
        assert a.t1 == pytest.approx(anchor_t + 2e-3)
    assert b.frame == 1 and b.seconds is None
    assert rec.samples["step"] == [pytest.approx(1e-3)]
    assert rec.spans(names={"step"}) == [("step", 0, a.t0, a.t1)]
    # a span on the CPU is a no-op
    with rec.device_span("cpu", torch.device("cpu")) as c:
        assert c is None
    assert "cpu" not in rec.device_names


def test_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    rec = profiling.StageTimer()
    for i in range(20):
        rec.begin_frame()
        with rec.stage("s"):
            pass
    spans = rec.spans()
    assert len(spans) == 8
    assert [s[1] for s in spans] == list(range(12, 20))
    # the samples are whole: they feed the summary and the readers
    assert len(rec.samples["s"]) == 20


def test_wall_clock_placement():
    rec = profiling.StageTimer()
    rec._clock.extend([(1.0, 5_000_000_000), (2.0, 6_000_000_100)])
    assert rec.wall_ns(1.5) == pytest.approx(5_500_000_050)
    assert rec.wall_ns(0.5) == pytest.approx(4_500_000_000)
    assert rec.wall_ns(3.0) == pytest.approx(7_000_000_100)


def test_fetch_waits_are_spans():
    from orbslam_birdview_tpu_torch.utils.async_fetch import (BackgroundFetch,
                                                              fetch)
    rec = profiling.StageTimer()
    rec.begin_frame()
    x = torch.arange(4)
    assert np.array_equal(BackgroundFetch(x, rec).get(), x.numpy())
    assert np.array_equal(fetch(x, rec), x.numpy())
    assert [s[:2] for s in rec.spans()] == [("wait", 0), ("wait", 0)]
    assert np.array_equal(fetch(x), x.numpy())       # no record: untimed
    assert len(rec.samples["wait"]) == 2


def test_device_clock_rate_from_start_stamps(monkeypatch):
    """A device timer running 3 ppm slow against the host: a span's start,
    recorded on an idle device, bounds the rate from below, and spans
    placed with it land where the host recorded them; spans within
    `MIN_RATE_BASE_S` of the anchor bound nothing."""
    host = [100.0]
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: host[0])
    slow = 1.0 - 3e-6

    def record_event(device):
        ev = FakeEvent((host[0] - 100.0) * slow * 1e3)   # device ms
        ev.done = True
        return ev
    rec = profiling.StageTimer(record_event=record_event)
    cuda = torch.device("cuda")
    rec.anchor_device(cuda)
    for at in (100.5, 130.0, 160.0):
        host[0] = at
        rec.begin_frame()
        with rec.device_span("step", cuda) as span:
            host[0] = at + 0.25
        rec.poll()
        if at < 100.0 + profiling.MIN_RATE_BASE_S:
            assert rec.rate is None and span.t0 == pytest.approx(
                100.0 + 0.5 * slow, abs=1e-12)
        else:
            assert rec.rate == pytest.approx(1.0 / slow, abs=1e-12)
            assert span.t0 == pytest.approx(at, abs=1e-9)
            assert span.t1 == pytest.approx(at + 0.25, abs=1e-9)
    # a start that ran late (a busy device) bounds the rate loosely: the
    # rate keeps the tighter bound
    host[0] = 190.0
    with rec.device_span("step", cuda) as late:
        late.start.at_ms += 5.0
        host[0] = 190.5
    rec.poll()
    assert rec.rate == pytest.approx(1.0 / slow, abs=1e-12)
    assert late.t0 == pytest.approx(190.005, abs=1e-6)
