"""The span recorder (`spslam_tpu_torch/tracing.py`) and the spans the
port puts at its stage boundaries, on the CPU.

* The recorder alone: off records nothing; spans nest per thread and carry
  the thread's name; a span's CPU time is at most its wall time; `mark`
  closes a span started on another thread; spans and `torch.profiler`'s
  events share one clock.
* One async `System` (planes, local BA, the relocalization index) over 8
  frames at 320x240 with the recorder and `Tracker.perf` on: every span of
  the tracker, the fused step and the mapping worker appears on its
  thread, under its parent, one `pipeline.queue_wait` per submitted
  keyframe, and each `tracker.<section>` span sums to its `Tracker.perf`
  seconds (one clock reading feeds both).

Every test that turns the recorder on turns it off and empties it after.
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from spslam_tpu_torch import tracing
from spslam_tpu_torch.bench import quantized
from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import TrackerConfig
from tests.test_torch_common import DEV
from tests.test_torch_perf_sections import INTR


@pytest.fixture
def recorder():
    tracing.reset()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.reset()


def _by_name(spans):
    return {s.name: s for s in spans}


def test_off_records_nothing():
    assert not tracing.ENABLED
    assert tracing.span("a") is tracing.span("b")      # one shared no-op
    with tracing.span("a"):
        tracing.mark("b", time.time_ns())
        t0 = tracing.stamp()
        tracing.section("c", t0, tracing.stamp())
    assert tracing.records() == []


def test_spans_nest_per_thread_and_carry_the_thread_name(recorder):
    inner_open = threading.Event()
    main_done = threading.Event()

    def other():
        with tracing.span("w.outer"):
            with tracing.span("w.inner"):
                inner_open.set()
                main_done.wait(10.0)

    th = threading.Thread(target=other, name="mapping")
    with tracing.span("m.outer"):
        th.start()
        inner_open.wait(10.0)
        with tracing.span("m.inner"):     # opened while the worker's are open
            pass
        t0 = tracing.stamp()
        tracing.section("m.section", t0, tracing.stamp())
    main_done.set()
    th.join(10.0)
    assert not th.is_alive()
    s = _by_name(tracing.records())
    assert {n: s[n].thread for n in s} == {
        "m.outer": "MainThread", "m.inner": "MainThread", "m.section": "MainThread",
        "w.outer": "mapping", "w.inner": "mapping"}
    assert s["m.outer"].parent == -1 and s["w.outer"].parent == -1
    assert s["m.inner"].parent == s["m.section"].parent == s["m.outer"].id
    assert s["w.inner"].parent == s["w.outer"].id
    assert len({x.id for x in s.values()}) == 5
    for child, parent in (("m.inner", "m.outer"), ("w.inner", "w.outer")):
        assert s[parent].start_ns <= s[child].start_ns <= s[child].end_ns <= s[parent].end_ns


def test_cpu_time_is_at_most_the_wall_time(recorder):
    with tracing.span("sleep"):
        time.sleep(0.05)
    with tracing.span("busy"):
        x = 0
        t_end = time.perf_counter() + 0.02
        while time.perf_counter() < t_end:
            x += 1
    s = _by_name(tracing.records())
    for name in ("sleep", "busy"):
        assert 0 <= s[name].cpu_ns <= s[name].end_ns - s[name].start_ns
    assert s["sleep"].cpu_ns < 0.5 * (s["sleep"].end_ns - s["sleep"].start_ns)
    assert s["busy"].cpu_ns > 0.005e9


def test_mark_closes_a_span_started_on_another_thread(recorder):
    t0 = time.time_ns()
    th = threading.Thread(target=lambda: tracing.mark("queue", t0), name="mapping")
    time.sleep(0.01)
    th.start()
    th.join(10.0)
    assert not th.is_alive()
    (s,) = tracing.records()
    assert (s.name, s.thread, s.start_ns, s.cpu_ns, s.parent) == ("queue", "mapping", t0,
                                                                   None, -1)
    assert s.end_ns - s.start_ns >= 0.01e9


def test_spans_share_the_profilers_clock(recorder):
    act = torch.profiler.ProfilerActivity
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        a = x + 1
        with tracing.span("mm"):
            b = x @ x
        c = x * 2
    del a, b, c
    s = _by_name(tracing.records())["mm"]
    ev = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()}
    assert s.start_ns <= ev["aten::mm"][0] <= ev["aten::mm"][1] <= s.end_ns
    assert ev["aten::add"][1] <= s.start_ns and s.end_ns <= ev["aten::mul"][0]


# where each span of the program is recorded, and the span (or spans) it sits in
PROGRAM_SPANS = {
    "system.init": ("MainThread", None),
    "system.shutdown": ("MainThread", None),
    "tracker.dispatch_frame": ("MainThread", None),
    "tracker.resolve_frame": ("MainThread", (None, "system.shutdown")),   # the flush
    "step.build": ("MainThread", "tracker.dispatch_frame"),
    "step.coarse": ("MainThread", "tracker.dispatch_frame"),
    "step.fallback": ("MainThread", "tracker.dispatch_frame"),
    "step.tight": ("MainThread", "tracker.dispatch_frame"),
    "step.planes": ("MainThread", "tracker.dispatch_frame"),
    "step.pack": ("MainThread", "tracker.dispatch_frame"),
    "pipeline.queue_wait": ("mapping", None),
    "worker.keyframe": ("mapping", None),
    "planes.keyframe": ("mapping", "worker.keyframe"),
    "planes.segment": ("mapping", "planes.keyframe"),
    "planes.associate": ("mapping", "planes.keyframe"),
    "mapper.keyframe": ("mapping", "worker.keyframe"),
    "mapper.cull_points": ("mapping", "mapper.keyframe"),
    "mapper.fuse": ("mapping", "mapper.keyframe"),
    "mapper.fuse_match": ("mapping", "mapper.fuse"),
    "mapper.fuse_merge": ("mapping", "mapper.fuse"),
    "mapper.local_ba": ("mapping", "mapper.keyframe"),
    "mapper.cull_keyframes": ("mapping", "mapper.keyframe"),
    "loop.keyframe": ("mapping", "worker.keyframe"),
    "tracker.refresh_snapshot": ("mapping", "worker.keyframe"),
}


def test_async_system_records_every_stage(recorder):
    seq = make_sequence(n_frames=8, intr=INTR)
    seq.frames = quantized(seq.frames)
    sys_ = System(SystemConfig(intr=INTR, use_planes=True, async_mapping=True, local_ba=True,
                               tracker=TrackerConfig(th_depth=3.2)), device=DEV)
    sys_.tracker.perf = {}
    for (g, d), ts in zip(seq.frames, seq.timestamps):
        sys_.track_rgbd(g, d, ts)
    sys_.shutdown()
    spans = tracing.records()
    by_id = {s.id: s for s in spans}
    names = Counter(s.name for s in spans)
    perf = dict(sys_.tracker.perf)
    n_frames = perf.pop("n_frames")
    sections = {"tracker." + k for k in perf}
    assert set(names) == set(PROGRAM_SPANS) | sections
    for s in spans:
        if s.name in sections:
            thread, parent = "MainThread", ("tracker.dispatch_frame", "tracker.resolve_frame")
        else:
            thread, parent = PROGRAM_SPANS[s.name]
            parent = parent if isinstance(parent, tuple) else (parent,)
        assert s.thread == thread, s
        assert (by_id[s.parent].name if s.parent >= 0 else None) in parent, s
        if s.cpu_ns is not None:
            assert s.cpu_ns <= (s.end_ns - s.start_ns) * 1.001 + 10_000, s
    assert names["pipeline.queue_wait"] == sys_.pipeline.n_submitted == names["worker.keyframe"]
    assert names["tracker.dispatch_frame"] == names["step.build"] == sys_.tracker.n_fused
    assert names["tracker.resolve_frame"] == n_frames
    for k, v in perf.items():
        got = sum(s.end_ns - s.start_ns for s in spans if s.name == "tracker." + k) * 1e-9
        assert got == pytest.approx(v, rel=1e-9, abs=1e-12), k
    # the stages of a step lie inside the interval of its `dispatch` section
    dispatch = [s for s in spans if s.name == "tracker.dispatch"]
    for s in spans:
        if s.name.startswith("step."):
            assert any(d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns for d in dispatch), s


def test_profile_host_span_table_divides_by_frames_and_keyframes():
    from spslam_tpu_torch.tools.profile_host import span_table

    ms = 1_000_000
    sp = [tracing.Span("tracker.dispatch_frame", "MainThread", 0, 40 * ms, 30 * ms, 0, -1),
          tracing.Span("tracker.dispatch_frame", "MainThread", 50, 50 + 20 * ms, 10 * ms, 1, -1),
          tracing.Span("worker.keyframe", "mapping", 0, 90 * ms, 60 * ms, 2, -1),
          tracing.Span("pipeline.queue_wait", "mapping", 0, 30 * ms, None, 3, -1)]
    assert span_table(sp, n_frames=4) == [
        ("tracker.dispatch_frame", "MainThread", 2, 15.0, 10.0, "frame"),
        ("worker.keyframe", "mapping", 1, 90.0, 60.0, "keyframe"),
        ("pipeline.queue_wait", "mapping", 1, 30.0, None, "keyframe")]


# ---------------------------------------------------------------- loop closing
def _loop_store(n_cams=8, n_pts=200):
    """n_cams keyframes in a row seeing the same n_pts points, each keyframe
    the parent of the next, the poses after the first perturbed (the scene
    of tests/unit/test_global_ba.py, built with the port's own pieces)."""
    from spslam_tpu_torch.geometry import np_lie
    from spslam_tpu_torch.geometry.camera import Intrinsics, project
    from spslam_tpu_torch.geometry.lie import se3_exp
    from spslam_tpu_torch.map.store import MapConfig, MapStore

    intr = Intrinsics(fx=100.0, fy=100.0, cx=32.0, cy=24.0, bf=8.0, width=64, height=48)
    rng = np.random.default_rng(0)
    st = MapStore(MapConfig(max_keyframes=32, max_points=4096, n_kp=256, max_obs_per_point=16))
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(4, 9, n_pts)], axis=-1).astype(np.float32)
    pids = None
    for c in range(n_cams):
        T = se3_exp(torch.tensor([0.25 * c, 0.02 * c, 0.0, 0.0, 0.04 * c, 0.0])).numpy()
        xc = np_lie.se3_apply(T, pts)
        uv = project(intr, torch.from_numpy(xc)).numpy()
        n_kp = st.cfg.n_kp
        frame = dict(uv=np.zeros((n_kp, 2), np.float32), octave=np.zeros(n_kp, np.int32),
                     angle=np.zeros(n_kp, np.float32),
                     desc=rng.integers(0, 2 ** 32, (n_kp, 8), dtype=np.uint32),
                     depth=np.zeros(n_kp, np.float32), u_right=np.full(n_kp, -1.0, np.float32),
                     valid=np.zeros(n_kp, bool))
        frame["uv"][:n_pts], frame["depth"][:n_pts] = uv, xc[:, 2]
        frame["u_right"][:n_pts] = uv[:, 0] - intr.bf / xc[:, 2]
        frame["valid"][:n_pts] = True
        k = st.add_keyframe(T, float(c), frame, c, parent=c - 1)
        if c == 0:
            dist = np.linalg.norm(pts, axis=-1)
            pids = st.add_points_bulk(pts, frame["desc"][:n_pts], pts / dist[:, None], dist, k,
                                      np.arange(n_pts))
        else:
            st.add_observations_bulk(pids, k, np.arange(n_pts))
            xi = torch.from_numpy(rng.normal(0, 0.02, 6).astype(np.float32))
            st.kf_pose[k] = np_lie.se3_compose(se3_exp(xi).numpy(), T)
    return st, intr


def test_loop_closing_spans_and_counters(recorder, monkeypatch):
    """One failed and one passing geometric check through `_close_loop` on
    a small store (the check itself replaced: it answers the loop edge),
    the global BA held on its `gba` thread after its solve until a
    keyframe has been added, a `wait_gba` that times out meanwhile, then
    the merge, which carries the new keyframe: every loop span on its
    thread, under its parent, and the counters add up."""
    from spslam_tpu_torch.geometry import np_lie
    from spslam_tpu_torch.loop import loop_closer
    from spslam_tpu_torch.loop.loop_closer import LoopCloser, LoopConfig

    st, intr = _loop_store()
    lc = LoopCloser(intr, st, cfg=LoopConfig(gba_settle_iters=1, gba_stage1_iters=1,
                                             gba_stage2_iters=1), device=DEV)
    answers = iter([(False, None),
                    (True, np_lie.se3_compose(st.kf_pose[0], np_lie.se3_inverse(st.kf_pose[7])))])
    monkeypatch.setattr(lc, "_geometric_check", lambda kf, cand, scale=1.0: next(answers))
    solved, go = threading.Event(), threading.Event()
    real = loop_closer.global_bundle_adjust

    def held_gba(*a, **kw):
        out = real(*a, **kw)
        solved.set()
        assert go.wait(60.0)
        return out

    monkeypatch.setattr(loop_closer, "global_bundle_adjust", held_gba)
    assert lc._close_loop(7, 0) is False
    assert lc._close_loop(7, 0) is True
    assert solved.wait(60.0)
    assert lc.wait_gba(timeout=0.01) is False        # held: times out, keeps the future
    with st.lock:
        frame = {k: getattr(st, "kf_" + k)[7].copy() for k in ("uv", "octave", "angle", "desc",
                                                              "depth", "valid")}
        frame["u_right"] = st.kf_ur[7].copy()
        st.add_keyframe(st.kf_pose[7], 8.0, frame, 8, parent=7)
    go.set()
    assert lc.wait_gba() is True
    assert (lc.n_geo_checks, lc.n_geo_passed, lc.n_loops_closed) == (2, 1, 1)
    assert (lc.n_gba_run, lc.n_gba_merged, lc.n_gba_timeouts, lc.n_gba_carried_kfs) == (1, 1, 1, 1)

    spans = tracing.records()
    by_id = {s.id: s for s in spans}
    names = Counter(s.name for s in spans)
    assert names == {"loop.close": 2, "loop.geometric_check": 2, "loop.pose_graph": 1,
                     "loop.pose_graph_assemble": 1, "loop.pose_graph_solve": 1,
                     "loop.correct_points": 1, "loop.fuse_ends": 1, "loop.wait_gba": 2,
                     "loop.gba": 1, "loop.gba_solve": 1, "loop.gba_merge": 1,
                     "mapper.fuse_match": 1, "mapper.fuse_merge": 1}
    parent_of = {"loop.geometric_check": "loop.close", "loop.pose_graph": "loop.close",
                 "loop.pose_graph_assemble": "loop.pose_graph",
                 "loop.pose_graph_solve": "loop.pose_graph", "loop.correct_points": "loop.close",
                 "loop.fuse_ends": "loop.close", "loop.gba_solve": "loop.gba",
                 "loop.gba_merge": "loop.gba", "loop.close": None, "loop.wait_gba": None,
                 "loop.gba": None, "mapper.fuse_match": "loop.fuse_ends",
                 "mapper.fuse_merge": "loop.fuse_ends"}
    for s in spans:
        assert (by_id[s.parent].name if s.parent >= 0 else None) == parent_of[s.name], s
        assert s.thread.startswith("gba") == s.name.startswith("loop.gba"), s
        if s.parent >= 0:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    (closed,) = [s for s in spans if s.name == "loop.close" and
                 any(c.parent == s.id and c.name == "loop.pose_graph" for c in spans)]
    (gba,) = [s for s in spans if s.name == "loop.gba"]
    assert gba.start_ns >= closed.start_ns

    # the recorder off: the same closure records nothing
    tracing.disable()
    tracing.reset()
    monkeypatch.setattr(loop_closer, "global_bundle_adjust", real)
    monkeypatch.setattr(lc, "_geometric_check", lambda kf, cand, scale=1.0: (
        True, np_lie.se3_compose(st.kf_pose[0], np_lie.se3_inverse(st.kf_pose[7]))))
    assert lc._close_loop(7, 0) is True and lc.wait_gba() is True
    assert tracing.records() == []
    assert (lc.n_loops_closed, lc.n_gba_run, lc.n_gba_merged) == (2, 2, 2)
