"""The readers of the program's spans (benchmark/program_spans.py and the
five metrics that read it) on a synthetic window worked out by hand.

The window is 0..1,000 ms.  The device runs at 0-100, 300-350 and
600-700 ms, so it idles over (100, 300), (350, 600) and (700, 1,000).
The tracker thread ("MainThread") and the mapping worker ("mapping") hold
these spans (ms; CPU ms after the colon):

    MainThread  tracker.dispatch   -200..-100 : 999   before the window
                tracker.dispatch_frame 50..450 : 300
                  tracker.upload       60..80  : 10
                  tracker.snapshot     80..100 : 15
                  tracker.dispatch    100..400 : 200
                    step.build        120..250 : 100
                tracker.resolve_frame 500..900 : 50
                  tracker.wait_small  500..880 : 5
                tracker.dispatch      980..1,050 : 20  clipped to 980..1,000
    mapping     pipeline.queue_wait    40..150, 450..810 (no CPU time)
                worker.keyframe       150..800 : 400
                  mapper.keyframe     160..700 : 300
                    mapper.local_ba   400..650 : 150
                  planes.keyframe     700..780 : 30
                worker.keyframe       810..995 : 110
                  mapper.keyframe     820..990 : 100
                planes.keyframe       -50..20  : 40    across the open
                mapper.keyframe       995..1,400 : 900   across the close
                pipeline.queue_wait   990..1,300

with 2 frames resolved (Tracker.perf's n_frames).  The means per keyframe
leave out the spans across the window's edges; the idle attribution
clips them.
"""

from typing import NamedTuple, Optional

import pytest

from benchmark import program_spans, spec
from benchmark import trace as tr
from benchmark.harness import Observations

MS = 1_000_000


class S(NamedTuple):
    name: str
    thread: str
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]
    id: int = 0
    parent: int = -1


def _s(name, thread, a, b, cpu):
    return S(name, thread, a * MS, b * MS, None if cpu is None else cpu * MS)


SPANS = [
    _s("tracker.dispatch", "MainThread", -200, -100, 999),
    _s("tracker.dispatch_frame", "MainThread", 50, 450, 300),
    _s("tracker.upload", "MainThread", 60, 80, 10),
    _s("tracker.snapshot", "MainThread", 80, 100, 15),
    _s("tracker.dispatch", "MainThread", 100, 400, 200),
    _s("step.build", "MainThread", 120, 250, 100),
    _s("tracker.resolve_frame", "MainThread", 500, 900, 50),
    _s("tracker.wait_small", "MainThread", 500, 880, 5),
    _s("tracker.dispatch", "MainThread", 980, 1050, 20),
    _s("pipeline.queue_wait", "mapping", 40, 150, None),
    _s("worker.keyframe", "mapping", 150, 800, 400),
    _s("mapper.keyframe", "mapping", 160, 700, 300),
    _s("mapper.local_ba", "mapping", 400, 650, 150),
    _s("planes.keyframe", "mapping", 700, 780, 30),
    _s("pipeline.queue_wait", "mapping", 450, 810, None),
    _s("worker.keyframe", "mapping", 810, 995, 110),
    _s("mapper.keyframe", "mapping", 820, 990, 100),
    _s("planes.keyframe", "mapping", -50, 20, 40),
    _s("mapper.keyframe", "mapping", 995, 1400, 900),
    _s("pipeline.queue_wait", "mapping", 990, 1300, None),
]

EVENTS = [("k1", 0, 100 * MS), ("k2", 300 * MS, 350 * MS), ("k3", 600 * MS, 700 * MS)]

READERS = ("tracker.dispatch_cpu_ms", "device.idle_in_step_pct", "mapper.cpu_ms_per_keyframe",
           "planes.cpu_ms_per_keyframe", "pipeline.queue_wait_ms")


class Recorder:
    def __init__(self, spans):
        self._spans = list(spans)

    def records(self):
        return list(self._spans)


def _obs(events=EVENTS):
    return Observations(perf={"n_frames": 2}, spans=[], trace=tr.summarize(events, 0, 1000 * MS),
                        frames_resolved=2, config=spec.cell("orbslam2_tum3.orbit").config,
                        frames=[], device="cpu")


@pytest.fixture
def readers():
    return {n: spec.metric_reader(n) for n in READERS}


def test_the_readers_read_the_hand_worked_numbers(readers, monkeypatch, capsys):
    monkeypatch.setattr(program_spans, "tracing", Recorder(SPANS))
    o = _obs()
    assert o.trace.gaps == [(100 * MS, 300 * MS), (350 * MS, 600 * MS), (700 * MS, 1000 * MS)]
    got = {n: r.read(o) for n, r in readers.items()}
    # (10 + 15 + 200 + 20) CPU ms in the window over 2 frames
    assert got["tracker.dispatch_cpu_ms"] == pytest.approx(122.5)
    # idle inside tracker.dispatch: 100..300, 350..400 and 980..1,000 = 270 of 1,000 ms
    assert got["device.idle_in_step_pct"] == pytest.approx(27.0)
    assert got["mapper.cpu_ms_per_keyframe"] == pytest.approx(200.0)
    assert got["planes.cpu_ms_per_keyframe"] == pytest.approx(30.0)
    assert got["pipeline.queue_wait_ms"] == pytest.approx(235.0)     # (110 + 360) / 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["device idle by (tracker span | worker span): "
                   "tracker.wait_small | mapper.keyframe: 0.300 s (30.0%); "
                   "- | mapper.local_ba: 0.250 s (25.0%); "
                   "step.build | mapper.keyframe: 0.200 s (20.0%)"]


def test_idle_is_named_by_each_threads_innermost_working_span():
    gaps = tr.summarize(EVENTS, 0, 1000 * MS).gaps
    # the queue wait (450..810, no CPU time) is open at 475 ms, inside the
    # local BA, and is left out: a wait is not what the worker is doing
    assert program_spans.idle_by_span(gaps, SPANS) == {
        ("step.build", "mapper.keyframe"): 200 * MS,
        ("-", "mapper.local_ba"): 250 * MS,
        ("tracker.wait_small", "mapper.keyframe"): 300 * MS}
    assert program_spans.overlap_ns([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == 5 + 5 + 2


def test_nothing_to_read_gives_nothing(readers, monkeypatch):
    for rec in (None, Recorder([]), Recorder(SPANS[:1])):    # no recorder, no span, none inside
        monkeypatch.setattr(program_spans, "tracing", rec)
        assert {n: r.read(_obs()) for n, r in readers.items()} == dict.fromkeys(READERS)
    monkeypatch.setattr(program_spans, "tracing", Recorder(SPANS))
    assert readers["device.idle_in_step_pct"].read(_obs(events=[])) is None
