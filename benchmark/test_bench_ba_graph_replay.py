"""The `mapper.ba_graph_replay_pct` reader on synthetic windows worked out by
hand, as benchmark/test_bench_program_spans.py does for the other span
readers.  The window is 0..1,000 ms; spans are (name, thread, start ms,
end ms, CPU ms)."""

import pytest
import torch

from benchmark import program_spans, spec
from benchmark.test_bench_program_spans import Recorder, _obs, _s

READER = "mapper.ba_graph_replay_pct"

# two local BAs inside the window, each holding its replay, and a third
# across the window's close whose replay lies inside the window
REPLAYED = [
    _s("mapper.keyframe", "mapping", 100, 400, 200),
    _s("mapper.local_ba", "mapping", 150, 300, 100),
    _s("mapper.ba_replay", "mapping", 200, 290, 20),
    _s("mapper.local_ba", "mapping", 500, 700, 90),
    _s("mapper.ba_replay", "mapping", 510, 600, 30),
    _s("mapper.local_ba", "mapping", 950, 1200, 300),
    _s("mapper.ba_replay", "mapping", 960, 990, 10),
]


@pytest.fixture
def reader():
    return spec.metric_reader(READER)


def _on_card():
    return _obs()._replace(device=torch.device("cuda", 0))


def _read(reader, monkeypatch, spans):
    monkeypatch.setattr(program_spans, "tracing", Recorder(spans))
    return reader.read(_on_card())


def test_every_local_ba_replayed_reads_100(reader, monkeypatch):
    assert _read(reader, monkeypatch, REPLAYED) == pytest.approx(100.0)


def test_spans_outside_the_window_are_left_out(reader, monkeypatch):
    # an eager local BA before the window's open and one across it count for nothing
    early = [_s("mapper.local_ba", "mapping", -900, -100, 700),
             _s("mapper.local_ba", "mapping", -50, 120, 150)]
    assert _read(reader, monkeypatch, early + REPLAYED) == pytest.approx(100.0)
    # a replay span outside its local BA, or on another thread, holds nothing
    stray = [_s("mapper.local_ba", "mapping", 750, 900, 140),
             _s("mapper.ba_replay", "mapping", 720, 800, 10),
             _s("mapper.ba_replay", "MainThread", 760, 790, 10)]
    assert _read(reader, monkeypatch, REPLAYED + stray) == pytest.approx(200.0 / 3)


def test_an_eager_local_ba_lowers_the_share(reader, monkeypatch):
    eager = [_s("mapper.local_ba", "mapping", 720, 900, 170),
             _s("mapper.ba_capture", "mapping", 800, 890, 80)]
    assert _read(reader, monkeypatch, REPLAYED + eager) == pytest.approx(200.0 / 3)


def test_nothing_to_read_gives_nothing(reader, monkeypatch):
    for spans in ([], [_s("mapper.keyframe", "mapping", 100, 400, 200)], REPLAYED[-2:]):
        assert _read(reader, monkeypatch, spans) is None      # no local BA inside the window
    monkeypatch.setattr(program_spans, "tracing", None)          # no recorder
    assert reader.read(_on_card()) is None
    monkeypatch.setattr(program_spans, "tracing", Recorder(REPLAYED))
    assert reader.read(_obs()) is None                           # the CPU: no graph there
    monkeypatch.setattr(reader, "_has_graph", lambda: False)     # a program without the graph
    assert _read(reader, monkeypatch, REPLAYED) is None
