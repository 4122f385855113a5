"""The readers of fusion's spans (`mapper.fuse_cpu_ms_per_keyframe`,
`mapper.fuse_graph_replay_pct`, `mapper.fuse_merge_cpu_ms_per_keyframe`)
on synthetic windows worked out by hand, as
benchmark/test_bench_ba_graph_replay.py does for the local BA's.  The
window is 0..1,000 ms; spans are (name, thread, start ms, end ms, CPU ms).
"""

import pytest
import torch

from benchmark import program_spans, spec
from benchmark.test_bench_program_spans import Recorder, _obs, _s

READERS = ("mapper.fuse_cpu_ms_per_keyframe", "mapper.fuse_graph_replay_pct",
           "mapper.fuse_merge_cpu_ms_per_keyframe")

# two fusions inside the window, each of two blocks that replay, and a
# third across the window's close whose block lies inside the window
REPLAYED = [
    _s("mapper.keyframe", "mapping", 100, 400, 200),
    _s("mapper.fuse", "mapping", 110, 300, 120),
    _s("mapper.fuse_match", "mapping", 120, 160, 20),
    _s("mapper.fuse_replay", "mapping", 125, 158, 18),
    _s("mapper.fuse_merge", "mapping", 160, 200, 30),
    _s("mapper.fuse_match", "mapping", 200, 240, 20),
    _s("mapper.fuse_replay", "mapping", 205, 238, 18),
    _s("mapper.fuse_merge", "mapping", 240, 290, 40),
    _s("mapper.fuse", "mapping", 500, 700, 80),
    _s("mapper.fuse_match", "mapping", 510, 540, 10),
    _s("mapper.fuse_replay", "mapping", 511, 539, 9),
    _s("mapper.fuse_merge", "mapping", 540, 560, 10),
    _s("mapper.fuse_match", "mapping", 560, 600, 10),
    _s("mapper.fuse_replay", "mapping", 561, 599, 9),
    _s("mapper.fuse_merge", "mapping", 600, 650, 30),
    _s("mapper.fuse", "mapping", 950, 1200, 300),
    _s("mapper.fuse_match", "mapping", 955, 980, 10),
    _s("mapper.fuse_replay", "mapping", 956, 979, 9),
    _s("mapper.fuse_merge", "mapping", 980, 999, 15),
]


@pytest.fixture
def readers():
    return {n: spec.metric_reader(n) for n in READERS}


def _on_card():
    return _obs()._replace(device=torch.device("cuda", 0))


def _read(readers, monkeypatch, spans, obs=None):
    monkeypatch.setattr(program_spans, "tracing", Recorder(spans))
    o = _on_card() if obs is None else obs
    return {n: r.read(o) for n, r in readers.items()}


def test_the_readers_read_the_hand_worked_numbers(readers, monkeypatch):
    got = _read(readers, monkeypatch, REPLAYED)
    # (120 + 80) / 2 whole fusions
    assert got["mapper.fuse_cpu_ms_per_keyframe"] == pytest.approx(100.0)
    # the five matches inside the window all hold a replay
    assert got["mapper.fuse_graph_replay_pct"] == pytest.approx(100.0)
    # the merges inside the two whole fusions: (30 + 40 + 10 + 30) / 2
    assert got["mapper.fuse_merge_cpu_ms_per_keyframe"] == pytest.approx(55.0)


def test_spans_outside_the_window_or_their_fusion_are_left_out(readers, monkeypatch):
    # an eager fusion before the window's open and one across it count for nothing
    early = [_s("mapper.fuse", "mapping", -900, -100, 700),
             _s("mapper.fuse_match", "mapping", -800, -700, 90),
             _s("mapper.fuse", "mapping", -50, 120, 150),
             _s("mapper.fuse_match", "mapping", -40, 20, 60)]
    got = _read(readers, monkeypatch, early + REPLAYED)
    assert got["mapper.fuse_cpu_ms_per_keyframe"] == pytest.approx(100.0)
    assert got["mapper.fuse_graph_replay_pct"] == pytest.approx(100.0)
    assert got["mapper.fuse_merge_cpu_ms_per_keyframe"] == pytest.approx(55.0)
    # a loop closure's fusion: its match counts in the share, its merge
    # (outside any mapper.fuse) not in the merge time; a replay outside its
    # match, or on another thread, holds nothing
    loop = [_s("loop.fuse_ends", "mapping", 750, 900, 100),
            _s("mapper.fuse_match", "mapping", 760, 800, 20),
            _s("mapper.fuse_replay", "mapping", 740, 790, 10),
            _s("mapper.fuse_replay", "MainThread", 770, 790, 10),
            _s("mapper.fuse_merge", "mapping", 800, 890, 80)]
    got = _read(readers, monkeypatch, REPLAYED + loop)
    assert got["mapper.fuse_cpu_ms_per_keyframe"] == pytest.approx(100.0)
    assert got["mapper.fuse_graph_replay_pct"] == pytest.approx(500.0 / 6)
    assert got["mapper.fuse_merge_cpu_ms_per_keyframe"] == pytest.approx(55.0)


def test_an_eager_match_lowers_the_share(readers, monkeypatch):
    eager = [_s("mapper.fuse", "mapping", 720, 900, 170),
             _s("mapper.fuse_match", "mapping", 730, 800, 60),
             _s("mapper.fuse_capture", "mapping", 770, 795, 20),
             _s("mapper.fuse_merge", "mapping", 800, 850, 40)]
    got = _read(readers, monkeypatch, REPLAYED + eager)
    assert got["mapper.fuse_graph_replay_pct"] == pytest.approx(500.0 / 6)
    assert got["mapper.fuse_cpu_ms_per_keyframe"] == pytest.approx((120 + 80 + 170) / 3)
    assert got["mapper.fuse_merge_cpu_ms_per_keyframe"] == pytest.approx((110 + 40) / 3)


def test_nothing_to_read_gives_nothing(readers, monkeypatch):
    # no fusion or match inside the window (the last fusion crosses its close)
    for spans in ([], [_s("mapper.keyframe", "mapping", 100, 400, 200)],
                  [REPLAYED[-4], REPLAYED[-1]]):
        assert _read(readers, monkeypatch, spans) == dict.fromkeys(READERS)
    monkeypatch.setattr(program_spans, "tracing", None)          # no recorder
    assert {n: r.read(_on_card()) for n, r in readers.items()} == dict.fromkeys(READERS)
    # the parent: fusion without the match and merge spans
    parent = [s for s in REPLAYED if s.name in ("mapper.keyframe", "mapper.fuse")]
    got = _read(readers, monkeypatch, parent)
    assert got == {"mapper.fuse_cpu_ms_per_keyframe": pytest.approx(100.0),
                   "mapper.fuse_graph_replay_pct": None,
                   "mapper.fuse_merge_cpu_ms_per_keyframe": None}
    # the CPU: no graph there, the CPU times still read
    got = _read(readers, monkeypatch, REPLAYED, obs=_obs())
    assert got["mapper.fuse_graph_replay_pct"] is None
    assert got["mapper.fuse_merge_cpu_ms_per_keyframe"] == pytest.approx(55.0)
    # a program without the graph
    share = readers["mapper.fuse_graph_replay_pct"]
    monkeypatch.setattr(share, "_has_graph", lambda: False)
    assert _read(readers, monkeypatch, REPLAYED)["mapper.fuse_graph_replay_pct"] is None
