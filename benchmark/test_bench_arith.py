"""The arithmetic of the metrics: end-to-end statistics, the device trace,
kernel B1's count and the per-layer readers."""

import math

import numpy as np
import pytest

from benchmark import b1_count, spec, stats
from benchmark import trace as tr
from benchmark.harness import Observations
from benchmark.scene import orbit_trajectory


def test_frames_per_s_is_all_frames_over_all_time():
    # 5 frames resolved inside a 10 s window, one after it, one never
    t_res = [1.0, 2.0, 2.0, 9.5, 10.0, 10.5, None]
    assert stats.frames_per_s(t_res, 0.0, 10.0) == 0.5


def test_resolution_times_follow_trajectory_growth():
    # a depth-2 pipeline: calls 0, 1 resolve nothing; call 2 resolves frame
    # 0, call 3 frame 1; the flush resolves frames 2 and 3
    ends = [1.0, 2.0, 3.0, 4.0, 6.0]
    n_traj = [0, 0, 1, 2, 4]
    assert stats.resolved_times(ends, n_traj) == [3.0, 4.0, 6.0, 6.0]


def test_latency_p90_over_every_frame():
    starts = np.arange(10, dtype=float)
    resolved = starts + np.array([1, 1, 1, 1, 1, 1, 1, 1, 2, 11], dtype=float)
    # numpy's linear 90th percentile of [1]*8 + [2, 11] is 2 + 0.1 * 9
    assert stats.latency_p90_ms(starts, resolved) == pytest.approx(2900.0)


def _moved(poses_cw, shift):
    """The same trajectory seen from a world frame shifted by `shift`:
    T_cw' = T_cw * T_(w w')."""
    out = poses_cw.copy()
    R = stats.quat_to_mat(poses_cw[:, :4].astype(np.float64))
    out[:, 4:7] = poses_cw[:, 4:7] - np.einsum("fij,j->fi", R, shift)
    return out


def test_pooled_ate_aligns_each_session_and_pools_frames():
    gt = orbit_trajectory(40).astype(np.float64)
    a = _moved(gt, np.array([0.3, -0.2, 1.0]))             # a rigid offset: no error
    assert stats.pooled_ate_mm([(a, gt)]) == pytest.approx(0.0, abs=1e-4)
    b = gt.copy()
    b[::2, 4] += 0.002                                      # +-1 mm about the mean
    e_b = stats.ate_errors(b, gt)
    both = stats.pooled_ate_mm([(a, gt), (b, gt)])
    assert both == pytest.approx(math.sqrt(np.sum(e_b ** 2) / 80) * 1e3, rel=1e-6)
    assert stats.pooled_ate_mm([(b, gt)]) == pytest.approx(math.sqrt(np.mean(e_b ** 2)) * 1e3)


def test_trace_union_gaps_and_breakdown():
    ev = [("k1", 0, 10), ("k2", 5, 20), ("Memcpy HtoD", 30, 40), ("k1", 35, 50),
          ("k3", 90, 130)]
    t = tr.summarize(ev, 2, 100)
    assert t.busy_ns == (20 - 2) + (50 - 30) + (100 - 90)
    assert t.gaps == [(20, 30), (50, 90)]
    assert [k[0] for k in t.kernels()] == ["k1", "k2", "k1", "k3"]
    assert t.window_s == pytest.approx(98e-9)
    spans = [("tracker call", 0, 80), ("mapper", 55, 95)]
    b = tr.breakdown(t, spans)
    assert b["idle_gaps"] == [["mapper+tracker call", 40e-9], ["tracker call", 10e-9]]
    assert b["device_ops"][0] == ["k1", 23e-9]


def test_b1_count_matches_the_kernels_frozen_numbers():
    sizes = b1_count.level_sizes(480, 640, 8, 1.2)
    w = b1_count.work(sizes)
    assert w.add_ops + w.minmax_ops == 113_820_700 and w.minmax_ops == 85_135_192
    assert w.bytes == 7_604_256
    assert b1_count.bound_s(w) == pytest.approx(85_135_192 / (132 * 64 * 1.98e9))


def test_b1_ring_count_is_the_ports_on_a_rendered_frame():
    """The compass-test count that the bound takes is the port's, on the
    pyramid the port builds (frozen copies, same numbers today)."""
    import torch
    from spslam_tpu_torch.ops import fast_cuda
    from spslam_tpu_torch.ops.fast import compass_reject
    from spslam_tpu_torch.ops.pyramid import build_pyramid_levels, default_spec

    from benchmark import scene
    from benchmark.reference.pyramid import PyramidSpec

    cam = scene.Camera(535.4, 539.2, 320.1, 247.6, 640, 480)
    g, _ = scene.render_frames(scene.make_room(3), scene.orbit_trajectory(40)[:1], cam, "cpu")
    gray = torch.clamp(g[0], 0, 255).to(torch.uint8)
    spec = default_spec(480, 640)
    levels, _ = build_pyramid_levels(gray.float(), spec, blur=False)
    want = sum(int((~compass_reject(x, 7.0))[fast_cuda.scored_region(*x.shape, 19)].sum())
               for x in levels)
    got = b1_count.ring_px(gray, PyramidSpec(*spec), 7.0)
    assert got == want and 0 < got < b1_count.work(spec.level_sizes).minmax_ops
    mine = b1_count.work(spec.level_sizes, ring_px=got)
    port = fast_cuda.fast_nms_work(spec.level_sizes, 19, got)
    assert (mine.add_ops + mine.minmax_ops, mine.minmax_ops) == (port.ops, port.minmax_ops)


def _obs(**kw):
    base = dict(perf={}, spans=[], trace=tr.summarize([], 0, 10**9), frames_resolved=0,
                config=spec.cell("orbslam2_tum3.orbit").config, frames=[], device="cpu")
    base.update(kw)
    return Observations(**base)


def test_every_per_layer_reader_reads_its_quantity_or_nothing():
    names = [m["name"] for m in spec.benchmark()["per_layer"]]
    readers = {n: spec.metric_reader(n) for n in names}
    for r in readers.values():      # nothing to read: nothing returned
        assert r.read(_obs()) is None
    perf = {"upload": 0.1, "snapshot": 0.2, "dispatch": 0.7, "wait_small": 0.05,
            "decode": 0.01, "kf_insert": 0.04, "n_frames": 4}
    b1 = b1_count.bound_s(b1_count.work(b1_count.level_sizes(480, 640, 8, 1.2)))
    ev = [("fast_nms_levels_kernel(LevelTable, int, float, float, int)", 0, int(4 * b1 * 1e9)),
          ("void at::native::add", 5 * 10**8, 6 * 10**8)]
    spans = [("mapper", 0, 2_000_000), ("mapper", 0, 4_000_000), ("plane mapper", 0, 1_000_000),
             ("loop closer", 0, 500_000)]
    flat = np.full((480, 640), 100, np.uint8)    # no pixel passes the compass test
    o = _obs(perf=perf, trace=tr.summarize(ev, 0, 10**9), frames_resolved=2, spans=spans,
             frames=[flat])
    got = {n: r.read(o) for n, r in readers.items()}
    assert got["tracker.dispatch_ms"] == pytest.approx(250.0)
    assert got["tracker.resolve_ms"] == pytest.approx(25.0)
    assert got["device.kernels_per_frame"] == 1.0
    assert got["device.idle_pct"] == pytest.approx(100 * (1 - (4 * b1 + 0.1)))
    ring_free = b1_count.bound_s(b1_count.work(b1_count.level_sizes(480, 640, 8, 1.2), ring_px=0))
    assert got["fast_nms_roofline"] == pytest.approx(25.0 * ring_free / b1, rel=1e-3)
    assert got["mapper.ms_per_keyframe"] == 3.0
    assert got["planes.ms_per_keyframe"] == 1.0
    assert got["loop.ms_per_keyframe"] == 0.5
