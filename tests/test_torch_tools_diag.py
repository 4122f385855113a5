"""The port's diagnostic and profiling tools (spslam_tpu_torch/tools/:
loop_lane_debug, debug_loop, ate_debug, profile_frame, profile_fused,
profile_ab, profile_pipeline, profile_tunnel, profile_xfer) on the CPU.

Tolerances, each where it is checked:
* profile_ab's replica and profile_fused's full variant: out_small and
  out_big equal to track_frame_step's bit for bit (the same ops in the same
  order), at a 320x240 frame, 256 features and a 512-point snapshot;
* debug_loop's gate values (covis_min, min-score, top-5, excluded), as
  the tracer reads them from the detector's LoopCloser._gates: equal to
  the same formula through spslam_tpu's Vocabulary.bow_vector and
  bow_similarity on the reference closer's own database, to 1e-12 (both
  sum float64 weights in the same word order); the tracer restores the
  instance's methods;
* loop_lane_debug's per-pass function on the lane's first 12 frames at
  device="cpu": ATE < 20 mm, the
  reference's per-pass keys (ATE, loops, median, spike, keyframes, events)
  and this port's (closures, gba, worker errors, launches), no worker
  error, no B1 launch (the CPU computes the plain version);
* the view gap: within 2 degrees of the loop trajectory's wrapped yaw gap
  (its pitch sway is 0.03 rad at most); the loop-edge error: 0 for the
  true edge, 10 mm and 1 degree for an edge moved by those, to 1e-3 (the
  trajectory's float32 quaternions);
* profile_tunnel's frame layout: the reference tool's bytes exactly;
* profile_frame, profile_fused, profile_ab and profile_pipeline at n = 1:
  their count of the frames they build equals the detect_levels calls
  (chip_smoke holds the card's launches to it), every time positive;
* ate_debug on 4 orbit frames: the async mode's keys, ATE < 20 mm (the
  sync mode is held to the JAX package in tests/test_torch_system.py);
* every tool's main raises RuntimeError without CUDA.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from spslam_tpu.loop.vocab import bow_similarity as jbow_similarity
from spslam_tpu_torch import bench
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.io.synthetic import loop_trajectory, make_room, make_sequence, render_frame
from spslam_tpu_torch.tools import (debug_loop, loop_lane_debug, profile_ab, profile_frame,
                                    profile_fused, profile_tunnel, profile_xfer)
from spslam_tpu_torch.tracking.tracker import TrackerConfig
from tests.test_torch_common import DEV
from tests.test_torch_config_parity import N_KF, _closer_pair

TOOLS = ("loop_lane_debug", "debug_loop", "ate_debug", "profile_frame", "profile_fused",
         "profile_ab", "profile_pipeline", "profile_tunnel", "profile_xfer")


@pytest.fixture(scope="module")
def small_seq():
    intr = Intrinsics(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=20.0, width=320, height=240)
    return make_sequence(n_frames=1, intr=intr)


SMALL_CFG = TrackerConfig(n_features=256, local_points_cap=512)


@pytest.fixture(scope="module")
def small_inputs(small_seq):
    return profile_frame.fused_inputs(small_seq, SMALL_CFG, DEV)


def _assert_same_outputs(got, want):
    assert torch.equal(got[1], want[1]), "out_small"
    assert torch.equal(got[2], want[2]), "out_big"


@pytest.mark.parametrize("has_vel", [True, False])
def test_profile_ab_replica_equals_step(small_inputs, has_vel):
    x = small_inputs
    q = torch.tensor([0.99, 0.05, -0.1, 0.02])
    T = torch.cat([q / q.norm(), torch.tensor([0.1, -0.05, 0.2])])
    hv = torch.tensor(has_vel)
    want = profile_frame.real_step(x, T, x["T0"], hv)
    _assert_same_outputs(profile_ab.replica(x, T, x["T0"], hv), want)


def test_profile_fused_full_variant_equals_step(small_inputs):
    x = small_inputs
    full = dict(profile_fused.CASES)["  + pack outputs"]
    _, small, big, _ = profile_fused.variant(x, **full)(x["T0"])
    # T_prev = T_prev2 = identity with a velocity: the step's prediction is
    # the identity exactly and its coarse radius the motion radius
    want = profile_frame.real_step(x, x["T0"], x["T0"], torch.tensor(True))
    _assert_same_outputs((None, small, big), want)
    fresh = profile_fused.real_variant(x, fresh_scalars=True)(x["T0"])
    _assert_same_outputs((None, fresh[1], fresh[2]), want)


@pytest.mark.parametrize("tool", ["profile_frame", "profile_fused", "profile_ab",
                                  "profile_pipeline"])
def test_profile_tools_count_the_frames_they_build(small_seq, tool, monkeypatch):
    """Each tool's count of the frames it builds (chip_smoke holds the
    card's FAST+NMS launches to it) equals the detect_levels calls made."""
    from spslam_tpu_torch.ops import fast_cuda

    calls = []
    plain = fast_cuda.fast_nms_scores_levels

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(fast_cuda, "fast_nms_scores_levels", counting)
    if tool == "profile_frame":
        r = profile_frame.profile(small_seq, SMALL_CFG, DEV, n=1, warmup=1)
        times, frames = [v for k, v in r.items() if k[0] != "_"], r["_frames"]
    elif tool == "profile_fused":
        rows = profile_fused.profile(small_seq, SMALL_CFG, DEV, n=1)
        times, frames = [ms for _, ms, _ in rows], len(rows) * 2   # n + 1 a case off the card
        assert len(rows) == len(profile_fused.CASES) + 2
    elif tool == "profile_ab":
        ra, rb = profile_ab.profile(small_seq, SMALL_CFG, DEV, n=1, reps=1)
        times, frames = ra + rb, 2 * (1 + 1) * 1
    else:
        from spslam_tpu_torch.tools import profile_pipeline

        r = profile_pipeline.profile(small_seq, SMALL_CFG, DEV, n=1)
        times, frames = [v for k, v in r.items() if k[0] != "_"], r["_frames"]
    assert len(calls) == frames
    assert all(np.isfinite(t) and t > 0 for t in times)


def test_ate_debug_modes_on_cpu():
    """The async mode's keys and line (the sync mode is held to the JAX
    package in tests/test_torch_system.py)."""
    from spslam_tpu_torch.tools import ate_debug

    r = ate_debug.run(make_sequence(n_frames=4), "async", DEV)
    assert set(r) == {"mode", "ate", "kfs", "pts", "metrics_kf"}
    assert r["kfs"] >= 1 and r["pts"] > 0 and 0 < r["ate"] < 0.02
    assert ate_debug.line(r).startswith("async     : ATE ")


def _covisible_closer_pair():
    """_closer_pair(0.0) with 24 points of keyframe 15 also seen by
    keyframes 14 and 13 and 8 of them by keyframe 9 (keyframe 15's
    covisible set: 13 and 14 at weight 24, 9 at 8)."""
    pair = _closer_pair(0.0)
    for lc in pair:
        st = lc.store
        slots = np.arange(24)
        pos = np.tile(np.array([0, 0, 2], np.float32), (24, 1))
        ids = st.add_points_bulk(pos, st.kf_desc[N_KF - 1][slots],
                                 np.tile(np.array([0, 0, 1], np.float32), (24, 1)),
                                 np.ones(24, np.float32), N_KF - 1, slots)
        st.add_observations_bulk(ids, 14, slots)
        st.add_observations_bulk(ids, 13, slots)
        st.add_observations_bulk(ids[:8], 9, slots[:8])
    return pair


def _reference_gates(jlc, kf):
    """The reference tool's gate formula through spslam_tpu's vocabulary and
    bow_similarity, over every covisible keyframe as its detector takes it."""
    st = jlc.store
    bow = jlc.vocab.bow_vector(st.kf_desc[kf][st.kf_kp_valid[kf]])
    covis = st.covisibility(kf, min_weight=5)
    exclude = set(int(c) for c in covis) | {int(kf)}
    exclude |= {int(k) for k in range(st.n_kf)
                if abs(int(st.kf_frame_id[k]) - int(st.kf_frame_id[kf])) < 1
                or kf - k < jlc.cfg.min_interval_kfs}
    scores = [s for s in (jbow_similarity(bow, jlc.kfdb.bow.get(int(c), {})) for c in covis)
              if s > 0]
    ms = min(scores) if scores else None
    everything = {k: jbow_similarity(bow, b) for k, b in jlc.kfdb.bow.items()}
    top = sorted(((v, k) for k, v in everything.items()), reverse=True)[:5]
    return dict(covis_min=ms, min_score=max(0.015, ms or 0), top=[(k, v) for v, k in top],
                excluded=sorted(exclude & set(jlc.kfdb.bow.keys()))), list(covis)


def test_debug_loop_gates_match_reference():
    jlc, tlc = _covisible_closer_pair()
    kf = N_KF - 1
    want, covis = _reference_gates(jlc, kf)
    assert sorted(map(int, covis)) == [9, 13, 14]
    lines = []
    with debug_loop.GateTracer(tlc, lines.append) as tracer:
        closed = tlc.process_keyframe(kf)
    assert closed == jlc.process_keyframe(kf)
    assert "process_keyframe" not in vars(tlc) and "_geometric_check" not in vars(tlc)
    (got,) = tracer.rows
    assert got["kf"] == kf and got["closed"] == closed
    # the gates the detector applied, as it applied them
    assert got["min_score"] == tlc.last_gates["min_score"]
    assert want["covis_min"] is not None and got["covis_min"] == pytest.approx(
        want["covis_min"], rel=0, abs=1e-12)
    assert got["min_score"] == pytest.approx(want["min_score"], rel=0, abs=1e-12)
    assert [k for k, _ in got["top"]] == [k for k, _ in want["top"]] and len(got["top"]) == 5
    np.testing.assert_allclose([v for _, v in got["top"]], [v for _, v in want["top"]],
                               rtol=0, atol=1e-12)
    assert got["excluded"] == want["excluded"] and 14 in got["excluded"]
    assert lines[0].startswith(f"KF {kf} (frame {kf}): covis_min=")
    assert "consistent-groups" in lines[-1]


def _lane_head(n: int):
    """The first n frames of the lane's 128-frame render, u8/u16 (the same
    room, poses and depth-noise draws, without rendering the other 116)."""
    seq = make_sequence(n_frames=1, trajectory="loop")
    rects = make_room(seed=0)
    rng = np.random.default_rng(2)              # make_sequence's draw for seed 0
    seq.poses_gt = loop_trajectory(128)[:n]
    seq.frames = bench.quantized([render_frame(rects, T, seq.intr, 0.004, rng)
                                  for T in seq.poses_gt])
    seq.timestamps = np.arange(n) / 30.0
    return seq


def test_lane_head_starts_as_make_sequence():
    # frame 0's pose is the same at every length, so the first frame and
    # depth-noise draw must equal make_sequence's
    want = bench.quantized(make_sequence(n_frames=2, trajectory="loop",
                                         depth_noise=0.004).frames[:1])[0]
    got = _lane_head(1).frames[0]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_loop_lane_pass_on_cpu():
    seq = _lane_head(12)
    res = loop_lane_debug.run_pass(loop_lane_debug.lane_system(seq, DEV), seq)
    assert set(loop_lane_debug.PASS_KEYS) <= set(res)
    assert res["kfs"] >= 1 and 0 < res["ate_mm"] < 20.0
    assert res["median_ms"] > 0 and res["spike_ms"] > 0
    assert res["worker_errors"] == [] and res["launches"] == 0
    assert res["loops"] == len(res["closures"]) == 0
    assert all(e["kind"] in ("detect", "closed", "gba") for e in res["events"])


def test_view_gap_is_the_wrapped_yaw():
    n = 128
    poses = loop_trajectory(n)
    for k in (10, 47, 64, 94, 127):
        yaw = math.degrees(2 * math.pi * 1.25 * k / n) % 360.0
        assert loop_lane_debug.view_gap_deg(poses[0], poses[k]) == pytest.approx(
            min(yaw, 360.0 - yaw), abs=2.0)
    intr = make_sequence(n_frames=1).intr
    assert loop_lane_debug.half_fov_deg(intr) == pytest.approx(31.37, abs=0.01)


def test_closure_truth_and_edge_error():
    poses = loop_trajectory(128)
    intr = make_sequence(n_frames=1).intr
    from spslam_tpu_torch.geometry import np_lie

    exact = np_lie.se3_compose(poses[0], np_lie.se3_inverse(poses[91]))
    assert loop_lane_debug.edge_error(exact, poses[0], poses[91]) == pytest.approx((0, 0),
                                                                                    abs=1e-3)
    # 10 mm along x and 1 degree about z on the left of the true edge
    h = math.radians(0.5)
    off = np.array([math.cos(h), 0, 0, math.sin(h), 0.01, 0, 0])
    mm, deg = loop_lane_debug.edge_error(np_lie.se3_compose(off, exact), poses[0], poses[91])
    # the trajectory is float32: its quaternions carry ~1e-7, 1e-3 deg after acos
    assert mm == pytest.approx(10.0, abs=1e-3) and deg == pytest.approx(1.0, abs=1e-3)
    events = [dict(kind="detect"), dict(kind="closed", kf=2, cand=0, early=False, inliers=94),
              dict(kind="gba")]
    kf_frame_id = np.array([0, 50, 91])
    (c,) = loop_lane_debug.closure_truth(events, [(0, 2, exact)], kf_frame_id, poses, intr)
    assert (c["frame"], c["cand_frame"], c["inliers"]) == (91, 0, 94)
    assert c["gap_deg"] == pytest.approx(40.07, abs=0.01) and not c["true_revisit"]
    assert c["edge_err_mm"] == pytest.approx(0, abs=0.1)


def test_tunnel_frame_layout_and_copy_tools_on_cpu():
    seq = make_sequence(n_frames=1)
    gray, depth = seq.frames[0]
    g = np.clip(gray, 0, 255).astype(np.uint8)
    d = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
    d8 = d[None].view(np.uint8).reshape(depth.shape[0], depth.shape[1], 2)
    np.testing.assert_array_equal(profile_tunnel.frame_u8(seq),
                                  np.stack([g, d8[..., 0], d8[..., 1]]))
    rows = profile_xfer.size_curve(DEV, sizes_kb=(16,), reps=1)
    assert [(kb, dr, m) for kb, dr, m, _ in rows] == [
        (16, "up", "pageable"), (16, "up", "pinned"), (16, "down", "pageable"),
        (16, "down", "pinned")]


@pytest.mark.parametrize("tool", TOOLS)
def test_main_without_cuda_raises(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = importlib.import_module(f"spslam_tpu_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
