"""Async mapping in the port (spslam_tpu_torch/tracking/pipeline.py, the
tracker's queue gate and snapshot refresh) against spslam_tpu on the CPU.

Gates and tolerances:
* tests/integration/test_async_pipeline.py's gates on the 20-frame orbit:
  async ATE < 30 mm and < 3 x max(sync, 3 mm); every submitted keyframe
  processed, no worker exception logged;
* the keyframe gate with a stubbed mapper queue (0, 1, kf_queue_cap): the
  reference's decision on the same store and inputs (exact), but where an
  urgent keyframe fails the ratio to the reference keyframe under async
  mapping: the port inserts it, the reference does not;
* `refresh_snapshot_values`: the same ids, pack and descriptors as a fresh
  `_local_snapshot_build` (exact), after a value and a topology change.
"""

import itertools
import logging
import threading

import numpy as np
import pytest

from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.map.store import MapConfig as JMapConfig, MapStore as JMapStore
from spslam_tpu.tracking.tracker import Tracker as JTracker, TrackerConfig as JTrackerConfig
from spslam_tpu_torch.eval.ate import ate_rmse
from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import Tracker, TrackerConfig
from tests.test_torch_common import DEV, n
from tests.test_torch_dist_gba import copy_store


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=20)


@pytest.fixture(scope="module")
def runs(seq):
    out = {}
    for mode in (False, True):
        s = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False,
                                async_mapping=mode), device=DEV)
        for (g, d), ts in zip(seq.frames, seq.timestamps):
            s.track_rgbd(g, d, ts)
        s.shutdown()
        out[mode] = s
    return out


def test_async_matches_sync_quality(seq, runs, caplog):
    ate = {m: ate_rmse(s.poses(), seq.poses_gt)[0] for m, s in runs.items()}
    assert ate[True] < 0.03, ate
    assert ate[True] < 3 * max(ate[False], 0.003), ate
    s = runs[True]
    assert s.store.n_kf >= 2
    assert s.tracker.mapper_queue_fn == s.pipeline.queue_len
    assert s.pipeline.n_processed == s.pipeline.n_submitted == s.store.n_kf
    assert s.pipeline.idle()


def test_worker_logs_and_survives_a_failing_keyframe(seq, caplog):
    s = System(SystemConfig(intr=seq.intr, enable_reloc=False, async_mapping=True), device=DEV)
    real = s.mapper.process_keyframe
    failed = []

    def fail_once(kf, run_ba=True):
        if not failed:
            failed.append(kf)
            raise RuntimeError("injected")
        return real(kf, run_ba=run_ba)

    s.mapper.process_keyframe = fail_once
    with caplog.at_level(logging.ERROR, logger="spslam_tpu_torch.tracking.pipeline"):
        for (g, d), ts in zip(seq.frames[:6], seq.timestamps[:6]):
            s.track_rgbd(g, d, ts)
        s.shutdown()
    assert failed and [r for r in caplog.records if "injected" in str(r.exc_info)]
    assert s.pipeline.n_processed == s.pipeline.n_submitted


def test_shutdown_idempotent(seq):
    s = System(SystemConfig(intr=seq.intr, async_mapping=True), device=DEV)
    for (g, d), ts in zip(seq.frames[:4], seq.timestamps[:4]):
        s.track_rgbd(g, d, ts)
    s.shutdown()
    s.shutdown()
    assert s.pipeline.idle()


def test_queue_gate_matches_reference(seq, runs):
    st = copy_store(runs[False].store)
    jst = copy_store(st, JMapStore, JMapConfig)
    port = Tracker(TrackerConfig(), seq.intr, st, device=DEV)
    ref = JTracker(JTrackerConfig(), JIntr(*seq.intr), jst)
    ref_kf = int(np.nonzero(st.kf_valid)[0][-1])
    for tr in (port, ref):
        tr.ref_kf = ref_kf
    cap = TrackerConfig().kf_queue_cap
    decisions = {}
    grid = itertools.product((0, 1, 5, 30), (20, 120, 300, 600), (30, 150), (150, 400),
                             (None, 700), (0, 1, cap))
    for since, n2, close_tr, close_av, n2_prev, q in grid:
        got = []
        for tr in (port, ref):
            tr.frames_since_kf = since
            tr.mapper_queue_fn = lambda q=q: q
            got.append(tr._need_new_kf(n2, close_tr, close_av, n2_prev=n2_prev))
        assert got[0] == got[1], (since, n2, close_tr, close_av, n2_prev, q)
        decisions[(since, n2, close_tr, close_av, n2_prev, q)] = got[0]
    # the queue moves some decisions (c1b needs an idle mapper; a full
    # queue holds back ordinary insertions)
    moved = [k for k in decisions if k[-1] == 0 and decisions[k] != decisions[k[:-1] + (cap,)]]
    assert moved
    port.mapper_queue_fn = None
    assert port._need_new_kf(20, 30, 400, n2_prev=None) == decisions[(1, 20, 30, 400, None, 0)]


def test_an_urgent_keyframe_skips_the_reference_ratio(seq, runs):
    """Inliers above 3/4 of the reference keyframe's points seen thrice, but
    falling so fast that the frames in flight would run out of map: with
    async mapping the port inserts, the reference's gate holds it back
    until the ratio is met.  Without the fall, or with synchronous
    mapping, both keep the keyframe out."""
    st = copy_store(runs[False].store)
    jst = copy_store(st, JMapStore, JMapConfig)
    port = Tracker(TrackerConfig(), seq.intr, st, device=DEV)
    ref = JTracker(JTrackerConfig(), JIntr(*seq.intr), jst)
    ref_kf = int(np.nonzero(st.kf_valid)[0][-1])
    for tr in (port, ref):
        tr.ref_kf = ref_kf
        tr.frames_since_kf = 1
        tr.mapper_queue_fn = lambda: 0
    assert not port._need_new_kf(10_000, 300, 400, n2_prev=None)
    ref_tracked = port._ref_tracked_cache[1]
    n2 = int(0.8 * ref_tracked) + 1
    depth = port.pipeline_depth
    n2_prev = n2 + (n2 - TrackerConfig().kf_urgent_cover) // depth + 1    # projects below 100
    assert n2 > TrackerConfig().kf_min_inliers
    assert port._need_new_kf(n2, 300, 400, n2_prev=n2_prev)
    assert not ref._need_new_kf(n2, 300, 400, n2_prev=n2_prev)
    assert not port._need_new_kf(n2, 300, 400, n2_prev=None)
    assert not ref._need_new_kf(n2, 300, 400, n2_prev=None)
    # synchronous mapping keeps the reference's gate
    port.mapper_queue_fn = None
    assert not port._need_new_kf(n2, 300, 400, n2_prev=n2_prev)


def _same_snapshot(a, b):
    assert np.array_equal(a[0], b[0])
    for x, y in zip(a[1:3], b[1:3]):
        np.testing.assert_array_equal(n(x), n(y))


def test_refresh_snapshot_values(runs):
    tr = runs[True].tracker
    st = tr.store
    tr._local_snapshot()
    # a value change (a BA write-back): the same rows re-gathered
    ids = tr._snapshot_cache[2][0]
    live = ids[ids >= 0]
    st.pt_pos[live] += 0.01
    st.version += 1
    tr.refresh_snapshot_values()
    assert tr._snapshot_cache[1] == st.version
    _same_snapshot(tr._snapshot_cache[2], tr._local_snapshot_build())
    # a topology change: the point set selected again
    st.erase_point(int(live[0]))
    st.topo_version += 1
    tr.refresh_snapshot_values()
    assert tr._snapshot_cache[0] == (st.topo_version, tr.ref_kf)
    _same_snapshot(tr._snapshot_cache[2], tr._local_snapshot_build())
    assert int(live[0]) not in tr._snapshot_cache[2][0]
    # nothing changed: a no-op
    cached = tr._snapshot_cache
    tr.refresh_snapshot_values()
    assert tr._snapshot_cache is cached


def test_a_closure_carries_a_keyframe_inserted_during_its_solve(monkeypatch):
    """The tracker inserts keyframe 8 (child of 7, with a point of its own)
    while the essential graph solves: the write-back moves it with its
    parent and its point with it, and the async System's tracker hears of
    the move once, under the store's lock, with the poses from before."""
    import torch

    from spslam_tpu_torch.geometry import np_lie
    from spslam_tpu_torch.loop import loop_closer
    from spslam_tpu_torch.loop.loop_closer import LoopCloser, LoopConfig
    from tests.test_torch_tracing import _loop_store

    st, intr = _loop_store()
    lc = LoopCloser(intr, st, cfg=LoopConfig(gba_async=False, gba_settle_iters=1,
                                             gba_stage1_iters=1, gba_stage2_iters=1),
                    device=DEV)
    # a loop edge 0.1 m off the map's: the closure moves keyframe 7
    T_loop = np_lie.se3_compose(np.array([1, 0, 0, 0, 0.1, 0, 0], np.float32),
                                np_lie.se3_compose(st.kf_pose[0], np_lie.se3_inverse(st.kf_pose[7])))
    monkeypatch.setattr(lc, "_geometric_check", lambda kf, cand, scale=1.0: (True, T_loop))
    monkeypatch.setattr(lc, "_global_refine", lambda: None)
    solve = loop_closer.optimize_pose_graph
    X = np.array([[0.3, -0.2, 5.0]], np.float32)

    def solve_while_tracking(prob, n_iters=20):
        with st.lock:
            frame = {k: getattr(st, "kf_" + k)[7].copy() for k in ("uv", "octave", "angle",
                                                                  "desc", "depth", "valid")}
            frame["u_right"] = st.kf_ur[7].copy()
            k = st.add_keyframe(np_lie.se3_compose(np.array([1, 0, 0, 0, 0.1, 0, 0], np.float32),
                                                   st.kf_pose[7]), 8.0, frame, 8, parent=7)
            st.add_points_bulk(X, frame["desc"][:1], np.array([[0, 0, 1.0]], np.float32),
                               np.array([5.0], np.float32), k, np.array([0]))
        return solve(prob, n_iters=n_iters)

    monkeypatch.setattr(loop_closer, "optimize_pose_graph", solve_while_tracking)
    heard = []

    def on_correction(old, new, kf):
        other = []
        t = threading.Thread(target=lambda: other.append(st.lock.acquire(blocking=False)))
        t.start()
        t.join()
        assert other == [False]     # the closer holds the store's lock
        heard.append((old.copy(), new.copy(), kf))

    lc.on_correction = on_correction
    before = st.kf_pose.copy()
    assert lc._close_loop(7, 0) is True
    ((old, new, kf),) = heard
    assert kf == 7 and st.n_kf == 9
    assert np.allclose(old[:8], before[:8]) and not np.allclose(new[7], old[7], atol=1e-4)
    # keyframe 8 keeps its pose relative to 7, and its point its place in 8's camera
    rel = [np_lie.se3_compose(P[8], np_lie.se3_inverse(P[7])) for P in (old, st.kf_pose)]
    np.testing.assert_allclose(rel[1], rel[0], atol=1e-5)
    pid = int(np.nonzero(st.pt_ref_kf[: st.pt_valid.shape[0]] == 8)[0][0])
    np.testing.assert_allclose(np_lie.se3_apply(st.kf_pose[8], st.pt_pos[pid:pid + 1]),
                               np_lie.se3_apply(old[8], X), atol=1e-4)
    assert torch.isfinite(torch.from_numpy(st.kf_pose[:9])).all()


def test_the_tracker_follows_its_reference_keyframe(seq, runs):
    """Two published map moves, applied at the tracker's next step: the
    pose keeps its place relative to the reference keyframe, the frames in
    flight carry the same move, the velocity stays and the device chain is
    rebuilt."""
    from spslam_tpu_torch.geometry import np_lie

    st = copy_store(runs[False].store)
    tr = Tracker(TrackerConfig(), seq.intr, st, device=DEV)
    ref = int(np.nonzero(st.kf_valid)[0][-1])
    tr.ref_kf = ref
    tr.T_cw = np_lie.se3_compose(np.array([1, 0, 0, 0, 0.05, 0, 0.1], np.float32),
                                 st.kf_pose[ref]).astype(np.float32)
    tr.velocity = np.array([1, 0, 0, 0, 0.01, 0, 0], np.float32)
    v0 = tr.velocity.copy()
    tr._chain = ("device", "poses")
    tr._pending = [{"corr": None}, {}]
    rel0 = np_lie.se3_compose(tr.T_cw, np_lie.se3_inverse(st.kf_pose[ref]))
    poses = [st.kf_pose.copy()]
    for step in (np.array([0.9987503, 0, 0.0499792, 0, 0.2, -0.1, 0.05], np.float32),
                 np.array([0.9950042, 0.0998334, 0, 0, 0, 0.3, 0], np.float32)):
        poses.append(np_lie.se3_compose(poses[-1], step[None]).astype(np.float32))
        tr.correct_map_frame(poses[-2], poses[-1], ref)
    T_before = tr.T_cw.copy()
    assert tr._chain is not None           # nothing moves before the tracker's next step
    np.testing.assert_array_equal(tr.T_cw, T_before)
    tr._take_correction()
    rel1 = np_lie.se3_compose(tr.T_cw, np_lie.se3_inverse(poses[-1][ref]))
    np.testing.assert_allclose(rel1, rel0, atol=1e-5)
    D = np_lie.se3_compose(np_lie.se3_inverse(poses[0][ref]), poses[-1][ref])
    for q in tr._pending:
        np.testing.assert_allclose(q["corr"], D, atol=1e-5)
    assert tr._chain is None and tr._correction is None
    np.testing.assert_array_equal(tr.velocity, v0)
