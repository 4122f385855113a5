"""Async mapping in the port (spslam_tpu_torch/tracking/pipeline.py, the
tracker's queue gate and snapshot refresh) against spslam_tpu on the CPU.

Gates and tolerances:
* tests/integration/test_async_pipeline.py's gates on the 20-frame orbit:
  async ATE < 30 mm and < 3 x max(sync, 3 mm); every submitted keyframe
  processed, no worker exception logged;
* the keyframe gate with a stubbed mapper queue (0, 1, kf_queue_cap): the
  reference's decision on the same store and inputs (exact);
* `refresh_snapshot_values`: the same ids, pack and descriptors as a fresh
  `_local_snapshot_build` (exact), after a value and a topology change.
"""

import itertools
import logging

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
