"""Relocalization and the default configuration against spslam_tpu on the
CPU: the two relocalization cases of tests/integration/test_failure_paths.py
(LOST through blank frames, then recovery through the keyframe database on
earlier views; and no recovery without a relocalizer), port beside JAX on
the same frames, and the reference's default SystemConfig (enable_reloc=True)
built in the port.

The port's tracker gets the reference's RANSAC hypotheses (the PRNGKey(23)
key chain, tests/test_torch_system_loop.py).  Gate: the reference test's
own (RELOC in the metrics, final state OK, recovered pose within 0.3 m of
truth), in both packages, and the two recovered poses within 5 cm of each
other.
"""

import numpy as np
import pytest

from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.system import System as JSystem, SystemConfig as JSystemConfig
from spslam_tpu.tracking.tracker import TrackState as JTrackState
from spslam_tpu_torch.geometry import np_lie
from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.loop.precompile import warm_loop_machinery, warm_sync_tracking
from spslam_tpu_torch.map.store import MapConfig
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import TrackState
from tests.test_torch_common import DEV
from tests.test_torch_system_loop import jax_draw_chain

N_LEAD = 28


@pytest.fixture(scope="module")
def rot_seq():
    # yaw rotation: views 1/4 and 3/4 through the sequence share nothing,
    # so recovery cannot come through the local-map fallback
    return make_sequence(n_frames=40, trajectory="loop")


def _lost_then_revisit(sys_, seq, n_lead, revisit, blank_frames=4):
    for t in range(n_lead):
        gray, depth = seq.frames[t]
        sys_.track_rgbd(gray, depth, float(seq.timestamps[t]))
    blank = np.zeros((seq.intr.height, seq.intr.width), np.float32)
    for k in range(blank_frames):
        sys_.track_rgbd(blank, np.zeros_like(blank), 10.0 + 0.1 * k)
    sys_.tracker.flush_pipeline()
    lost = sys_.tracker.state.name == "LOST"
    for t in revisit:
        gray, depth = seq.frames[t]
        sys_.track_rgbd(gray, depth, 20.0 + float(seq.timestamps[t]))
    sys_.shutdown()
    return lost


def _err_to_truth(seq, T_rec, frame):
    T_gt = np_lie.se3_compose(seq.poses_gt[frame], np_lie.se3_inverse(seq.poses_gt[0]))
    return float(np.linalg.norm(np_lie.se3_compose(T_rec, np_lie.se3_inverse(T_gt))[4:7]))


def test_lost_then_relocalize_against_reference(rot_seq):
    seq = rot_seq
    jsys = JSystem(JSystemConfig(intr=JIntr(*seq.intr), enable_reloc=True))
    tsys = System(SystemConfig(intr=seq.intr, enable_reloc=True), device=DEV)
    tsys.tracker.reloc_draw = jax_draw_chain(23)
    revisit = range(2, 12)
    for sys_ in (jsys, tsys):
        assert _lost_then_revisit(sys_, seq, N_LEAD, revisit), "blank frames must lose tracking"
    assert jsys.tracker.state == JTrackState.OK and tsys.tracker.state == TrackState.OK
    for sys_ in (jsys, tsys):
        assert "RELOC" in [m.get("state") for m in sys_.tracker.metrics]
    e_j = _err_to_truth(seq, jsys.tracker.T_cw, 11)
    e_t = _err_to_truth(seq, tsys.tracker.T_cw, 11)
    assert e_j < 0.3 and e_t < 0.3, (e_j, e_t)
    assert np.linalg.norm(tsys.tracker.T_cw[4:7] - jsys.tracker.T_cw[4:7]) < 0.05
    # use_loop=False: the database is maintained, no loop is ever closed
    lc, st = tsys.loop_closer, tsys.store
    assert lc.n_loops_closed == 0
    assert set(np.nonzero(st.kf_valid[: st.n_kf])[0]) <= set(lc.kfdb.bow)


def test_reloc_disabled_stays_lost_against_reference(rot_seq):
    seq = rot_seq
    jsys = JSystem(JSystemConfig(intr=JIntr(*seq.intr), enable_reloc=False, use_loop=False))
    tsys = System(SystemConfig(intr=seq.intr, enable_reloc=False, use_loop=False), device=DEV)
    assert jsys.loop_closer is None and tsys.loop_closer is None
    for sys_ in (jsys, tsys):
        _lost_then_revisit(sys_, seq, 16, range(2, 8))
    assert jsys.tracker.state == JTrackState.LOST
    assert tsys.tracker.state == TrackState.LOST


def test_default_config_builds():
    sys_ = System(SystemConfig(), device=DEV)
    assert sys_.cfg.enable_reloc and not sys_.cfg.use_loop
    assert sys_.loop_closer is not None and sys_.loop_closer.vocab.trained
    assert sys_.loop_closer.vocab.vocab_bits.shape == (4096, 256)
    assert sys_.tracker.relocalizer == (sys_.loop_closer.vocab, sys_.loop_closer.kfdb)
    assert sys_.tracker.pipeline_depth == 3
    assert System(SystemConfig(use_loop=True), device=DEV).tracker.pipeline_depth == 2


def test_warm_ups_run(rot_seq):
    warm_loop_machinery(rot_seq.intr, MapConfig(max_keyframes=32, max_points=4096),
                        pose_graph_iters=2, device=DEV)
    sys_ = warm_sync_tracking(rot_seq.intr, rot_seq.frames[:4], rot_seq.timestamps[:4],
                              device=DEV)
    assert sys_.tracker.frame_id == 4
