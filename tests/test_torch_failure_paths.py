"""The fast-motion and use_loop cases of
tests/integration/test_failure_paths.py (TestFastMotion,
TestUseLoopSemantics) on the port, on the CPU.

The JAX package's run of the same scenarios is in the tier-1 suite
already, so the port is held to the reference test's own gates: the 3x
subsampled 45-frame orbit ends OK with ATE < 50 mm; the 64-frame loop
sequence with use_loop=False closes no loop while the keyframe database
indexes every keyframe.  The jump gate's settings are compared with the
reference's System directly (it is cheap to build).  Kept in a file of its
own (~100 s on the CPU) so `--dist loadfile` gives it one worker.
"""

import pytest

from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.system import System as JSystem, SystemConfig as JSystemConfig
from spslam_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
from spslam_tpu_torch.eval.ate import ate_rmse
from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import TrackerConfig, TrackState
from tests.test_torch_common import DEV


def test_fast_sequence_tracks():
    """3x-subsampled orbit: the constant-velocity window misses repeatedly,
    and the fused step's global fallback and the pose-jump gate keep the
    trajectory bounded."""
    seq = make_sequence(n_frames=45)
    idx = list(range(0, 45, 3))
    sys_ = System(SystemConfig(intr=seq.intr), device=DEV)
    for t in idx:
        gray, depth = seq.frames[t]
        sys_.track_rgbd(gray, depth, float(seq.timestamps[t]))
    sys_.shutdown()
    assert sys_.tracker.state == TrackState.OK
    rmse, _ = ate_rmse(sys_.poses(), seq.poses_gt[idx])
    assert rmse < 0.05, f"fast-motion ATE too large: {rmse}"


def test_jump_gate_config_plumbed():
    seq = make_sequence(n_frames=2)
    sys_ = System(SystemConfig(intr=seq.intr, tracker=TrackerConfig(jump_gate_t=0.5,
                                                                    jump_gate_r=0.7)),
                  device=DEV)
    ref = JSystem(JSystemConfig(intr=JIntr(*seq.intr),
                                tracker=JTrackerConfig(jump_gate_t=0.5, jump_gate_r=0.7)))
    assert (sys_.tracker.jump_gate_t, sys_.tracker.jump_gate_r) == (0.5, 0.7)
    assert (sys_.tracker.jump_gate_t, sys_.tracker.jump_gate_r) == (
        ref.tracker.jump_gate_t, ref.tracker.jump_gate_r)


def test_use_loop_false_never_closes():
    """use_loop=False with enable_reloc=True: the keyframe database is kept
    up, but loop detection never runs on the canonical loop sequence."""
    seq = make_sequence(n_frames=64, trajectory="loop", depth_noise=0.004)
    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, use_loop=False,
                               enable_reloc=True), device=DEV)
    assert sys_.loop_closer is not None
    for (gray, depth), ts in zip(seq.frames, seq.timestamps):
        sys_.track_rgbd(gray, depth, ts)
    sys_.shutdown()
    assert sys_.loop_closer.n_loops_closed == 0, "use_loop=False closed a loop"
    n_kf = int(sys_.store.kf_valid.sum())
    assert n_kf >= 2
    assert len(sys_.loop_closer.kfdb.bow) >= n_kf, \
        "the keyframe database must index keyframes with use_loop=False"
