"""The tracker's host-section accounting (`Tracker.perf`, `Tracker._pt`)
against spslam_tpu's on the CPU, and its cost to the result.

* A 10-frame orbit at 320x240 (u8 gray, u16 depth) through both packages'
  System with the same config (no local BA, synchronous mapping, pipeline
  depth 3) and `tracker.perf = {}`: the same section keys and the same
  n_frames (frames resolved from the fused step), exactly.
* The port's poses with `perf = {}` and the span recorder on equal its
  poses with `perf = None` and the recorder off bit for bit (the
  accounting and the spans read the clock and nothing else).
"""

import numpy as np
import pytest

from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.system import System as JSystem, SystemConfig as JSystemConfig
from spslam_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
from spslam_tpu_torch import tracing
from spslam_tpu_torch.bench import quantized
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.io.synthetic import make_sequence
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tools.profile_host import SECTIONS
from spslam_tpu_torch.tracking.tracker import TrackerConfig
from tests.test_torch_common import DEV

INTR = Intrinsics(fx=262.5, fy=262.5, cx=159.5, cy=119.5, bf=20.0, width=320, height=240)


@pytest.fixture(scope="module")
def seq():
    s = make_sequence(n_frames=10, intr=INTR)
    s.frames = quantized(s.frames)
    return s


def _run(system, seq, perf):
    system.tracker.perf = perf
    for (gray, depth), ts in zip(seq.frames, seq.timestamps):
        system.track_rgbd(gray, depth, ts)
    system.shutdown()
    return system.poses(), system.tracker.perf


def _port():
    return System(SystemConfig(intr=INTR, local_ba=False, enable_reloc=False,
                               tracker=TrackerConfig(th_depth=3.2, pipeline_depth=3)),
                  device=DEV)


@pytest.fixture(scope="module")
def port_run(seq):
    """The port with perf on and the span recorder on (tests/test_torch_
    tracing.py holds the spans themselves)."""
    tracing.enable()
    try:
        return _run(_port(), seq, {})
    finally:
        tracing.disable()
        tracing.reset()


def test_sections_match_reference(seq, port_run):
    jsys = JSystem(JSystemConfig(intr=JIntr(*INTR), local_ba=False, enable_reloc=False,
                                 tracker=JTrackerConfig(th_depth=3.2, pipeline_depth=3)))
    _, want = _run(jsys, seq, {})
    _, got = port_run
    assert set(got) == set(want)
    assert got["n_frames"] == want["n_frames"] > 0
    assert set(got) - {"n_frames"} <= set(SECTIONS)
    assert all(v >= 0.0 for k, v in got.items() if k != "n_frames")


def test_perf_on_leaves_poses_bit_for_bit(seq, port_run):
    poses_off, perf_off = _run(_port(), seq, None)
    assert perf_off is None
    np.testing.assert_array_equal(port_run[0], poses_off)
