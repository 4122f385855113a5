"""The cell orbslam2_tum3_loop.revisit: ORB-SLAM2 with its loop-closing
thread (configs/orbslam2_tum3_loop.json) on the revisiting traffic
(traffic/revisit.json).  On the CPU, the cell's files: the configuration
is orbslam2_tum3's with the loop closer on and nothing else changed.  On
the card, a session's closures against the plain reference
(benchmark/loop_check.py).
"""

import os

import numpy as np
import pytest

from benchmark import spec

CONFIG = os.path.join(spec.HERE, "configs", "orbslam2_tum3_loop.json")
TRAFFIC = os.path.join(spec.HERE, "traffic", "revisit.json")
CELL = "orbslam2_tum3_loop.revisit"


def test_the_cell_is_the_point_configuration_with_loop_closing():
    loop, point = spec.cell(CELL), spec.cell("orbslam2_tum3.orbit")
    for key in ("camera", "tracker", "mapper", "map", "plane_cfg"):
        assert loop.config[key] == point.config[key], key
    diff = {k for k in point.config["system"]
            if loop.config["system"][k] != point.config["system"][k]}
    assert diff == {"use_loop"} and loop.config["system"]["use_loop"] is True
    assert loop.config["reduced"] == ["session_frames"]
    assert loop.limits == point.limits
    t = loop.traffic
    assert (t["room"], t["trajectory"], t["trajectory_args"], t["frames_per_session"]) == (
        "textured", "loop", {"turns": 1.25}, 64)


@pytest.mark.cuda
def test_a_sessions_closures_agree_with_the_reference(cuda_device):
    """The first session from a seed, on the card, through the System as
    the benchmark builds it: every closure's essential graph (512 keyframe
    slots) and point correction against the reference, which agrees within
    loop_check's tolerances in float32 and not in TF32."""
    from benchmark import loop_check, traffic
    from spslam_tpu_torch.system import System

    config, mix = spec._load_json(CONFIG), spec._load_json(TRAFFIC)
    s = traffic.make_sessions(mix, config, 2**31 + 1601, cuda_device)[0]
    cap = loop_check.Capture()
    cap.install()
    try:
        sys_ = System(spec.system_config(config), device=cuda_device)
        for i in range(len(s.ts)):
            sys_.track_rgbd(s.gray[i], s.depth[i], float(s.ts[i]))
        sys_.shutdown()
    finally:
        cap.remove()
    assert cap.closures, "the session closed no loop"
    for c in cap.closures:
        assert c.problem["poses"].shape == (config["map"]["max_keyframes"], 7)
        g = loop_check.gaps(c, cuda_device)
        t = loop_check.gaps(c, cuda_device, precision="tf32")
        print(f"closure: float32 {g}; tf32 {t}")
        assert loop_check.within(g), g
        assert not loop_check.within(t), t
        assert np.isfinite(g["pose_gap_mm"]) and g["keyframes"] >= 2
