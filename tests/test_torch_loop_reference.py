"""A loop closure's correction in the port against the benchmark's plain
reference (benchmark/reference/pose_graph.py), on the CPU at a small size.

The problem is chip_smoke's drifted loop: 24 keyframes of odometry with
noise and one loop edge carrying the true relative pose, placed in 32
keyframe slots (8 invalid) with its edges padded to 64, as
`LoopCloser._optimize_graph` pads them; 300 points, each seen from a
reference keyframe.  The port solves it with `optimize_pose_graph` and
moves the points with `LoopCloser._correct_points`, through
benchmark/loop_check.py's capture; the reference solves and corrects it
again (`loop_check.gaps`): one Gauss-Newton step, the whole solve, and
the point correction, each held to its tolerance in loop_check (5e-5,
3.5e-4 and 1e-5 of the move; their reasons are there).  This problem
reads 6.7e-6, 6.4e-6 and 0.  The controls fall outside: the reference
with its normal equations in TF32 (emulated on the CPU by rounding their
product's operands), 2.8e-4 in the first step, and the problem with its
loop edge dropped.
"""

import numpy as np
import pytest
import torch

from benchmark import loop_check
from chip_smoke import _drifted_loop
from spslam_tpu_torch.geometry import np_lie
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.loop import loop_closer
from spslam_tpu_torch.map.store import MapConfig, MapStore
from spslam_tpu_torch.solver.pose_graph import PoseGraphProblem
from tests.test_torch_common import DEV

K_LOOP, SLOTS, EDGES, N_PTS = 24, 32, 64, 300
INTR = Intrinsics(fx=100.0, fy=100.0, cx=32.0, cy=24.0, bf=8.0, width=64, height=48)


def _padded(arrs):
    """The drifted loop in SLOTS keyframe slots and EDGES edge slots."""
    out = dict(arrs)
    pad_k = SLOTS - K_LOOP
    out["poses"] = np.concatenate([arrs["poses"], np.tile(arrs["poses"][:1], (pad_k, 1))])
    out["fixed"] = np.arange(SLOTS) == 0
    out["valid"] = np.arange(SLOTS) < K_LOOP
    pad_e = EDGES - len(arrs["edge_i"])
    for k, fill in (("edge_i", 0), ("edge_j", 0), ("edge_w", 0.0), ("edge_valid", False)):
        out[k] = np.concatenate([arrs[k], np.full(pad_e, fill, arrs[k].dtype)])
    out["edge_T"] = np.concatenate([arrs["edge_T"],
                                    np.tile(np.float32([1, 0, 0, 0, 0, 0, 0]), (pad_e, 1))])
    return out


@pytest.fixture(scope="module")
def closure():
    arrs, _ = _drifted_loop(K=K_LOOP, seed=10)
    arrs = _padded(arrs)
    st = MapStore(MapConfig(max_keyframes=SLOTS, max_points=512, n_kp=16))
    st.kf_pose[:] = arrs["poses"]
    st.kf_valid[:K_LOOP] = True
    st.n_kf = K_LOOP
    rng = np.random.default_rng(3)
    ref_kf = rng.integers(0, K_LOOP, N_PTS).astype(np.int32)
    ref_kf[:5] = K_LOOP + 2                  # an invalid reference: keyframe 0 stands in
    Xc = np.stack([rng.uniform(-2, 2, N_PTS), rng.uniform(-1.5, 1.5, N_PTS),
                   rng.uniform(1, 5, N_PTS)], axis=-1).astype(np.float32)
    kf_of = np.where(ref_kf < K_LOOP, ref_kf, 0)
    st.pt_pos[:N_PTS] = np_lie.se3_apply(np_lie.se3_inverse(arrs["poses"][kf_of]), Xc)
    st.pt_ref_kf[:N_PTS] = ref_kf
    st.pt_valid[:N_PTS] = True
    st.n_pt = N_PTS
    lc = loop_closer.LoopCloser(INTR, st, device=DEV)
    cap = loop_check.Capture()
    cap.install()
    try:
        old = st.kf_pose.copy()
        prob = PoseGraphProblem(**{k: torch.from_numpy(v) for k, v in arrs.items()})
        new = loop_closer.optimize_pose_graph(prob, n_iters=20).numpy()
        st.kf_pose[:K_LOOP] = new[:K_LOOP]
        lc._correct_points(old)
    finally:
        cap.remove()
    assert loop_closer.optimize_pose_graph.__name__ == "optimize_pose_graph"
    (c,) = cap.closures
    return c


def test_the_capture_holds_the_ports_closure(closure):
    c = closure
    assert c.problem["poses"].shape == (SLOTS, 7) and c.n_iters == 20
    assert int(c.problem["edge_valid"].sum()) == K_LOOP
    assert len(c.pt_ids) == N_PTS
    # the program moved the keyframes and the points by the loop's correction
    g = loop_check.gaps(c, DEV)
    assert 50.0 < g["correction_mm"] < 500.0 and g["point_correction_mm"] > 10.0
    np.testing.assert_array_equal(c.solved[K_LOOP:], c.problem["poses"][K_LOOP:])


def test_port_and_reference_agree_within_the_tolerance(closure):
    g = loop_check.gaps(closure, DEV)
    assert loop_check.within(g), g


@pytest.mark.parametrize("control", ["tf32", "loop_edge_dropped"])
def test_the_controls_fall_outside_the_tolerance(closure, control):
    c = closure
    if control == "tf32":
        g = loop_check.gaps(c, DEV, precision="tf32")
    else:
        ev = c.problem["edge_valid"].copy()
        ev[K_LOOP - 1] = False                 # the loop edge is the last valid one
        g = loop_check.gaps(c._replace(problem=dict(c.problem, edge_valid=ev)), DEV)
    assert not loop_check.within(g), g
