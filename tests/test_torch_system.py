"""The port's whole slice against spslam_tpu on the CPU: the 20-frame
synthetic sequence through both Systems (point-only tracking + local BA),
a map saved by the JAX System tracked by the port, and the port's package
rules (no JAX import, CUDA by default, unported features refused).

Tolerance: the port's ATE within 1.5 mm of the JAX run's on the same
frames, both under 20 mm (the integration test's bound); the two runs
differ by float32 summation order and rare orientation-bin flips, which
can change a keyframe decision.
"""

import ast
import os

import numpy as np
import pytest
import torch

from spslam_tpu.eval.ate import ate_rmse as j_ate
from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.system import System as JSystem, SystemConfig as JSystemConfig
from spslam_tpu_torch.eval.ate import ate_rmse as t_ate
from spslam_tpu_torch.ops import fast_cuda
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import TrackState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seq():
    from spslam_tpu_torch.io.synthetic import make_sequence

    s = make_sequence(n_frames=20)
    # camera-native dtypes, as bench.py feeds them
    s.frames = [(np.clip(g, 0, 255).astype(np.uint8),
                 np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in s.frames]
    return s


@pytest.fixture(scope="module")
def runs(seq, tmp_path_factory):
    jsys = JSystem(JSystemConfig(intr=JIntr(*seq.intr), local_ba=True, enable_reloc=False))
    tsys = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False), device="cpu")
    launches0 = fast_cuda.LAUNCHES
    for (gray, depth), ts in zip(seq.frames, seq.timestamps):
        jsys.track_rgbd(gray, depth, ts)
        tsys.track_rgbd(gray, depth, ts)
    jsys.shutdown()
    tsys.shutdown()
    map_path = str(tmp_path_factory.mktemp("map") / "jax_map.npz")
    jsys.save_map(map_path)
    return dict(jsys=jsys, tsys=tsys, map_path=map_path,
                launches=fast_cuda.LAUNCHES - launches0)


def test_synthetic_sequence_matches_reference(seq):
    from spslam_tpu.io import synthetic as jsyn

    poses = jsyn.orbit_trajectory(20)
    np.testing.assert_allclose(seq.poses_gt, poses, rtol=0, atol=1e-6)
    rects = jsyn.make_room(seed=0)
    for i in (0, 7):
        g, d = seq.frames[i]
        jg, jd = jsyn.render_frame(rects, poses[i], JIntr(*seq.intr))
        assert np.mean(g != np.clip(jg, 0, 255).astype(np.uint8)) < 1e-4
        jd16 = np.clip(jd * 5000.0, 0, 65535).astype(np.uint16)
        assert np.abs(d.astype(np.int32) - jd16).max() <= 1   # quantization boundary


def test_slice_ate_against_reference(seq, runs):
    jsys, tsys = runs["jsys"], runs["tsys"]
    ate_j, _ = j_ate(jsys.poses(), seq.poses_gt)
    ate_t, _ = t_ate(tsys.poses(), seq.poses_gt)
    assert not [m for m in tsys.tracker.metrics if m["state"] == "LOST"]
    assert not [m for m in jsys.tracker.metrics if m["state"] == "LOST"]
    assert tsys.tracker.state == TrackState.OK
    assert ate_j < 0.02 and ate_t < 0.02, (ate_j, ate_t)
    assert ate_t <= ate_j + 1.5e-3, (ate_t, ate_j)
    assert tsys.store.n_kf >= 2 and tsys.store.n_pt > 200
    assert tsys.tracker.n_fused >= 15
    # the ATE copy agrees with the reference's on the same trajectory
    np.testing.assert_allclose(t_ate(tsys.poses(), seq.poses_gt)[1],
                               j_ate(tsys.poses(), seq.poses_gt)[1], rtol=1e-5, atol=1e-7)


def test_cpu_run_never_launches_the_kernel(runs):
    assert runs["launches"] == 0


def test_jax_map_tracked_by_port(seq, runs, tmp_path):
    jsys = runs["jsys"]
    tsys = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False), device="cpu")
    tsys.load_map(runs["map_path"])
    st, jst = tsys.store, jsys.store
    assert (st.n_kf, st.n_pt) == (jst.n_kf, jst.n_pt)
    np.testing.assert_array_equal(st.pt_desc, jst.pt_desc)
    tsys.activate_localization_mode()
    gray, depth = seq.frames[19]
    tsys.track_rgbd(gray, depth, 1.0)
    poses = tsys.poses()
    assert tsys.tracker.state == TrackState.OK
    assert st.n_kf == jst.n_kf                      # localization adds no keyframe
    # the port's pose of frame 19 in the JAX map agrees with the JAX run's
    T_j = jsys.poses()[19]
    assert np.linalg.norm(poses[-1][4:7] - T_j[4:7]) < 5e-3
    # and the port's own checkpoint round-trips
    path = str(tmp_path / "port_map.npz")
    tsys.save_map(path)
    again = System(SystemConfig(intr=seq.intr, enable_reloc=False), device="cpu")
    again.load_map(path)
    np.testing.assert_array_equal(again.store.kf_obs, st.kf_obs)
    tsys.save_trajectory_tum(str(tmp_path / "traj.txt"))
    lines = (tmp_path / "traj.txt").read_text().strip().splitlines()
    assert len(lines) == 1 and len(lines[0].split()) == 8


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "spslam_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "spslam_tpu", "cv2"), (f, mod)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        System(SystemConfig(enable_reloc=False))


@pytest.mark.parametrize("flag", ["async_mapping", "gba_distributed"])
def test_unported_features_refused(flag):
    kw = dict(enable_reloc=False)
    kw[flag] = True
    with pytest.raises(NotImplementedError, match="slice"):
        System(SystemConfig(**kw), device="cpu")
