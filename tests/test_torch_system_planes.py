"""The planes slice against spslam_tpu on the CPU: the reference's 15-frame
planes run (tests/integration/test_slam_planes.py) through both Systems
with use_planes=True, and a planes map saved by the JAX System tracked by
the port.

Tolerance: the port's ATE within 1.5 mm of the JAX run's on the same
frames, both under 20 mm (the integration test's bound), as for the point
path (tests/test_torch_system.py); the map-plane checks are the
integration test's own.
"""

import numpy as np
import pytest

from spslam_tpu.eval.ate import ate_rmse as j_ate
from spslam_tpu.geometry.camera import Intrinsics as JIntr
from spslam_tpu.system import System as JSystem, SystemConfig as JSystemConfig
from spslam_tpu_torch.eval.ate import ate_rmse as t_ate
from spslam_tpu_torch.io.synthetic import make_room, make_sequence
from spslam_tpu_torch.system import System, SystemConfig
from spslam_tpu_torch.tracking.tracker import PLANE_CAP, TrackState
from tests.test_torch_common import DEV


@pytest.fixture(scope="module")
def seq():
    s = make_sequence(n_frames=15)
    s.frames = [(np.clip(g, 0, 255).astype(np.uint8),
                 np.clip(d * 5000.0, 0, 65535).astype(np.uint16)) for g, d in s.frames]
    return s


@pytest.fixture(scope="module")
def runs(seq, tmp_path_factory):
    jsys = JSystem(JSystemConfig(intr=JIntr(*seq.intr), local_ba=True, use_planes=True,
                                 enable_reloc=False))
    tsys = System(SystemConfig(intr=seq.intr, local_ba=True, use_planes=True,
                               enable_reloc=False), device=DEV)
    for (gray, depth), ts in zip(seq.frames, seq.timestamps):
        jsys.track_rgbd(gray, depth, ts)
        tsys.track_rgbd(gray, depth, ts)
    jsys.shutdown()
    tsys.shutdown()
    map_path = str(tmp_path_factory.mktemp("map") / "jax_planes_map.npz")
    jsys.save_map(map_path)
    return dict(jsys=jsys, tsys=tsys, map_path=map_path)


def _room_matches(store):
    """Map planes within 5 deg and 0.1 m of a wall, floor or box face."""
    gt = [np.concatenate([r.normal, [-np.dot(r.normal, r.origin)]]).astype(np.float32)
          for r in make_room(seed=0)]
    matched = 0
    for l in np.nonzero(store.pl_valid)[0]:
        est = store.pl_coef[l]
        for g in gt:
            e = est if np.dot(est[:3], g[:3]) > 0 else -est
            ang = np.degrees(np.arccos(np.clip(np.dot(e[:3], g[:3]), -1, 1)))
            if ang < 5.0 and abs(e[3] - g[3]) < 0.1:
                matched += 1
                break
    return matched


def test_planes_run_against_reference(seq, runs):
    jsys, tsys = runs["jsys"], runs["tsys"]
    ate_j, _ = j_ate(jsys.poses(), seq.poses_gt)
    ate_t, _ = t_ate(tsys.poses(), seq.poses_gt)
    assert tsys.tracker.pipeline_depth == 2 and tsys.tracker.use_planes
    assert not [m for m in tsys.tracker.metrics if m["state"] == "LOST"]
    assert ate_j < 0.02 and ate_t < 0.02, (ate_j, ate_t)
    assert ate_t <= ate_j + 1.5e-3, (ate_t, ate_j)
    st = tsys.store
    assert int(st.pl_valid.sum()) >= 3
    assert st.pl_obs_count[: st.n_pl].max() >= 3
    assert len(st.ppe_a) >= 1
    assert _room_matches(st) >= 3, _room_matches(st)
    assert abs(int(st.pl_valid.sum()) - int(jsys.store.pl_valid.sum())) <= 2


def test_jax_planes_map_tracked_by_port(seq, runs):
    jsys = runs["jsys"]
    tsys = System(SystemConfig(intr=seq.intr, local_ba=True, use_planes=True,
                               enable_reloc=False), device=DEV)
    tsys.load_map(runs["map_path"])
    st, jst = tsys.store, jsys.store
    assert st.n_pl == jst.n_pl and st.n_pl >= 3
    np.testing.assert_array_equal(st.pl_coef, jst.pl_coef)
    # the checkpoint holds no structural edges, in either package
    assert len(st.ppe_a) == 0
    tsys.activate_localization_mode()
    ids, _, _, pl_pack = tsys.tracker._local_snapshot()
    pl = pl_pack.numpy()
    assert pl.shape == (PLANE_CAP, 5) and int(pl[:, 4].sum()) == int(jst.pl_valid.sum())
    gray, depth = seq.frames[14]
    tsys.track_rgbd(gray, depth, 1.0)
    poses = tsys.poses()
    assert tsys.tracker.state == TrackState.OK
    assert (st.n_kf, st.n_pl) == (jst.n_kf, jst.n_pl)     # localization maps nothing
    assert np.linalg.norm(poses[-1][4:7] - jsys.poses()[14][4:7]) < 5e-3
