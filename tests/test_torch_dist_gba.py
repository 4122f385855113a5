"""The port's sharded global BA (spslam_tpu_torch/solver/global_ba.py::
dist_global_bundle_adjust) and the auto mode of its global_bundle_adjust
against spslam_tpu on the CPU.  The JAX side shards over conftest's 8
virtual devices, the port over 8 "cpu" entries of its device list.

Tolerances: poses 1e-4, points 1e-3 (the local BA's bound in
tests/test_torch_mapping.py); the perturbed map
comes back to a median keyframe position error under 5 mm from 1 cm of
noise (tests/dist/test_dist_gba.py's gate); the small-map fallback leaves
the store unchanged (exact).
"""

import numpy as np
import pytest

from spslam_tpu.map.store import MapConfig as JMapConfig, MapStore as JMapStore
from spslam_tpu.solver import global_ba as jgba
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.map.store import SAVED_ARRAYS, SAVED_COUNTS, MapConfig, MapStore
from spslam_tpu_torch.solver import global_ba as tgba
from tests.test_torch_common import DEV
from tests.unit import test_global_ba as jscene

CPU8 = ["cpu"] * 8


def copy_store(st, cls=MapStore, cfg_cls=MapConfig):
    """A store of either package holding a copy of a store's map."""
    out = cls(cfg_cls(max_keyframes=st.kf_pose.shape[0], max_points=st.pt_pos.shape[0],
                      max_planes=st.pl_coef.shape[0], n_kp=st.kf_uv.shape[1],
                      max_obs_per_point=st.pt_obs_kf.shape[1]))
    for k in SAVED_ARRAYS + SAVED_COUNTS:
        v = getattr(st, k)
        setattr(out, k, np.array(v) if isinstance(v, np.ndarray) else v)
    out.ppe_a, out.ppe_b, out.ppe_type = st.ppe_a.copy(), st.ppe_b.copy(), st.ppe_type.copy()
    return out


@pytest.fixture(scope="module")
def perturbed():
    """The port System's map of tests/dist/test_dist_gba.py's 24-frame
    sequence, then 1 cm of noise on keyframe positions and points."""
    from spslam_tpu_torch.io.synthetic import make_sequence
    from spslam_tpu_torch.system import System, SystemConfig

    seq = make_sequence(n_frames=24)
    sys_ = System(SystemConfig(intr=seq.intr, local_ba=True, enable_reloc=False), device=DEV)
    for (gray, depth), ts in zip(seq.frames, seq.timestamps):
        sys_.track_rgbd(gray, depth, ts)
    sys_.shutdown()
    st = sys_.store
    kf_ids = np.nonzero(st.kf_valid)[0]
    pt_ids = np.nonzero(st.pt_valid)[0]
    assert len(pt_ids) >= 64 * 8, len(pt_ids)
    clean = st.kf_pose[kf_ids].copy()
    rng = np.random.default_rng(3)
    st.kf_pose[kf_ids[1:], 4:7] += rng.normal(0, 0.01, (len(kf_ids) - 1, 3)).astype(np.float32)
    st.pt_pos[pt_ids] += rng.normal(0, 0.01, (len(pt_ids), 3)).astype(np.float32)
    return dict(st=st, intr=seq.intr, kf_ids=kf_ids, pt_ids=pt_ids, clean=clean)


def test_small_map_falls_back():
    intr = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
    st = MapStore(MapConfig(max_keyframes=8, max_points=256, n_kp=64))
    frame_np = dict(
        uv=np.zeros((64, 2), np.float32), octave=np.zeros(64, np.int32),
        angle=np.zeros(64, np.float32), desc=np.zeros((64, 8), np.uint32),
        depth=np.ones(64, np.float32), u_right=np.full(64, -1.0, np.float32),
        valid=np.ones(64, bool),
    )
    for k in range(2):
        st.add_keyframe(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), 0.0, frame_np, k)
    # 40 points: under the 64-per-shard floor for any D >= 2
    st.add_points_bulk(np.zeros((40, 3), np.float32), np.zeros((40, 8), np.uint32),
                       np.tile(np.array([0, 0, 1], np.float32), (40, 1)),
                       np.ones(40, np.float32), 0, np.arange(40))
    before = (st.kf_pose.copy(), st.pt_pos.copy(), st.version)
    assert tgba.dist_global_bundle_adjust(st, intr, n_shards=8, devices=CPU8) is False
    # one device: D = 1, declined whatever the map
    assert tgba.dist_global_bundle_adjust(st, intr, devices=["cpu"]) is False
    np.testing.assert_array_equal(st.kf_pose, before[0])
    np.testing.assert_array_equal(st.pt_pos, before[1])
    assert st.version == before[2]


def test_perturbed_map_recovers(perturbed):
    p = perturbed
    st = copy_store(p["st"])
    assert tgba.dist_global_bundle_adjust(st, p["intr"], n_iters=12, devices=CPU8)
    err = np.linalg.norm(st.kf_pose[p["kf_ids"], 4:7] - p["clean"][:, 4:7], axis=1)
    assert float(np.median(err)) < 0.005, np.median(err)


def test_dist_gba_matches_reference(perturbed):
    p = perturbed
    st = copy_store(p["st"])
    jst = copy_store(p["st"], JMapStore, JMapConfig)
    assert jgba.dist_global_bundle_adjust(jst, p["intr"], n_shards=8) is True
    assert tgba.dist_global_bundle_adjust(st, p["intr"], n_shards=8, devices=CPU8) is True
    np.testing.assert_allclose(st.kf_pose, jst.kf_pose, atol=1e-4)
    np.testing.assert_allclose(st.pt_pos, jst.pt_pos, atol=1e-3)


def test_distributed_true_matches_reference(perturbed):
    """global_bundle_adjust(distributed=True) takes the sharded solver in
    both packages (write_back=False: it writes inline)."""
    p = perturbed
    st = copy_store(p["st"])
    jst = copy_store(p["st"], JMapStore, JMapConfig)
    want = jgba.global_bundle_adjust(jst, p["intr"], distributed=True, write_back=False)
    got = tgba.global_bundle_adjust(st, p["intr"], distributed=True, write_back=False,
                                    device=DEV, devices=CPU8)
    assert got == want == dict(wrote=True, newton=True)
    np.testing.assert_allclose(st.kf_pose, jst.kf_pose, atol=1e-4)
    np.testing.assert_allclose(st.pt_pos, jst.pt_pos, atol=1e-3)


def test_auto_mode_on_one_device_settles_like_the_reference(monkeypatch):
    """A map whose Schur tensor exceeds GBA_MAX_Y_ELEMS, one device: the
    sharded solver declines (D = 1) and the port settles 3x longer, as the
    reference's one-device fallback (distributed=False) does."""
    saved = jscene.rng
    jscene.rng = np.random.default_rng(7)   # the scene of test_global_ba.py's first call
    try:
        jst, poses_true, _, _ = jscene.build_store_scene()
    finally:
        jscene.rng = saved
    st = copy_store(jst)
    err0 = jscene.pose_err(st, poses_true)
    monkeypatch.setattr(jgba, "GBA_MAX_Y_ELEMS", 1000)
    monkeypatch.setattr(tgba, "GBA_MAX_Y_ELEMS", 1000)
    calls = []
    real = tgba.dist_global_bundle_adjust

    def spy(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(tgba, "dist_global_bundle_adjust", spy)
    assert jgba.global_bundle_adjust(jst, jscene.INTR, distributed=False) is False
    assert tgba.global_bundle_adjust(st, Intrinsics(*jscene.INTR), device=DEV) is False
    assert calls == [False]
    np.testing.assert_allclose(st.kf_pose, jst.kf_pose, atol=1e-4)
    np.testing.assert_allclose(st.pt_pos, jst.pt_pos, atol=1e-3)
    assert jscene.pose_err(st, poses_true) < err0      # the settle moved toward truth
