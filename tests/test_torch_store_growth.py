"""The cases of tests/unit/test_capacity_growth.py (6) and
tests/unit/test_store_versions.py::TestTopoVersion (3), each run on the
reference's MapStore and on the port's: the reference test's own asserts
on the port, and every array, count and version of the two stores equal
exactly (both stores are numpy; the snapshot's gathered values too)."""

from types import SimpleNamespace

import numpy as np
import pytest

from spslam_tpu.geometry import camera as jcam
from spslam_tpu.map import store as jstore
from spslam_tpu.system import System as JSystem, SystemConfig as JSystemConfig
from spslam_tpu.tracking import tracker as jtracker
from spslam_tpu_torch.geometry import camera as tcam
from spslam_tpu_torch.map import store as tstore
from spslam_tpu_torch.system import System as TSystem, SystemConfig as TSystemConfig
from spslam_tpu_torch.tracking import tracker as ttracker
from tests.test_torch_common import DEV, assert_same_store, n

JAX = SimpleNamespace(MapStore=jstore.MapStore, MapConfig=jstore.MapConfig,
                      Intrinsics=jcam.Intrinsics, TrackerConfig=jtracker.TrackerConfig,
                      Tracker=jtracker.Tracker, SystemConfig=JSystemConfig,
                      System=JSystem, kw={})
PORT = SimpleNamespace(MapStore=tstore.MapStore, MapConfig=tstore.MapConfig,
                       Intrinsics=tcam.Intrinsics, TrackerConfig=ttracker.TrackerConfig,
                       Tracker=ttracker.Tracker, SystemConfig=TSystemConfig,
                       System=TSystem, kw={"device": DEV})
INTR = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0, width=640, height=480)
IDENT = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)


def _frame(n_kp, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        uv=rng.uniform(0, 400, (n_kp, 2)).astype(np.float32),
        octave=np.zeros(n_kp, np.int32),
        angle=np.zeros(n_kp, np.float32),
        desc=rng.integers(0, 2 ** 32, (n_kp, 8), np.uint64).astype(np.uint32),
        depth=np.ones(n_kp, np.float32),
        u_right=np.full(n_kp, -1.0, np.float32),
        valid=np.ones(n_kp, bool),
    )


def _bulk(st, n_pts, z, ref_kf, slots, dist=1.0):
    return st.add_points_bulk(
        np.tile(np.array([0, 0, z], np.float32), (n_pts, 1)),
        np.zeros((n_pts, 8), np.uint32),
        np.tile(np.array([0, 0, 1], np.float32), (n_pts, 1)),
        np.full(n_pts, dist, np.float32), ref_kf, slots,
    )


def _system(pkg, map_cfg):
    cfg = pkg.SystemConfig(intr=pkg.Intrinsics(**INTR), tracker=pkg.TrackerConfig(n_features=8))
    cfg.map = map_cfg
    return pkg.System(cfg, **pkg.kw)


# ------------------------------------------- tests/unit/test_capacity_growth.py
def keyframes_grow_past_initial_cap(pkg, tmp_path):
    st = pkg.MapStore(pkg.MapConfig(max_keyframes=2, max_points=64, n_kp=8))
    f = _frame(8)
    for k in range(5):
        assert st.add_keyframe(np.array([1, 0, 0, 0, 0.1 * k, 0, 0], np.float32),
                               float(k), f, k) == k
    assert st.cfg.max_keyframes >= 5
    assert st.kf_valid[:5].all()
    np.testing.assert_allclose(st.kf_pose[1, 4], 0.1, atol=1e-6)
    assert (st.kf_pose[5:, 0] == 1.0).all()
    return st


def points_grow_in_bulk(pkg, tmp_path):
    st = pkg.MapStore(pkg.MapConfig(max_keyframes=4, max_points=8, n_kp=64))
    st.add_keyframe(IDENT, 0.0, _frame(64), 0)
    ids = _bulk(st, 40, 3.0, 0, np.arange(40))
    assert st.cfg.max_points >= 48
    assert st.pt_valid[ids].all()
    assert st.pt_visible.shape[0] == st.cfg.max_points
    return st


def planes_grow(pkg, tmp_path):
    st = pkg.MapStore(pkg.MapConfig(max_planes=1))
    for i in range(4):
        assert st.add_plane(np.array([0, 0, 1, 2.0 + i], np.float32), 0, 100) == i
    assert st.cfg.max_planes >= 4
    assert (st.pl_coef[4:, 2] == 1.0).all()
    return st


def save_load_roundtrip_after_growth(pkg, tmp_path):
    sys_a = _system(pkg, pkg.MapConfig(max_keyframes=2, max_points=16, n_kp=8))
    st = sys_a.store
    f = _frame(8)
    for k in range(5):
        st.add_keyframe(np.array([1, 0, 0, 0, 0.1 * k, 0, 0], np.float32), float(k), f, k)
    _bulk(st, 30, 3.0, 0, np.arange(8).repeat(4)[:30])
    path = str(tmp_path / "grown.npz")
    sys_a.save_map(path)
    sys_b = _system(pkg, pkg.MapConfig(max_keyframes=2, max_points=16, n_kp=8))
    sys_b.load_map(path)
    assert sys_b.store.n_kf == 5
    assert sys_b.store.cfg.max_keyframes == st.cfg.max_keyframes
    np.testing.assert_array_equal(sys_b.store.kf_pose, st.kf_pose)
    np.testing.assert_array_equal(sys_b.store.pt_pos, st.pt_pos)
    return sys_b.store


def grown_planes_save_load_then_observe(pkg, tmp_path):
    sys_a = _system(pkg, pkg.MapConfig(max_keyframes=4, max_points=64, max_planes=2, n_kp=8))
    st = sys_a.store
    st.add_keyframe(IDENT, 0.0, _frame(8), 0)
    for i in range(5):  # grows past max_planes=2
        st.add_plane(np.array([0, 0, 1, 1.0 + i], np.float32), 0, 100)
    path = str(tmp_path / "planes.npz")
    sys_a.save_map(path)
    sys_b = _system(pkg, pkg.MapConfig(max_keyframes=4, max_points=64, max_planes=2, n_kp=8))
    sys_b.load_map(path)
    stb = sys_b.store
    assert stb.pl_obs_pi.shape[0] == stb.cfg.max_planes
    assert stb.pl_obs_w.shape[0] == stb.cfg.max_planes
    # observing a plane beyond the constructor cap must not crash
    stb.add_plane_observation(4, 0, pi_cam=np.array([0, 0, 1, 5.0], np.float32), weight=1.0)
    assert stb.pl_obs_count[4] == 1
    return stb


def shared_mapconfig_not_mutated(pkg, tmp_path):
    shared = pkg.MapConfig(max_keyframes=2, max_points=16, n_kp=8)
    a, b = pkg.MapStore(shared), pkg.MapStore(shared)
    f = _frame(8)
    for k in range(4):
        a.add_keyframe(IDENT, float(k), f, k)
    assert shared.max_keyframes == 2, "caller's config must stay untouched"
    for k in range(4):
        b.add_keyframe(IDENT, float(k), f, k)
    assert b.kf_valid[:4].all()
    return b


# --------------------- tests/unit/test_store_versions.py::TestTopoVersion
def _mk_store(pkg):
    return pkg.MapStore(pkg.MapConfig(max_keyframes=8, max_points=512, n_kp=32))


def structural_mutations_bump_topo(pkg, tmp_path):
    st = _mk_store(pkg)
    t0 = st.topo_version
    k = st.add_keyframe(IDENT, 0.0, _frame(32), 0)
    assert st.topo_version > t0
    t1 = st.topo_version
    ids = st.add_points_bulk(np.zeros((4, 3), np.float32), np.zeros((4, 8), np.uint32),
                             np.tile(np.array([0, 0, 1], np.float32), (4, 1)),
                             np.ones(4, np.float32), k, np.arange(4))
    assert st.topo_version > t1
    t2 = st.topo_version
    st.erase_point(int(ids[0]))
    assert st.topo_version > t2
    return st


def value_writes_do_not_bump_topo(pkg, tmp_path):
    st = _mk_store(pkg)
    st.add_keyframe(IDENT, 0.0, _frame(32), 0)
    topo, ver = st.topo_version, st.version
    # BA-style write-backs: pose + point positions
    st.set_kf_pose(0, np.array([1, 0, 0, 0, 0.1, 0, 0], np.float32))
    st.pt_pos[:4] += 0.01
    st.version += 1
    assert st.version > ver
    assert st.topo_version == topo
    return st


def snapshot_regather_sees_new_values(pkg, tmp_path):
    st = _mk_store(pkg)
    k = st.add_keyframe(IDENT, 0.0, _frame(32), 0)
    _bulk(st, 8, 3.0, k, np.arange(8), dist=3.0)
    tr = pkg.Tracker(pkg.TrackerConfig(local_points_cap=16), pkg.Intrinsics(**INTR), st,
                     **pkg.kw)
    tr.ref_kf = k
    ids1, pack1, _, _ = tr._local_snapshot()
    # value-only change (what BA write-back does)
    st.pt_pos[0] = [1.0, 2.0, 5.0]
    st.version += 1
    ids2, pack2, _, _ = tr._local_snapshot()
    np.testing.assert_array_equal(n(ids1), n(ids2))
    row = int(np.nonzero(n(ids2) == 0)[0][0])
    np.testing.assert_allclose(n(pack2)[row, 0:3], [1.0, 2.0, 5.0])
    # structural change invalidates the id set
    _bulk(st, 2, 4.0, k, np.arange(8, 10), dist=4.0)
    ids3, pack3, _, _ = tr._local_snapshot()
    assert (n(ids3) >= 0).sum() == 10
    return st, [n(x) for x in (ids1, pack1, ids2, pack2, ids3, pack3)]


CASES = [keyframes_grow_past_initial_cap, points_grow_in_bulk, planes_grow,
         save_load_roundtrip_after_growth, grown_planes_save_load_then_observe,
         shared_mapconfig_not_mutated, structural_mutations_bump_topo,
         value_writes_do_not_bump_topo, snapshot_regather_sees_new_values]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_store_case_on_both_packages(case, tmp_path):
    """Each case returns its final store, or (store, gathered arrays)."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = case(JAX, tmp_path / "jax")
    got = case(PORT, tmp_path / "port")
    if isinstance(want, tuple):
        (want, want_arrays), (got, got_arrays) = want, got
        for a, b in zip(got_arrays, want_arrays):
            np.testing.assert_array_equal(a, b)
    assert_same_store(got, want)
