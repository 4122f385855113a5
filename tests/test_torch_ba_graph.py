"""The local mapper's graphed bundle adjustment (mapping/ba_graph.py) on the
CPU, where no graph is captured: the static-buffer path that a capture
records, the choice of who takes a graph, and the mapper's eager path.

Problems are windows of a synthetic map at the default MapperConfig's
shapes (M 24, P 4,096, R 16,384, L 16, Q 64, E 32).  Every comparison is
bit for bit: the arithmetic is the same on the same inputs.
"""

import numpy as np
import pytest
import torch

from spslam_tpu_torch import cuda_graphs, tracing
from spslam_tpu_torch.geometry import np_lie
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.geometry.plane import transform_plane_np
from spslam_tpu_torch.map.store import MapConfig, MapStore
from spslam_tpu_torch.mapping import ba_graph
from spslam_tpu_torch.mapping.local_mapper import LocalMapper, MapperConfig
from spslam_tpu_torch.solver.ba import BAProblem, bundle_adjust
from tests.test_torch_common import assert_same_store

INTR = Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0, width=640, height=480)
CFG = MapperConfig()
N_KF = 8
# two world planes seen by every keyframe, perpendicular: a floor and a back wall
PLANES = np.array([[0.0, -1.0, 0.0, 1.5], [0.0, 0.0, -1.0, 7.0]], np.float32)


def _store(seed: int, planes: bool) -> MapStore:
    """N_KF keyframes on a short arc, ~900 points in front of them with
    noisy observations (a few gross outliers), perturbed keyframe poses
    and point positions; with `planes`, two planes observed from every
    keyframe and a perpendicular edge between them."""
    rng = np.random.default_rng(seed)
    st = MapStore(MapConfig(max_keyframes=32, max_points=2048, max_planes=8))
    N = st.cfg.n_kp
    n_pts = 900
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(3, 6, n_pts)], -1).astype(np.float32)
    for k in range(N_KF):
        a = 0.03 * k
        T = np.array([np.cos(a / 2), 0, np.sin(a / 2), 0, -0.08 * k, 0.01 * k, 0], np.float32)
        xc = np_lie.se3_apply(T, pts)
        uv = np.stack([INTR.fx * xc[:, 0] / xc[:, 2] + INTR.cx,
                       INTR.fy * xc[:, 1] / xc[:, 2] + INTR.cy], -1)
        vis = np.nonzero((uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480))[0]
        vis = vis[:N]
        n = len(vis)
        frame = dict(uv=np.zeros((N, 2), np.float32), octave=np.zeros(N, np.int32),
                     angle=np.zeros(N, np.float32), desc=np.zeros((N, 8), np.uint32),
                     depth=np.zeros(N, np.float32), u_right=np.full(N, -1.0, np.float32),
                     valid=np.zeros(N, bool))
        obs = uv[vis] + rng.normal(0, 0.5, (n, 2))
        obs[rng.uniform(size=n) < 0.03] += 40.0
        frame["uv"][:n] = obs
        frame["octave"][:n] = rng.integers(0, 4, n)
        frame["depth"][:n] = xc[vis, 2]
        frame["u_right"][:n] = obs[:, 0] - INTR.bf / xc[vis, 2]
        frame["valid"][:n] = True
        T_noisy = T.copy()
        if k > 0:
            T_noisy[4:] += rng.normal(0, 0.01, 3).astype(np.float32)
        st.add_keyframe(T_noisy, 0.1 * k, frame, frame_id=k, parent=k - 1)
        c = st.pt_n_obs[vis]
        st.pt_obs_kf[vis, c] = k
        st.pt_obs_slot[vis, c] = np.arange(n)
        st.pt_n_obs[vis] = c + 1
        st.kf_obs[k, :n] = vis
        if planes:
            for l, pi in enumerate(PLANES):
                if k == 0:
                    st.add_plane(pi + np.array([0, 0, 0, 0.02], np.float32), 0, 500)
                pi_c = transform_plane_np(T, pi) + rng.normal(0, 1e-3, 4).astype(np.float32)
                st.add_plane_observation(l, k, pi_c, 50.0)
    if planes:
        st.add_plane_edge(0, 1, 1)
    st.pt_pos[:n_pts] = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    st.pt_valid[:n_pts] = True
    st.n_pt = n_pts
    return st


def _problem(seed: int, planes: bool, kf: int) -> BAProblem:
    return LocalMapper(CFG, INTR, _store(seed, planes), "cpu")._host_problem(kf)[0]


def _eager(prob: BAProblem) -> tuple:
    return ba_graph.fetch(bundle_adjust(prob, INTR, CFG.ba_stage1_iters, CFG.ba_stage2_iters))


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("poses", "points", "planes", "obs_inlier")):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_static_buffers_give_each_problem_its_own_result():
    """Two problems in turn through one set of static tensors (copy-in,
    then the solve a capture records, run eagerly on them): each gives its
    own bundle_adjust result, and the first result is not overwritten."""
    p1, p2 = _problem(1, True, N_KF - 1), _problem(2, False, N_KF - 2)
    assert ba_graph.problem_dims(p1) == ba_graph.mapper_dims(CFG)
    assert bool(p1.plane_valid.any()) and bool(p1.pp_valid.any())
    assert not bool(p2.plane_valid.any())
    for name in ("poses", "points", "obs_uv", "obs_ur", "obs_inv_sigma2", "pt_obs", "planes",
                 "pobs_pi", "pp_valid"):
        assert not torch.equal(getattr(p1, name), getattr(p2, name)), name
    want1, want2 = _eager(p1), _eager(p2)
    static, solve = cuda_graphs.static_call(p1, ba_graph.build(INTR, CFG), "cpu")
    cuda_graphs.load(static, p1)
    got1 = ba_graph.fetch(solve())
    cuda_graphs.load(static, p2)
    got2 = ba_graph.fetch(solve())
    _assert_equal(got1, want1)
    _assert_equal(got2, want2)
    # the solve moved the map, so equal results are not the inputs echoed
    assert not np.array_equal(want1[0], p1.poses.numpy())
    assert not np.array_equal(want1[2], p1.planes.numpy())


def test_only_the_mappers_shape_on_a_card_reaches_the_cache():
    """The key is None (eager, no entry) off a CUDA device and for a
    problem of another shape, such as the global BA's."""
    prob = _problem(1, True, N_KF - 1)
    # the same window padded to other shapes, as the global BA's are
    other = MapperConfig(ba_max_poses=12, ba_max_free=8, ba_max_points=1024, ba_max_obs=4096,
                         ba_obs_per_point=8, ba_max_planes=4, ba_max_plane_obs=16,
                         ba_max_pp_edges=8)
    small = LocalMapper(other, INTR, _store(1, True), "cpu")._host_problem(N_KF - 1)[0]
    assert ba_graph.problem_dims(small) == ba_graph.mapper_dims(other)
    cuda = torch.device("cuda", 0)
    key = ba_graph.key(prob, INTR, CFG, cuda)
    assert key is not None
    assert ba_graph.key(prob, INTR._replace(fx=500.0), CFG, cuda) != key
    assert ba_graph.key(prob, INTR, MapperConfig(ba_stage2_iters=7), cuda) != key
    assert ba_graph.key(small, INTR, CFG, cuda) is None
    assert ba_graph.key(prob, INTR, CFG, "cpu") is None
    graphs = cuda_graphs.CapturedCalls("mapper.ba")
    _assert_equal(ba_graph.solve(small, INTR, CFG, "cpu", graphs), _eager(small))
    assert graphs._entries == {} and (graphs.captures, graphs.replays) == (0, 0)


@pytest.mark.parametrize("planes", [False, True])
def test_local_mapper_on_the_cpu_stays_eager(planes):
    """LocalMapper.local_ba on the CPU records no replay or capture span,
    adds no cache entry, and writes back what bundle_adjust on
    the window's host problem, moved to the device, gives."""
    kf = N_KF - 1
    st, st_ref = _store(3, planes), _store(3, planes)
    tracing.reset()
    tracing.enable()
    try:
        LocalMapper(CFG, INTR, st, "cpu").local_ba(kf)
        names = {s.name for s in tracing.records()}
    finally:
        tracing.disable()
        tracing.reset()
    assert not names & {"mapper.ba_replay", "mapper.ba_capture"}
    assert ba_graph.GRAPHS._entries == {}

    prob, kf_ids, fixed_mask, pts, obs_src, pl_ids = LocalMapper(
        CFG, INTR, st_ref, "cpu")._host_problem(kf)
    res = bundle_adjust(ba_graph.to_device(prob, "cpu"), INTR, stage1_iters=CFG.ba_stage1_iters,
                        stage2_iters=CFG.ba_stage2_iters)
    new_poses, new_points = res.poses.numpy(), res.points.numpy()
    new_planes, inl = res.planes.numpy(), res.obs_inlier.numpy()
    before = st_ref.kf_pose.copy()
    for i, k in enumerate(kf_ids):
        if not fixed_mask[i]:
            st_ref.set_kf_pose(int(k), new_poses[i])
    st_ref.pt_pos[pts] = new_points[: len(pts)]
    st_ref.pl_coef[pl_ids] = new_planes[: len(pl_ids)]
    src_p, src_k, _ = obs_src
    for ri in np.nonzero(~inl[: len(src_p)])[0]:
        if st_ref.pt_valid[int(src_p[ri])]:
            st_ref.remove_observation(int(src_p[ri]), int(src_k[ri]))
    st_ref.version += 1
    assert_same_store(st, st_ref)
    assert not np.array_equal(st.kf_pose, before)
    assert (~inl[: len(src_p)]).any()
    assert len(pl_ids) == (2 if planes else 0)
