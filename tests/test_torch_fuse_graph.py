"""Fusion's graphed projection match (mapping/fuse_graph.py) on the CPU,
where no graph is captured: the static-buffer path that a capture records,
the choice of who takes a graph, `project_points`' log-scale argument, and
the local mapper's eager path.

The scene: four keyframes on a short arc over one set of landmarks with
random descriptors; the first keyframe makes a point of every landmark,
the others observe the first half of those points and make duplicates of
the second half, which fusion then merges.  Every comparison is bit for
bit: the arithmetic is the same on the same inputs.
"""

import numpy as np
import torch

from spslam_tpu_torch import cuda_graphs, tracing
from spslam_tpu_torch.geometry import np_lie
from spslam_tpu_torch.geometry.camera import Intrinsics
from spslam_tpu_torch.map.store import MapConfig, MapStore
from spslam_tpu_torch.mapping import fuse, fuse_graph
from spslam_tpu_torch.mapping.local_mapper import LocalMapper, MapperConfig
from spslam_tpu_torch.tracking.tracker import octave_log_scale, project_points
from tests.test_torch_common import assert_same_store

INTR = Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0, width=640, height=480)
N_KF, N_PTS, N_KP = 4, 160, 256


def _store(seed: int) -> MapStore:
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, N_PTS), rng.uniform(-1.5, 1.5, N_PTS),
                    rng.uniform(4, 7, N_PTS)], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (N_PTS, 8), dtype=np.uint32)
    st = MapStore(MapConfig(max_keyframes=16, max_points=2048, n_kp=N_KP))
    half = N_PTS // 2
    for k in range(N_KF):
        a = 0.02 * k
        T = np.array([np.cos(a / 2), 0, np.sin(a / 2), 0, -0.1 * k, 0.01 * k, 0], np.float32)
        xc = np_lie.se3_apply(T, pts)
        uv = np.stack([INTR.fx * xc[:, 0] / xc[:, 2] + INTR.cx,
                       INTR.fy * xc[:, 1] / xc[:, 2] + INTR.cy], -1).astype(np.float32)
        fr = dict(uv=np.zeros((N_KP, 2), np.float32), octave=np.zeros(N_KP, np.int32),
                  angle=np.zeros(N_KP, np.float32), desc=np.zeros((N_KP, 8), np.uint32),
                  depth=np.zeros(N_KP, np.float32), u_right=np.full(N_KP, -1.0, np.float32),
                  valid=np.zeros(N_KP, bool))
        fr["uv"][:N_PTS] = uv + rng.normal(0, 0.3, uv.shape).astype(np.float32)
        fr["desc"][:N_PTS], fr["depth"][:N_PTS], fr["valid"][:N_PTS] = desc, xc[:, 2], True
        kf = st.add_keyframe(T, float(k), fr, k, parent=k - 1)
        C = np_lie.camera_center(T)
        slots = np.arange(N_PTS)
        new = slots if k == 0 else slots[half:]
        pos = pts[new] + (0 if k == 0 else rng.normal(0, 0.01, (len(new), 3)).astype(np.float32))
        vec = pos - C
        dist = np.linalg.norm(vec, axis=-1)
        st.add_points_bulk(pos, desc[new], vec / dist[:, None], dist, kf, new,
                           octave=np.zeros(len(new), np.int32))
        if k > 0:
            st.add_observations_bulk(slots[:half], kf, slots[:half])
    return st


def _block(st: MapStore, pids, kfs) -> tuple:
    """The host inputs of one block: `_kf_stack`'s five tensors, then
    `_point_block`'s two."""
    _, *stack = fuse._kf_stack(st, np.asarray(kfs, np.int32), "cpu")
    _, *block = fuse._point_block(st, np.asarray(pids, np.int32), "cpu")
    return (*stack, *block)


def _eager(inputs) -> tuple:
    idx, dist = fuse._fuse_match_batch(*inputs, INTR)
    return idx.numpy(), dist.numpy()


def _fetch_with_dist(out) -> tuple:
    return out[0].cpu().numpy(), out[1].cpu().numpy()


def test_static_buffers_give_each_block_its_own_result():
    """Two blocks in turn through one set of static tensors (copy-in, then
    the match a capture records, run eagerly on them): each gives its own
    `_fuse_match_batch` result."""
    st = _store(0)
    valid = np.nonzero(st.pt_valid)[0]
    b1 = _block(st, valid, [1, 2, 3])
    b2 = _block(st, valid[::-1][:100], [0, 2])
    assert [tuple(x.shape) for x in b1] == [tuple(x.shape) for x in b2]
    assert b1[0].shape[0] == fuse.FUSE_TARGETS and b1[5].shape[0] == fuse.FUSE_POINTS
    want1, want2 = _eager(b1), _eager(b2)
    static, match = cuda_graphs.static_call(b1, fuse_graph.build(INTR), "cpu")
    cuda_graphs.load(static, b1)
    got1 = _fetch_with_dist(match())
    cuda_graphs.load(static, b2)
    got2 = _fetch_with_dist(match())
    for got, want in ((got1, want1), (got2, want2)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # both blocks match, and differently: equal results are not one echoed
    assert (want1[0] >= 0).sum() > 50 and (want2[0] >= 0).sum() > 50
    assert not np.array_equal(want1[0], want2[0])


def test_only_a_full_block_on_a_card_reaches_the_cache():
    """The key is None (eager, no entry) off a CUDA device and for a block
    of another shape; on the CPU the cache's answer is the eager one."""
    st = _store(1)
    valid = np.nonzero(st.pt_valid)[0]
    full = _block(st, valid, [1, 2])
    cuda = torch.device("cuda", 0)
    key = fuse_graph.key(full, INTR, cuda)
    assert key is not None
    assert fuse_graph.key(full, INTR._replace(fx=500.0), cuda) != key
    assert fuse_graph.key(full, INTR, "cpu") is None
    fewer_targets = (*(x[:4] for x in full[:5]), *full[5:])
    fewer_points = (*full[:5], *(x[:512] for x in full[5:]))
    for other in (fewer_targets, fewer_points):
        assert fuse_graph.key(other, INTR, cuda) is None
    graphs = cuda_graphs.CapturedCalls("mapper.fuse")
    for inputs in (full, fewer_targets, fewer_points):
        got = fuse_graph.match(inputs, INTR, "cpu", graphs, _fetch_with_dist)
        want = _eager(inputs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(fuse_graph.match(inputs, INTR, "cpu", graphs), want[0])
    assert graphs._entries == {} and (graphs.captures, graphs.replays, graphs.failures) == (0, 0, 0)


def test_project_points_log_scale_argument_changes_nothing():
    """project_points with `octave_log_scale` passed in gives the same
    uv, ok, octave and depth as with the log scale made inside, bit for bit."""
    rng = np.random.default_rng(5)
    n = 4096
    pos = torch.from_numpy(np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                                     rng.uniform(0.5, 9, n)], -1).astype(np.float32))
    normal = torch.nn.functional.normalize(pos + torch.from_numpy(
        rng.normal(0, 0.3, (n, 3)).astype(np.float32)), dim=-1)
    maxd = torch.from_numpy(rng.uniform(1, 12, n).astype(np.float32))
    mind = maxd / 1.2 ** 8
    valid = torch.from_numpy(rng.uniform(size=n) < 0.9)
    T = torch.tensor([0.999, 0.02, -0.03, 0.01, 0.1, -0.05, 0.2], dtype=torch.float32)
    T = torch.cat([T[:4] / torch.linalg.norm(T[:4]), T[4:]])
    want = project_points(T, pos, normal, mind, maxd, valid, INTR)
    got = project_points(T, pos, normal, mind, maxd, valid, INTR, octave_log_scale("cpu"))
    for g, w, name in zip(got, want, ("uv", "ok", "oct_pred", "z")):
        assert torch.equal(g, w), name
    assert bool(want[1].any()) and len(torch.unique(want[2])) > 3


def _fuse_into_keyframes_per_block(st, intr, pids, target_kfs, device):
    """fuse_into_keyframes as it was before the cache: `_fuse_match_batch`
    called directly on each block."""
    if len(pids) == 0 or len(target_kfs) == 0:
        return 0, 0
    total_fused = total_added = 0
    for t0 in range(0, len(target_kfs), fuse.FUSE_TARGETS):
        kf_ids, *stack = fuse._kf_stack(st, target_kfs[t0: t0 + fuse.FUSE_TARGETS], device)
        for p0 in range(0, len(pids), fuse.FUSE_POINTS):
            pid_block, *block = fuse._point_block(st, pids[p0: p0 + fuse.FUSE_POINTS], device)
            idx, _ = fuse._fuse_match_batch(*stack, *block, intr)
            f, a = fuse._merge_matches(st, pid_block, kf_ids, idx.cpu().numpy())
            total_fused += f
            total_added += a
    return total_fused, total_added


def test_local_mapper_on_the_cpu_never_enters_the_cache(monkeypatch):
    """LocalMapper.process_keyframe on the CPU records fusion's match and
    merge spans but no replay or capture, adds no cache entry, and leaves
    the store as `_fuse_match_batch` called block by block does."""
    kf = N_KF - 1
    st, st_ref = _store(3), _store(3)
    n_before = int(st.pt_valid.sum())
    tracing.reset()
    tracing.enable()
    try:
        LocalMapper(MapperConfig(), INTR, st, "cpu").process_keyframe(kf, run_ba=False)
        names = [s.name for s in tracing.records()]
    finally:
        tracing.disable()
        tracing.reset()
    assert {"mapper.fuse", "mapper.fuse_match", "mapper.fuse_merge"} <= set(names)
    assert names.count("mapper.fuse_match") == names.count("mapper.fuse_merge") >= 2
    assert not set(names) & {"mapper.fuse_replay", "mapper.fuse_capture"}
    g = fuse_graph.GRAPHS
    assert g._entries == {} and (g.captures, g.replays, g.failures) == (0, 0, 0)
    assert int(st.pt_valid.sum()) < n_before          # duplicates were fused

    monkeypatch.setattr(fuse, "fuse_into_keyframes", _fuse_into_keyframes_per_block)
    LocalMapper(MapperConfig(), INTR, st_ref, "cpu").process_keyframe(kf, run_ba=False)
    assert_same_store(st, st_ref)
