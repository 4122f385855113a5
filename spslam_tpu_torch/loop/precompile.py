"""Warm-up of the loop-closure machinery (port of
spslam_tpu/loop/precompile.py).

The reference compiles every XLA program of the closure path ahead of the
first closure.  On the card nothing compiles, but the first call of each
op still pays for creating the cuSOLVER / cuBLAS handles, loading the
kernels' modules and growing the caching allocator: one dummy call of each
op at the production shapes moves that cost out of the first closure.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geometry.camera import Intrinsics


def warm_loop_machinery(intr: Intrinsics, map_cfg=None, pose_graph_iters: int = 20,
                        device=None):
    """One call of every device op the loop-closure path runs."""
    from ..map.store import MapConfig, MapStore
    from ..ops.match import TH_HIGH, match_descriptors, search_by_projection
    from ..solver.global_ba import global_bundle_adjust
    from ..solver.pose_graph import PoseGraphProblem, optimize_pose_graph
    from .loop_closer import LoopConfig, _retransform
    from .sim3 import draw_hypotheses, ransac_align
    from .vocab import quantize

    dev = resolve_device(device)
    map_cfg = map_cfg or MapConfig()
    N = map_cfg.n_kp
    rng = np.random.default_rng(0)

    def d(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    bits = d((rng.uniform(size=(N, 256)) > 0.5).astype(np.float32))
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    angles = torch.zeros(N, dtype=torch.float32, device=dev)
    match_descriptors(bits, bits, valid, valid, angles, angles, max_dist=64.0, ratio=0.85)
    uv = d(rng.uniform(0, 400, (N, 2)).astype(np.float32))
    octv = torch.zeros(N, dtype=torch.int32, device=dev)
    search_by_projection(uv, bits, valid, octv, uv, bits, valid, octv,
                         torch.full((N,), 10.0, device=dev),
                         max_dist=TH_HIGH, ratio=0.95, check_rotation=False)
    pts = d(rng.normal(0, 1, (N, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32))
    ransac_align(pts, pts, valid, draw_hypotheses(np.ones(N, bool), torch.Generator()))
    quantize(bits, d((rng.uniform(size=(4096, 256)) > 0.5).astype(np.float32)), valid)

    # pose graph at the production size (K = max_keyframes, E = 256)
    K, E = map_cfg.max_keyframes, 256
    ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    prob = PoseGraphProblem(
        poses=d(np.tile(ident, (K, 1))), fixed=d(np.arange(K) == 0), valid=d(np.arange(K) < 4),
        edge_i=torch.zeros(E, dtype=torch.int64, device=dev),
        edge_j=d(np.minimum(np.arange(E) % 4, 3).astype(np.int64)),
        edge_T=d(np.tile(ident, (E, 1))), edge_w=torch.ones(E, device=dev),
        edge_valid=d(np.arange(E) < 3),
    )
    optimize_pose_graph(prob, n_iters=pose_graph_iters)
    T = d(np.tile(ident, (8192, 1)))
    _retransform(T, T, torch.zeros((8192, 3), device=dev))

    # dense global BA at the GBA_MIN_* floors, on the minimum viable map
    st = MapStore(MapConfig(max_keyframes=map_cfg.max_keyframes, max_points=map_cfg.max_points,
                            max_planes=map_cfg.max_planes, n_kp=N))
    frame_np = dict(
        uv=rng.uniform(50, 400, (N, 2)).astype(np.float32),
        octave=np.zeros(N, np.int32),
        angle=np.zeros(N, np.float32),
        desc=rng.integers(0, 2 ** 32, (N, 8), np.uint64).astype(np.uint32),
        depth=rng.uniform(1.0, 3.0, N).astype(np.float32),
        u_right=np.full(N, -1.0, np.float32),
        valid=np.ones(N, bool),
    )
    for k in range(2):
        st.add_keyframe(np.array([1, 0, 0, 0, 0, 0.1 * k, 0], np.float32), float(k), frame_np, k)
    slots = np.arange(64)
    pos = np.concatenate([rng.uniform(-1, 1, (64, 2)), rng.uniform(2, 4, (64, 1))],
                         axis=1).astype(np.float32)
    ids = st.add_points_bulk(pos, frame_np["desc"][:64],
                             np.tile(np.array([0, 0, 1], np.float32), (64, 1)),
                             np.ones(64, np.float32), 0, slots)
    st.add_observations_bulk(ids, 1, slots)
    lc = LoopConfig()
    global_bundle_adjust(st, intr, settle_iters=lc.gba_settle_iters,
                         stage1_iters=lc.gba_stage1_iters, stage2_iters=lc.gba_stage2_iters,
                         distributed=False, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm_sync_tracking(intr: Intrinsics, frames, timestamps, device=None):
    """Run the synchronous tracking programs that only execute on anomalies
    (pose-jump replays, LOST, relocalization): a few real frames through a
    throwaway System, then the pose teleported 5 m sideways for one more
    frame, so the global fallback and the relocalization machinery run."""
    from ..system import System, SystemConfig

    sys_ = System(SystemConfig(intr=intr), device=device)
    n = min(len(frames), 4)
    for (g, dd), ts in zip(frames[: n - 1], timestamps[: n - 1]):
        sys_.track_rgbd(g, dd, float(ts))
    sys_.tracker.flush_pipeline()
    tr = sys_.tracker
    if tr.state.name == "OK":
        tr.velocity = None
        tr._chain = None
        tr.T_cw = tr.T_cw + np.array([0, 0, 0, 0, 5.0, 0, 0], np.float32)
        g, dd = frames[n - 1]
        tr.process(g, dd, float(timestamps[n - 1]))
    sys_.shutdown()
    return sys_
