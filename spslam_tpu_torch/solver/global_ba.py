"""Global bundle adjustment over the whole map after a loop closure (port
of spslam_tpu/solver/global_ba.py).

Dense path: the map is flattened on the host into one BAProblem padded to
power-of-two sizes with the reference's floors (GBA_MIN_*), an alternating
resection-intersection settle (`refine_alternating`) absorbs the pose
graph's correction, then the two-stage Schur LM of solver/ba.py converges
it.  At the floors the Schur tensor Y is [8192, 192, 3] float32.

Sharded path (`dist_global_bundle_adjust`): points and their observations
split into trajectory segments over a list of devices, the reduced camera
system summed once per LM iteration (parallel/dist_ba.py).  Auto mode
takes it once Y would exceed GBA_MAX_Y_ELEMS; with fewer than two devices
(one GPU) it declines, and the dense path settles 3x longer instead, as
the reference does on one chip.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import resolve_device
from ..geometry.camera import Intrinsics
from .ba import BAProblem, build_point_obs_table, bundle_adjust, refine_alternating
from .robust import octave_inv_sigma2

GBA_MAX_Y_ELEMS = 2 ** 29  # ~2 GiB of f32 for the [P, 6M, 3] Schur tensor

# padding floors for the dense global problem (the reference's, so shapes
# stay fixed over a run)
GBA_MIN_M = 32      # keyframes
GBA_MIN_P = 8192    # points
GBA_MIN_R = 32768   # observations


def _pow2(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _flatten_point_obs(st, omax: int):
    """Flatten the store's per-point observation tables into compact flat
    arrays: None if the map is too small, else a dict with the compact
    keyframe / point id maps and per-observation (cam_idx, pt_row, uv, ur,
    octave).  Call under store.lock if other threads may write."""
    kf_ids = np.nonzero(st.kf_valid)[0].astype(np.int32)
    pt_ids = np.nonzero(st.pt_valid)[0].astype(np.int32)
    if len(kf_ids) < 2 or len(pt_ids) < 50:
        return None
    kf_to_idx = np.full(st.cfg.max_keyframes, -1, np.int32)
    kf_to_idx[kf_ids] = np.arange(len(kf_ids), dtype=np.int32)
    kf_arr = st.pt_obs_kf[pt_ids]                       # [Np, O]
    slot_arr = st.pt_obs_slot[pt_ids]
    ok = (kf_arr >= 0) & (kf_to_idx[np.maximum(kf_arr, 0)] >= 0) & (slot_arr >= 0)
    cum = np.cumsum(ok, axis=1)
    keep = ok & (cum <= omax)
    n_dropped = int(ok.sum() - keep.sum())
    if n_dropped:
        logging.getLogger(__name__).info(
            "global BA: dropped %d observations beyond the %d-per-point cap", n_dropped, omax)
    rows, cols = np.nonzero(keep)
    k_sel = kf_arr[rows, cols]
    s_sel = slot_arr[rows, cols]
    return dict(
        kf_ids=kf_ids, pt_ids=pt_ids, kf_to_idx=kf_to_idx,
        rows=rows,
        cam_idx=kf_to_idx[k_sel],
        uv=st.kf_uv[k_sel, s_sel].astype(np.float32),
        ur=st.kf_ur[k_sel, s_sel].astype(np.float32),
        octave=st.kf_octave[k_sel, s_sel].astype(np.int32),
    )


def assemble_global_problem(store, intr: Intrinsics, omax: int | None = None, device=None):
    """Flatten the whole MapStore into a padded BAProblem on `device`.
    Returns (prob, kf_ids, pt_ids, pl_ids), or None if the map is too
    small.  Call under store.lock if other threads may write."""
    st = store
    dev = resolve_device(device)
    omax = omax or st.cfg.max_obs_per_point
    flat = _flatten_point_obs(st, omax)
    if flat is None:
        return None
    kf_ids, pt_ids, kf_to_idx = flat["kf_ids"], flat["pt_ids"], flat["kf_to_idx"]
    rows = flat["rows"]
    n_obs = len(rows)

    M = _pow2(len(kf_ids), GBA_MIN_M)
    P = _pow2(len(pt_ids), GBA_MIN_P)
    R = _pow2(max(n_obs, 1), GBA_MIN_R)
    obs_cam = np.zeros(R, np.int32)
    obs_pt = np.zeros(R, np.int32)
    obs_uv = np.zeros((R, 2), np.float32)
    obs_ur = np.full(R, -1.0, np.float32)
    obs_oct = np.zeros(R, np.int32)
    obs_valid = np.zeros(R, bool)
    obs_cam[:n_obs] = flat["cam_idx"]
    obs_pt[:n_obs] = rows
    obs_uv[:n_obs] = flat["uv"]
    obs_ur[:n_obs] = flat["ur"]
    obs_oct[:n_obs] = flat["octave"]
    obs_valid[:n_obs] = True
    pt_obs = build_point_obs_table(rows, P, omax)

    poses = np.zeros((M, 7), np.float32)
    poses[:, 0] = 1.0
    poses[: len(kf_ids)] = st.kf_pose[kf_ids]
    pose_valid = np.zeros(M, bool)
    pose_valid[: len(kf_ids)] = True
    pose_fixed = np.zeros(M, bool)
    pose_fixed[0] = True  # gauge: oldest valid keyframe
    points = np.zeros((P, 3), np.float32)
    points[: len(pt_ids)] = st.pt_pos[pt_ids]
    point_valid = np.zeros(P, bool)
    point_valid[: len(pt_ids)] = True

    # planes: all valid, with their stored per-keyframe observations
    L = max(st.cfg.max_planes, 1)
    pl_ids = np.nonzero(st.pl_valid)[0].astype(np.int32)
    planes = np.zeros((L, 4), np.float32)
    planes[:, 2] = 1.0
    plane_valid = np.zeros(L, bool)
    planes[: len(pl_ids)] = st.pl_coef[pl_ids]
    plane_valid[: len(pl_ids)] = True
    Q = max(L * st.pl_obs_kf.shape[1], 1)
    pobs_cam = np.zeros(Q, np.int32)
    pobs_plane = np.zeros(Q, np.int32)
    pobs_pi = np.tile(np.array([0, 0, 1, 0], np.float32), (Q, 1))
    pobs_w = np.zeros(Q, np.float32)
    pobs_valid = np.zeros(Q, bool)
    if len(pl_ids):
        O = st.pl_obs_kf.shape[1]
        kf_obs = st.pl_obs_kf[pl_ids]                    # [Lp, O]
        ok_pl = (
            (np.arange(O)[None, :] < st.pl_obs_count[pl_ids][:, None])
            & (kf_obs >= 0)
            & (kf_to_idx[np.maximum(kf_obs, 0)] >= 0)
        )
        li_arr, j_arr = np.nonzero(ok_pl)
        q = len(li_arr)
        pobs_cam[:q] = kf_to_idx[kf_obs[li_arr, j_arr]]
        pobs_plane[:q] = li_arr
        pobs_pi[:q] = st.pl_obs_pi[pl_ids[li_arr], j_arr]
        pobs_w[:q] = np.maximum(st.pl_obs_w[pl_ids[li_arr], j_arr], 1e-3)
        pobs_valid[:q] = True
    E = max(len(st.ppe_a), 1)
    pl_index = {int(l): i for i, l in enumerate(pl_ids)}
    pp_a = np.zeros(E, np.int32)
    pp_b = np.zeros(E, np.int32)
    pp_type = np.zeros(E, np.int32)
    pp_w = np.zeros(E, np.float32)
    pp_valid = np.zeros(E, bool)
    e = 0
    for a, b, t in zip(st.ppe_a, st.ppe_b, st.ppe_type):
        if int(a) in pl_index and int(b) in pl_index:
            pp_a[e], pp_b[e], pp_type[e] = pl_index[int(a)], pl_index[int(b)], int(t)
            pp_w[e] = 10.0
            pp_valid[e] = True
            e += 1

    def d(a):
        return torch.from_numpy(a).to(dev)

    prob = BAProblem(
        poses=d(poses), pose_fixed=d(pose_fixed), pose_valid=d(pose_valid),
        points=d(points), point_valid=d(point_valid),
        obs_cam=d(obs_cam), obs_pt=d(obs_pt), obs_uv=d(obs_uv), obs_ur=d(obs_ur),
        obs_inv_sigma2=octave_inv_sigma2(d(obs_oct)), obs_valid=d(obs_valid),
        pt_obs=d(pt_obs),
        planes=d(planes), plane_valid=d(plane_valid),
        pobs_cam=d(pobs_cam), pobs_plane=d(pobs_plane), pobs_pi=d(pobs_pi),
        pobs_w=d(pobs_w), pobs_valid=d(pobs_valid),
        pp_a=d(pp_a), pp_b=d(pp_b), pp_type=d(pp_type), pp_w=d(pp_w), pp_valid=d(pp_valid),
    )
    return prob, kf_ids, pt_ids, pl_ids


def global_bundle_adjust(store, intr: Intrinsics, settle_iters: int = 4, stage1_iters: int = 4,
                         stage2_iters: int = 8, distributed: bool | None = None,
                         write_back: bool = True, device=None, devices=None):
    """Global BA over the whole map: an alternating settle, then the full
    Schur LM.

    `distributed`: None (auto) runs the dense Newton while the Schur tensor
    Y fits GBA_MAX_Y_ELEMS and otherwise the sharded solver over this
    process's devices; True forces the sharded solver; False never uses
    it.  When the sharded solver declines (fewer than two devices, or a
    map too small to shard), a map too large for Y settles 3x longer
    instead (the bounded-memory fallback).

    write_back=True: write into the store; returns True if a Newton-type
    stage (dense or sharded) ran.  write_back=False (the loop closer's GBA
    worker): returns {kf_ids, poses, pt_ids, points, pl_ids, planes,
    newton, wrote=False} for the caller to merge, or None when the map is
    too small; the sharded path writes inline and returns {wrote=True,
    newton=True}.  `devices`: the sharded solver's device list (default:
    this process's GPUs on CUDA, [device] on the CPU)."""
    st = store
    dev = resolve_device(device)
    if devices is None and dev.type != "cuda":
        devices = [dev]
    n_iters = stage1_iters + stage2_iters
    if distributed is True and dist_global_bundle_adjust(st, intr, n_iters=n_iters,
                                                         devices=devices):
        return True if write_back else dict(wrote=True, newton=True)
    with st.lock:
        out = assemble_global_problem(st, intr, device=device)
    if out is None:
        return False if write_back else None
    prob, kf_ids, pt_ids, pl_ids = out

    M, P = prob.poses.shape[0], prob.points.shape[0]
    newton = P * 6 * M * 3 <= GBA_MAX_Y_ELEMS
    if not newton and distributed is None and dist_global_bundle_adjust(
            st, intr, n_iters=n_iters, devices=devices):
        return True if write_back else dict(wrote=True, newton=True)

    def settle(poses, points, n):
        return refine_alternating(
            poses, prob.pose_fixed | ~prob.pose_valid, points, prob.point_valid,
            prob.obs_cam, prob.obs_pt, prob.obs_uv, prob.obs_ur, prob.obs_inv_sigma2,
            prob.obs_valid.to(torch.float32), intr, n_iters=n)

    poses, points = prob.poses, prob.points
    if settle_iters > 0:
        poses, points = settle(poses, points, settle_iters)
    if newton:
        res = bundle_adjust(prob._replace(poses=poses, points=points), intr,
                            stage1_iters=stage1_iters, stage2_iters=stage2_iters)
        new_poses, new_points = res.poses.cpu().numpy(), res.points.cpu().numpy()
        new_planes = res.planes.cpu().numpy()
    else:
        poses, points = settle(poses, points, 3 * settle_iters)
        new_poses, new_points = poses.cpu().numpy(), points.cpu().numpy()
        new_planes = None

    if not write_back:
        return dict(
            wrote=False, newton=newton,
            kf_ids=kf_ids, poses=new_poses[: len(kf_ids)],
            pt_ids=pt_ids, points=new_points[: len(pt_ids)],
            pl_ids=pl_ids,
            planes=new_planes[: len(pl_ids)] if new_planes is not None else None,
        )
    with st.lock:
        st.kf_pose[kf_ids] = new_poses[: len(kf_ids)]
        st.pt_pos[pt_ids] = new_points[: len(pt_ids)]
        if new_planes is not None and len(pl_ids):
            st.pl_coef[pl_ids] = new_planes[: len(pl_ids)]
        st.version += 1
    return newton


def dist_global_bundle_adjust(store, intr: Intrinsics, n_shards: int | None = None,
                              n_iters: int = 12, devices=None) -> bool:
    """Global BA with keyframe trajectory segments and their map blocks
    sharded over `devices` (parallel/dist_ba.py), written back into the
    store.

    `devices`: the shards' devices, one shard each, and repeats allowed
    (default: this process's GPUs, `dist_ba.global_mesh()`); D =
    min(n_shards, len(devices)), as the reference caps by its devices.
    With a `torch.distributed` group of W processes up, every process
    passes its own devices, D counts all W x len(devices), each process
    solves its block of shards and the solved points are all-reduced once
    at the end.

    Points only (planes keep their pose-graph-corrected values), the
    oldest keyframe fixed as gauge, each point on its owning keyframe's
    segment (reference keyframe, else its first observing camera), no
    settle stage.  Returns False, leaving the store as it was, when D < 2
    or the map has fewer than 64 points per shard."""
    from ..parallel import dist_ba

    st = store
    devices = list(devices) if devices is not None else dist_ba.global_mesh()
    world = torch.distributed.get_world_size() if dist_ba._group_up() else 1
    rank = torch.distributed.get_rank() if world > 1 else 0
    D = min(n_shards or len(devices) * world, len(devices) * world)
    D -= D % world
    with st.lock:
        flat = _flatten_point_obs(st, st.cfg.max_obs_per_point)
        if flat is None:
            return False
        kf_ids, pt_ids = flat["kf_ids"], flat["pt_ids"]
        if D < 2 or len(pt_ids) < 64 * D:
            return False
        poses = st.kf_pose[kf_ids].astype(np.float32).copy()
        points = st.pt_pos[pt_ids].astype(np.float32).copy()
        # owning keyframe in compact index space (reference keyframe when
        # still valid, else the point's first observing camera)
        ref = st.pt_ref_kf[pt_ids]
        ref_ok = (ref >= 0) & st.kf_valid[np.maximum(ref, 0)]
        pt_ref_compact = np.where(ref_ok, flat["kf_to_idx"][np.maximum(ref, 0)],
                                  -1).astype(np.int64)

    rows = flat["rows"]
    first = np.full(len(pt_ids), len(rows), np.int64)
    np.minimum.at(first, rows, np.arange(len(rows)))
    seen = first < len(rows)
    fallback_ref = np.zeros(len(pt_ids), np.int64)
    fallback_ref[seen] = flat["cam_idx"][first[seen]]
    pt_ref_compact = np.where(pt_ref_compact >= 0, pt_ref_compact, fallback_ref)

    pose_fixed = np.zeros(len(kf_ids), bool)
    pose_fixed[0] = True  # gauge
    prob, shard_of_pt, local_idx = dist_ba.partition_problem(
        poses, pose_fixed, points, flat["cam_idx"].astype(np.int32), rows.astype(np.int64),
        flat["uv"], flat["ur"],
        octave_inv_sigma2(torch.from_numpy(flat["octave"])).numpy(),
        n_shards=D, obs_per_point=st.cfg.max_obs_per_point, pt_ref_kf=pt_ref_compact,
        strategy="segments", return_mapping=True,
    )
    per = D // world
    new_poses, pts, _ = dist_ba.dist_bundle_adjust(
        dist_ba.local_shards(prob, rank, world), intr, devices[:per], n_iters=n_iters)
    if world > 1:
        # every process writes the whole map: gather the shards' points
        full = torch.zeros((D,) + pts.shape[1:], dtype=pts.dtype, device=pts.device)
        full[rank * per:(rank + 1) * per] = pts
        torch.distributed.all_reduce(full)
        pts = full
    new_poses, new_points = new_poses.cpu().numpy(), pts.cpu().numpy()
    with st.lock:
        st.kf_pose[kf_ids] = new_poses
        st.pt_pos[pt_ids] = new_points[shard_of_pt, local_idx]
        st.version += 1
    return True
