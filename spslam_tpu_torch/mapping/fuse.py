"""Duplicate map-point fusion (port of spslam_tpu/mapping/fuse.py; the
reference's ORBmatcher::Fuse driven by LocalMapping::SearchInNeighbors).

One device call projects a padded point block into a stack of target
keyframes and Hamming-matches it; the host merges the resulting
(point, keyframe, slot) triples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.camera import Intrinsics
from ..map.store import MapStore
from ..ops.brief import unpack_bits
from ..ops.match import TH_LOW, search_by_projection
from ..tracking.tracker import project_points

FUSE_TARGETS = 8     # static target-KF stack per call
FUSE_POINTS = 1024   # static point-block size per call


def _fuse_match_batch(T_cw_t, kp_uv_t, kp_desc_t, kp_valid_t, kp_oct_t,
                      pt_pack, pt_desc, intr: Intrinsics):
    """Project one point block into T target keyframes and match.

    T_cw_t [T,7], kp_uv_t [T,N,2], kp_desc_t [T,N,8] int32, kp_valid_t [T,N],
    kp_oct_t [T,N], pt_pack [P,9], pt_desc [P,8] int32.
    Returns (idx [T,P] matched kp slot or -1, dist [T,P])."""
    pos = pt_pack[:, 0:3]
    normal = pt_pack[:, 3:6]
    mind, maxd = pt_pack[:, 6], pt_pack[:, 7]
    valid = pt_pack[:, 8] > 0.5
    pt_bits = unpack_bits(pt_desc)
    idx, dist = [], []
    for t in range(T_cw_t.shape[0]):
        uv, ok, oct_pred, _ = project_points(T_cw_t[t], pos, normal, mind, maxd, valid, intr)
        radius = 3.0 * torch.pow(1.2, oct_pred.to(torch.float32))
        res = search_by_projection(
            uv, pt_bits, ok, oct_pred, kp_uv_t[t], unpack_bits(kp_desc_t[t]),
            kp_valid_t[t], kp_oct_t[t], radius, max_dist=TH_LOW, ratio=1.0,
        )
        idx.append(torch.where(res.valid, res.idx, -1))
        dist.append(res.dist)
    return torch.stack(idx), torch.stack(dist)


def _point_block(st: MapStore, pids: np.ndarray, device):
    """Pad a point-id list into the static [FUSE_POINTS, 9] + desc block."""
    pids = np.asarray(pids, np.int32)[:FUSE_POINTS]
    ids = np.concatenate([pids, np.full(FUSE_POINTS - len(pids), -1, np.int32)])
    sel = np.maximum(ids, 0)
    pack = np.concatenate(
        [
            st.pt_pos[sel],
            st.pt_normal[sel],
            st.pt_min_dist[sel][:, None],
            st.pt_max_dist[sel][:, None],
            (ids >= 0).astype(np.float32)[:, None],
        ],
        axis=-1,
    ).astype(np.float32)
    return (ids, torch.from_numpy(pack).to(device),
            torch.from_numpy(st.pt_desc[sel].view(np.int32)).to(device))


def _kf_stack(st: MapStore, kf_ids: np.ndarray, device):
    """Pad a target-KF list into static [FUSE_TARGETS, ...] stacks."""
    kf_ids = np.asarray(kf_ids, np.int32)[:FUSE_TARGETS]
    ids = np.concatenate([kf_ids, np.full(FUSE_TARGETS - len(kf_ids), -1, np.int32)])
    sel = np.maximum(ids, 0)
    valid = st.kf_kp_valid[sel] & (ids >= 0)[:, None]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (ids, dev(st.kf_pose[sel]), dev(st.kf_uv[sel]),
            dev(st.kf_desc[sel].view(np.int32)), dev(valid), dev(st.kf_octave[sel]))


def _merge_matches(st: MapStore, pid_block: np.ndarray, kf_ids: np.ndarray,
                   idx: np.ndarray) -> tuple[int, int]:
    """Apply fuse matches host-side (idx [T, P] kp slot or -1): a slot bound
    to another valid point fuses the two (keeping the better-observed one),
    a free slot gains an observation.  Returns (n_fused, n_added)."""
    n_fused = n_added = 0
    touched: list[int] = []
    with st.lock:
        for ti, kf in enumerate(kf_ids):
            if kf < 0:
                continue
            kf = int(kf)
            for pi in np.nonzero(idx[ti] >= 0)[0]:
                p = int(pid_block[pi])
                if p < 0 or not st.pt_valid[p]:
                    continue
                slot = int(idx[ti, pi])
                existing = int(st.kf_obs[kf, slot])
                if existing == p:
                    continue
                if existing >= 0 and st.pt_valid[existing]:
                    if st.pt_n_obs[existing] >= st.pt_n_obs[p]:
                        st.replace_point(p, existing)
                        touched.append(existing)
                    else:
                        st.replace_point(existing, p)
                        touched.append(p)
                    n_fused += 1
                else:
                    if (st.pt_obs_kf[p][: st.pt_n_obs[p]] == kf).any():
                        continue
                    st.add_observation(p, kf, slot)
                    touched.append(p)
                    n_added += 1
        if touched:
            st.update_point_stats(np.unique(touched))
    return n_fused, n_added


def fuse_into_keyframes(st: MapStore, intr: Intrinsics, pids: np.ndarray,
                        target_kfs: np.ndarray, device) -> tuple[int, int]:
    """Fuse the given map points into the given target keyframes."""
    if len(pids) == 0 or len(target_kfs) == 0:
        return 0, 0
    total_fused = total_added = 0
    for t0 in range(0, len(target_kfs), FUSE_TARGETS):
        kf_ids, poses, uv, desc, valid, octv = _kf_stack(
            st, target_kfs[t0 : t0 + FUSE_TARGETS], device)
        for p0 in range(0, len(pids), FUSE_POINTS):
            pid_block, pack, pdesc = _point_block(st, pids[p0 : p0 + FUSE_POINTS], device)
            idx, _ = _fuse_match_batch(poses, uv, desc, valid, octv, pack, pdesc, intr)
            f, a = _merge_matches(st, pid_block, kf_ids, idx.cpu().numpy())
            total_fused += f
            total_added += a
    return total_fused, total_added


def search_in_neighbors(st: MapStore, intr: Intrinsics, kf: int, device,
                        n_first: int = 8, n_second: int = 4) -> tuple[int, int]:
    """Fuse the new keyframe's points into its 1st+2nd degree covisible
    neighbours, then the neighbours' points back into the new keyframe."""
    first = st.covisibility(kf, min_weight=15)[:n_first]
    if len(first) == 0:
        first = st.covisibility(kf, min_weight=5)[:n_first]
    targets: list[int] = []
    seen = {int(kf)}
    for c in first:
        if int(c) not in seen:
            targets.append(int(c))
            seen.add(int(c))
        for c2 in st.covisibility(int(c), min_weight=15)[:n_second]:
            if int(c2) not in seen:
                targets.append(int(c2))
                seen.add(int(c2))
    if not targets:
        return 0, 0
    targets_arr = np.asarray(targets, np.int32)

    own = st.kf_obs[kf]
    own = own[own >= 0]
    own = own[st.pt_valid[own]]
    f1, a1 = fuse_into_keyframes(st, intr, own, targets_arr, device)

    neigh_pts = st.kf_obs[targets_arr].ravel()
    neigh_pts = np.unique(neigh_pts[neigh_pts >= 0])
    neigh_pts = neigh_pts[st.pt_valid[neigh_pts]]
    f2, a2 = fuse_into_keyframes(st, intr, neigh_pts, np.array([kf], np.int32), device)
    return f1 + f2, a1 + a2
