"""Local mapping: map-point culling, fusion, local BA, keyframe culling
(port of spslam_tpu/mapping/local_mapper.py).

The BA window (keyframes, points, the map planes the window observes, their
observations and structural edges) is assembled on the host from the
MapStore into a padded fixed-shape BAProblem, solved on the device (on a
CUDA device as a replay of one captured graph, `mapping/ba_graph.py`), and
written back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, tracing
from ..geometry.camera import Intrinsics
from ..map.store import MapStore
from ..solver.ba import BAProblem
from ..solver.robust import octave_inv_sigma2
from . import ba_graph


@dataclass(frozen=True)
class MapperConfig:
    """Same fields and defaults as the reference's MapperConfig."""

    ba_max_poses: int = 24        # free + fixed keyframes in the window
    ba_max_free: int = 16
    ba_max_points: int = 4096
    ba_max_obs: int = 16384
    ba_obs_per_point: int = 16    # = MapConfig.max_obs_per_point
    ba_max_planes: int = 16
    ba_max_plane_obs: int = 64
    ba_max_pp_edges: int = 32
    cull_found_ratio: float = 0.25
    cull_min_obs: int = 3
    kf_cull_redundancy: float = 0.9
    fuse_neighbors: bool = True   # SearchInNeighbors -> ORBmatcher::Fuse
    ba_every: int = 2             # run local BA every N keyframes
    ba_stage1_iters: int = 4      # LM iterations before the chi2 gate
    ba_stage2_iters: int = 6      # LM iterations after


class LocalMapper:
    def __init__(self, cfg: MapperConfig, intr: Intrinsics, store: MapStore, device=None):
        self.cfg = cfg
        self.intr = intr
        self.store = store
        self.device = resolve_device(device)
        self._recent_points: list[tuple[int, int]] = []  # (point_id, birth_kf)

    def on_new_points(self, pids: np.ndarray, kf: int):
        """Register points born at keyframe `kf` for `cull_points`.  As in
        the reference, nothing on the System's path calls it, so culling
        sees only what a caller registers here."""
        for p in np.asarray(pids):
            self._recent_points.append((int(p), kf))

    def process_keyframe(self, kf: int, run_ba: bool = True):
        """Point maintenance, culling, fusion, local BA, keyframe culling for
        a newly inserted keyframe (the reference's LocalMapping::Run step)."""
        with tracing.span("mapper.keyframe"):
            st = self.store
            pts = st.kf_obs[kf]
            pts = pts[pts >= 0]
            with st.lock:
                st.update_point_stats(pts)
            with tracing.span("mapper.cull_points"):
                self.cull_points(kf)
            if self.cfg.fuse_neighbors and self.store.n_kf >= 3:
                from .fuse import search_in_neighbors

                with tracing.span("mapper.fuse"):
                    search_in_neighbors(self.store, self.intr, kf, self.device)
            due = self.store.n_kf <= 5 or (self.store.n_kf % self.cfg.ba_every == 0)
            if run_ba and self.store.n_kf >= 3 and due:
                with tracing.span("mapper.local_ba"):
                    self.local_ba(kf)
            with tracing.span("mapper.cull_keyframes"):
                self.cull_keyframes(kf)

    def cull_points(self, kf: int):
        """Drop recent points with a poor found/visible ratio or too few
        observations shortly after creation (MapPointCulling)."""
        st = self.store
        with st.lock:
            keep = []
            for p, birth in self._recent_points:
                if not st.pt_valid[p]:
                    continue
                age = kf - birth
                ratio = st.pt_found[p] / max(st.pt_visible[p], 1)
                if ratio < self.cfg.cull_found_ratio:
                    st.erase_point(p)
                elif age >= 2 and st.pt_n_obs[p] < self.cfg.cull_min_obs:
                    st.erase_point(p)
                elif age >= 3:
                    continue  # graduated
                else:
                    keep.append((p, birth))
            self._recent_points = keep

    def _assemble_window(self, kf: int):
        """Local window: covisible KFs (free) + boundary observers (fixed)."""
        st = self.store
        cfg = self.cfg
        cov = st.covisibility(kf, min_weight=5)
        free = np.concatenate([[kf], cov[: cfg.ba_max_free - 1]]).astype(np.int32)
        pts = st.local_points(free)
        if len(pts) > cfg.ba_max_points:
            order = np.argsort(-st.pt_n_obs[pts], kind="stable")
            pts = pts[order[: cfg.ba_max_points]]
        obs_kfs = st.pt_obs_kf[pts]
        all_kfs = np.unique(obs_kfs[obs_kfs >= 0])
        fixed = np.setdiff1d(all_kfs, free)
        fixed = fixed[st.kf_valid[fixed]]
        n_fixed_cap = cfg.ba_max_poses - len(free)
        if len(fixed) > n_fixed_cap:
            fixed = fixed[:n_fixed_cap]
        kf_ids = np.concatenate([free, fixed]).astype(np.int32)
        fixed_mask = np.zeros(len(kf_ids), bool)
        fixed_mask[len(free):] = True
        if not fixed_mask.any():
            fixed_mask[np.argmin(kf_ids)] = True   # gauge: pin the oldest
        return kf_ids, fixed_mask, pts

    def _host_problem(self, kf: int):
        """(host BAProblem, kf_ids, fixed_mask, pts, obs_src, pl_ids) for the
        window around kf, or None when the window is too small."""
        st = self.store
        cfg = self.cfg
        kf_ids, fixed_mask, pts = self._assemble_window(kf)
        if len(pts) < 10 or len(kf_ids) < 2:
            return None
        M, P = cfg.ba_max_poses, cfg.ba_max_points
        R, O = cfg.ba_max_obs, cfg.ba_obs_per_point

        poses = np.zeros((M, 7), np.float32)
        poses[:, 0] = 1
        poses[: len(kf_ids)] = st.kf_pose[kf_ids]
        pose_fixed = np.zeros(M, bool)
        pose_fixed[: len(kf_ids)] = fixed_mask
        pose_valid = np.zeros(M, bool)
        pose_valid[: len(kf_ids)] = True
        points = np.zeros((P, 3), np.float32)
        points[: len(pts)] = st.pt_pos[pts]
        point_valid = np.zeros(P, bool)
        point_valid[: len(pts)] = True

        # observations from the per-point tables, first O per point
        kf_to_idx = np.full(st.cfg.max_keyframes, -1, np.int32)
        kf_to_idx[kf_ids] = np.arange(len(kf_ids), dtype=np.int32)
        kf_arr = st.pt_obs_kf[pts]
        slot_arr = st.pt_obs_slot[pts]
        in_win = (kf_arr >= 0) & (kf_to_idx[np.maximum(kf_arr, 0)] >= 0) & (slot_arr >= 0)
        cum = np.cumsum(in_win, axis=1)
        keep = in_win & (cum <= O)
        rows, cols = np.nonzero(keep)
        rows = rows[:R]
        cols = cols[:R]
        n_obs_used = len(rows)
        k_sel = kf_arr[rows, cols]
        s_sel = slot_arr[rows, cols]

        obs_cam = np.zeros(R, np.int32)
        obs_pt = np.zeros(R, np.int32)
        obs_uv = np.zeros((R, 2), np.float32)
        obs_ur = np.full(R, -1.0, np.float32)
        obs_oct = np.zeros(R, np.int32)
        obs_valid = np.zeros(R, bool)
        obs_cam[:n_obs_used] = kf_to_idx[k_sel]
        obs_pt[:n_obs_used] = rows
        obs_uv[:n_obs_used] = st.kf_uv[k_sel, s_sel]
        obs_ur[:n_obs_used] = st.kf_ur[k_sel, s_sel]
        obs_oct[:n_obs_used] = st.kf_octave[k_sel, s_sel]
        obs_valid[:n_obs_used] = True
        pt_obs = np.full((P, O), -1, np.int32)
        pt_obs[rows, cum[rows, cols] - 1] = np.arange(n_obs_used, dtype=np.int32)
        obs_src = (pts[rows], k_sel, s_sel)

        planes, plane_valid, pobs, pp, pl_ids = self._window_planes(kf_to_idx)

        def host(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        prob = BAProblem(
            poses=host(poses), pose_fixed=host(pose_fixed), pose_valid=host(pose_valid),
            points=host(points), point_valid=host(point_valid),
            obs_cam=host(obs_cam), obs_pt=host(obs_pt), obs_uv=host(obs_uv),
            obs_ur=host(obs_ur), obs_inv_sigma2=octave_inv_sigma2(host(obs_oct)),
            obs_valid=host(obs_valid), pt_obs=host(pt_obs),
            planes=host(planes), plane_valid=host(plane_valid),
            **{k: host(v) for k, v in {**pobs, **pp}.items()},
        )
        return prob, kf_ids, fixed_mask, pts, obs_src, pl_ids

    def _window_planes(self, kf_to_idx: np.ndarray):
        """Map planes observed from the window's keyframes (up to
        ba_max_planes), their observations (up to ba_max_plane_obs) and the
        structural edges among them (up to ba_max_pp_edges), padded: padding
        planes and observations are [0, 0, 1, 0]."""
        st = self.store
        cfg = self.cfg
        L, Q, E = cfg.ba_max_planes, cfg.ba_max_plane_obs, cfg.ba_max_pp_edges
        planes = np.zeros((L, 4), np.float32)
        planes[:, 2] = 1.0
        plane_valid = np.zeros(L, bool)
        pobs = dict(
            pobs_cam=np.zeros(Q, np.int32), pobs_plane=np.zeros(Q, np.int32),
            pobs_pi=np.tile(np.array([0, 0, 1, 0], np.float32), (Q, 1)),
            pobs_w=np.zeros(Q, np.float32), pobs_valid=np.zeros(Q, bool),
        )
        pl_ids = []
        q = 0
        for l in np.nonzero(st.pl_valid)[0]:
            obs_in_window = [j for j in range(st.pl_obs_count[l])
                             if kf_to_idx[st.pl_obs_kf[l, j]] >= 0]
            if not obs_in_window or len(pl_ids) >= L:
                continue
            li = len(pl_ids)
            pl_ids.append(int(l))
            planes[li] = st.pl_coef[l]
            plane_valid[li] = True
            for j in obs_in_window:
                if q >= Q:
                    break
                pobs["pobs_cam"][q] = kf_to_idx[st.pl_obs_kf[l, j]]
                pobs["pobs_plane"][q] = li
                pobs["pobs_pi"][q] = st.pl_obs_pi[l, j]
                pobs["pobs_w"][q] = max(st.pl_obs_w[l, j], 1e-3)
                pobs["pobs_valid"][q] = True
                q += 1
        pp = dict(pp_a=np.zeros(E, np.int32), pp_b=np.zeros(E, np.int32),
                  pp_type=np.zeros(E, np.int32), pp_w=np.zeros(E, np.float32),
                  pp_valid=np.zeros(E, bool))
        pl_index = {l: i for i, l in enumerate(pl_ids)}
        e = 0
        for a, b, typ in zip(st.ppe_a, st.ppe_b, st.ppe_type):
            if e >= E:
                break
            if int(a) in pl_index and int(b) in pl_index:
                pp["pp_a"][e] = pl_index[int(a)]
                pp["pp_b"][e] = pl_index[int(b)]
                pp["pp_type"][e] = int(typ)
                pp["pp_w"][e] = 10.0
                pp["pp_valid"][e] = True
                e += 1
        return planes, plane_valid, pobs, pp, pl_ids

    def local_ba(self, kf: int):
        st = self.store
        built = self._host_problem(kf)
        if built is None:
            return
        prob, kf_ids, fixed_mask, pts, obs_src, pl_ids = built
        # solved and fetched before taking the store lock
        new_poses, new_points, new_planes, inl = ba_graph.solve(
            prob, self.intr, self.cfg, self.device)
        with st.lock:
            for i, k in enumerate(kf_ids):
                if not fixed_mask[i]:
                    st.set_kf_pose(int(k), new_poses[i])
            st.pt_pos[pts] = new_points[: len(pts)]
            st.pl_coef[pl_ids] = new_planes[: len(pl_ids)]
            src_p, src_k, _ = obs_src
            for ri in np.nonzero(~inl[: len(src_p)])[0]:
                p = int(src_p[ri])
                if st.pt_valid[p]:
                    st.remove_observation(p, int(src_k[ri]))
            st.version += 1

    def cull_keyframes(self, kf: int):
        """Erase local KFs whose points are >= 90% covered by >= 3 other
        keyframes (KeyFrameCulling)."""
        st = self.store
        with st.lock:
            for k in st.covisibility(kf, min_weight=5):
                if k == 0 or k == kf or not st.kf_valid[k]:
                    continue
                pts = st.kf_obs[k]
                pts = pts[pts >= 0]
                if len(pts) < 20:
                    continue
                redundant = np.sum(st.pt_n_obs[pts] >= 4)
                if redundant > self.cfg.kf_cull_redundancy * len(pts):
                    st.erase_keyframe(int(k))
