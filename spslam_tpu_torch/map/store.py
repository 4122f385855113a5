"""Host-side map store: keyframes, map points, map planes, observations,
covisibility (numpy copy of spslam_tpu/map/store.py; the port imports
nothing of the JAX package).

Flat numpy SoA arrays owned by the host; device work (matching, BA)
consumes padded snapshots of them and results merge back by index.
Capacities start at MapConfig's values and DOUBLE on demand; indices are
stable for the whole run (erased entries are masked invalid).

`from_numpy` / `load_arrays` read the arrays of a saved map, including the
.npz that spslam_tpu's System.save_map writes (same array names).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..native.bindings import covis_count

# byte -> popcount lookup table (for pairwise Hamming over packed descriptors)
_POPCNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)


@dataclass
class MapConfig:
    max_keyframes: int = 512
    max_points: int = 65536
    max_planes: int = 64
    n_kp: int = 1024          # keypoint budget per keyframe
    max_obs_per_point: int = 16


# the arrays a map checkpoint holds (System.save_map), besides the counters
# n_kf, n_pt and n_pl
SAVED_ARRAYS = tuple(
    "kf_pose kf_valid kf_ts kf_frame_id kf_parent kf_uv kf_octave "
    "kf_angle kf_desc kf_depth kf_ur kf_kp_valid kf_obs "
    "pt_pos pt_valid pt_desc pt_normal pt_min_dist pt_max_dist "
    "pt_ref_kf pt_first_kf pt_obs_kf pt_obs_slot pt_n_obs "
    "pt_visible pt_found pl_coef pl_valid pl_obs_kf pl_obs_pi "
    "pl_obs_w pl_obs_count pl_ref_kf pl_n_pts".split()
)
SAVED_COUNTS = ("n_kf", "n_pt", "n_pl")


class MapStore:
    @classmethod
    def from_numpy(cls, data, cfg: MapConfig | None = None) -> "MapStore":
        """A store holding the arrays of a saved map: `data` maps the names
        in SAVED_ARRAYS and SAVED_COUNTS to numpy arrays (an opened .npz)."""
        st = cls(cfg or MapConfig())
        st.load_arrays(data)
        return st

    def load_arrays(self, data):
        """Adopt a saved map's arrays and capacities (see from_numpy)."""
        names = set(getattr(data, "files", None) or data.keys())
        missing = [k for k in SAVED_ARRAYS + SAVED_COUNTS if k not in names]
        if missing:
            raise ValueError(f"saved map lacks arrays: {missing}")
        for k in SAVED_COUNTS:
            setattr(self, k, int(data[k]))
        for k in SAVED_ARRAYS:
            setattr(self, k, np.array(data[k]))
        self.cfg.max_keyframes = self.kf_pose.shape[0]
        self.cfg.max_points = self.pt_pos.shape[0]
        self.cfg.max_planes = self.pl_coef.shape[0]
        self.cfg.n_kp = self.kf_uv.shape[1]
        self.cfg.max_obs_per_point = self.pt_obs_kf.shape[1]
        self.version += 1
        self.topo_version += 1

    def __init__(self, cfg: MapConfig):
        import dataclasses
        import threading

        # own a private copy: capacity growth mutates cfg in place, and a
        # MapConfig shared between two stores would otherwise desync the
        # second store's capacity invariant from its actual array sizes
        self.cfg = dataclasses.replace(cfg)
        # guards short host-side mutation sections in async-pipeline mode
        # (the reference's Map::mMutexMapUpdate, massively narrowed)
        self.lock = threading.RLock()
        K, P, L, N, O = (
            cfg.max_keyframes,
            cfg.max_points,
            cfg.max_planes,
            cfg.n_kp,
            cfg.max_obs_per_point,
        )
        # --- keyframes ---
        self.kf_pose = np.zeros((K, 7), np.float32)
        self.kf_pose[:, 0] = 1.0
        self.kf_valid = np.zeros(K, bool)
        self.kf_ts = np.zeros(K, np.float64)
        self.kf_frame_id = np.full(K, -1, np.int64)
        self.kf_parent = np.full(K, -1, np.int32)  # spanning tree
        # per-keyframe keypoint data (copied from FrameData at insertion)
        self.kf_uv = np.zeros((K, N, 2), np.float32)
        self.kf_octave = np.zeros((K, N), np.int32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_depth = np.zeros((K, N), np.float32)
        self.kf_ur = np.full((K, N), -1.0, np.float32)
        self.kf_kp_valid = np.zeros((K, N), bool)
        self.kf_obs = np.full((K, N), -1, np.int32)  # map point id per kp slot
        self.n_kf = 0
        # --- map points ---
        self.pt_pos = np.zeros((P, 3), np.float32)
        self.pt_valid = np.zeros(P, bool)
        self.pt_desc = np.zeros((P, 8), np.uint32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_ref_kf = np.full(P, -1, np.int32)
        self.pt_first_kf = np.full(P, -1, np.int32)
        self.pt_obs_kf = np.full((P, O), -1, np.int32)
        self.pt_obs_slot = np.full((P, O), -1, np.int32)
        self.pt_n_obs = np.zeros(P, np.int32)
        self.pt_visible = np.ones(P, np.int32)   # times predicted visible
        self.pt_found = np.ones(P, np.int32)     # times actually matched
        self.n_pt = 0
        # --- map planes ---
        self.pl_coef = np.zeros((L, 4), np.float32)
        self.pl_valid = np.zeros(L, bool)
        self.pl_obs_kf = np.full((L, O), -1, np.int32)
        self.pl_obs_pi = np.zeros((L, O, 4), np.float32)  # observed (n,d) in KF cam frame
        self.pl_obs_w = np.zeros((L, O), np.float32)      # information (inlier-based)
        self.pl_obs_count = np.zeros(L, np.int32)
        self.pl_ref_kf = np.full(L, -1, np.int32)
        self.pl_n_pts = np.zeros(L, np.int32)    # supporting inlier count
        self.n_pl = 0
        # plane-plane structural edges ("supposed plane" relations); a map
        # checkpoint does not hold them, in either package
        self.ppe_a = np.zeros(0, np.int32)
        self.ppe_b = np.zeros(0, np.int32)
        self.ppe_type = np.zeros(0, np.int32)  # 0 parallel, 1 perpendicular
        # monotonically increasing map version (bumped by any writer)
        self.version = 0
        # topology version: bumped only when the SET of keyframes / points /
        # observations changes (not when BA/PGO rewrite values) — lets the
        # tracker's local-map snapshot skip recomputing covisibility and ids
        # on value-only updates and just re-gather the same rows
        self.topo_version = 0
        # callbacks called with the keyframe id when a keyframe is erased
        # (the loop closer's database drops it: culled keyframes stop being
        # loop and relocalization candidates)
        self.erase_kf_hooks: list = []

    # ------------------------------------------------------------------
    # capacity growth: indices stay stable, only the flat array objects are
    # swapped under the lock; device consumers pad to their own static caps
    # ------------------------------------------------------------------

    def _grow_rows(self, names_fills):
        for name, fill in names_fills:
            a = getattr(self, name)
            b = np.full((a.shape[0] * 2,) + a.shape[1:], fill, a.dtype)
            b[: a.shape[0]] = a
            setattr(self, name, b)

    def _ensure_kf_capacity(self):
        if self.n_kf < self.cfg.max_keyframes:
            return
        with self.lock:
            if self.n_kf < self.cfg.max_keyframes:
                return
            self._grow_rows([
                ("kf_pose", 0.0), ("kf_valid", False), ("kf_ts", 0.0),
                ("kf_frame_id", -1), ("kf_parent", -1), ("kf_uv", 0.0),
                ("kf_octave", 0), ("kf_angle", 0.0), ("kf_desc", 0),
                ("kf_depth", 0.0), ("kf_ur", -1.0), ("kf_kp_valid", False),
                ("kf_obs", -1),
            ])
            self.kf_pose[self.cfg.max_keyframes:, 0] = 1.0
            self.cfg.max_keyframes *= 2

    def _ensure_pt_capacity(self, n_new: int = 1):
        if self.n_pt + n_new <= self.cfg.max_points:
            return
        with self.lock:
            while self.n_pt + n_new > self.cfg.max_points:
                self._grow_rows([
                    ("pt_pos", 0.0), ("pt_valid", False), ("pt_desc", 0),
                    ("pt_normal", 0.0), ("pt_min_dist", 0.0),
                    ("pt_max_dist", 0.0), ("pt_ref_kf", -1),
                    ("pt_first_kf", -1), ("pt_obs_kf", -1),
                    ("pt_obs_slot", -1), ("pt_n_obs", 0),
                    ("pt_visible", 1), ("pt_found", 1),
                ])
                self.cfg.max_points *= 2

    def _ensure_pl_capacity(self):
        if self.n_pl < self.cfg.max_planes:
            return
        with self.lock:
            if self.n_pl < self.cfg.max_planes:
                return
            self._grow_rows([
                ("pl_coef", 0.0), ("pl_valid", False), ("pl_obs_kf", -1),
                ("pl_obs_pi", 0.0), ("pl_obs_w", 0.0), ("pl_obs_count", 0),
                ("pl_ref_kf", -1), ("pl_n_pts", 0),
            ])
            self.pl_coef[self.cfg.max_planes:, 2] = 1.0
            self.cfg.max_planes *= 2

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------

    def add_keyframe(self, T_cw, ts, frame_np: dict, frame_id: int,
                     parent: int = -1) -> int:
        """frame_np: dict of numpy arrays from FrameData (uv, octave, angle,
        desc, depth, u_right, valid).  `parent` is the spanning-tree parent
        (the tracker's reference keyframe at insertion — the reference's
        KeyFrame::ChangeParent/mpParent, used for essential-graph spanning
        edges and erase-time re-parenting)."""
        self._ensure_kf_capacity()
        k = self.n_kf
        self.kf_parent[k] = parent if 0 <= parent < k else -1
        self.kf_pose[k] = T_cw
        self.kf_ts[k] = ts
        self.kf_frame_id[k] = frame_id
        self.kf_uv[k] = frame_np["uv"]
        self.kf_octave[k] = frame_np["octave"]
        self.kf_angle[k] = frame_np["angle"]
        self.kf_desc[k] = frame_np["desc"]
        self.kf_depth[k] = frame_np["depth"]
        self.kf_ur[k] = frame_np["u_right"]
        self.kf_kp_valid[k] = frame_np["valid"]
        self.kf_obs[k] = -1
        self.kf_valid[k] = True
        self.n_kf += 1
        self.version += 1
        self.topo_version += 1
        return k

    def set_kf_pose(self, k: int, T_cw):
        self.kf_pose[k] = T_cw
        self.version += 1

    def erase_keyframe(self, k: int):
        """KF culling: detach observations and invalidate."""
        slots = np.nonzero(self.kf_obs[k] >= 0)[0]
        for s in slots:
            self.remove_observation(int(self.kf_obs[k, s]), k)
        self.kf_valid[k] = False
        # re-parent children in the spanning tree to this KF's parent
        children = np.nonzero((self.kf_parent == k) & self.kf_valid)[0]
        self.kf_parent[children] = self.kf_parent[k]
        self.version += 1
        self.topo_version += 1
        for hook in self.erase_kf_hooks:
            hook(k)

    # ------------------------------------------------------------------
    # points
    # ------------------------------------------------------------------

    def add_point(self, pos, desc, normal, ref_kf: int, dist: float,
                  octave: int = 0) -> int:
        """One new point with no observation yet; returns its id.  Its
        scale range is the reference's: max distance dist * 1.2^octave."""
        self._ensure_pt_capacity()
        p = self.n_pt
        self.pt_pos[p] = pos
        self.pt_desc[p] = desc
        self.pt_normal[p] = normal
        self.pt_ref_kf[p] = ref_kf
        self.pt_first_kf[p] = ref_kf
        self.pt_max_dist[p] = dist * 1.2 ** octave
        self.pt_min_dist[p] = self.pt_max_dist[p] / 1.2 ** 8
        self.pt_valid[p] = True
        self.pt_n_obs[p] = 0
        self.pt_visible[p] = 1
        self.pt_found[p] = 1
        self.n_pt += 1
        self.version += 1
        self.topo_version += 1
        return p

    def add_points_bulk(self, pos, desc, normal, dist, ref_kf: int, slots,
                        octave=None) -> np.ndarray:
        """Vectorized creation of n new points observed by (ref_kf, slots).

        Returns the new point ids.  Equivalent to n single-point creations,
        each with its first observation, without per-point Python overhead.
        """
        n = len(pos)
        self._ensure_pt_capacity(n)
        p0 = self.n_pt
        ids = np.arange(p0, p0 + n, dtype=np.int32)
        self.pt_pos[ids] = pos
        self.pt_desc[ids] = desc
        self.pt_normal[ids] = normal
        level = 1.2 ** octave if octave is not None else 1.0
        self.pt_max_dist[ids] = dist * level
        self.pt_min_dist[ids] = self.pt_max_dist[ids] / 1.2 ** 8
        self.pt_ref_kf[ids] = ref_kf
        self.pt_first_kf[ids] = ref_kf
        self.pt_valid[ids] = True
        self.pt_n_obs[ids] = 1
        self.pt_visible[ids] = 1
        self.pt_found[ids] = 1
        self.pt_obs_kf[ids, 0] = ref_kf
        self.pt_obs_slot[ids, 0] = slots
        self.kf_obs[ref_kf, slots] = ids
        self.n_pt += n
        self.version += 1
        self.topo_version += 1
        return ids

    def add_observations_bulk(self, pids, kf: int, slots):
        """Vectorized add_observation for multiple points into one keyframe
        (skips slot conflicts and full observation lists)."""
        pids = np.asarray(pids)
        slots = np.asarray(slots)
        ok = (self.kf_obs[kf, slots] < 0) & (self.pt_n_obs[pids] < self.cfg.max_obs_per_point)
        pids, slots = pids[ok], slots[ok]
        c = self.pt_n_obs[pids]
        self.pt_obs_kf[pids, c] = kf
        self.pt_obs_slot[pids, c] = slots
        self.pt_n_obs[pids] = c + 1
        self.kf_obs[kf, slots] = pids
        self.version += 1
        self.topo_version += 1

    def add_observation(self, p: int, kf: int, slot: int):
        if self.kf_obs[kf, slot] >= 0:
            return  # slot taken
        c = self.pt_n_obs[p]
        if c >= self.cfg.max_obs_per_point:
            return
        self.pt_obs_kf[p, c] = kf
        self.pt_obs_slot[p, c] = slot
        self.pt_n_obs[p] = c + 1
        self.kf_obs[kf, slot] = p
        self.version += 1
        self.topo_version += 1

    def remove_observation(self, p: int, kf: int):
        """Detach point p from keyframe kf and compact its observation list
        (the reference's MapPoint::EraseObservation); fully vectorized —
        KF culling calls this for every slot of the culled keyframe."""
        obs_kf = self.pt_obs_kf[p]
        mask = obs_kf == kf
        if mask.any():
            slots = self.pt_obs_slot[p][mask]
            slots = slots[slots >= 0]
            hit = slots[self.kf_obs[kf, slots] == p]
            self.kf_obs[kf, hit] = -1
        keep = ~mask & (obs_kf >= 0)
        kfs = obs_kf[keep]
        slots = self.pt_obs_slot[p][keep]
        self.pt_obs_kf[p] = -1
        self.pt_obs_slot[p] = -1
        self.pt_obs_kf[p, : len(kfs)] = kfs
        self.pt_obs_slot[p, : len(slots)] = slots
        self.pt_n_obs[p] = len(kfs)
        if self.pt_n_obs[p] <= 1 and self.pt_valid[p]:
            self.erase_point(p)
        self.version += 1
        self.topo_version += 1

    def erase_point(self, p: int):
        for i in range(self.pt_n_obs[p]):
            kf, slot = self.pt_obs_kf[p, i], self.pt_obs_slot[p, i]
            if kf >= 0 and self.kf_obs[kf, slot] == p:
                self.kf_obs[kf, slot] = -1
        self.pt_obs_kf[p] = -1
        self.pt_obs_slot[p] = -1
        self.pt_n_obs[p] = 0
        self.pt_valid[p] = False
        self.version += 1
        self.topo_version += 1

    def replace_point(self, old: int, new: int):
        """Fuse: redirect all observations of `old` to `new` (the reference's
        MapPoint::Replace)."""
        if old == new:
            return
        kfs = self.pt_obs_kf[old, : self.pt_n_obs[old]]
        slots = self.pt_obs_slot[old, : self.pt_n_obs[old]]
        ok = kfs >= 0
        kfs, slots = kfs[ok], slots[ok]
        # only slots still pointing at `old` transfer (fuse may have
        # retargeted a slot in between)
        owned = self.kf_obs[kfs, slots] == old
        dup = np.isin(kfs, self.pt_obs_kf[new, : self.pt_n_obs[new]])
        # new already observed in this KF: just clear the slot
        clear = owned & dup
        self.kf_obs[kfs[clear], slots[clear]] = -1
        xfer = owned & ~dup
        k_x, s_x = kfs[xfer], slots[xfer]
        _, first = np.unique(k_x, return_index=True)
        k_x, s_x = k_x[np.sort(first)], s_x[np.sort(first)]
        self.kf_obs[k_x, s_x] = new
        c = self.pt_n_obs[new]
        room = max(self.cfg.max_obs_per_point - c, 0)
        k_r, s_r = k_x[:room], s_x[:room]   # overflow keeps the forward link
        self.pt_obs_kf[new, c : c + len(k_r)] = k_r
        self.pt_obs_slot[new, c : c + len(k_r)] = s_r
        self.pt_n_obs[new] = c + len(k_r)
        self.pt_found[new] += self.pt_found[old]
        self.pt_visible[new] += self.pt_visible[old]
        self.pt_obs_kf[old] = -1
        self.pt_obs_slot[old] = -1
        self.pt_n_obs[old] = 0
        self.pt_valid[old] = False
        self.version += 1
        self.topo_version += 1

    # ------------------------------------------------------------------
    # planes (each writer bumps `version`: the tracker's plane snapshot is
    # cached on it)
    # ------------------------------------------------------------------

    def add_plane(self, coef, ref_kf: int, n_pts: int) -> int:
        self._ensure_pl_capacity()
        l = self.n_pl
        self.pl_coef[l] = coef
        self.pl_ref_kf[l] = ref_kf
        self.pl_n_pts[l] = n_pts
        self.pl_valid[l] = True
        self.n_pl += 1
        self.version += 1
        return l

    def add_plane_observation(self, l: int, kf: int, pi_cam=None, weight: float = 1.0):
        c = self.pl_obs_count[l]
        if c < self.pl_obs_kf.shape[1] and not (self.pl_obs_kf[l, :c] == kf).any():
            self.pl_obs_kf[l, c] = kf
            if pi_cam is not None:
                self.pl_obs_pi[l, c] = pi_cam
            self.pl_obs_w[l, c] = weight
            self.pl_obs_count[l] = c + 1
            self.version += 1

    def add_plane_edge(self, a: int, b: int, etype: int):
        """Structural parallel (0) / perpendicular (1) edge between planes."""
        dup = (((self.ppe_a == a) & (self.ppe_b == b))
               | ((self.ppe_a == b) & (self.ppe_b == a))).any()
        if not dup:
            self.ppe_a = np.append(self.ppe_a, np.int32(a))
            self.ppe_b = np.append(self.ppe_b, np.int32(b))
            self.ppe_type = np.append(self.ppe_type, np.int32(etype))
            self.version += 1

    # ------------------------------------------------------------------
    # covisibility / local map queries
    # ------------------------------------------------------------------

    def covisibility(self, k: int, min_weight: int = 15) -> np.ndarray:
        """KF ids sharing >= min_weight map points with KF k, ordered by
        weight descending (the reference's covisibility graph edges).
        Counted by the native C++ counter (native/src/covis.cc) when the
        library is there, else by numpy bincount."""
        counts = covis_count(self.kf_obs[k], self.pt_obs_kf, k, self.cfg.max_keyframes)
        if counts is None:
            pts = self.kf_obs[k]
            pts = pts[pts >= 0]
            if len(pts) == 0:
                return np.zeros(0, np.int32)
            obs_kfs = self.pt_obs_kf[pts].ravel()
            obs_kfs = obs_kfs[(obs_kfs >= 0) & (obs_kfs != k)]
            if len(obs_kfs) == 0:
                return np.zeros(0, np.int32)
            counts = np.bincount(obs_kfs, minlength=self.cfg.max_keyframes)
        ids = np.nonzero((counts >= min_weight) & self.kf_valid)[0]
        order = np.argsort(-counts[ids], kind="stable")
        return ids[order].astype(np.int32)

    def local_keyframes(self, k: int, min_weight: int = 15, max_n: int = 32) -> np.ndarray:
        cov = self.covisibility(k, min_weight)
        ids = np.concatenate([[k], cov[: max_n - 1]]).astype(np.int32)
        return ids

    def local_points(self, kf_ids: np.ndarray) -> np.ndarray:
        """Unique valid point ids observed by the given keyframes."""
        pts = self.kf_obs[kf_ids].ravel()
        pts = np.unique(pts[pts >= 0])
        return pts[self.pt_valid[pts]].astype(np.int32)

    def update_point_stats(self, pts: np.ndarray):
        """Refresh distinctive descriptor + normal + scale range for the
        given points from their observations (the reference's MapPoint::
        ComputeDistinctiveDescriptors + UpdateNormalAndDepth,
        src/MapPoint.cc — SURVEY.md §2 #6).  Fully vectorized over the
        whole point batch AND each point's <=O observations."""
        pts = np.asarray(pts, np.int64).reshape(-1)
        if len(pts) == 0:
            return
        pts = pts[self.pt_valid[pts] & (self.pt_n_obs[pts] > 0)]
        if len(pts) == 0:
            return
        kfs = self.pt_obs_kf[pts]        # [n, O]
        slots = self.pt_obs_slot[pts]    # [n, O]
        has = kfs >= 0
        kfs_s = np.maximum(kfs, 0)
        slots_s = np.maximum(slots, 0)
        descs = self.kf_desc[kfs_s, slots_s]             # [n, O, 8] uint32
        # distinctive descriptor: min median pairwise Hamming distance
        # (XOR + popcount LUT — ~100x lighter than a 256-wide bit expansion)
        by = descs.view(np.uint8).reshape(descs.shape[0], descs.shape[1], 32)
        xor = by[:, :, None, :] ^ by[:, None, :, :]      # [n, O, O, 32]
        dist = _POPCNT8[xor].sum(-1, dtype=np.int32).astype(np.float32)
        pair_ok = has[:, :, None] & has[:, None, :]
        dist = np.where(pair_ok, dist, np.nan)
        dist[~has] = 0.0  # rows of invalid obs: keep non-NaN (masked below)
        med = np.nanmedian(dist, axis=2)                 # [n, O]
        med = np.where(has, med, np.inf)
        best = np.argmin(med, axis=1)
        rows = np.arange(len(pts))
        self.pt_desc[pts] = descs[rows, best]
        # normal: mean unit vector from observing camera centers to point
        centers = self._camera_centers(kfs_s.ravel()).reshape(kfs.shape + (3,))
        vecs = self.pt_pos[pts][:, None, :] - centers    # [n, O, 3]
        norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
        vecs = np.where(has[..., None], vecs / np.maximum(norms, 1e-9), 0.0)
        nrm = vecs.sum(1) / np.maximum(has.sum(1)[:, None], 1)
        self.pt_normal[pts] = nrm / np.maximum(
            np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9
        )
        # scale-invariance range from the most recent observation
        last = np.maximum(has.sum(1) - 1, 0)
        ref_kf = kfs_s[rows, last]
        ref_slot = slots_s[rows, last]
        dist_ref = np.linalg.norm(
            self.pt_pos[pts] - self._camera_centers(ref_kf), axis=-1
        )
        level_factor = 1.2 ** self.kf_octave[ref_kf, ref_slot]
        self.pt_max_dist[pts] = dist_ref * level_factor
        self.pt_min_dist[pts] = self.pt_max_dist[pts] / 1.2 ** 8

    def _camera_centers(self, kf_ids: np.ndarray) -> np.ndarray:
        from ..geometry.np_lie import camera_center

        return camera_center(self.kf_pose[kf_ids])
